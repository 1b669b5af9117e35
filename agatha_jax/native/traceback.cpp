// Native banded affine-gap traceback (CIGAR).
//
// Two engines share this file:
//
// 1. `agatha_traceback` — row-major full-region DP that mirrors
//    agatha_jax/ops/traceback.py EXACTLY (same recurrence as the device
//    DP / reference CORE_COMPUTE, agatha_kernel.h:20-31: both gap
//    states re-open from the diagonal candidate `temp`).  The Python
//    implementation is the semantic reference; tests cross-check this
//    against it cell-for-cell on random pairs.
//
// 2. `agatha_traceback_adaptive` / `agatha_traceback_batch` — the
//    batch-rate path.  Antidiagonal-major DP over a narrow window
//    skewed along the (0,0)->(t_end,q_end) line, auto-vectorized
//    (int32 lanes; AVX-512 on the build host), with the window half-
//    width doubling until the achieved end score equals the score the
//    device DP reported.  Score verification makes the narrow window
//    safe: any path that attains the known-optimal score inside a
//    sub-region of the full walk-back region is itself an optimal,
//    legal path (same trick as minimap2's adaptive banding).  Paths
//    may differ from engine 1's in tie-break order; scores may not.
//
// C++ because host-side CIGAR for ~10kb reads costs ~0.8 s/pair in
// NumPy — far too slow to keep chips fed at batch rate.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int32_t kMinusInf2 = -16384;       // MINUS_INF2 (gasal_kernels.h:39)
const int64_t kNeg = -1000000000LL;      // path -inf
const int32_t kNeg32 = -(1 << 28);       // path -inf (int32 engine)
const int32_t kNValue = 14;
const int32_t kNPenalty = 1;

inline int64_t sub_score(uint8_t qb, uint8_t tb, int32_t match,
                         int32_t mism) {
  if (qb == kNValue || tb == kNValue) return -kNPenalty;
  return qb == tb ? match : -mism;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills cigar_out (run-length encoded, NUL
// terminated) and score_out.  Returns -1 if cigar_cap is too small.
// bw gates the boundary inits (the scoring band); bw_region widens the
// walk-back region so end positions the kernel reports from
// band-exempt chunk-interior cells stay inside the stored flags.
int agatha_traceback(const uint8_t* qcodes, const uint8_t* tcodes,
                     int32_t q_end, int32_t t_end, int32_t match,
                     int32_t mism, int32_t goe, int32_t ge, int32_t bw,
                     int32_t bw_region, char* cigar_out,
                     int64_t cigar_cap, int64_t* score_out) {
  const int64_t nq = q_end + 1;
  const int64_t nt = t_end + 1;
  const int64_t bwr = bw_region;
  const int64_t width =
      (2LL * bwr + 1 < nq) ? (2LL * bwr + 1) : nq;

  auto lo = [&](int64_t r) { return r - bwr > 0 ? r - bwr : 0; };
  auto hi = [&](int64_t r) {
    return r + bwr < nq - 1 ? r + bwr : nq - 1;
  };

  // flags: bits 0-1 H source (0 diag, 1 E, 2 F); bit 2 E opened from
  // temp; bit 3 F opened from temp.
  std::vector<uint8_t> flags(static_cast<size_t>(nt) * width, 0);
  std::vector<int64_t> prev_h(width), prev_e(width), prev_temp(width);
  std::vector<int64_t> h_row(width), e_val(width), temp(width);
  std::vector<int64_t> f_val(width);

  // virtual row -1: top boundary (agatha_kernel.h:126-148)
  int64_t prev_lo = lo(0);
  {
    int64_t h0 = hi(0);
    for (int64_t j = 0; j + lo(0) <= h0; ++j) {
      int64_t col = lo(0) + j;
      if (col <= bw) {
        prev_h[j] = -(goe + (int64_t)ge * col);
        prev_e[j] = prev_h[j] - goe;
      } else {
        prev_h[j] = kMinusInf2;
        prev_e[j] = kMinusInf2;
      }
      prev_temp[j] = kNeg;
    }
  }

  int64_t prev_m = hi(0) - lo(0) + 1;

  for (int64_t r = 0; r < nt; ++r) {
    const int64_t l = lo(r), h_ = hi(r);
    const int64_t m = h_ - l + 1;
    const uint8_t tb = tcodes[r];
    uint8_t* frow = flags.data() + r * width;

    // windowed fetch helpers: prev arrays are indexed from prev_lo
    auto wget = [&](const std::vector<int64_t>& prev, int64_t j0,
                    int64_t i, int64_t fill) -> int64_t {
      int64_t j = j0 + i;
      return (j >= 0 && j < prev_m) ? prev[j] : fill;
    };

    const int64_t j0_diag = (l - 1) - prev_lo;
    const int64_t j0_up = l - prev_lo;

    int64_t f_state;
    if (l == 0) {
      f_state = (r <= bw) ? (-(goe + (int64_t)ge * r) - goe)
                          : (int64_t)kMinusInf2;
    } else {
      f_state = kNeg;
    }
    int64_t temp_left = kNeg;

    for (int64_t i = 0; i < m; ++i) {
      const int64_t col = l + i;
      // diagonal H(r-1, q-1)
      int64_t htl = wget(prev_h, j0_diag, i, kMinusInf2);
      if (col == 0) {
        if (r == 0) {
          htl = 0;  // origin corner
        } else {
          htl = (r - 1 <= bw) ? -(goe + (int64_t)ge * (r - 1))
                              : (int64_t)kMinusInf2;
        }
      }
      const int64_t tmp = htl + sub_score(qcodes[col], tb, match, mism);
      temp[i] = tmp;

      // E arriving from row r-1
      int64_t ev;
      bool e_open_flag = false;
      if (r == 0) {
        ev = wget(prev_e, j0_up, i, kNeg);  // top-boundary E directly
      } else {
        const int64_t e_in = wget(prev_e, j0_up, i, kNeg);
        const int64_t t_up = wget(prev_temp, j0_up, i, kNeg);
        const int64_t e_open = t_up - goe;
        const int64_t e_ext = e_in - ge;
        ev = e_open >= e_ext ? e_open : e_ext;
        e_open_flag = e_open >= e_ext;
      }
      e_val[i] = ev;

      // F along the row
      int64_t fv;
      bool f_open_flag = false;
      if (i == 0 && l == 0) {
        fv = f_state;  // left-boundary F directly at column 0
      } else {
        const int64_t fo = temp_left - goe;
        const int64_t fe = f_state - ge;
        fv = fo >= fe ? fo : fe;
        // the Python reference hardcodes f_from_open[0] = False at
        // the band's left edge (ops/traceback.py); the fo/fe compare
        // on kNeg sentinels would spuriously set it when
        // gap_oe <= gap_extend
        f_open_flag = (i != 0) && fo >= fe;
      }
      f_val[i] = fv;

      int64_t hv = tmp;
      uint8_t src = 0;
      if (ev > hv) {
        hv = ev;
        src = 1;
      }
      if (fv > hv) {
        hv = fv;
        src = 2;
      }
      h_row[i] = hv;
      frow[i] = static_cast<uint8_t>(
          src | (e_open_flag ? 4 : 0) | (f_open_flag ? 8 : 0));

      temp_left = tmp;
      f_state = fv;
    }

    prev_h.swap(h_row);
    prev_e.swap(e_val);
    prev_temp.swap(temp);
    prev_lo = l;
    prev_m = m;
  }

  *score_out = prev_h[q_end - lo(t_end)];

  // --- walk back ---
  std::vector<char> ops;
  ops.reserve(nq + nt);
  int64_t r = t_end, q = q_end;
  char state = 'H';
  while (r >= 0 && q >= 0) {
    if (q < lo(r) || q > hi(r)) return -2;  // escaped the band
    const uint8_t fl = flags[r * width + (q - lo(r))];
    if (state == 'H') {
      const uint8_t src = fl & 3;
      if (src == 0) {
        ops.push_back('M');
        --r;
        --q;
      } else if (src == 1) {
        state = 'E';
      } else {
        state = 'F';
      }
    } else if (state == 'E') {
      ops.push_back('D');
      const bool opened = fl & 4;
      --r;
      if (opened) {
        ops.push_back('M');
        --r;
        --q;
        state = 'H';
      }
    } else {  // F
      ops.push_back('I');
      const bool opened = fl & 8;
      --q;
      if (opened) {
        ops.push_back('M');
        --r;
        --q;
        state = 'H';
      }
    }
  }
  while (q >= 0) {
    ops.push_back('I');
    --q;
  }
  while (r >= 0) {
    ops.push_back('D');
    --r;
  }

  // reverse + run-length encode
  int64_t pos = 0;
  for (int64_t i = static_cast<int64_t>(ops.size()) - 1; i >= 0;) {
    const char op = ops[i];
    int64_t j = i;
    while (j >= 0 && ops[j] == op) --j;
    const int64_t run = i - j;
    char buf[24];
    const int wrote = snprintf(buf, sizeof buf, "%lld%c",
                               static_cast<long long>(run), op);
    if (pos + wrote + 1 > cigar_cap) return -1;
    memcpy(cigar_out + pos, buf, wrote);
    pos += wrote;
    i = j;
  }
  cigar_out[pos] = '\0';
  return 0;
}

}  // extern "C"

// ===========================================================================
// Engine 2: adaptive skewed-window antidiagonal DP (batch-rate path).
// ===========================================================================

namespace {

// One reusable per-thread workspace so batch calls do not reallocate.
struct Workspace {
  std::vector<int32_t> h0, h1, h2;       // H at d, d-1, d-2 (rotated)
  std::vector<int32_t> t0, t1, e0, e1, f0, f1;
  std::vector<int32_t> sc;               // per-diagonal substitution row
  std::vector<int32_t> rlo_v, m_v;       // per-diagonal window lo / width
  std::vector<uint8_t> flags;
  std::vector<uint8_t> qrev;             // reversed query codes
  std::vector<char> ops;
};

// Window geometry for one (q_end, t_end, hw): r in [rlo(d), rlo(d)+m(d)-1]
// on antidiagonal d = r + q.  rlo is monotone with per-step increments of
// at most 1 (each candidate in the max is), which keeps the SIMD loads of
// the previous diagonals at static offsets in {-1, 0, +1}.
inline void window_geometry(int32_t q_end, int32_t t_end, int32_t hw,
                            std::vector<int32_t>& rlo_v,
                            std::vector<int32_t>& m_v) {
  const int64_t D = (int64_t)q_end + t_end;
  rlo_v.resize(D + 1);
  m_v.resize(D + 1);
  for (int64_t d = 0; d <= D; ++d) {
    // center of the skew line in r-coordinates
    int64_t c = D ? (d * t_end) / D : 0;
    int64_t lo = c - hw;
    if (lo < d - q_end) lo = d - q_end;
    if (lo < 0) lo = 0;
    int64_t hi = c + hw;
    if (hi > d) hi = d;
    if (hi > t_end) hi = t_end;
    rlo_v[d] = (int32_t)lo;
    m_v[d] = (int32_t)(hi - lo + 1);
  }
}

// Boundary inits, identical to engine 1 / agatha_kernel.h:126-148.
inline int32_t top_h_init(int64_t col, int32_t goe, int32_t ge,
                          int32_t bw) {
  return col <= bw ? (int32_t)(-(goe + (int64_t)ge * col)) : kMinusInf2;
}

// The hot DP step for one antidiagonal.  A separate function because
// gcc only honors __restrict__ reliably on parameters; inside the
// caller the alias-check count blows the versioning budget and the
// loop stays scalar.
__attribute__((always_inline)) inline void diag_step(int32_t m, int32_t goe, int32_t ge,
               const int32_t* __restrict__ h2d,
               const int32_t* __restrict__ t1u,
               const int32_t* __restrict__ e1u,
               const int32_t* __restrict__ t1l,
               const int32_t* __restrict__ f1l,
               const int32_t* __restrict__ sc,
               int32_t* __restrict__ t0, int32_t* __restrict__ e0,
               int32_t* __restrict__ f0, int32_t* __restrict__ h0,
               uint8_t* __restrict__ frow) {
  for (int32_t j = 0; j < m; ++j) {
    const int32_t tmp = h2d[j] + sc[j];
    const int32_t eo = t1u[j] - goe;
    const int32_t ee = e1u[j] - ge;
    const int32_t ev = eo >= ee ? eo : ee;
    const int32_t fo = t1l[j] - goe;
    const int32_t fe = f1l[j] - ge;
    const int32_t fv = fo >= fe ? fo : fe;
    int32_t hv = tmp;
    int32_t src = 0;
    if (ev > hv) { hv = ev; src = 1; }
    if (fv > hv) { hv = fv; src = 2; }
    t0[j] = tmp;
    e0[j] = ev;
    f0[j] = fv;
    h0[j] = hv;
    frow[j] = (uint8_t)(src | ((eo >= ee) << 2) | ((fo >= fe) << 3));
  }
}

// Solve the window, fill ws.flags, return the achieved score at
// (t_end, q_end).  Flag layout matches engine 1 (bits 0-1 H source,
// bit 2 E opened, bit 3 F opened).
int32_t solve_window(const uint8_t* qcodes, const uint8_t* tcodes,
                     int32_t q_end, int32_t t_end, int32_t match,
                     int32_t mism, int32_t goe, int32_t ge, int32_t bw,
                     int32_t hw, Workspace& ws) {
  const int64_t D = (int64_t)q_end + t_end;
  window_geometry(q_end, t_end, hw, ws.rlo_v, ws.m_v);
  const int64_t W = 2LL * hw + 2;        // flags stride
  ws.flags.assign((size_t)(D + 1) * W, 0);

  // Reversed query so the per-diagonal substitution row is unit-stride:
  // qrev[i] = qcodes[q_end - i]; cell j on diagonal d reads
  // qrev[(q_end - d + rlo) + j].
  ws.qrev.resize(q_end + 1);
  for (int64_t i = 0; i <= q_end; ++i) ws.qrev[i] = qcodes[q_end - i];

  // DP rows with one guard slot in front and three behind (window
  // width changes by at most 1 per diagonal, shifts by at most 1).
  const size_t cap = (size_t)W + 6;
  auto prep = [&](std::vector<int32_t>& v) { v.assign(cap, 0); };
  prep(ws.h0); prep(ws.h1); prep(ws.h2);
  prep(ws.t0); prep(ws.t1);
  prep(ws.e0); prep(ws.e1);
  prep(ws.f0); prep(ws.f1);
  ws.sc.assign(cap, 0);

  int32_t* h0 = ws.h0.data() + 1;
  int32_t* h1 = ws.h1.data() + 1;
  int32_t* h2 = ws.h2.data() + 1;
  int32_t* t0 = ws.t0.data() + 1;
  int32_t* t1 = ws.t1.data() + 1;
  int32_t* e0 = ws.e0.data() + 1;
  int32_t* e1 = ws.e1.data() + 1;
  int32_t* f0 = ws.f0.data() + 1;
  int32_t* f1 = ws.f1.data() + 1;
  int32_t* sc = ws.sc.data() + 1;

  auto set_guards = [&](int32_t* a, int32_t m, int32_t fill) {
    a[-1] = fill;
    a[m] = fill;
    a[m + 1] = fill;
    a[m + 2] = fill;
  };

  int32_t m_p1 = 0, m_p2 = 0;  // widths of d-1 / d-2 rows
  int32_t score = kNeg32;

  for (int64_t d = 0; d <= D; ++d) {
    const int32_t rlo = ws.rlo_v[d];
    const int32_t m = ws.m_v[d];
    const int32_t s1 = d >= 1 ? rlo - ws.rlo_v[d - 1] : 0;
    const int32_t s2 = d >= 2 ? rlo - ws.rlo_v[d - 2] : 0;
    uint8_t* frow = ws.flags.data() + (size_t)d * W;

    // substitution scores for this diagonal (unit-stride via qrev)
    const uint8_t* qr = ws.qrev.data() + (q_end - d + rlo);
    const uint8_t* tc = tcodes + rlo;
    for (int32_t j = 0; j < m; ++j) {
      const uint8_t qb = qr[j], tb = tc[j];
      sc[j] = (qb == kNValue || tb == kNValue)
                  ? -kNPenalty
                  : (qb == tb ? match : -mism);
    }

    // shifted views of the previous diagonals; the rotated write rows
    // never alias them, which diag_step's restrict params promise
    const int32_t* t1u = t1 + s1 - 1;  // temp(d-1) at r-1 (E source)
    const int32_t* e1u = e1 + s1 - 1;
    const int32_t* t1l = t1 + s1;      // temp(d-1) at r   (F source)
    const int32_t* f1l = f1 + s1;
    diag_step(m, goe, ge, h2 + s2 - 1, t1u, e1u, t1l, f1l, sc,
              t0, e0, f0, h0, frow);

    // boundary patches (scalar): r == 0 can only sit at j == 0,
    // q == 0 only at j == m-1.
    auto patch = [&](int32_t j, int32_t htl, int32_t ev, bool eflag,
                     bool use_ev, int32_t fv, bool fflag, bool use_fv) {
      const int32_t tmp = htl + sc[j];
      int32_t evv, fvv;
      bool ef, ff;
      if (use_ev) {
        evv = ev; ef = eflag;
      } else {
        const int32_t eo = t1u[j] - goe, ee = e1u[j] - ge;
        evv = eo >= ee ? eo : ee; ef = eo >= ee;
      }
      if (use_fv) {
        fvv = fv; ff = fflag;
      } else {
        const int32_t fo = t1l[j] - goe, fe = f1l[j] - ge;
        fvv = fo >= fe ? fo : fe; ff = fo >= fe;
      }
      int32_t hv = tmp;
      int32_t src = 0;
      if (evv > hv) { hv = evv; src = 1; }
      if (fvv > hv) { hv = fvv; src = 2; }
      t0[j] = tmp; e0[j] = evv; f0[j] = fvv; h0[j] = hv;
      frow[j] = (uint8_t)(src | (ef << 2) | (ff << 3));
    };
    if (rlo == 0) {
      // cell (0, d): top boundary row
      const int64_t q = d;
      const int32_t htl =
          d == 0 ? 0 : top_h_init(q - 1, goe, ge, bw);
      const int32_t ev =
          q <= bw ? top_h_init(q, goe, ge, bw) - goe : kMinusInf2;
      if (d == 0) {
        const int32_t fv =
            0 <= bw ? -goe - goe : kMinusInf2;  // left F at r=0
        patch(0, htl, ev, false, true, fv, false, true);
      } else {
        patch(0, htl, ev, false, true, 0, false, false);
      }
    }
    if (rlo + m - 1 == d && d >= 1) {
      // cell (d, 0): left boundary column
      const int32_t j = m - 1;
      const int32_t htl = top_h_init(d - 1, goe, ge, bw);
      const int32_t fv =
          d <= bw ? top_h_init(d, goe, ge, bw) - goe : kMinusInf2;
      patch(j, htl, 0, false, false, fv, false, true);
    }

    if (d == D) score = h0[t_end - rlo];

    set_guards(h0, m, kMinusInf2);
    set_guards(t0, m, kNeg32);
    set_guards(e0, m, kNeg32);
    set_guards(f0, m, kNeg32);

    // rotate: d -> d-1 -> d-2
    std::swap(ws.h2, ws.h1);
    std::swap(ws.h1, ws.h0);
    std::swap(ws.t1, ws.t0);
    std::swap(ws.e1, ws.e0);
    std::swap(ws.f1, ws.f0);
    h0 = ws.h0.data() + 1; h1 = ws.h1.data() + 1; h2 = ws.h2.data() + 1;
    t0 = ws.t0.data() + 1; t1 = ws.t1.data() + 1;
    e0 = ws.e0.data() + 1; e1 = ws.e1.data() + 1;
    f0 = ws.f0.data() + 1; f1 = ws.f1.data() + 1;
    m_p2 = m_p1;
    m_p1 = m;
    (void)m_p2;
    (void)h1;
  }
  return score;
}

// Walk ws.flags back from (t_end, q_end).  Returns 0, or -2 if the
// walk leaves the window (caller widens and retries).
int walk_window(const Workspace& ws, int32_t q_end, int32_t t_end,
                int64_t W, std::vector<char>& ops) {
  ops.clear();
  int64_t r = t_end, q = q_end;
  char state = 'H';
  while (r >= 0 && q >= 0) {
    const int64_t d = r + q;
    const int64_t j = r - ws.rlo_v[d];
    if (j < 0 || j >= ws.m_v[d]) return -2;
    const uint8_t fl = ws.flags[(size_t)d * W + j];
    if (state == 'H') {
      const uint8_t src = fl & 3;
      if (src == 0) {
        ops.push_back('M');
        --r; --q;
      } else if (src == 1) {
        state = 'E';
      } else {
        state = 'F';
      }
    } else if (state == 'E') {
      ops.push_back('D');
      const bool opened = fl & 4;
      --r;
      if (opened) {
        ops.push_back('M');
        --r; --q;
        state = 'H';
      }
    } else {
      ops.push_back('I');
      const bool opened = fl & 8;
      --q;
      if (opened) {
        ops.push_back('M');
        --r; --q;
        state = 'H';
      }
    }
  }
  while (q >= 0) { ops.push_back('I'); --q; }
  while (r >= 0) { ops.push_back('D'); --r; }
  return 0;
}

int emit_cigar(const std::vector<char>& ops, char* out, int64_t cap) {
  int64_t pos = 0;
  for (int64_t i = (int64_t)ops.size() - 1; i >= 0;) {
    const char op = ops[i];
    int64_t j = i;
    while (j >= 0 && ops[j] == op) --j;
    char buf[24];
    const int wrote = snprintf(buf, sizeof buf, "%lld%c",
                               (long long)(i - j), op);
    if (pos + wrote + 1 > cap) return -1;
    memcpy(out + pos, buf, wrote);
    pos += wrote;
    i = j;
  }
  out[pos] = '\0';
  return 0;
}

// Adaptive driver for one pair.  expected == INT64_MIN means "score
// unknown": solve once at the maximum window.  Returns 0 ok, -1 cigar
// buffer too small, -2 walk escaped even the widest window, 1 accepted
// at the widest window with score != expected (legitimate only in the
// documented int16-wrap regimes — callers should surface it).
int traceback_adaptive_one(const uint8_t* qcodes, const uint8_t* tcodes,
                           int32_t q_end, int32_t t_end, int32_t match,
                           int32_t mism, int32_t goe, int32_t ge,
                           int32_t bw, int64_t expected, char* cigar_out,
                           int64_t cigar_cap, int64_t* score_out,
                           Workspace& ws) {
  const int32_t delta =
      q_end > t_end ? q_end - t_end : t_end - q_end;
  // Widest window == the legacy engine's walk-back region
  // (|q - r| <= bw_region, bw_region = max(bw, delta) + 16) expressed
  // in skew coordinates.
  const int32_t bw_region = (bw > delta ? bw : delta) + 16;
  const int32_t hw_max = (bw_region + delta) / 2 + 24;

  int32_t hw = 32;
  if (expected == INT64_MIN) hw = hw_max;
  for (;;) {
    if (hw > hw_max) hw = hw_max;
    const int32_t score = solve_window(qcodes, tcodes, q_end, t_end,
                                       match, mism, goe, ge, bw, hw, ws);
    const bool last = hw >= hw_max;
    // At the widest window the result is accepted even when score !=
    // expected (int16-wrap regimes have no exactly-matching window);
    // a walk escape there is final.
    if ((int64_t)score == expected || expected == INT64_MIN || last) {
      const int wrc =
          walk_window(ws, q_end, t_end, 2LL * hw + 2, ws.ops);
      if (wrc == 0) {
        *score_out = score;
        const int erc = emit_cigar(ws.ops, cigar_out, cigar_cap);
        if (erc != 0) return erc;
        const bool mismatch =
            expected != INT64_MIN && (int64_t)score != expected;
        return mismatch ? 1 : 0;
      }
      if (last) return -2;
    }
    hw *= 2;
  }
}

}  // namespace

extern "C" {

// Single-pair adaptive traceback (see engine 2 notes at the top).
int agatha_traceback_adaptive(const uint8_t* qcodes,
                              const uint8_t* tcodes, int32_t q_end,
                              int32_t t_end, int32_t match, int32_t mism,
                              int32_t goe, int32_t ge, int32_t bw,
                              int64_t expected, char* cigar_out,
                              int64_t cigar_cap, int64_t* score_out) {
  Workspace ws;
  return traceback_adaptive_one(qcodes, tcodes, q_end, t_end, match,
                                mism, goe, ge, bw, expected, cigar_out,
                                cigar_cap, score_out, ws);
}

// Batch adaptive traceback over concatenated code blobs; pairs are
// independent, so they are striped across a small thread pool (the
// analogue of the reference's OpenMP host parallelism,
// test_prog.cpp:195-214).  cigars_out is (n, per_cap) row-major; rcs
// gets the per-pair return code.
int agatha_traceback_batch(const uint8_t* qblob, const int64_t* qoff,
                           const uint8_t* tblob, const int64_t* toff,
                           const int32_t* qends, const int32_t* tends,
                           const int64_t* expected, int64_t n,
                           int32_t match, int32_t mism, int32_t goe,
                           int32_t ge, int32_t bw, char* cigars_out,
                           int64_t per_cap, int64_t* scores_out,
                           int32_t* rcs, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = (int32_t)n;
  auto worker = [&](int32_t tid) {
    Workspace ws;
    for (int64_t i = tid; i < n; i += n_threads) {
      rcs[i] = traceback_adaptive_one(
          qblob + qoff[i], tblob + toff[i], qends[i], tends[i], match,
          mism, goe, ge, bw,
          expected ? expected[i] : INT64_MIN,
          cigars_out + i * per_cap, per_cap, scores_out + i, ws);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads - 1);
    for (int32_t t = 1; t < n_threads; ++t) pool.emplace_back(worker, t);
    worker(0);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
