// AGAThA guided-alignment DP for one pair, written for one CUDA block.
//
// Mapping (one block per pair): each thread owns one packed reference
// word — 8 consecutive DP rows — with its H/E/F state in registers, as
// in the reference kernel (agatha_kernel.h:195-284).  The block sweeps
// base antidiagonals: on each one every thread updates its 8 cells,
// takes the row below its word from the previous thread (a warp shuffle,
// or shared memory across warps), and the block reduces the packed
// (H<<16)|r maximum that drives the reference's Z-drop schedule
// (agatha_kernel.h:291-313, 336-356).  A block of W/8 threads covers a
// window of W rows; when the target is longer than the window, the
// window slides up 128 rows at a time by re-assigning the bottom rows'
// threads to the rows above the top (a cyclic row order), so no state
// moves.
//
// The arithmetic is the plain-JAX DP's (agatha_jax/ops/dp.py) cell for
// cell, and the results match ops/sweep.py bit for bit: int16 strip
// truncation (compiled out under SAFE16), slice and chunk clipping, the
// chunk-interior band exemption, the (H<<16)|r tie-break, the per-
// diagonal Z-drop checks with the unguarded wrap-up pass, empty-slice
// termination, N handling and z_threshold < 0.
//
// The code is plain C++ over a context type `Ctx` that supplies the
// thread ids and the three cross-thread operations, so the same body
// compiles for the card (dp_ffi.cu) and for a host emulation of a block.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define AG_FN __device__ __forceinline__
#else
#define AG_FN inline
#endif

namespace agatha {

constexpr int32_t kMinusInf2 = -16384;  // SHRT_MIN / 2
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kNValue = 14;
constexpr int32_t kNPenalty = 1;
constexpr int32_t kShiftQ = 128;     // window shift (rows)
constexpr int32_t kShiftEvery = 64;  // base diagonals between shift checks
constexpr int32_t kGuard = 32;
constexpr int kRows = 8;             // rows per thread
constexpr int kMaxThreads = 512;     // block size bound (<= 128 registers)

struct Params {
  int32_t match, mismatch, goe, ge, sw, z, bw;
  int32_t wt;  // target codes per row
  int32_t qf;  // query codes per row
  int32_t w;   // window rows = kRows * threads per block
};

// Shared-memory exchange record per warp: the row below the next warp's
// first row, and the warp's diagonal maximum.
struct Xchg {
  int32_t h, e, q, dmax;
};

AG_FN int32_t trunc16(int32_t x) { return (int32_t)(int16_t)x; }
AG_FN int32_t ctrunc16(int32_t t) { return t >= 0 ? (t >> 4) : -((-t) >> 4); }
AG_FN int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
AG_FN int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
AG_FN int32_t pack_hr(int32_t h, int32_t r) {
  return (int32_t)(((uint32_t)h << 16) + (uint32_t)r);
}
AG_FN int32_t code_at(const uint8_t* row, int32_t i) {
  const uint8_t b = row[i >> 1];
  return (i & 1) ? (b >> 4) : (b & 15);
}

struct Pair {
  int32_t qlen, rlen, pql, prl, n_diags, i_end8, end_p;
  AG_FN void slice_bounds(const Params& p, int32_t i, int32_t& ss,
                          int32_t& se) const {
    // banded slice clipping (agatha_kernel.h:183-186)
    ss = imax(imax(0, i - pql + 1), ctrunc16((i << 3) + (8 - p.bw)));
    se = imin(imin(prl - 1, i + (p.sw - 1)),
              ctrunc16((i << 3) + (8 * (p.sw - 1) + 7 + p.bw)));
  }
};

// One thread's word: rows r0 .. r0+7 and their state.
struct Word {
  int32_t r0, pr, cs, ce;
  int32_t ha[kRows], hb[kRows];  // H as of d-1 / d-2, roles alternate
  int32_t f[kRows];              // F state
  int32_t e[kRows];              // E leaving each row on the last step
  int32_t sm[kRows], sx[kRows];  // match / mismatch score per row
  int32_t tc[kRows];             // target code per row
  uint32_t qv;                   // query code per row, nibble m = row m
  // per packed diagonal
  int32_t base_qq, base_band;
  bool x_a, x_b, y_a, y_b, cse_a;

  // Enter rows r0 .. r0+7: boundary inits (agatha_kernel.h:126-148).
  AG_FN void enter(const Params& p, const Pair& P, const uint8_t* trow,
                   int32_t row0) {
    r0 = row0;
    pr = r0 >> 3;
    cs = imax(0, (pr << 3) - p.bw) >> 3;
    ce = imin(P.pql - 1, ((pr << 3) + (7 + p.bw)) >> 3);
    uint32_t tv = 0;
    if (r0 < p.wt) tv = *(const uint32_t*)(trow + (r0 >> 1));
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int32_t r = r0 + m;
      const int32_t kb = trunc16(-(p.goe + p.ge * r));
      const bool in_b0 = r <= p.bw;
      ha[m] = hb[m] = in_b0 ? kb : kMinusInf2;
      f[m] = in_b0 ? trunc16(kb - p.goe) : kMinusInf2;
      e[m] = kMinusInf2;
      tc[m] = (tv >> (4 * m)) & 15;
      const bool tn = tc[m] == kNValue;
      sm[m] = tn ? -kNPenalty : p.match;
      sx[m] = tn ? -kNPenalty : -p.mismatch;
    }
  }
};

struct Book {
  int32_t ms, mr, mq, term, diags;

  AG_FN void check(const Params& p, const Pair& P, int32_t d,
                   int32_t dmax) {
    const bool live = term == 0 && d < P.end_p;
    const bool gate =
        live && ((d < P.i_end8 && d < P.n_diags) || d >= P.i_end8);
    const int32_t th = dmax >> 16;
    const int32_t tr = dmax & 0xFFFF;
    const int32_t dq = d - tr;
    const bool upd = gate && th > ms;
    if (p.z >= 0 && gate && !upd && tr >= mr && dq >= mq) {
      int32_t gap = (tr - mr) - (dq - mq);
      gap = gap < 0 ? -gap : gap;
      if (ms - th > p.z + gap * p.ge) term = 1;
    }
    if (upd) {
      ms = th;
      mr = tr;
      mq = dq;
    }
    diags += live ? 1 : 0;
  }
};

// Base diagonal d = d8 + K.  h1 holds H as of d-1, h2 as of d-2; the
// new H overwrites h2.
template <int K, bool SAFE16, class Ctx>
AG_FN void substep(const Ctx& cx, const Params& p, const Pair& P, Word& w,
                   Book& bk, int32_t d8, int32_t vbase,
                   const uint8_t* qrow, int32_t (&h1)[kRows],
                   int32_t (&h2)[kRows]) {
  const int32_t d = d8 + K;
  const int lane = cx.lane();
  const int warp = cx.warp();
  const int nwarp = cx.nwarp();
  Xchg* xs = cx.xchg();

  // the row below this word, as of the previous step
  int32_t nb_h = cx.shfl_prev(h2[kRows - 1]);
  int32_t nb_e = cx.shfl_prev(w.e[kRows - 1]);
  uint32_t nb_q = (uint32_t)cx.shfl_prev((int32_t)w.qv);
  if (nwarp > 1 && lane == 0) {
    const Xchg& x = xs[((d + 1) & 1) * nwarp + (warp + nwarp - 1) % nwarp];
    nb_h = x.h;
    nb_e = x.e;
    nb_q = (uint32_t)x.q;
  }
  const bool bottom = w.r0 == vbase;
  int32_t in_q = (int32_t)(nb_q >> 28);
  if (bottom) {
    // the window's bottom row reads the query and the top boundary
    const int32_t qi = d - vbase;
    in_q = (qi >= 0 && qi < p.qf) ? code_at(qrow, qi) : 0;
    if (vbase == 0) {
      const int32_t col = d - 1;
      nb_h = col < 0 ? 0
             : col <= p.bw ? trunc16(-(p.goe + p.ge * col))
                           : kMinusInf2;
      nb_e = d <= p.bw
                 ? trunc16(trunc16(-(p.goe + p.ge * d)) - p.goe)
                 : kMinusInf2;
    } else {
      nb_h = kMinusInf2;
      nb_e = kMinusInf2;
    }
  }
  w.qv = (w.qv << 4) | (uint32_t)in_q;

  int32_t dmax = kInt32Min;
#pragma unroll
  for (int m = kRows - 1; m >= 0; --m) {
    const int32_t r = w.r0 + m;
    const int32_t qq = w.base_qq + (K - m);
    const bool valid = qq >= 0 && qq < P.qlen;
    const int32_t dband = w.base_band + (K - 2 * m);
    const bool in_band = dband >= -p.bw && dband <= p.bw;
    // cells with m > K sit on packed diagonal D-1 (class b)
    const bool zc = (m > K) ? (w.y_b || (w.x_b && in_band))
                            : (w.y_a || (w.x_a && in_band));
    const bool C = valid && zc;
    // chunk-start cells: first processed column of their chunk
    const bool cst = (m == K) && qq >= 0 && w.cse_a;

    int32_t htl = (m == 0) ? nb_h : h2[m > 0 ? m - 1 : 0];
    int32_t e_in = (m == 0) ? nb_e : w.e[m > 0 ? m - 1 : 0];
    if (!SAFE16) {
      if (m == 0 || cst) htl = trunc16(htl);
      // E crosses the (int16) top strip at the word boundary; the
      // bottom row's boundary value is already in range
      if (m == 0 && !bottom) e_in = trunc16(e_in);
    }
    if (cst && r > P.rlen) htl = kMinusInf2;
    int32_t f_in = w.f[m];
    if (cst) {
      if (!SAFE16) f_in = trunc16(f_in);
      if (r >= P.rlen) f_in = kMinusInf2;
    }

    const int32_t qc = (w.qv >> (4 * m)) & 15;
    int32_t s = (qc == w.tc[m]) ? w.sm[m] : w.sx[m];
    if (qc == kNValue) s = -kNPenalty;
    const int32_t temp = htl + s;
    const int32_t h_new = imax(imax(temp, f_in), e_in);
    const int32_t tg = temp - p.goe;
    if (C) {
      w.f[m] = imax(tg, f_in - p.ge);
      w.e[m] = imax(tg, e_in - p.ge);
      h2[m] = h_new;
      dmax = imax(dmax, pack_hr(h_new, r));
    } else {
      w.f[m] = f_in;
      w.e[m] = e_in;
      h2[m] = h1[m];
    }
  }

  dmax = cx.warp_max(dmax);
  if (nwarp > 1) {
    Xchg* mine = &xs[(d & 1) * nwarp + warp];
    if (lane == 31) {
      mine->h = h1[kRows - 1];  // H as of d-1: the next step's h2
      mine->e = w.e[kRows - 1];
      mine->q = (int32_t)w.qv;
    }
    if (lane == 0) mine->dmax = dmax;
    cx.sync();
    dmax = xs[(d & 1) * nwarp].dmax;
    for (int i = 1; i < nwarp; ++i) dmax = imax(dmax, xs[(d & 1) * nwarp + i].dmax);
  }
  bk.check(p, P, d, dmax);
}

// Align one pair; out = [score, query_end, target_end, diagonals].
template <bool SAFE16, class Ctx>
AG_FN void align_pair(const Ctx& cx, const Params& p, int32_t qlen,
                      int32_t rlen, const uint8_t* trow,
                      const uint8_t* qrow, int32_t* out) {
  const int tid = cx.warp() * 32 + cx.lane();
  const int nwarp = cx.nwarp();
  const int32_t W = p.w;
  const bool windowed = W < p.wt;
  const int32_t sw = p.sw;

  Pair P;
  P.qlen = qlen;
  P.rlen = rlen;
  P.pql = (qlen + 7) >> 3;
  P.prl = (rlen + 7) >> 3;
  P.n_diags = qlen + rlen - 1;
  const int32_t tad = P.prl + P.pql - 1;
  P.i_end8 = (((tad + sw - 1) / sw) * sw) << 3;
  P.end_p = P.i_end8 + 8;

  Word w;
  w.enter(p, P, trow, kRows * tid);
  w.qv = 0;
  if (nwarp > 1) {
    // what the first step reads as "the previous step" (buffer 1)
    if (cx.lane() == 31) {
      Xchg& x = cx.xchg()[nwarp + cx.warp()];
      x.h = w.ha[kRows - 1];
      x.e = w.e[kRows - 1];
      x.q = 0;
    }
    cx.sync();
  }

  Book bk{0, 0, 0, 0, 0};
  int32_t vbase = 0, d8 = 0, i1 = 0, kph = 0;
  while (bk.term == 0 && d8 < P.end_p) {
    if (windowed && d8 % kShiftEvery == 0 &&
        (((d8 - p.bw) >> 1) - kGuard) - vbase >= kShiftQ &&
        vbase + kShiftQ <= p.wt - W) {
      // rows [vbase, vbase + 128) can never compute again: their
      // threads take the rows above the window's top
      if (w.r0 < vbase + kShiftQ) w.enter(p, P, trow, w.r0 + W);
      vbase += kShiftQ;
    }
    const int32_t D = d8 >> 3;
    const int32_t i2 = kph == 0 ? i1 - sw : i1;
    const int32_t pq_a = D - w.pr;
    const int32_t pq_b = pq_a - 1;
    int32_t ss1, se1, ss2, se2;
    P.slice_bounds(p, i1, ss1, se1);
    P.slice_bounds(p, i2, ss2, se2);
    // X: in slice + chunk; Y: also chunk-interior (band-exempt)
    w.x_a = w.pr >= ss1 && w.pr <= se1 && pq_a >= w.cs && pq_a <= w.ce;
    w.x_b = w.pr >= ss2 && w.pr <= se2 && pq_b >= w.cs && pq_b <= w.ce;
    w.y_a = w.x_a && pq_a > w.cs && pq_a < w.ce;
    w.y_b = w.x_b && pq_b > w.cs && pq_b < w.ce;
    w.cse_a = pq_a == imax(w.cs, i1 - w.pr);
    w.base_qq = d8 - w.r0;
    w.base_band = d8 - 2 * w.r0;
    if (kph == 0 && d8 < P.i_end8) {
      // an empty slice ends the job (agatha_kernel.h:189-191)
      int32_t ss, se;
      P.slice_bounds(p, D, ss, se);
      if (ss > se) break;
    }
    substep<0, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.ha, w.hb);
    substep<1, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.hb, w.ha);
    substep<2, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.ha, w.hb);
    substep<3, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.hb, w.ha);
    substep<4, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.ha, w.hb);
    substep<5, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.hb, w.ha);
    substep<6, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.ha, w.hb);
    substep<7, SAFE16>(cx, p, P, w, bk, d8, vbase, qrow, w.hb, w.ha);
    d8 += 8;
    if (++kph >= sw) {
      kph = 0;
      i1 += sw;
    }
  }
  if (tid == 0) {
    out[0] = bk.ms;
    out[1] = bk.mq;
    out[2] = bk.mr;
    out[3] = bk.diags;
  }
}

}  // namespace agatha
