"""Vectorised antidiagonal-sweep formulation of the AGAThA semantics.

This is the mathematical core of the device DP: instead of the
reference's subwarp/slice/chunk execution scheme (agatha_kernel.h), the
DP is swept one *base* antidiagonal at a time with all state held in
row-indexed vectors.  Each step is pure elementwise work plus one-row
shifts.  The plain-JAX DP (`agatha_jax.ops.dp`) and the CUDA kernel
(`agatha_jax/cuda/dp.cuh`) are this sweep with a moving band window;
this NumPy version keeps full-length rows for clarity and serves as the
second, structurally-independent oracle cross-checked against
`reference_sim`.

Equivalence argument (summary; see reference_sim's docstring for the
semantics being reproduced):

* The DP recurrence is order-independent given the per-cell *computed*
  predicate, which is a pure function of (r, q, lens, band, slice_width)
  — word-level slice/chunk clipping plus the per-cell band test applied
  only in chunk-edge words (agatha_kernel.h:183-186,224-225,230-253).
* Values flowing through not-computed cells freeze, which reproduces the
  reference's strip-mediated staleness.
* Rows beyond ref_len reload MINUS_INF2 registers at each chunk start
  (agatha_kernel.h:206-216); reproduced by resetting the frozen H / F of
  rows >= ref_len at chunk-start columns.
* int16 strip storage (short2) is reproduced by truncating E and the
  diagonal-H input at block-row crossings (r % 8 == 0, the top strip,
  agatha_kernel.h:239-241,255-258) and F / diagonal-H at chunk-start
  columns (the left strip, agatha_kernel.h:204-217,271-281).
* Per-antidiagonal maxima are complete at the end of their sweep step,
  so the slice-boundary Z-drop schedule (agatha_kernel.h:291-313) is
  equivalent to checking each diagonal right after its step, in order,
  stopping everything at termination.  The final wrap-up pass checks 8
  more diagonals without the diagonal-count guard
  (agatha_kernel.h:336-356).
"""

from __future__ import annotations

import numpy as np

from agatha_jax.config import AlignConfig
from agatha_jax.constants import INT32_MIN, MINUS_INF2, N_PENALTY, N_VALUE

_I64 = np.int64


def _trunc16(x: np.ndarray) -> np.ndarray:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _i32(x: np.ndarray) -> np.ndarray:
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _ctrunc16(a: np.ndarray | int) -> np.ndarray | int:
    """C-style truncation of a/16 (a may be negative)."""
    a = np.asarray(a, dtype=_I64)
    return np.where(a >= 0, a // 16, -((-a) // 16))


def align_one_sweep(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    qlen: int,
    rlen: int,
    cfg: AlignConfig,
) -> tuple[int, int, int]:
    """Antidiagonal-sweep alignment of one pair; matches align_one."""
    sw = cfg.slice_width
    bw = cfg.band_width
    z = cfg.z_threshold
    goe = cfg.gap_oe
    ge = cfg.gap_extend
    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    R8 = prl * 8

    t = np.asarray(t_codes[:R8], dtype=_I64)
    q = np.asarray(q_codes[: pql * 8], dtype=_I64)

    r_idx = np.arange(R8, dtype=_I64)
    pr = r_idx >> 3
    # chunk bounds per row-block (agatha_kernel.h:224-225)
    cs = np.maximum(0, 8 * pr - bw) // 8
    ce = np.minimum(pql - 1, (8 * pr + 7 + bw) // 8)

    def hd_init(l: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        k = _trunc16(-(goe + ge * l))
        h = np.where(l <= bw, k, MINUS_INF2)
        e = np.where(l <= bw, _trunc16(k - goe), MINUS_INF2)
        return h, e

    # left-strip inits become the initial frozen H / F states
    left_h0, left_f0 = hd_init(r_idx)
    hf1 = left_h0.copy()   # frozen H as of step d-1
    hf2 = left_h0.copy()   # frozen H as of step d-2
    fst = left_f0.copy()   # F input state
    est = np.full(R8, MINUS_INF2, dtype=_I64)  # E input state

    blk_first = (r_idx & 7) == 0  # rows that read the (int16) top strip
    fake = r_idx >= rlen          # rows beyond ref_len in the last word

    n_diags = qlen + rlen - 1
    tad = prl + pql - 1
    i_end = -(-tad // sw) * sw

    max_score = 0
    max_ref_idx = 0
    max_query_idx = 0
    terminated = False

    def computed_mask(d: int) -> np.ndarray:
        qq = d - r_idx
        valid = (qq >= 0) & (qq < qlen)
        pq = qq >> 3
        dp = pr + pq
        i = (dp // sw) * sw
        ss = np.maximum(
            np.maximum(0, i - pql + 1), _ctrunc16(8 * i + 8 - bw)
        )
        se = np.minimum(
            np.minimum(prl - 1, i + sw - 1),
            _ctrunc16(8 * (i + sw - 1) + 7 + bw),
        )
        in_slice = (pr >= ss) & (pr <= se)
        in_chunk = (pq >= cs) & (pq <= ce)
        interior = (pq > cs) & (pq < ce)
        in_band = np.abs(qq - r_idx) <= bw
        return valid & in_slice & in_chunk & (interior | in_band)

    def chunk_start_mask(d: int) -> np.ndarray:
        """Cells sitting at the first processed column of their chunk."""
        qq = d - r_idx
        ok = (qq >= 0) & ((qq & 7) == 0)
        pq = qq >> 3
        i = ((pr + pq) // sw) * sw
        return ok & (pq == np.maximum(cs, i - pr))

    def sub_score(d: int) -> np.ndarray:
        qq = d - r_idx
        qi = np.clip(qq, 0, q.size - 1)
        qb = q[qi]
        rb = t
        s = np.where(qb == rb, cfg.match, -cfg.mismatch)
        return np.where((qb == N_VALUE) | (rb == N_VALUE), -N_PENALTY, s)

    def top_init_h(col: int) -> int:
        if col < 0:
            return 0  # topleft[0] init: origin corner (agatha_kernel.h:146)
        if col <= bw:
            return int(_trunc16(np.asarray(-(goe + ge * col))))
        return MINUS_INF2

    def top_init_e(col: int) -> int:
        if col <= bw:
            k = int(_trunc16(np.asarray(-(goe + ge * col))))
            return int(_trunc16(np.asarray(k - goe)))
        return MINUS_INF2

    def step(d: int) -> int:
        """Compute base antidiagonal d; returns packed diagonal max."""
        nonlocal hf1, hf2, fst, est
        C = computed_mask(d)
        cstart = chunk_start_mask(d)

        # diagonal-H input: H(r-1, q-1) with strip truncations/resets
        htl = np.empty(R8, dtype=_I64)
        htl[1:] = hf2[:-1]
        htl[0] = top_init_h(d - 1)
        htl = np.where(blk_first, _trunc16(htl), htl)          # top strip
        htl = np.where(cstart & ~blk_first, _trunc16(htl), htl)  # left strip
        prev_fake = np.zeros(R8, dtype=bool)
        prev_fake[1:] = fake[:-1]
        htl = np.where(cstart & prev_fake, MINUS_INF2, htl)    # fake reload

        # E input: flows down rows; truncated through the top strip
        e_in = est
        e_in = np.where(blk_first, _trunc16(e_in), e_in)
        e_in[0] = top_init_e(d)  # est[0] is injected fresh each step anyway

        # F input: flows along rows; truncated/reset at chunk reload
        f_in = np.where(cstart, _trunc16(fst), fst)
        f_in = np.where(cstart & fake, MINUS_INF2, f_in)

        s = sub_score(d)
        temp = htl + s
        h_new = np.maximum(np.maximum(temp, f_in), e_in)

        f_next = np.where(C, np.maximum(temp - goe, f_in - ge), f_in)
        e_next_src = np.where(C, np.maximum(temp - goe, e_in - ge), e_in)

        hf2 = hf1
        hf1 = np.where(C, h_new, hf1)
        fst = f_next
        est = np.empty(R8, dtype=_I64)
        est[1:] = e_next_src[:-1]
        est[0] = top_init_e(d + 1)

        packed = _i32((h_new << 16) + r_idx)
        packed = np.where(C, packed, INT32_MIN)
        return int(packed.max()) if R8 else INT32_MIN

    def check_diag(d: int, diag_max: int) -> bool:
        nonlocal max_score, max_ref_idx, max_query_idx
        th = diag_max >> 16
        tr = diag_max & 0xFFFF
        if th > max_score:
            max_score = th
            max_ref_idx = tr
            max_query_idx = d - tr
        elif tr >= max_ref_idx and (d - tr) >= max_query_idx:
            tl = tr - max_ref_idx
            ql = (d - tr) - max_query_idx
            gap = abs(tl - ql)
            if z >= 0 and max_score - th > z + gap * ge:
                return True
        return False

    for islice in range(0, i_end, sw):
        ss = max(0, islice - pql + 1,
                 int(_ctrunc16(8 * islice + 8 - bw)))
        se = min(prl - 1, islice + sw - 1,
                 int(_ctrunc16(8 * (islice + sw - 1) + 7 + bw)))
        if ss > se:  # empty slice terminates the job (agatha_kernel.h:189)
            terminated = True
            break
        for d in range(8 * islice, 8 * (islice + sw)):
            dmax = step(d)
            if d < n_diags:
                if check_diag(d, dmax):
                    terminated = True
                    break
        if terminated:
            break

    if not terminated:
        # wrap-up: 8 diagonals past the last slice, unguarded
        for d in range(8 * i_end, 8 * i_end + 8):
            dmax = step(d)
            if check_diag(d, dmax):
                break

    return max_score, max_query_idx, max_ref_idx
