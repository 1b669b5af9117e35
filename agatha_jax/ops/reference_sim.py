"""Bit-exact scalar oracle for the AGAThA guided alignment semantics.

This module is the *contract* the device DP routes are tested against.  It
reimplements, in plain Python integers, the exact observable semantics of
the reference aligner kernel (AGAThA/src/kernels/agatha_kernel.h:49-431)
at word/slice granularity — including behaviours that fall out of the
CUDA execution scheme and are visible in the results:

* extension-style affine DP where both gap states re-open from the
  diagonal score ``temp`` rather than from H (CORE_COMPUTE,
  agatha_kernel.h:20-31);
* banding applied per-cell only in the two *edge* words of each 8-row
  chunk; interior words compute all 64 cells unconditionally, so cells up
  to 7 beyond the band contribute (agatha_kernel.h:230-253, 32-46);
* slice-level row-block clipping with C-truncation division
  (agatha_kernel.h:183-186) and job termination when a slice clips empty
  (agatha_kernel.h:189-191);
* boundary strips initialised to ``-(gapOE + gapExt*l)`` inside the band
  and MINUS_INF2 = SHRT_MIN/2 outside (agatha_kernel.h:126-148);
* rows beyond ref_len inside the last packed word are computed from
  MINUS_INF2-reloaded registers each slice and pollute the antidiagonal
  maxima (agatha_kernel.h:206-216 load guard, no row guard in the core);
* per-antidiagonal maxima packed as ``(H<<16) | ref_idx`` (ties break
  toward larger ref index) reduced in a ring of 8*(slice_width+1)
  diagonals (agatha_kernel.h:29-30,151-153);
* minimap2-style Z-drop checked per base antidiagonal in order at slice
  boundaries, plus the final 8-diagonal wrap-up pass that lacks the
  diagonal-count guard (agatha_kernel.h:291-313, 336-356);
* int16 truncation of H/E/F values stored in the global strips (short2,
  gasal.h:147) — only observable when intermediate values exit int16
  range (e.g. Z-drop disabled).

It is deliberately slow (clarity over speed); use the vectorised sweep
(`agatha_jax.ops.sweep`) or the device DP (`agatha_jax.ops.dp`) for
real workloads.
"""

from __future__ import annotations

import numpy as np

from agatha_jax.config import AlignConfig, c_div_trunc
from agatha_jax.constants import INT32_MIN, MINUS_INF2, N_PENALTY, N_VALUE


def _trunc16(x: int) -> int:
    """int16 wraparound (storage into short2 strips, gasal.h:147)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _i32(x: int) -> int:
    """int32 wraparound (device register arithmetic)."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def align_one(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    qlen: int,
    rlen: int,
    cfg: AlignConfig,
) -> tuple[int, int, int]:
    """Align one pair; returns (score, query_end, target_end).

    ``q_codes``/``t_codes`` are 4-bit base codes padded to a multiple of
    8 (see packing.encode_padded); ``qlen``/``rlen`` are the true lengths.
    Results match the reference's device_res (agatha_kernel.h:359-363).
    """
    assert qlen >= 1 and rlen >= 1
    sw = cfg.slice_width
    bw = cfg.band_width
    z = cfg.z_threshold
    goe = cfg.gap_oe
    ge = cfg.gap_extend
    match, mism = cfg.match, cfg.mismatch
    total_shm = cfg.total_shm

    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    q = [int(v) for v in q_codes[: pql * 8]]
    t = [int(v) for v in t_codes[: prl * 8]]

    # --- strip initialisation (agatha_kernel.h:126-148) ---
    def _hd_init(l: int) -> tuple[int, int]:
        if l <= bw:
            k = _trunc16(-(goe + ge * l))
            return k, _trunc16(k - goe)
        return MINUS_INF2, MINUS_INF2

    top_h = [0] * (pql * 8)   # H of row above, per query column
    top_e = [0] * (pql * 8)   # E (vertical-gap state), per query column
    for l in range(pql * 8):
        top_h[l], top_e[l] = _hd_init(l)
    left_h = [0] * (prl * 8)  # H at last processed column, per ref row
    left_f = [0] * (prl * 8)  # F (horizontal-gap state), per ref row
    for l in range(prl * 8):
        left_h[l], left_f[l] = _hd_init(l)
    topleft = [0] * prl       # diagonal H corner per ref word (int32)
    for l in range(prl):
        if l == 0:
            topleft[l] = 0
        elif l * 8 - 1 <= bw:
            topleft[l] = -(goe + ge * (l * 8 - 1))
        else:
            topleft[l] = MINUS_INF2

    ring = [INT32_MIN] * total_shm  # per-antidiagonal packed maxima

    max_score = 0
    max_ref_idx = 0
    max_query_idx = 0
    terminated = False

    n_diags = qlen + rlen - 1  # base antidiagonal count
    tad = prl + pql - 1        # packed antidiagonal count

    def _sub(qb: int, rb: int) -> int:
        # DEV_GET_SUB_SCORE_GLOBAL with N_PENALTY (gasal_kernels.h:48-50)
        s = match if qb == rb else -mism
        if qb == N_VALUE or rb == N_VALUE:
            s = -N_PENALTY
        return s

    def _process_chunk(pr: int, i: int) -> None:
        """One row-block's slice chunk (agatha_kernel.h:195-284)."""
        ref_idx = pr * 8
        h = [0] * 9
        f = [0] * 9
        p = [0] * 9
        p[1] = topleft[pr]
        for m in range(1, 9):
            r = ref_idx + m - 1
            if r < rlen:
                h[m] = left_h[r]
                f[m] = left_f[r]
            else:
                h[m] = MINUS_INF2
                f[m] = MINUS_INF2
        for m in range(2, 9):
            p[m] = h[m - 1]
        chunk_start = max(0, ref_idx - bw) // 8
        chunk_end = min(pql - 1, (ref_idx + 7 + bw) // 8)

        pq = i - pr
        for _y in range(sw):
            if chunk_start <= pq <= chunk_end:
                boundary = pq == chunk_start or pq == chunk_end
                for qi in range(pq * 8, pq * 8 + 8):
                    if qi >= qlen:
                        break
                    qb = q[qi]
                    h[0] = top_h[qi]
                    e = top_e[qi]
                    for m in range(1, 9):
                        r = ref_idx + m - 1
                        if boundary and (qi + bw < r or qi - bw > r):
                            p[m] = h[m - 1]
                            continue
                        temp = _sub(qb, t[r]) + p[m]
                        h[m] = max(temp, f[m], e)
                        f[m] = max(temp - goe, f[m] - ge)
                        e = max(temp - goe, e - ge)
                        p[m] = h[m - 1]
                        d = (r + qi) % total_shm
                        ring[d] = max(ring[d], _i32((h[m] << 16) + r))
                    top_h[qi] = _trunc16(h[8])
                    top_e[qi] = _trunc16(e)
            pq += 1

        for m in range(1, 9):
            r = ref_idx + m - 1
            if r < rlen:
                left_h[r] = _trunc16(h[m])
                left_f[r] = _trunc16(f[m])
        topleft[pr] = p[1]

    def _check_diag(d: int, ring_slot: int) -> bool:
        """Score update + Z-drop for one base antidiagonal.

        Returns True when the termination condition fires
        (agatha_kernel.h:293-313).
        """
        nonlocal max_score, max_ref_idx, max_query_idx
        temp = ring[ring_slot]
        th = temp >> 16          # arithmetic shift: packed H
        tr = temp & 0xFFFF       # packed ref idx
        if th > max_score:
            max_score = th
            max_ref_idx = tr
            max_query_idx = d - tr
        elif tr >= max_ref_idx and (d - tr) >= max_query_idx:
            tl = tr - max_ref_idx
            ql = (d - tr) - max_query_idx
            gap = tl - ql if tl > ql else ql - tl
            if z >= 0 and max_score - th > z + gap * ge:
                return True
        return False

    i = 0
    while i < tad:
        # slice clipping (agatha_kernel.h:183-191)
        slice_start = max(0, i - pql + 1)
        slice_start = max(slice_start, c_div_trunc(8 * i + 8 - bw, 16))
        slice_end = min(prl - 1, i + sw - 1)
        slice_end = min(slice_end, c_div_trunc(8 * (i + sw - 1) + 7 + bw, 16))
        if slice_start > slice_end:
            terminated = True

        if not terminated:
            for pr in range(slice_start, slice_end + 1):
                _process_chunk(pr, i)

            # post-slice score update + Z-drop (agatha_kernel.h:291-313)
            for d in range(i * 8, (i + sw) * 8):
                if d < n_diags:
                    slot = d % total_shm
                    if _check_diag(d, slot):
                        terminated = True
                        break
                    ring[slot] = INT32_MIN

        if terminated:
            tad = i
        i += sw

        if i >= tad:
            # final wrap-up pass — note: no `d < n_diags` guard
            # (agatha_kernel.h:336-356)
            if not terminated:
                for o in range(8):
                    d = i * 8 + o
                    # (equal to the reference's diag_idx+o for the
                    # power-of-two ring sizes the reference requires)
                    slot = d % total_shm
                    if _check_diag(d, slot):
                        terminated = True
                        break
                    ring[slot] = INT32_MIN
            break

    return max_score, max_query_idx, max_ref_idx


def align_pairs(
    pairs: list[tuple[np.ndarray, np.ndarray, int, int]],
    cfg: AlignConfig,
) -> list[tuple[int, int, int]]:
    """Oracle over a list of (q_codes, t_codes, qlen, rlen) tuples."""
    return [align_one(qc, tc, ql, rl, cfg) for qc, tc, ql, rl in pairs]
