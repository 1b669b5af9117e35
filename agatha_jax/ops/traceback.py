"""Banded affine-gap traceback (CIGAR) — a capability the reference lacks.

The reference kernel outputs only score + end positions; its `cigar` /
`packed_tb_matrices` fields are allocated NULL and never computed
(gasal.h:91-92,142; res.cpp:27-28).  This module adds full alignment
paths: the engine's device DP finds (score, q_end, t_end), then the
banded region [0..t_end] x [0..q_end] is re-solved with direction
flags and walked back.

The recurrence matches the kernel's scoring exactly (CORE_COMPUTE,
agatha_kernel.h:20-31): affine gaps where BOTH gap states re-open from
the diagonal candidate ``temp = H[r-1][q-1] + s`` rather than from H.
Consequently a gap that "opens" at (r, q) forces the previous move to
be diagonal from (r-1, q-1) — the walk-back handles this explicitly.

Cell flags (uint8):
  bits 0-1: H source  (0 = diagonal/temp, 1 = E [gap along target],
            2 = F [gap along query])
  bit 2:    E opened from temp (else extended from E above)
  bit 3:    F opened from temp (else extended from F left)

CIGAR convention (SAM, query-centric): M = both consumed, D = target
consumed only, I = query consumed only.  Boundary columns/rows outside
the band score MINUS_INF2, mirroring the kernel's strip init
(agatha_kernel.h:126-148), so reported paths stay inside the band.
"""

from __future__ import annotations

import numpy as np

from agatha_jax.config import AlignConfig
from agatha_jax.constants import MINUS_INF2, N_PENALTY, N_VALUE

_NEG = -(10 ** 9)  # effectively -inf for path arithmetic (int64 safe)


def _origin_score(qb: int, tb: int, cfg: AlignConfig) -> int:
    """Substitution score of the single origin cell (0, 0).

    The kernel reports score 0 / ends (0, 0) both for a genuine
    zero-scoring origin and for its never-updated initial state; this
    is the one scoring rule both disambiguation sites share
    (`traceback_one`, `never_updated_indices`)."""
    if qb == N_VALUE or tb == N_VALUE:
        return -N_PENALTY
    return cfg.match if qb == tb else -cfg.mismatch


def _sub_scores(q_codes: np.ndarray, t_base: int,
                cfg: AlignConfig) -> np.ndarray:
    s = np.where(q_codes == t_base, cfg.match, -cfg.mismatch)
    n_mask = (q_codes == N_VALUE) | (t_base == N_VALUE)
    return np.where(n_mask, -N_PENALTY, s).astype(np.int64)


def traceback_one(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_end: int,
    t_end: int,
    cfg: AlignConfig,
    expected_score: int | None = None,
) -> tuple[str, int]:
    """Compute the CIGAR of the extension path ending at (q_end, t_end).

    Returns (cigar, path_score).  ``path_score`` is the plain affine
    score of the region and equals the kernel's reported score whenever
    the int16 strip round-trips were value-preserving (always true in
    the `int16_safe` regime) AND the end is in-band.  At band-exempt
    ends (|q_end - t_end| > band_width) the reference's boundary-block
    band test skips out-of-band cells while retaining their stale H
    (agatha_kernel.h:236-239), so the reported score can include
    stale-carry values no genuine affine path reproduces; the CIGAR is
    then the best genuine path to the reported end and ``path_score``
    may be lower (tests/test_traceback.py
    test_band_exempt_end_stale_carry).

    When ``expected_score`` is 0 and ends are (0, 0), the kernel result
    may be its never-updated initial state ("no positive-scoring
    extension", agatha_kernel.h:119-123 init); the empty CIGAR is
    returned in that case.
    """
    if expected_score == 0 and q_end == 0 and t_end == 0:
        if _origin_score(int(q_codes[0]), int(t_codes[0]), cfg) != 0:
            return "", 0

    # Region band: the kernel's band-exempt chunk-interior cells can
    # place the best end up to ~7 cells outside |q-r| <= bw
    # (reference_sim docstring), so the walk-back region must be wider
    # than the scoring band or the end position itself may fall outside
    # the stored flags.  Boundary inits still use the true bw.
    bw_region = max(cfg.band_width, abs(q_end - t_end)) + 16

    # Native paths.  With a known expected score the adaptive engine
    # (narrow skewed window widened until the score is reproduced) is
    # ~50-100x faster than the full-region DP on long reads; without
    # one, the legacy full-region engine mirrors this module exactly.
    from agatha_jax import native

    if expected_score is not None:
        nres = native.traceback_adaptive(
            q_codes, t_codes, q_end, t_end, cfg, expected_score
        )
        if nres is not None:
            return nres
    nres = native.traceback(
        q_codes, t_codes, q_end, t_end, cfg, bw_region
    )
    if nres is not None:
        return nres
    bw = cfg.band_width            # scoring band (boundary inits)
    bwr = bw_region                # walk-back region (see above)
    goe, ge = cfg.gap_oe, cfg.gap_extend

    nq = q_end + 1          # columns (query)
    nt = t_end + 1          # rows (target)

    # banded storage: row r holds columns [lo(r), hi(r)]
    width = min(2 * bwr + 1, nq)

    def lo(r):
        return max(0, r - bwr)

    def hi(r):
        return min(nq - 1, r + bwr)

    flags = np.zeros((nt, width), np.uint8)

    # H/E state of the previous row over its column window
    def init_top(cols):
        h = np.where(cols <= bw, -(goe + ge * cols), MINUS_INF2)
        e = np.where(cols <= bw, h - goe, MINUS_INF2)
        return h.astype(np.int64), e.astype(np.int64)

    # virtual row -1: top boundary (agatha_kernel.h:126-148)
    prev_cols = np.arange(lo(0), hi(0) + 1, dtype=np.int64)
    prev_h, prev_e = init_top(prev_cols)
    prev_lo = int(prev_cols[0])

    def window_copy(prev, j0, m, fill):
        """out[i] = prev[j0 + i] where in range, else fill."""
        out = np.full(m, fill, np.int64)
        src_s = max(0, j0)
        src_e = min(prev.size, j0 + m)
        if src_s < src_e:
            d = src_s - j0
            out[d : d + (src_e - src_s)] = prev[src_s:src_e]
        return out

    prev_temp = np.full(prev_h.shape, _NEG, np.int64)

    for r in range(nt):
        l, h_ = lo(r), hi(r)
        m = h_ - l + 1
        s = _sub_scores(q_codes[l : h_ + 1], int(t_codes[r]), cfg)

        # H(r-1, q-1)
        htl = window_copy(prev_h, l - 1 - prev_lo, m, MINUS_INF2)
        if l == 0:
            if r == 0:
                htl[0] = 0  # origin corner
            else:
                htl[0] = (
                    -(goe + ge * (r - 1)) if r - 1 <= bw else MINUS_INF2
                )
        temp = htl + s

        e_in = window_copy(prev_e, l - prev_lo, m, _NEG)
        if r == 0:
            # row 0 consumes the top-boundary E directly (the sweep
            # injects top_init_e at lane 0 each step)
            e_val = e_in
            e_from_open = np.zeros(m, bool)
        else:
            temp_up = window_copy(prev_temp, l - prev_lo, m, _NEG)
            e_open = temp_up - goe
            e_ext = e_in - ge
            e_val = np.maximum(e_open, e_ext)
            e_from_open = e_open >= e_ext

        # F along the row: f[i] = max(temp[i-1]-goe, f[i-1]-ge) is a
        # max-plus prefix scan; in (f + ge*i) space it is a running max.
        idx = np.arange(m, dtype=np.int64)
        if l == 0:
            f0 = (
                -(goe + ge * r) - goe if r <= bw else MINUS_INF2
            )  # left-boundary F, consumed directly at column 0
        else:
            f0 = _NEG
        a = temp - goe + ge * (idx + 1)      # candidate opened after col i
        run = np.empty(m, np.int64)
        run[0] = f0                          # f0 + ge*0
        if m > 1:
            run[1:] = np.maximum.accumulate(
                np.maximum(a[:-1], f0)
            )
        f_val = run - ge * idx
        f_from_open = np.zeros(m, bool)
        if m > 1:
            f_from_open[1:] = (temp[:-1] - goe) >= (f_val[:-1] - ge)

        h_row = np.maximum(temp, np.maximum(e_val, f_val))
        src = np.zeros(m, np.uint8)
        src = np.where(e_val > temp, 1, src).astype(np.uint8)
        src = np.where(
            f_val > np.maximum(temp, e_val), 2, src
        ).astype(np.uint8)
        flags[r, :m] = (
            src
            | (e_from_open.astype(np.uint8) << 2)
            | (f_from_open.astype(np.uint8) << 3)
        )

        prev_h, prev_e, prev_temp = h_row, e_val, temp
        prev_lo = l

    score = int(prev_h[q_end - lo(t_end)])

    # --- walk back ---
    ops: list[str] = []
    r, q = t_end, q_end
    state = "H"
    while r >= 0 and q >= 0:
        if not (lo(r) <= q <= hi(r)):
            raise AssertionError(
                f"traceback escaped the band at r={r} q={q}"
            )
        fl = int(flags[r, q - lo(r)])
        if state == "H":
            src = fl & 3
            if src == 0:
                ops.append("M")
                r -= 1
                q -= 1
            elif src == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            # E at (r, q): gap along target; came from row r-1
            ops.append("D")
            opened = bool(fl & 4)
            r -= 1
            if opened:
                # re-opened from temp(r-1, q): forced diagonal next
                ops.append("M")
                r -= 1
                q -= 1
                state = "H"
            # else stay in E at (r-1, q)
        else:  # F
            ops.append("I")
            opened = bool(fl & 8)
            q -= 1
            if opened:
                ops.append("M")
                r -= 1
                q -= 1
                state = "H"

    # leading unaligned boundary run (path entered row/col -1 territory)
    while q >= 0:
        ops.append("I")
        q -= 1
    while r >= 0:
        ops.append("D")
        r -= 1

    ops.reverse()
    # run-length encode
    out = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(f"{j - i}{ops[i]}")
        i = j
    return "".join(out), score


def never_updated_indices(
    encoded, scores, q_ends, t_ends, cfg: AlignConfig
) -> set[int]:
    """Pairs whose kernel result is the never-updated initial state.

    Score 0 at (0, 0) can either be a real alignment (origin cell
    scores 0) or the kernel's untouched init (agatha_kernel.h:119-123)
    when no positive-scoring extension exists; only the latter gets the
    empty CIGAR.  Vectorized pre-scan: only all-zero results qualify.
    """
    zeroish = np.flatnonzero(
        (np.asarray(scores) == 0)
        & (np.asarray(q_ends) == 0)
        & (np.asarray(t_ends) == 0)
    )
    out: set[int] = set()
    for i in zeroish:
        qc, tc, _ql, _rl = encoded[i]
        if _origin_score(int(qc[0]), int(tc[0]), cfg) != 0:
            out.add(int(i))
    return out


def traceback_all(
    encoded: list[tuple[np.ndarray, np.ndarray, int, int]],
    q_ends: np.ndarray,
    t_ends: np.ndarray,
    scores: np.ndarray,
    cfg: AlignConfig,
    n_threads: int = 0,
) -> list[str]:
    """Batch CIGAR traceback for a whole aligned batch.

    Uses the native threaded adaptive-band engine when available
    (native/traceback.cpp engine 2); falls back to per-pair
    `traceback_one`.  Pairs whose kernel result is the never-updated
    initial state (score 0 at (0,0) with a non-zero-scoring origin
    cell) get the empty CIGAR, as in `traceback_one`.
    """
    from agatha_jax import native

    n = len(encoded)
    if n == 0:
        return []
    cigars: list[str | None] = [None] * n
    skip = never_updated_indices(encoded, scores, q_ends, t_ends, cfg)
    for i in skip:
        cigars[i] = ""
    todo = [i for i in range(n) if i not in skip]
    if not todo:
        return cigars  # type: ignore[return-value]
    if not native.available():
        for i in todo:
            qc, tc, _ql, _rl = encoded[i]
            cigars[i] = traceback_one(
                qc, tc, int(q_ends[i]), int(t_ends[i]), cfg,
                expected_score=int(scores[i]),
            )[0]
        return cigars  # type: ignore[return-value]
    # Slab the native calls: the batch API allocates an (n, per_cap)
    # CIGAR buffer sized by the slab's longest pair, so bounded slabs
    # keep peak memory O(slab * max_len) instead of O(batch * max_len)
    # (~8 GB for 100k long reads otherwise).
    SLAB = 4096
    qe = np.asarray(q_ends)
    te = np.asarray(t_ends)
    sc = np.asarray(scores, np.int64)
    for s0 in range(0, len(todo), SLAB):
        slab = todo[s0:s0 + SLAB]
        nres = native.traceback_batch(
            [encoded[i] for i in slab],
            qe[slab], te[slab], sc[slab], cfg,
            n_threads=n_threads,
        )
        for k, i in enumerate(slab):
            cigars[i] = nres[k]
    return cigars  # type: ignore[return-value]


def cigar_to_pairs(cigar: str):
    """Expand a CIGAR into (query_consumed, target_consumed) totals."""
    import re

    q = t = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            q += n
            t += n
        elif op == "I":
            q += n
        else:
            t += n
    return q, t


def score_cigar(
    cigar: str,
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    cfg: AlignConfig,
) -> int:
    """Score an alignment path under the engine's scoring model."""
    import re

    goe, ge = cfg.gap_oe, cfg.gap_extend
    q = t = 0
    total = 0
    for n_, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n_)
        if op == "M":
            for _ in range(n):
                qb, tb = int(q_codes[q]), int(t_codes[t])
                if qb == N_VALUE or tb == N_VALUE:
                    total += -N_PENALTY
                elif qb == tb:
                    total += cfg.match
                else:
                    total += -cfg.mismatch
                q += 1
                t += 1
        else:
            total += -(goe + ge * (n - 1))
            if op == "I":
                q += n
            else:
                t += n
    return total
