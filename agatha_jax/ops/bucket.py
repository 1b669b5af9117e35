"""Bucket wire format and geometry shared by every DP route.

A bucket is ``(meta, tcodes, qfwd)``:

* ``meta``   (GB, 2) int32 — [qlen, rlen] per pair; padding pairs use
  qlen = rlen = 1.
* ``tcodes`` (GB, W/2) uint8 — target 4-bit codes, two per byte (low
  nibble first), W a multiple of ``WIDTH_UNIT``.
* ``qfwd``   (GB, QF/2) uint8 — query codes in the same packing.

Nibble packing is the wire analogue of the reference's packed layout
(pack_rc_seqs.h:13-53): it halves host->device traffic again vs int8.
"""

from __future__ import annotations

import numpy as np

from agatha_jax.config import AlignConfig

# Row and width grids.  They bound the number of distinct compiled
# bucket shapes; no device tiling depends on them.  Widths must stay
# multiples of SHIFT_Q so the sliding window parks exactly at the end of
# a long target.
ROW_UNIT = 8
WIDTH_UNIT = 128

# The sliding window advances by SHIFT_Q rows per shift; a shift
# opportunity occurs every SHIFT_EVERY base diagonals (demand is half a
# row per diagonal, so opportunities outpace demand 4x).
SHIFT_Q = 128
SHIFT_EVERY = 64
# Rows outside the plain band that can still host computed cells
# (chunk-interior band exemption + slice-clip slop, agatha_kernel.h:
# 183-186, 224-225: < 24 rows for sw <= 3) and the shift-policy guard
# (>= SLOP so a shift never overruns the lowest needed row).
SLOP = 24
GUARD = 32


def int16_safe(cfg: AlignConfig, max_len: int) -> bool:
    """True when no live DP value can leave int16 range.

    Then the reference's int16 strip round-trips are identities and a
    route may skip them.  Bounds (conservative):
      * positive: best score <= match * max_len, plus the (H<<16)|r
        packing already requires H < 2^15;
      * negative: live cells sit within z + band*ge of the running best
        (Z-drop fires at the next slice check otherwise), plus boundary
        strip inits (-(goe+ge*band) floored at MINUS_INF2) and at most
        one slice of further decay before the check runs.
    Requires Z-drop enabled; with z < 0 scores decay without bound and
    the reference's int16 wraparound is observable.
    """
    if cfg.z_threshold < 0:
        return False
    if cfg.match * max_len >= 32000:
        return False
    decay = (
        16384
        + cfg.z_threshold
        + (2 * cfg.band_width + 64) * cfg.gap_extend
        + 8 * cfg.slice_width * (cfg.mismatch + cfg.gap_oe + cfg.gap_extend)
        + 1024
    )
    return decay < 32768


def window_width(cfg: AlignConfig) -> int:
    """Row width of the sliding band window for this config.

    Margin budget on top of the band width bw, per shift period (the
    window is chosen once per SHIFT_EVERY base diagonals):
      * worst vbase at period start: the shift policy keeps
        vbase > (d-bw)/2 - GUARD - SHIFT_Q (else it would have
        shifted), and never above (d-bw)/2 - GUARD;
      * top row needed by period end (d grown by SHIFT_EVERY):
        (d + SHIFT_EVERY + 7 + bw)/2 + SLOP;
      * so W >= bw + SHIFT_EVERY/2 + 4 + SLOP + GUARD + SHIFT_Q
        = bw + 220 for the current constants;
      * post-shift query-window healing: a shift leaves SHIFT_Q stale
        rows at the top of the query window that move up one row per
        diagonal; no computed cell may read one before it falls off.
        That needs W > bw + SLOP + GUARD + SHIFT_Q + 36, i.e. STRICTLY
        more than bw + 220 — hence the need+1 below: when bw + 220 is
        an exact multiple of WIDTH_UNIT (bw = 804, 932, ...) plain
        rounding would add zero slack.
    Rounded up to WIDTH_UNIT: 1024 rows for the canonical bw=751.
    """
    need = cfg.band_width + SHIFT_EVERY // 2 + 4 + SLOP + GUARD + SHIFT_Q
    return -(-(need + 1) // WIDTH_UNIT) * WIDTH_UNIT


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """Host side of the nibble wire format; codes.shape[1] must be even."""
    c = codes.astype(np.uint8)
    return (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(p):
    """(GB, X/2) uint8, two 4-bit codes per byte -> (GB, X) int32."""
    import jax.numpy as jnp

    a = p.astype(jnp.int32)
    lo = a & 0xF
    hi = (a >> 4) & 0xF
    return jnp.stack([lo, hi], axis=-1).reshape(p.shape[0], -1)


def wire_width(a) -> int:
    """Code count per row of a nibble-packed bucket array."""
    return 2 * int(a.shape[1])


def build_bucket_arrays(
    pairs: list[tuple[np.ndarray, np.ndarray, int, int]],
    *,
    w: int | None = None,
    qf: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack (q_codes, t_codes, qlen, rlen) tuples into a bucket.

    Pads the pair count to a multiple of ROW_UNIT with dummy 1x1 pairs;
    the target and query widths default to the longest padded sequence
    rounded up to WIDTH_UNIT.  Returns the wire format (see module doc).
    """
    n = len(pairs)
    max_w = max((-(-rl // 8) * 8 for _q, _t, _ql, rl in pairs), default=8)
    max_q = max((-(-ql // 8) * 8 for _q, _t, ql, _rl in pairs), default=8)
    w = w or -(-max_w // WIDTH_UNIT) * WIDTH_UNIT
    qf = qf or -(-max_q // WIDTH_UNIT) * WIDTH_UNIT
    assert w >= max_w and qf >= max_q, (w, max_w, qf, max_q)
    gb = max(ROW_UNIT, -(-n // ROW_UNIT) * ROW_UNIT)
    meta = np.ones((gb, 2), np.int32)
    tcodes = np.zeros((gb, w), np.uint8)
    qfwd = np.zeros((gb, qf), np.uint8)
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        meta[p] = (ql, rl)
        tcodes[p, : len(tc)] = tc
        qfwd[p, : len(qc)] = qc
    return meta, pack_nibbles(tcodes), pack_nibbles(qfwd)
