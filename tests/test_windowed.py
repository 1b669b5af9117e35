"""Sliding band window vs oracle (small band => the window activates at
modest lengths so the CPU run stays fast)."""

import numpy as np
import pytest

from agatha_jax.config import AlignConfig
from agatha_jax.ops.bucket import build_bucket_arrays, window_width
from agatha_jax.ops.dp import align_bucket
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

from .conftest import mutate, random_seq


def _check(pairs, cfg):
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    w = 2 * tcodes.shape[1]  # nibble-packed wire format
    assert w > window_width(cfg), "test must exercise the windowed path"
    out = np.asarray(align_bucket(meta, tcodes, qfwd, cfg))
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = tuple(int(v) for v in out[p, :3])
        assert got == tuple(exp), f"pair {p} ql={ql} rl={rl}"


@pytest.mark.parametrize("cfg", [
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                band_width=60, z_threshold=200),
    AlignConfig(band_width=40, z_threshold=100, slice_width=2),
    AlignConfig(band_width=25, z_threshold=-1, slice_width=1),
    # band_width + 220 an exact multiple of 128: the window margin's
    # strict inequality (W > bw + 220) gets zero slack from rounding
    # here, so window_width must bump W one width unit (query-window
    # healing)
    AlignConfig(band_width=36, z_threshold=150),
])
def test_windowed_matches_oracle(rng, cfg):
    pairs = []
    for i in range(8):
        n = 650 + 40 * i
        q = random_seq(rng, n, 0.01)
        t = mutate(rng, q) if i % 2 == 0 else random_seq(rng, n + 30, 0.01)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    _check(pairs, cfg)


def test_window_width_strict_margin():
    """W must exceed bw + 220 strictly (post-shift query-window
    healing)."""
    for bw in (36, 164, 751, 804, 932):
        cfg = AlignConfig(band_width=bw)
        assert window_width(cfg) > bw + 220, bw


def test_windowed_asymmetric_lengths(rng):
    """Short query vs long target and vice versa (window parks/clips)."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=50, z_threshold=-1)
    pairs = []
    for ql, rl in [(100, 900), (900, 100), (700, 700), (1, 800)]:
        q = random_seq(rng, ql)
        t = random_seq(rng, rl)
        pairs.append((encode_padded(q), encode_padded(t), ql, rl))
    _check(pairs, cfg)


def test_windowed_mixed_bucket_with_short_pairs(rng):
    """Window policy is global per bucket; short pairs must not break."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=60, z_threshold=300)
    pairs = []
    for n in [20, 100, 400, 800, 850, 900, 950, 1000]:
        q = random_seq(rng, n)
        pairs.append((encode_padded(q), encode_padded(q), n, n))
    _check(pairs, cfg)
