"""Short-read regime (band covers every diagonal) vs the oracle.

At the canonical band 751 every cell of a <= 752 bp pair is in band, so
slice and chunk clipping are active in the reference formulation yet
vacuous cell-wise.  One DP route serves these buckets and long reads
alike; these tests hold it to align_one_sweep — scores, end positions,
terminations — including fake-row pollution and the Z-drop wrap-up.
"""

import numpy as np
import pytest

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.cuda import state_width
from agatha_jax.engine import AlignEngine
from agatha_jax.ops.bucket import build_bucket_arrays, int16_safe
from agatha_jax.ops.dp import align_bucket
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

from .conftest import mutate, random_seq

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=751)
CONFIGS = [
    CANON,
    # tight z: forces terminations inside slices and at wrap-up
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3, z_threshold=20, band_width=751),
    # different scoring + slice width
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=5, z_threshold=150, band_width=911),
]


def _rand_pairs(rng, n=40, lo=8, hi=170):
    out = []
    for i in range(n):
        ql = int(rng.integers(lo, hi))
        q = random_seq(rng, ql, 0.03)
        if i % 3 == 0:
            t = random_seq(rng, int(rng.integers(lo, hi)), 0.03)
        else:
            t = mutate(rng, q)
        out.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return out


def _check_bucket(pairs, cfg):
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    out = np.asarray(align_bucket(meta, tcodes, qfwd, cfg))
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = tuple(int(v) for v in out[p, :3])
        assert got == tuple(exp), (p, got, tuple(exp), ql, rl)
    return out


@pytest.mark.parametrize("cfg", CONFIGS)
def test_short_reads_match_oracle(rng, cfg):
    assert int16_safe(cfg, max_len=512)
    _check_bucket(_rand_pairs(rng), cfg)


def test_short_read_bucket_shapes(rng):
    """150 bp reads: the engine packs them into 256-code rows on the
    row grid, and the CUDA kernel serves each pair with one warp."""
    pairs = []
    for _ in range(13):
        q = random_seq(rng, 150)
        t = mutate(rng, q)[:150]
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    (b,) = AlignEngine(CANON).make_buckets(pairs)
    assert b.meta.shape == (16, 2)
    assert b.tcodes.shape == (16, 128) and b.tcodes.dtype == np.uint8
    assert b.qfwd.shape == (16, 128) and b.qfwd.dtype == np.uint8
    assert (b.meta[13:] == 1).all()  # padding pairs are 1 x 1
    assert state_width(256, CANON) == 256


def test_short_reads_exact_at_band_edge(rng):
    """Pairs exactly at band == max(qlen-1, 8*prl-1) — where every cell
    is just in band — stay bit-exact."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=60, band_width=88)
    pairs = []
    for ql, rl in [(89, 88), (89, 81), (12, 88), (89, 10), (88, 88)]:
        for _ in range(4):
            q = random_seq(rng, ql, 0.02)
            t = (mutate(rng, q) + random_seq(rng, rl))[:rl]
            pairs.append((encode_padded(q), encode_padded(t), len(q),
                          len(t)))
    _check_bucket(pairs, cfg)


def test_midlength_matches_oracle(rng):
    """300-750 bp at the canonical band: slice and chunk clipping are
    active in the reference formulation (8*tad+8 > band), yet provably
    vacuous cell-wise."""
    pairs = []
    for n in [200, 299, 300, 450, 600, 601, 740, 752]:
        q = random_seq(rng, n, 0.02)
        t = mutate(rng, q)[:752]
        pairs.append((encode_padded(q), encode_padded(t), len(q),
                      len(t)))
    meta = np.array([[ql, rl] for _q, _t, ql, rl in pairs], np.int32)
    tad = -(-meta[:, 0] // 8) + -(-meta[:, 1] // 8) - 1
    assert (8 * tad.max() + 8) > CANON.band_width
    _check_bucket(pairs, CANON)


def test_midlength_tight_z(rng):
    """~600 bp pairs with a tight Z-drop threshold."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=100, band_width=751)
    pairs = []
    for n in [480, 600, 740]:
        q = random_seq(rng, n, 0.02)
        t = mutate(rng, q)[:752]
        pairs.append((encode_padded(q), encode_padded(t), len(q),
                      len(t)))
    _check_bucket(pairs, cfg)


def test_short_reads_bucket_matches_oracle(rng):
    """A 24-pair canonical bucket of 8-170 bp reads."""
    _check_bucket(_rand_pairs(rng, n=24), CANON)


def test_engine_short_reads_single_vs_mesh(rng):
    """Short-read buckets sharded over the 8-device mesh equal the
    single-device engine bit for bit, diags included."""
    pairs = _rand_pairs(rng, n=48)
    eng = AlignEngine(CANON, EngineConfig(aligns_per_batch=16))
    res = eng.align(pairs)
    assert res.routes == ["xla-sharded"] * 3
    one = AlignEngine(CANON, EngineConfig(aligns_per_batch=16,
                                          use_all_devices=False))
    off = one.align(pairs)
    assert off.routes == ["xla"] * 3
    assert (res.scores == off.scores).all()
    assert (res.query_ends == off.query_ends).all()
    assert (res.target_ends == off.target_ends).all()
    assert (res.diags == off.diags).all()


def test_engine_long_pair_beyond_band(rng):
    """A 900 bp pair (past full band coverage at band 751) through the
    same engine route."""
    q = random_seq(rng, 900)
    t = mutate(rng, q)
    enc = [(encode_padded(q), encode_padded(t), len(q), len(t))]
    res = AlignEngine(CANON).align(enc)
    exp = align_one_sweep(*enc[0], CANON)
    assert (int(res.scores[0]), int(res.query_ends[0]),
            int(res.target_ends[0])) == tuple(exp)


def test_short_reads_strip_path_matches_fast_path(rng):
    """Full-row parity, diags included, between the int16-safe fast
    path and the strip round-trip path at a tight Z-drop."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=25, band_width=751)
    pairs = _rand_pairs(rng, n=16, lo=8, hi=150)
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    fast = np.asarray(align_bucket(meta, tcodes, qfwd, cfg))
    slow = np.asarray(align_bucket(meta, tcodes, qfwd, cfg,
                                   force_strips=True))
    assert (fast == slow).all(), np.argwhere((fast != slow).any(axis=1))
