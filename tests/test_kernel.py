"""Bucket DP vs the cross-validated sweep oracle (bit-exact).

Runs the plain-JAX DP route on the CPU backend.  The CUDA kernel is
held to the same results by tests/test_cuda.py (host emulation of its
body) and on the card by chip_smoke.py.
"""

import numpy as np
import pytest

from agatha_jax.config import AlignConfig
from agatha_jax.ops.bucket import build_bucket_arrays
from agatha_jax.ops.dp import align_bucket
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

from .conftest import mutate, random_seq

CANON = AlignConfig(
    match=1, mismatch=4, gap_open=6, gap_extend=2,
    slice_width=3, z_threshold=400, band_width=751,
)


def _run_and_compare(pairs, cfg):
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    out = np.asarray(align_bucket(meta, tcodes, qfwd, cfg))
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = tuple(int(v) for v in out[p, :3])
        assert got == tuple(exp), f"pair {p} (ql={ql}, rl={rl})"


def _random_pairs(rng, n, lo=1, hi=260, n_frac=0.02):
    pairs = []
    for i in range(n):
        ql = int(rng.integers(lo, hi))
        q = random_seq(rng, ql, n_frac)
        if i % 2 == 0:
            t = mutate(rng, q)
        else:
            t = random_seq(rng, int(rng.integers(lo, hi)), n_frac)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return pairs


@pytest.mark.parametrize(
    "cfg",
    [
        CANON,
        AlignConfig(),  # reference CLI defaults
        AlignConfig(band_width=10, z_threshold=20, slice_width=2),
        AlignConfig(z_threshold=-1, band_width=50, slice_width=1),
        AlignConfig(band_width=0),
        AlignConfig(z_threshold=0),
        AlignConfig(slice_width=5, band_width=17, z_threshold=37),
        # small bands against moderate lengths hit the clip geometry of
        # the canonical band against 10 kb reads
        AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=31),
        AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=20, band_width=101),
        AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                    slice_width=5, z_threshold=150, band_width=55),
        AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=1, z_threshold=100, band_width=63),
        AlignConfig(match=3, mismatch=5, gap_open=4, gap_extend=2,
                    slice_width=4, z_threshold=800, band_width=127),
    ],
)
def test_kernel_matches_oracle(rng, cfg):
    _run_and_compare(_random_pairs(rng, 16), cfg)


def test_kernel_tiny_and_edge_lengths(rng):
    pairs = []
    for ql, rl in [(1, 1), (1, 200), (200, 1), (8, 8), (7, 9), (64, 63)]:
        q = random_seq(rng, ql)
        t = random_seq(rng, rl)
        pairs.append((encode_padded(q), encode_padded(t), ql, rl))
    _run_and_compare(pairs, CANON)
    _run_and_compare(pairs, AlignConfig(band_width=3, z_threshold=5))


def test_kernel_multi_program(rng):
    """More pairs than the row grid unit: several row groups."""
    _run_and_compare(_random_pairs(rng, 24, lo=1, hi=140), CANON)


@pytest.mark.parametrize("lo,hi", [(100, 160), (40, 500)])
def test_kernel_length_spread(rng, lo, hi):
    """Narrow and wide length spreads within one bucket."""
    _run_and_compare(_random_pairs(rng, 24, lo=lo, hi=hi), CANON)


@pytest.mark.parametrize("cfg", [
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3, z_threshold=400, band_width=31),
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=2, z_threshold=60, band_width=15),
    CANON,
])
def test_kernel_adversarial_shapes(rng, cfg):
    """Extreme aspect ratios (rlen >> qlen + band and the converse),
    empty-slice terminations and single-base edges."""
    pairs = []
    for ql, rl in [(8, 400), (400, 8), (16, 391), (391, 16), (1, 200),
                   (200, 1), (9, 9), (64, 257), (257, 64), (120, 120),
                   (33, 300), (300, 33)]:
        q = random_seq(rng, ql, 0.05)
        t = random_seq(rng, rl, 0.05)
        pairs.append((encode_padded(q), encode_padded(t), ql, rl))
    _run_and_compare(pairs, cfg)


def test_kernel_hits_empty_slice(rng):
    """A target far longer than query + band ends at an empty slice:
    the sweep stops there, and the diagonal count says so."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=15)
    q = random_seq(rng, 16)
    t = random_seq(rng, 600)
    pairs = [(encode_padded(q), encode_padded(t), 16, 600)]
    _run_and_compare(pairs, cfg)
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    diags = int(np.asarray(align_bucket(meta, tcodes, qfwd, cfg))[0, 3])
    assert 0 < diags < 16 + 600 - 1


def test_kernel_n_codes(rng):
    """N-heavy homologous pairs: N scores -N_PENALTY on either side."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=63)
    pairs = []
    for n in (180, 90):
        q = random_seq(rng, n, 0.2)
        t = mutate(rng, q)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    _run_and_compare(pairs, cfg)


def test_kernel_identical_sequences(rng):
    pairs = []
    for n in [30, 100, 129, 256]:
        q = random_seq(rng, n)
        pairs.append((encode_padded(q), encode_padded(q), n, n))
    _run_and_compare(pairs, CANON)


def test_kernel_all_n_sequences(rng):
    q = "N" * 50
    t = random_seq(rng, 60)
    pairs = [(encode_padded(q), encode_padded(t), 50, 60)]
    _run_and_compare(pairs, CANON)


def test_safe16_fast_path_matches_strip_path(rng):
    """int16-safe fast path must equal the full strip-roundtrip path."""
    from agatha_jax.ops.bucket import int16_safe

    assert int16_safe(CANON, max_len=4096)
    assert not int16_safe(
        AlignConfig(z_threshold=-1), max_len=4096
    )
    pairs = _random_pairs(rng, 16, hi=300)
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    fast = np.asarray(align_bucket(meta, tcodes, qfwd, CANON))
    slow = np.asarray(
        align_bucket(meta, tcodes, qfwd, CANON, force_strips=True)
    )
    assert (fast == slow).all()


def test_kernel_padding_pairs_ignored(rng):
    """GB padding with dummy pairs must not corrupt real outputs."""
    pairs = _random_pairs(rng, 3)
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    # padded to the row grid
    assert meta.shape[0] >= 8 and meta.shape[0] % 8 == 0
    out = np.asarray(align_bucket(meta, tcodes, qfwd, CANON))
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, CANON)
        assert tuple(int(v) for v in out[p, :3]) == tuple(exp)


def test_align_bucket_gb_contract(rng):
    """Any GB that is a multiple of 8 is accepted (the row count is
    free; the engine only rounds it to bound compile shapes)."""
    pairs = _random_pairs(rng, 5)  # pads to the row grid
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    # rebuild with a hand-chosen GB=40 (not a power of two)
    gb = 40
    m = np.ones((gb, 2), np.int32)
    tc = np.zeros((gb, tcodes.shape[1]), tcodes.dtype)
    qf = np.zeros((gb, qfwd.shape[1]), qfwd.dtype)
    m[: meta.shape[0] if meta.shape[0] < gb else gb] = meta[:gb]
    tc[: tcodes.shape[0] if tcodes.shape[0] < gb else gb] = tcodes[:gb]
    qf[: qfwd.shape[0] if qfwd.shape[0] < gb else gb] = qfwd[:gb]
    out = np.asarray(align_bucket(m, tc, qf, CANON))
    assert out.shape == (gb, 4)
    for p, (qc, tcc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tcc, ql, rl, CANON)
        assert tuple(int(v) for v in out[p, :3]) == tuple(exp)
