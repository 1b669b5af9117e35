"""Cross-validation of the two independent oracle implementations.

`reference_sim.align_one` transliterates the reference's execution
semantics (slices / chunks / registers / strips); `sweep.align_one_sweep`
is the antidiagonal-sweep reformulation the device DP uses.  Agreement
across randomized inputs and parameter settings validates both the
semantics extraction and the sweep equivalence argument.
"""

import numpy as np
import pytest

from agatha_jax.config import AlignConfig
from agatha_jax.ops import packing
from agatha_jax.ops.reference_sim import align_one
from agatha_jax.ops.sweep import align_one_sweep
from tests.conftest import mutate, random_seq

CANONICAL = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                        slice_width=3, z_threshold=400, band_width=751)
DEFAULTS = AlignConfig()


def _pair(q: str, t: str):
    return (packing.encode_padded(q), packing.encode_padded(t),
            len(q), len(t))


def _both(q: str, t: str, cfg: AlignConfig):
    a = align_one(*_pair(q, t), cfg)
    b = align_one_sweep(*_pair(q, t), cfg)
    assert a == b, f"sim={a} sweep={b} q={q!r} t={t!r} cfg={cfg}"
    return a


def test_perfect_match():
    score, qe, te = _both("ACGT", "ACGT", DEFAULTS)
    assert (score, qe, te) == (8, 3, 3)


def test_perfect_match_long():
    s = "ACGTTGCA" * 4
    score, qe, te = _both(s, s, DEFAULTS)
    assert (score, qe, te) == (2 * len(s), len(s) - 1, len(s) - 1)


def test_single_mismatch_middle():
    q = "AAAAAAAAAA"
    t = "AAAAACAAAA"
    score, qe, te = _both(q, t, DEFAULTS)
    assert score == 2 * 9 - 4
    assert (qe, te) == (9, 9)


def test_single_deletion():
    q = "ACGTACGTACGT"
    t = "ACGTACTACGT"  # G deleted
    cfg = DEFAULTS
    score, qe, te = _both(q, t, cfg)
    # 11 matches, one length-1 gap: 22 - (4+2)
    assert score == 22 - cfg.gap_oe
    assert (qe, te) == (11, 10)


def test_all_n_scores_minus_one():
    score, qe, te = _both("NNNN", "NNNN", DEFAULTS)
    # N vs N scores -1; best score never exceeds the initial 0
    assert score == 0


def test_empty_band_gives_zero():
    # target much longer than query with tiny band: the band exits the
    # matrix and the job terminates via the empty-slice path
    q = "ACGT" * 2
    t = "ACGT" * 64
    _both(q, t, AlignConfig(band_width=4))


@pytest.mark.parametrize("bw", [0, 1, 3, 7, 8, 15, 17, 751])
def test_band_widths(rng, bw):
    cfg = AlignConfig(band_width=bw)
    for _ in range(5):
        n = int(rng.integers(1, 96))
        q = random_seq(rng, n)
        t = mutate(rng, q)
        _both(q, t, cfg)


@pytest.mark.parametrize("sw", [1, 3, 7])
def test_slice_widths(rng, sw):
    cfg = AlignConfig(slice_width=sw, band_width=17)
    for _ in range(5):
        q = random_seq(rng, int(rng.integers(1, 80)))
        t = mutate(rng, q)
        _both(q, t, cfg)


@pytest.mark.parametrize("z", [-1, 0, 10, 100, 400])
def test_zdrop_settings(rng, z):
    cfg = AlignConfig(z_threshold=z, band_width=31)
    for _ in range(5):
        q = random_seq(rng, int(rng.integers(8, 120)))
        t = mutate(rng, q, sub=0.3)
        _both(q, t, cfg)


def test_zdrop_unrelated_tails(rng):
    # homologous head + unrelated tail: exercises real Z-drop firing
    cfg = AlignConfig(z_threshold=20, band_width=31)
    for _ in range(8):
        head = random_seq(rng, 40)
        q = head + random_seq(rng, 60)
        t = mutate(rng, head, sub=0.05) + random_seq(rng, 60)
        _both(q, t, cfg)


def test_random_cross_validation(rng):
    for i in range(40):
        cfg = AlignConfig(
            match=int(rng.integers(1, 5)),
            mismatch=int(rng.integers(1, 6)),
            gap_open=int(rng.integers(0, 8)),
            gap_extend=int(rng.integers(1, 4)),
            slice_width=int(rng.choice([1, 3])),
            z_threshold=int(rng.choice([-1, 50, 400])),
            band_width=int(rng.choice([3, 9, 20, 751])),
        )
        nq = int(rng.integers(1, 130))
        q = random_seq(rng, nq, n_frac=0.05)
        if rng.random() < 0.5:
            t = mutate(rng, q)
        else:
            t = random_seq(rng, int(rng.integers(1, 130)), n_frac=0.05)
        _both(q, t, cfg)


def test_asymmetric_lengths(rng):
    cfg = AlignConfig(band_width=15)
    for nq, nt in [(1, 100), (100, 1), (9, 64), (64, 9), (8, 8), (7, 17)]:
        q = random_seq(rng, nq)
        t = random_seq(rng, nt)
        _both(q, t, cfg)


def test_canonical_config_homologous(rng):
    for _ in range(5):
        q = random_seq(rng, 300)
        t = mutate(rng, q)
        _both(q, t, CANONICAL)
