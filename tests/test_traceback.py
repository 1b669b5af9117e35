"""CIGAR traceback: path validity, score equality, engine integration."""

import numpy as np
import pytest

from agatha_jax.config import AlignConfig
from agatha_jax.engine import AlignEngine
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep
from agatha_jax.ops.traceback import (
    cigar_to_pairs,
    score_cigar,
    traceback_one,
)

from .conftest import mutate, random_seq

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)


def _check_pair(q, t, cfg):
    qc = encode_padded(q)
    tc = encode_padded(t)
    score, q_end, t_end = align_one_sweep(qc, tc, len(q), len(t), cfg)
    cigar, tb_score = traceback_one(
        qc, tc, q_end, t_end, cfg, expected_score=score
    )
    if cigar == "":
        assert score == 0
        return cigar
    # the path must consume exactly [0..q_end] x [0..t_end]
    qc_n, tc_n = cigar_to_pairs(cigar)
    assert qc_n == q_end + 1, (cigar, q_end)
    assert tc_n == t_end + 1, (cigar, t_end)
    # the path's score must equal the DP score
    assert tb_score == score, (cigar, tb_score, score)
    assert score_cigar(cigar, qc, tc, cfg) == score
    return cigar


def test_identity_alignment(rng):
    q = random_seq(rng, 80)
    cigar = _check_pair(q, q, CFG)
    assert cigar == "80M"


def test_single_substitution(rng):
    q = random_seq(rng, 60)
    t = q[:30] + ("A" if q[30] != "A" else "C") + q[31:]
    cigar = _check_pair(q, t, CFG)
    assert cigar == "60M"


def test_insertion_and_deletion(rng):
    q = random_seq(rng, 60)
    t = q[:20] + q[25:]  # 5-base deletion from target
    _check_pair(q, t, CFG)
    t2 = q[:20] + "ACGTA" + q[20:]
    _check_pair(q, t2, CFG)


@pytest.mark.parametrize("cfg", [
    CFG,
    AlignConfig(),
    AlignConfig(band_width=10, z_threshold=50),
])
def test_random_pairs_path_valid(rng, cfg):
    for i in range(20):
        ql = int(rng.integers(1, 150))
        q = random_seq(rng, ql, 0.02)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(1, 150)), 0.02
        )
        _check_pair(q, t, cfg)


def test_end_position_outside_band(rng):
    """Band-exempt chunk-interior cells can report end positions up to
    ~7 cells outside |q - r| <= bw; the walk-back region must cover
    them (regression: this used to IndexError / return -2)."""
    cfg = AlignConfig(match=2, mismatch=3, gap_open=2, gap_extend=1,
                      band_width=1)
    found = False
    for _ in range(200):
        ql = int(rng.integers(8, 24))
        rl = int(rng.integers(8, 24))
        q = random_seq(rng, ql)
        t = random_seq(rng, rl)
        qc = encode_padded(q)
        tc = encode_padded(t)
        score, q_end, t_end = align_one_sweep(qc, tc, ql, rl, cfg)
        cigar, tb_score = traceback_one(
            qc, tc, q_end, t_end, cfg, expected_score=score
        )
        if cigar == "":
            continue
        qc_n, tc_n = cigar_to_pairs(cigar)
        assert qc_n == q_end + 1 and tc_n == t_end + 1
        if abs(q_end - t_end) > cfg.band_width:
            found = True
    assert found, "no out-of-band end case generated; widen the search"


def test_band_exempt_end_stale_carry():
    """At a band-exempt end (|q_end - t_end| > bw) the kernel-reported
    score can include stale-carry values: the reference's boundary-
    block band test skips out-of-band cells but keeps their stale H in
    the register (agatha_kernel.h:236-239 `continue`), so leaked
    values feed later diagonals.  Pinned counterexample: a clean
    full-rectangle affine DP (every cell computed, same boundary
    inits) proves no genuine path reaches the reported score — the
    traceback must return the best genuine path WITHOUT warning."""
    import warnings

    from agatha_jax.constants import MINUS_INF2, N_PENALTY, N_VALUE

    cfg = AlignConfig(match=2, mismatch=3, gap_open=2, gap_extend=1,
                      band_width=1)
    q = "TTCCCACGCTGGGTCGGTGG"
    t = "GACCGCGCCGCAGTGGGTC"
    qc, tc = encode_padded(q), encode_padded(t)
    score, q_end, t_end = align_one_sweep(qc, tc, len(q), len(t), cfg)
    assert (score, q_end, t_end) == (2, 15, 9)
    assert abs(q_end - t_end) > cfg.band_width  # band-exempt end

    # clean full-rectangle DP with the reference recurrence
    # (E/F re-open from the diagonal candidate) and boundary inits
    goe, ge, bw = cfg.gap_oe, cfg.gap_extend, cfg.band_width
    NEG = -(10 ** 9)
    ql, rl = len(q), len(t)
    H = np.full((rl + 1, ql + 1), NEG, np.int64)
    E = np.full((rl + 1, ql + 1), NEG, np.int64)
    F = np.full((rl + 1, ql + 1), NEG, np.int64)
    H[0, 0] = 0
    for l in range(max(ql, rl)):
        h = -(goe + ge * l) if l <= bw else MINUS_INF2
        if l < ql:
            H[0, l + 1] = h
            E[0, l + 1] = h - goe if l <= bw else MINUS_INF2
        if l < rl:
            H[l + 1, 0] = h
            F[l + 1, 0] = h - goe if l <= bw else MINUS_INF2
    for r in range(rl):
        for c in range(ql):
            qb, tb = int(qc[c]), int(tc[r])
            s = (-N_PENALTY if N_VALUE in (qb, tb)
                 else (cfg.match if qb == tb else -cfg.mismatch))
            temp = H[r][c] + s
            ev = max(temp - goe, E[r][c + 1] - ge)
            fv = max(temp - goe, F[r + 1][c] - ge)
            H[r + 1][c + 1] = max(temp, ev, fv)
            E[r + 1][c + 1] = ev
            F[r + 1][c + 1] = fv
    genuine_best = int(H[t_end + 1][q_end + 1])
    assert genuine_best < score  # the reported 2 is leak-borne

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning fails the test
        cigar, tb_score = traceback_one(
            qc, tc, q_end, t_end, cfg, expected_score=score
        )
    assert cigar != ""
    qc_n, tc_n = cigar_to_pairs(cigar)
    assert qc_n == q_end + 1 and tc_n == t_end + 1
    assert tb_score < score  # best genuine path, honestly reported


def test_native_traceback_matches_python(rng):
    """The C++ traceback must equal the NumPy reference exactly.

    The gap_open=0 config covers the band's left-edge F-open flag:
    with gap_oe == gap_extend the C++ engine's sentinel compare used
    to set f_from_open at i==0 where the Python reference hardcodes
    False (fixed round 5)."""
    import agatha_jax.native as nv

    if not nv.available():
        pytest.skip("native library unavailable")
    zero_open = AlignConfig(match=1, mismatch=4, gap_open=0,
                            gap_extend=2, z_threshold=400,
                            band_width=31)
    for i in range(20):
        ql = int(rng.integers(1, 250))
        q = random_seq(rng, ql, 0.03)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(1, 250)), 0.03
        )
        qc = encode_padded(q)
        tc = encode_padded(t)
        qe, te = len(q) - 1, len(t) - 1
        for cfg in (CFG, zero_open):
            nat = nv.traceback(qc, tc, qe, te, cfg)
            saved_lib, saved_tried = nv._lib, nv._tried
            try:
                nv._lib, nv._tried = None, True
                py = traceback_one(qc, tc, qe, te, cfg)
            finally:
                nv._lib, nv._tried = saved_lib, saved_tried
            assert nat == py, (i, cfg.gap_open)


def test_adaptive_matches_expected_score(rng):
    """The adaptive engine must reproduce the known DP score exactly,
    including pairs whose path wanders far off the end-point line
    (forcing the window to widen and retry)."""
    import agatha_jax.native as nv

    if not nv.available():
        pytest.skip("native library unavailable")
    for i in range(12):
        ql = int(rng.integers(40, 400))
        q = random_seq(rng, ql, 0.02)
        if i % 3 == 0:
            # big structural indel: path deviates from the skew line
            t = q[: ql // 4] + q[3 * ql // 4:]
        else:
            t = mutate(rng, q, sub=0.15, ins=0.1, dele=0.1)
        qc = encode_padded(q)
        tc = encode_padded(t)
        score, q_end, t_end = align_one_sweep(qc, tc, len(q), len(t), CFG)
        if score == 0 and q_end == 0 and t_end == 0:
            continue
        cigar, tb_score = nv.traceback_adaptive(
            qc, tc, q_end, t_end, CFG, score
        )
        assert tb_score == score
        qc_n, tc_n = cigar_to_pairs(cigar)
        assert qc_n == q_end + 1 and tc_n == t_end + 1
        assert score_cigar(cigar, qc, tc, CFG) == score


def test_traceback_all_batch(rng):
    """traceback_all (threaded native batch) upholds the per-pair
    invariants and handles the empty-CIGAR special case."""
    from agatha_jax.ops.traceback import traceback_all

    enc = []
    exp = []
    for i in range(10):
        ql = int(rng.integers(30, 300))
        q = random_seq(rng, ql, 0.02)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(30, 300)), 0.02
        )
        qc, tc = encode_padded(q), encode_padded(t)
        enc.append((qc, tc, len(q), len(t)))
        exp.append(align_one_sweep(qc, tc, len(q), len(t), CFG))
    scores = np.array([e[0] for e in exp], np.int64)
    qends = np.array([e[1] for e in exp], np.int32)
    tends = np.array([e[2] for e in exp], np.int32)
    cigars = traceback_all(enc, qends, tends, scores, CFG)
    assert len(cigars) == len(enc)
    for i, (qc, tc, _ql, _rl) in enumerate(enc):
        if cigars[i] == "":
            assert scores[i] == 0
            continue
        qc_n, tc_n = cigar_to_pairs(cigars[i])
        assert qc_n == qends[i] + 1 and tc_n == tends[i] + 1
        assert score_cigar(cigars[i], qc, tc, CFG) == scores[i]


def test_engine_traceback(rng):
    engine = AlignEngine(CFG)
    pairs = []
    for i in range(6):
        q = random_seq(rng, 50 + 10 * i)
        pairs.append((q, mutate(rng, q)))
    enc = [
        (encode_padded(q), encode_padded(t), len(q), len(t))
        for q, t in pairs
    ]
    res = engine.align(enc, traceback=True)
    assert res.cigars is not None and len(res.cigars) == 6
    for i, (qc, tc, ql, rl) in enumerate(enc):
        qc_n, tc_n = cigar_to_pairs(res.cigars[i])
        assert qc_n == int(res.query_ends[i]) + 1
        assert tc_n == int(res.target_ends[i]) + 1
        assert (
            score_cigar(res.cigars[i], qc, tc, CFG)
            == int(res.scores[i])
        )
