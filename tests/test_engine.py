"""Engine bucketing/dispatch and CLI end-to-end tests (CPU, plain-JAX DP)."""

import subprocess
import sys

import numpy as np

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.engine import AlignEngine, _round_shape
from agatha_jax.io.fasta import SeqPair, write_fasta
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

from .conftest import mutate, random_seq

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)


def test_round_shape_grid():
    assert _round_shape(1) == 128
    assert _round_shape(128) == 128
    assert _round_shape(129) == 256
    assert _round_shape(300) == 384
    assert _round_shape(400) == 512
    assert _round_shape(1000) == 1024
    assert _round_shape(1100) == 1536
    for x in [5, 130, 700, 5000, 99999]:
        assert _round_shape(x) % 128 == 0
        assert _round_shape(x) >= x


def test_engine_matches_oracle_mixed_lengths(rng):
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=8))
    encoded = []
    for i in range(20):
        ql = int(rng.integers(1, 200))
        q = random_seq(rng, ql, 0.02)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(1, 200)), 0.02
        )
        encoded.append(
            (encode_padded(q), encode_padded(t), len(q), len(t))
        )
    res = engine.align(encoded)
    assert res.n_buckets == 3  # 20 pairs / 8 per bucket
    for i, (qc, tc, ql, rl) in enumerate(encoded):
        exp = align_one_sweep(qc, tc, ql, rl, CFG)
        got = (int(res.scores[i]), int(res.query_ends[i]),
               int(res.target_ends[i]))
        assert got == tuple(exp), f"pair {i}"


def test_engine_applies_seq_ops(rng):
    """Reverse/complement ops from FASTA headers flow through encode."""
    q = random_seq(rng, 60)
    t = random_seq(rng, 60)
    engine = AlignEngine(CFG)
    for qop in range(4):
        for top in range(4):
            pairs = [SeqPair(q, t, qop, top)]
            enc = engine.encode_pairs(pairs)
            res = engine.align(enc)
            exp = align_one_sweep(*enc[0], CFG)
            assert (int(res.scores[0]), int(res.query_ends[0]),
                    int(res.target_ends[0])) == tuple(exp)


def test_empty_batch_and_empty_sequence(rng):
    import pytest

    engine = AlignEngine(CFG)
    res = engine.align([])
    assert len(res.scores) == 0
    q = encode_padded("ACGT")
    with pytest.raises(ValueError, match="empty sequence"):
        engine.align([(q, q, 0, 4)])
    with pytest.raises(ValueError, match="empty sequence"):
        engine.align([(q, q, 4, 0)])


def test_packing_limit_warning(rng):
    """Over-range pairs warn once per call AND still flow through with
    the oracle-identical (degraded) results the reference would give."""
    import warnings

    from agatha_jax.ops.sweep import align_one_sweep

    # match * min(ql, rl) >= 2^15 with a real 48-base pair: the exact
    # overflow the reference's (H<<16)|r packing exhibits.
    cfg = AlignConfig(match=800, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=751)
    engine = AlignEngine(cfg)
    pairs = []
    for _ in range(2):
        q = random_seq(rng, 48)
        qc = encode_padded(q)
        tc = encode_padded(mutate(rng, q))
        pairs.append((qc, tc, 48, len(tc)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = engine.align(pairs)
        msgs = [x for x in w if "16-bit" in str(x.message)]
        # one aggregated warning per align() call, not one per pair
        assert len(msgs) == 1
        assert "2 pair(s)" in str(msgs[0].message)
    for i, (qc, tc, ql, rl) in enumerate(pairs):
        score, qe, te = align_one_sweep(qc, tc, ql, rl, cfg)
        assert res.scores[i] == score
        assert res.query_ends[i] == qe
        assert res.target_ends[i] == te


def test_cli_end_to_end(tmp_path, rng):
    qs, ts, ops = [], [], []
    for i in range(5):
        q = random_seq(rng, 40 + 10 * i)
        qs.append(q)
        ts.append(mutate(rng, q))
        ops.append(i % 4)
    qf = tmp_path / "query.fasta"
    tf = tmp_path / "target.fasta"
    raw = tmp_path / "raw.log"
    write_fasta(str(qf), qs, ops)
    write_fasta(str(tf), ts, [0] * 5)

    proc = subprocess.run(
        [sys.executable, "-m", "agatha_jax.cli", "-p",
         "-m", "1", "-x", "4", "-q", "6", "-r", "2",
         str(qf), str(tf), str(raw)],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": "/root"},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().split("\n")
    assert len(lines) == 5

    # cross-check against the oracle
    engine = AlignEngine(CFG)
    enc = engine.encode_pairs(
        [SeqPair(qs[i], ts[i], ops[i], 0) for i in range(5)]
    )
    for i, line in enumerate(lines):
        exp = align_one_sweep(*enc[i], CFG)
        assert line == (
            f"{exp[0]}\tquery_batch_end={exp[1]}"
            f"\ttarget_batch_end={exp[2]}"
        )
    # raw file has one kernel-ms line
    assert len(raw.read_text().strip().split("\n")) == 1


def test_per_bucket_times(rng):
    """per_bucket_times yields one completion delta per bucket."""
    enc = []
    for i in range(24):
        q = random_seq(rng, 30 + 10 * (i % 5))
        t = mutate(rng, q)
        enc.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=8))
    res = engine.align(enc, per_bucket_times=True)
    assert res.bucket_ms is not None
    assert len(res.bucket_ms) == res.n_buckets
    assert all(ms >= 0 for ms in res.bucket_ms)
    base = engine.align(enc)
    assert (res.scores == base.scores).all()


def test_mixed_windowed_and_full_buckets(rng):
    """One align() call spanning both DP layouts: a long pair that
    takes the sliding-window path bucketed alongside short pairs on
    the full-width path."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=300)
    # window_width(300) = 640; rlen > 640 forces the sliding window
    enc = []
    q = random_seq(rng, 700)
    t = mutate(rng, q)
    enc.append((encode_padded(q), encode_padded(t), 700, len(t)))
    for i in range(15):
        s = random_seq(rng, 30 + 8 * i)
        t = mutate(rng, s)
        enc.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    engine = AlignEngine(cfg, EngineConfig(aligns_per_batch=8))
    res = engine.align(enc)
    assert res.n_buckets >= 2
    for i, (qc, tc, ql, rl) in enumerate(enc):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = (int(res.scores[i]), int(res.query_ends[i]),
               int(res.target_ends[i]))
        assert got == tuple(exp), f"pair {i}"


def test_target_buckets_splits_without_changing_results(rng):
    """EngineConfig.target_buckets controls the adaptive bucket count
    (floor 64 pairs/bucket); results are split-invariant."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)
    enc = []
    for i in range(256):
        s = random_seq(rng, 24 + (i % 40))
        t = mutate(rng, s)
        enc.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    r2 = AlignEngine(cfg, EngineConfig(target_buckets=2)).align(enc)
    r4 = AlignEngine(cfg, EngineConfig(target_buckets=4)).align(enc)
    assert r2.n_buckets == 2 and r4.n_buckets == 4
    assert (r2.scores == r4.scores).all()
    assert (r2.query_ends == r4.query_ends).all()
    assert (r2.target_ends == r4.target_ends).all()


def test_bucket_floor_is_work_adaptive(rng):
    """The split's per-bucket floor is a fixed 64 pairs, whatever the
    per-pair sweep work.

    The former work-adaptive floor (smaller buckets for long pairs,
    sized from a per-substep cost and a per-dispatch floor measured on
    other hardware) is gone: on a GPU a bucket of a few long pairs
    leaves most SMs idle.  Only the split is asserted here (host-side);
    split-invariance of results is covered by
    test_target_buckets_splits_*.
    """
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)

    def enc_of(n, length):
        out = []
        for i in range(n):
            s = random_seq(rng, length + (i % 7))
            out.append((encode_padded(s), encode_padded(s),
                        len(s), len(s)))
        return out

    eng = AlignEngine(cfg)
    sizes_long = [len(b.indices)
                  for b in eng.iter_buckets(enc_of(128, 40000))]
    assert sizes_long == [64, 64], sizes_long
    # short pairs: the 64 floor holds even at target_buckets=16
    sizes_short = [len(b.indices)
                   for b in eng.iter_buckets(enc_of(128, 100))]
    assert sizes_short == [64, 64], sizes_short


def test_bucket_size_snaps_to_lane_block(rng):
    """Bucket sizes no longer snap up to 128-pair blocks (a padding
    rule of kernels that mapped pairs onto 128 vector lanes): the
    64-pair target split stands, and the -a cap still binds."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)
    enc = []
    for i in range(256):
        s = random_seq(rng, 24 + (i % 40))
        t = mutate(rng, s)
        enc.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    eng = AlignEngine(cfg, EngineConfig(target_buckets=4))
    sizes = [len(b.indices) for b in eng.iter_buckets(enc)]
    assert sizes == [64] * 4
    capped = AlignEngine(cfg, EngineConfig(target_buckets=4,
                                           aligns_per_batch=8))
    assert all(len(b.indices) <= 8 for b in capped.iter_buckets(enc))


def test_snap_decided_per_chunk_not_per_dataset(rng):
    """Every chunk keeps the tuned target_buckets split whatever its
    lengths: long banded chunks, short reads, and a mixed batch all cut
    at the same size, and each bucket's rows pad to the row grid."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=63)
    longs = []
    for i in range(256):
        s = random_seq(rng, 600 + (i % 50))
        t = mutate(rng, s)
        longs.append((encode_padded(s), encode_padded(t),
                      len(s), len(t)))
    eng = AlignEngine(cfg, EngineConfig(target_buckets=4))
    assert [len(b.indices) for b in eng.iter_buckets(longs)] == [64] * 4

    shorts = []
    for i in range(124):
        s = random_seq(rng, 24 + (i % 17))
        t = mutate(rng, s)
        shorts.append((encode_padded(s), encode_padded(t),
                       len(s), len(t)))
    buckets = list(eng.iter_buckets(shorts + longs))
    # 380 pairs / 4 = 95 per bucket; rows round up to 96
    assert [len(b.indices) for b in buckets] == [95] * 4
    assert all(b.meta.shape[0] == 96 for b in buckets)
