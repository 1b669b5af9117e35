"""Streaming engine: chunked results equal the batch path, bounded window."""

import os
import subprocess
import sys

import numpy as np

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.engine import AlignEngine
from agatha_jax.io.fasta import SeqPair, write_fasta
from agatha_jax.ops.packing import encode_padded

from .conftest import mutate, random_seq

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _encoded(rng, n):
    out = []
    for i in range(n):
        q = random_seq(rng, 30 + (i % 7) * 20)
        t = mutate(rng, q) if i % 2 else random_seq(rng, 40)
        out.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return out


def test_stream_matches_batch(rng):
    enc = _encoded(rng, 150)
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=64))
    batch = engine.align(enc)
    chunks = list(engine.align_stream(iter(enc)))
    assert len(chunks) == 3  # 64 + 64 + 22
    scores = np.concatenate([c.scores for c in chunks])
    qends = np.concatenate([c.query_ends for c in chunks])
    tends = np.concatenate([c.target_ends for c in chunks])
    assert (scores == batch.scores).all()
    assert (qends == batch.query_ends).all()
    assert (tends == batch.target_ends).all()


def test_stream_routes_are_per_chunk(rng):
    """Each yielded result carries ITS chunk's routes, not the most
    recently dispatched chunk's.

    Regression: routes were once read from shared instance state at
    collect time, so with max_in_flight > 1 an early chunk reported the
    later chunks' routes.  Every chunk's result must hold the very list
    its own dispatch returned.
    """
    short = []
    for i in range(8):
        q = random_seq(rng, 20 + i)
        t = random_seq(rng, 4)
        short.append((encode_padded(q), encode_padded(t),
                      len(q), len(t)))
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=31)
    longs = []
    for i in range(16):
        q = random_seq(rng, 200 + i)
        t = mutate(rng, q)
        longs.append((encode_padded(q), encode_padded(t),
                      len(q), len(t)))
    engine = AlignEngine(cfg, EngineConfig(aligns_per_batch=8))
    dispatched = []
    orig = engine._dispatch

    def spy(encoded):
        out = orig(encoded)
        dispatched.append(out[2])
        return out

    engine._dispatch = spy
    chunks = list(engine.align_stream(iter(short + longs),
                                      max_in_flight=3))
    assert len(chunks) == 3 == len(dispatched)
    for c, routes in zip(chunks, dispatched):
        assert c.routes is routes
        # the plain-JAX DP, sharded over the 8-device CPU mesh
        assert c.routes == ["xla-sharded"] * c.n_buckets, c.routes


def test_stream_bounded_window(rng):
    """At most max_in_flight chunks may be alive before a yield."""
    enc = _encoded(rng, 8 * 10)
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=8))
    live = 0
    peak = 0
    orig = engine._dispatch
    collected = [0]

    def counting_dispatch(encoded, **kw):
        nonlocal live, peak
        live += 1
        peak = max(peak, live)
        return orig(encoded, **kw)

    orig_collect = engine._collect

    def counting_collect(*a, **k):
        nonlocal live
        live -= 1
        collected[0] += 1
        return orig_collect(*a, **k)

    engine._dispatch = counting_dispatch
    engine._collect = counting_collect
    n = sum(
        len(c.scores)
        for c in engine.align_stream(iter(enc), max_in_flight=3)
    )
    assert n == 80
    assert collected[0] == 10
    assert peak <= 3


def test_stream_accepts_seqpairs(rng):
    pairs = []
    for i in range(10):
        q = random_seq(rng, 50)
        pairs.append(SeqPair(q, mutate(rng, q), 0, 0))
    engine = AlignEngine(CFG)
    chunks = list(engine.align_stream(iter(pairs)))
    res = engine.align_pairs(pairs)
    got = np.concatenate([c.scores for c in chunks])
    assert (got == res.scores).all()


def test_cli_stream_stdout_identical(tmp_path):
    """--stream must produce byte-identical stdout to the batch path."""
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": "/root"}
    base = [sys.executable, "-m", "agatha_jax.cli", "-p",
            "-m", "1", "-x", "4", "-q", "6", "-r", "2", "-a", "8",
            os.path.join(GOLDEN, "query.fasta"),
            os.path.join(GOLDEN, "target.fasta")]
    batch = subprocess.run(base, capture_output=True, text=True,
                           timeout=900, env=env)
    stream = subprocess.run(base + ["--stream"], capture_output=True,
                            text=True, timeout=900, env=env)
    assert batch.returncode == 0, batch.stderr[-2000:]
    assert stream.returncode == 0, stream.stderr[-2000:]
    assert stream.stdout == batch.stdout


def test_cli_stream_cigar(tmp_path, rng):
    """--stream --cigar: CIGAR column present, raw file one line/chunk."""
    qs, ts = [], []
    for i in range(12):
        q = random_seq(rng, 40 + 5 * i)
        qs.append(q)
        ts.append(mutate(rng, q))
    qf = tmp_path / "q.fasta"
    tf = tmp_path / "t.fasta"
    raw = tmp_path / "raw.log"
    write_fasta(str(qf), qs)
    write_fasta(str(tf), ts)
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": "/root"}
    proc = subprocess.run(
        [sys.executable, "-m", "agatha_jax.cli", "--stream", "--cigar",
         "-m", "1", "-x", "4", "-q", "6", "-r", "2",
         "-a", "5", str(qf), str(tf), str(raw)],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 12
    assert all("\tcigar=" in ln for ln in lines)
    # -a has a floor of ROW_UNIT=8: 12 pairs -> chunks of 8+4 -> 2
    # raw lines (one per chunk)
    assert len(open(raw).read().split()) == 2
