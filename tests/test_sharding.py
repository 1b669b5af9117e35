"""Multi-device data-parallel dispatch on the virtual 8-CPU mesh."""

import numpy as np

from agatha_jax.config import AlignConfig
from agatha_jax.ops.bucket import ROW_UNIT, build_bucket_arrays
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep
from agatha_jax.parallel.sharding import (
    align_bucket_sharded,
    make_pairs_mesh,
    pad_rows,
)

from .conftest import mutate, random_seq

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)


def test_sharded_matches_oracle(rng):
    mesh = make_pairs_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 8

    pairs = []
    for i in range(n_dev * ROW_UNIT):
        ql = int(rng.integers(1, 120))
        q = random_seq(rng, ql, 0.02)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(1, 120)), 0.02
        )
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))

    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    out = np.asarray(
        align_bucket_sharded(meta, tcodes, qfwd, CFG, mesh)
    )
    assert out.shape == (n_dev * ROW_UNIT, 4)
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, CFG)
        assert tuple(int(v) for v in out[p, :3]) == tuple(exp), f"pair {p}"


def test_sharded_pad_rows(rng):
    mesh = make_pairs_mesh()
    q = random_seq(rng, 64)
    pairs = [(encode_padded(q), encode_padded(q), 64, 64)]
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    gb = mesh.devices.size * ROW_UNIT
    out = np.asarray(
        align_bucket_sharded(
            pad_rows(meta, gb, 1), pad_rows(tcodes, gb),
            pad_rows(qfwd, gb), CFG, mesh,
        )
    )
    exp = align_one_sweep(*pairs[0], CFG)
    assert tuple(int(v) for v in out[0, :3]) == tuple(exp)


def test_graft_entry_dryrun():
    import sys

    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    g.dryrun_multichip(2)


def test_engine_uses_all_devices_matches_single(rng):
    """AlignEngine production path shards buckets over the mesh; the
    results (and input-order mapping) must equal single-device."""
    from agatha_jax.config import EngineConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.utils.workload import make_workload

    enc = make_workload(30, 500, seed=13)
    multi = AlignEngine(
        CFG, EngineConfig(aligns_per_batch=8)
    )
    single = AlignEngine(
        CFG, EngineConfig(aligns_per_batch=8, use_all_devices=False),
    )
    rm = multi.align(enc)
    rs = single.align(enc)
    assert multi._local_mesh() is not None  # mesh really engaged
    assert (rm.scores == rs.scores).all()
    assert (rm.query_ends == rs.query_ends).all()
    assert (rm.target_ends == rs.target_ends).all()
    assert (rm.diags == rs.diags).all()


def test_engine_sharded_windowed_bucket(rng):
    """Long-target pairs (sliding band window) through the sharded
    engine."""
    from agatha_jax.config import EngineConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.ops.bucket import window_width

    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=40, z_threshold=150)
    pairs = []
    for i in range(10):
        n = 600 + 30 * i
        q = random_seq(rng, n, 0.01)
        t = mutate(rng, q) if i % 2 else random_seq(rng, n + 20, 0.01)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    assert max(p[3] for p in pairs) > window_width(cfg)
    eng = AlignEngine(cfg, EngineConfig(aligns_per_batch=16))
    res = eng.align(pairs)
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = (int(res.scores[p]), int(res.query_ends[p]),
               int(res.target_ends[p]))
        assert got == tuple(exp), f"pair {p}"
