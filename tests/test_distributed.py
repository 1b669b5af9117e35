"""Host-sharding logic for multi-host data parallelism."""

from agatha_jax.parallel import distributed


def test_host_shard_single_process():
    assert distributed.host_shard(10) == slice(0, 10)


def test_host_shard_balanced(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "process_count", lambda: 4)
    covered = []
    for p in range(4):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        sl = distributed.host_shard(10)
        covered.extend(range(*sl.indices(10)))
        assert (sl.stop - sl.start) in (2, 3)
    assert covered == list(range(10))  # exact partition, in order


def test_align_distributed_runs_local_shard(rng, monkeypatch):
    import jax

    from agatha_jax.config import AlignConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.ops.packing import encode_padded

    from .conftest import random_seq

    encoded = []
    for i in range(6):
        q = random_seq(rng, 30 + i)
        encoded.append((encode_padded(q), encode_padded(q), len(q), len(q)))

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    eng = AlignEngine(AlignConfig())
    sl, res = distributed.align_distributed(eng, encoded)
    assert sl == slice(3, 6)
    assert len(res.scores) == 3
    assert (res.scores == [2 * (33 + i) for i in range(3)]).all()
