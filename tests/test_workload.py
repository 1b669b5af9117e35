"""Cell accounting and workload synthesis."""

import numpy as np

from agatha_jax.utils.workload import banded_cells, make_workload


def _brute_cells(ql, rl, nd, bw):
    total = 0
    for r in range(rl):
        for q in range(ql):
            if abs(q - r) <= bw and (q + r) < nd:
                total += 1
    return total


def test_banded_cells_matches_bruteforce(rng):
    for _ in range(10):
        ql = int(rng.integers(1, 40))
        rl = int(rng.integers(1, 40))
        bw = int(rng.integers(0, 20))
        nd = int(rng.integers(1, ql + rl))
        assert banded_cells([ql], [rl], [nd], bw) == _brute_cells(
            ql, rl, nd, bw
        )


def test_make_workload_deterministic():
    a = make_workload(4, 500, seed=9)
    b = make_workload(4, 500, seed=9)
    for (qa, ta, qla, rla), (qb, tb, qlb, rlb) in zip(a, b):
        assert qla == qlb and rla == rlb
        assert (qa == qb).all() and (ta == tb).all()
    c = make_workload(4, 500, seed=10)
    assert any(
        (x[2] != y[2]) or not (x[0] == y[0]).all() for x, y in zip(a, c)
    )


def test_cli_flags_reach_config(tmp_path):
    from agatha_jax.cli import build_parser

    args = build_parser().parse_args(
        ["-m", "5", "-x", "7", "-q", "11", "-r", "3", "-s", "2",
         "-z", "99", "-w", "42", "q.fa", "t.fa"]
    )
    assert (args.m, args.x, args.q, args.r) == (5, 7, 11, 3)
    assert (args.s, args.z, args.w) == (2, 99, 42)
    assert args.query_fasta == "q.fa" and args.target_fasta == "t.fa"
    assert args.raw_file is None
