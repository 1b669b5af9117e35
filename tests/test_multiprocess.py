"""Real multi-process data-parallel run (2 JAX processes over local
TCP), validating the jax.distributed + host_shard path end-to-end.

This is the closest a single machine gets to BASELINE config 5
(N >= 2 hosts): two OS processes initialize a distributed JAX runtime,
each aligns its deterministic shard, and the merged results must match
the oracle.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from agatha_jax.config import AlignConfig
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

from .conftest import random_seq

_WORKER = r"""
import json, sys
import numpy as np
import jax

coord, pid, nprocs, out_path = sys.argv[1:5]
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coord,
    num_processes=int(nprocs),
    process_id=int(pid),
)

from agatha_jax.config import AlignConfig
from agatha_jax.engine import AlignEngine
from agatha_jax.ops.packing import encode_padded
from agatha_jax.parallel.distributed import align_distributed

# deterministic shared input manifest (same on every process)
rng = np.random.default_rng(7)
bases = np.array(list("ACGT"))
encoded = []
for i in range(10):
    n = 40 + 7 * i
    q = "".join(bases[rng.integers(0, 4, size=n)])
    encoded.append((encode_padded(q), encode_padded(q), n, n))

eng = AlignEngine(AlignConfig())
sl, res = align_distributed(eng, encoded)
json.dump(
    {
        "start": sl.start,
        "stop": sl.stop,
        "scores": [int(s) for s in res.scores],
    },
    open(out_path, "w"),
)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed(tmp_path):
    # (bounded by the per-process wait(timeout=540) below)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {
        "PATH": "/usr/bin:/bin",
        "HOME": "/root",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": "/root/repo",
    }
    procs = []
    outs = []
    for pid in range(2):
        out = tmp_path / f"out{pid}.json"
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker), coord, str(pid), "2",
                 str(out)],
                env=env, cwd="/root/repo",
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
        )
    for p in procs:
        try:
            p.wait(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker hung")
    for p in procs:
        assert p.returncode == 0, p.stderr.read().decode()[-2000:]

    # merge shards and compare to the oracle
    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    encoded = []
    for i in range(10):
        n = 40 + 7 * i
        q = "".join(bases[rng.integers(0, 4, size=n)])
        encoded.append((encode_padded(q), encode_padded(q), n, n))

    merged = [None] * 10
    for out in outs:
        d = json.load(open(out))
        for j, s in enumerate(d["scores"]):
            merged[d["start"] + j] = s
    assert None not in merged
    for i, (qc, tc, ql, rl) in enumerate(encoded):
        exp = align_one_sweep(qc, tc, ql, rl, AlignConfig())[0]
        assert merged[i] == exp, i
