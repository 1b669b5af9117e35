"""Drive the aligner's main path once on a GPU and check it is exact.

Usage:  python chip_smoke.py          # one card, all phases
        python chip_smoke.py --four   # four cards: sharded headline only

Phases (each prints one line; the first failure raises, exit != 0):
  1. device   — platform, device kind, count, nvidia-smi name/power
  2. build    — build and load the CUDA DP library (set-up time)
  3. parity   — the CUDA kernel vs the plain-JAX DP on the card, all
                four columns exactly, plus pairs vs the host oracle
                (ops.sweep), on: the 1024 x 10 kb headline buckets, 32
                of 128 x 75 kb pairs at band 2001, 8192 x 150 bp
                short reads, two int16-unsafe configs, N runs with all
                four op codes
  4. engine   — AlignEngine.align on the headline (wall, buckets,
                routes, GCUPS), the CLI against tests/golden, one
                --cigar run checked path by path, align_stream
  5. a/b      — the CUDA route vs the plain-JAX route end to end, and
                each route's device time on one headline bucket from a
                jax.profiler trace

The last line is {"ok": true, "device": {...}} with the device as JAX
reports it.  The script refuses to run on anything but a gpu backend.
"""

import contextlib
import glob
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

CANON = dict(match=1, mismatch=4, gap_open=6, gap_extend=2,
             slice_width=3, z_threshold=400, band_width=751)
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, reps):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def same_rows(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    bad = np.flatnonzero((a != b).any(axis=1))
    if a.shape != b.shape or bad.size:
        raise AssertionError(
            f"{what}: {bad.size} rows differ, first {bad[:5].tolist()}: "
            f"{a[bad[:3]].tolist()} vs {b[bad[:3]].tolist()}"
        )


def same_result(a, b, what):
    for col in ("scores", "query_ends", "target_ends", "diags"):
        if not (getattr(a, col) == getattr(b, col)).all():
            raise AssertionError(f"{what}: {col} differ")


def check_oracle(rows, encoded, cfg, what):
    from agatha_jax.ops.sweep import align_one_sweep

    for row, e in zip(rows, encoded):
        exp = tuple(align_one_sweep(*e, cfg))
        got = tuple(int(v) for v in row[:3])
        if got != exp:
            raise AssertionError(f"{what}: oracle {exp} vs {got}")
    return len(encoded)


def bucket_parity(buckets, encoded, cfg, what, n_oracle, force=False):
    """CUDA vs plain-JAX DP on every bucket; oracle on a few pairs."""
    from agatha_jax.ops.dp import align_bucket

    rows = n_checked = 0
    for b in buckets:
        cu = np.asarray(align_bucket(b.meta, b.tcodes, b.qfwd, cfg,
                                     route="cuda", force_strips=force))
        xl = align_bucket(b.meta, b.tcodes, b.qfwd, cfg, route="xla",
                          force_strips=force)
        same_rows(cu, xl, what)
        rows += len(b.indices)
        k = min(len(b.indices), n_oracle - n_checked)
        if k > 0:
            n_checked += check_oracle(
                cu[:k], [encoded[i] for i in b.indices[:k]], cfg, what)
    say("parity", f"{what}: {rows} pairs in {len(buckets)} buckets "
                  f"CUDA == plain-JAX DP on all 4 columns; {n_checked} "
                  "pairs == host oracle")


def n_run_pairs(n, seed):
    """Homologous pairs with runs of N and all four op codes."""
    from agatha_jax.io.fasta import SeqPair

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    pairs = []
    for i in range(n):
        q = bases[rng.integers(0, 4, int(rng.integers(100, 1200)))]
        t = q.copy()
        flip = rng.random(len(t)) < 0.08
        t[flip] = bases[rng.integers(0, 4, int(flip.sum()))]
        for s in (q, t):
            lo = int(rng.integers(0, len(s)))
            s[lo:lo + int(rng.integers(1, 40))] = "N"
        pairs.append(SeqPair("".join(q), "".join(t), i % 4, (i // 4) % 4))
    return pairs


def device_time(trace_dir):
    """(busy ns, dp_kernel ns, device events, line names) on the GPU
    planes of a trace: busy is the union of the stream lines' events."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    busy = kern = n_ev = 0
    names = set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            names.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            iv = sorted((e.start_ns, e.end_ns) for e in line.events)
            n_ev += len(iv)
            end = None
            for s, e in iv:
                if end is None or s > end:
                    busy += e - s
                    end = e
                elif e > end:
                    busy += e - end
                    end = e
            kern += sum(e.duration_ns for e in line.events
                        if "dp_kernel" in e.name)
    return busy, kern, n_ev, sorted(names)


def run_cli(argv):
    from agatha_jax import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}")
    return buf.getvalue()


def four_cards(cfg, device):
    """The headline on a 4-card mesh vs one card, bit for bit."""
    import jax

    from agatha_jax.config import EngineConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.utils.workload import make_workload

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four needs 4 devices, found "
                         f"{len(jax.devices())}")
    enc = make_workload(1024, 10000)
    multi = AlignEngine(cfg)
    one = AlignEngine(cfg, EngineConfig(use_all_devices=False))
    multi.align(enc)
    one.align(enc)
    t4, r4 = timed(lambda: multi.align(enc), 3)
    t1, r1 = timed(lambda: one.align(enc), 3)
    assert multi._local_mesh() is not None
    assert set(r4.routes) == {"cuda-sharded"}, r4.routes
    same_result(r4, r1, "4-card mesh vs 1 card")
    # every card ran the kernel on its own shard of a bucket
    b = multi.make_buckets(enc)[0]
    from agatha_jax.parallel.sharding import align_bucket_sharded, pad_rows

    gb = -(-b.meta.shape[0] // 32) * 32
    out = align_bucket_sharded(pad_rows(b.meta, gb, 1),
                               pad_rows(b.tcodes, gb),
                               pad_rows(b.qfwd, gb), cfg, multi._mesh)
    shards = out.addressable_shards
    assert len({s.device.id for s in shards}) == 4, shards
    assert all(s.data.shape == (gb // 4, 4) for s in shards)
    say("four", f"1024 x 10 kb: 4 cards {t4 * 1e3:.3f} ms, 1 card "
                f"{t1 * 1e3:.3f} ms, results identical; shards on "
                f"devices {sorted(s.device.id for s in shards)}")
    return device


def main(argv):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke.py needs a gpu backend, not "
                         f"{backend!r}")
    from agatha_jax import cuda
    from agatha_jax.config import AlignConfig, EngineConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.ops.traceback import cigar_to_pairs, score_cigar
    from agatha_jax.utils.cache import enable_compilation_cache
    from agatha_jax.utils.workload import (
        gpu_name_power,
        make_workload,
        result_gcups,
    )

    enable_compilation_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    smi = gpu_name_power()
    say("device", f"{device}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    cuda.load()
    say("build", f"{cuda.library_path()} built and loaded in "
                 f"{time.perf_counter() - t0:.1f} s")
    cfg = AlignConfig(**CANON)

    if "--four" in argv:
        four_cards(cfg, device)
        print(smi)
        print(json.dumps({"ok": True, "device": device}))
        return

    # 3. kernel parity at real widths
    eng = AlignEngine(cfg)
    enc10 = make_workload(1024, 10000)
    bucket_parity(eng.make_buckets(enc10), enc10, cfg,
                  "1024 x 10 kb canonical", n_oracle=2)
    ont = AlignConfig(**dict(CANON, band_width=2001))
    enc75 = make_workload(128, 75000)[:32]
    bucket_parity(AlignEngine(ont).make_buckets(enc75), enc75, ont,
                  "32 of 128 x 75 kb, band 2001", n_oracle=0)
    enc150 = make_workload(8192, 150, spread=0.05)
    bucket_parity(eng.make_buckets(enc150), enc150, cfg,
                  "8192 x 150 bp", n_oracle=32)
    noz = AlignConfig(**dict(CANON, z_threshold=-1))
    enc2k = make_workload(64, 2000, seed=7)
    bucket_parity(AlignEngine(noz).make_buckets(enc2k), enc2k, noz,
                  "64 x 2 kb, z=-1 (int16 wrap)", n_oracle=2)
    bucket_parity(eng.make_buckets(enc10[:64]), enc10[:64], cfg,
                  "64 x 10 kb, strips forced", n_oracle=0, force=True)
    encn = eng.encode_pairs(n_run_pairs(64, seed=3))
    bucket_parity(eng.make_buckets(encn), encn, cfg,
                  "64 pairs with N runs, ops 0-3", n_oracle=8)

    # 4. main path end to end
    eng.align(enc10)
    wall, res = timed(lambda: eng.align(enc10), 3)
    gcups = result_gcups(enc10, res, cfg, wall)
    say("engine", f"align 1024 x 10 kb: {wall * 1e3:.3f} ms, "
                  f"{res.n_buckets} buckets, routes {sorted(set(res.routes))}"
                  f", {gcups:.3f} GCUPS")
    flags = ["-p", "-m", "1", "-x", "4", "-q", "6", "-r", "2"]
    for extra, q, t, log in [
        ([], "query.fasta", "target.fasta", "score.log"),
        (["-w", "15", "-z", "-1"], "query2.fasta", "target2.fasta",
         "score2.log"),
    ]:
        out = run_cli(flags + extra + [os.path.join(GOLDEN, q),
                                       os.path.join(GOLDEN, t)])
        with open(os.path.join(GOLDEN, log)) as f:
            if out != f.read():
                raise AssertionError(f"CLI output differs from {log}")
        say("engine", f"CLI on {q}/{t}: empty diff against {log}")
    from agatha_jax.io.fasta import read_fasta_pairs

    qf, tf = (os.path.join(GOLDEN, n) for n in ("query.fasta",
                                                "target.fasta"))
    lines = run_cli(flags + ["--cigar", qf, tf]).splitlines()
    encg = eng.encode_pairs(read_fasta_pairs(qf, tf))
    n_cig = 0
    for line, (qc, tc, _ql, _rl) in zip(lines, encg):
        score, qe, te, cig = line.split("\t")
        qe = int(qe.split("=")[1])
        te = int(te.split("=")[1])
        cig = cig.split("=", 1)[1]
        if cig:
            assert cigar_to_pairs(cig) == (qe + 1, te + 1), line
            assert score_cigar(cig, qc, tc, cfg) == int(score), line
            n_cig += 1
    assert len(lines) == len(encg)
    say("engine", f"--cigar: {n_cig} of {len(lines)} CIGARs reach their "
                  "end points and rescore to the reported score")
    seng = AlignEngine(cfg, EngineConfig(aligns_per_batch=256))
    chunks = list(seng.align_stream(iter(enc10)))
    for col in ("scores", "query_ends", "target_ends", "diags"):
        got = np.concatenate([getattr(c, col) for c in chunks])
        assert (got == getattr(res, col)).all(), col
    say("engine", f"align_stream: {len(chunks)} chunks equal the batch "
                  "result")

    # 5. A/B: CUDA vs plain-JAX DP, end to end and on device
    xeng = AlignEngine(cfg, EngineConfig(dp_route="xla"))
    xeng.align(enc10)
    xwall, xres = timed(lambda: xeng.align(enc10), 2)
    same_result(xres, res, "plain-JAX engine vs CUDA engine")
    say("a/b", f"align 1024 x 10 kb end to end: CUDA {wall * 1e3:.3f} ms, "
               f"plain-JAX DP {xwall * 1e3:.3f} ms "
               f"({xwall / wall:.2f}x); card {smi}")
    from agatha_jax.ops.dp import align_bucket

    b = eng.make_buckets(enc10)[-1]  # the longest pairs
    d8 = int(res.diags[b.indices].max()) // 8
    for route in ("cuda", "xla"):
        def one():
            return np.asarray(align_bucket(b.meta, b.tcodes, b.qfwd, cfg,
                                           route=route))
        one()
        bwall, _ = timed(one, 3)
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                one()
            busy, kern, n_ev, names = device_time(d)
        say("a/b", f"{route}: one {len(b.indices)}-pair bucket "
                   f"({d8} packed diagonals): wall {bwall * 1e3:.3f} ms, "
                   f"device busy {busy / 1e6:.3f} ms (idle share "
                   f"{1 - busy / 1e9 / bwall:.3f}), dp_kernel "
                   f"{kern / 1e6:.3f} ms, {n_ev} device events "
                   f"(trace lines: {names})")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    say("a/b", f"peak device memory {peak / 2**20:.1f} MiB")

    print(smi)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main(sys.argv[1:])
