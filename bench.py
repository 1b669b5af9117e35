"""Benchmark: GCUPS on the canonical guided-alignment workload, on a GPU.

Mirrors the reference harness (AGAThA.sh:44): canonical parameters
-m 1 -x 4 -q 6 -r 2 -s 3 -z 400 -w 751.  The reference's bundled
dataset is stripped from the mount, so a deterministic synthetic
long-read seed-extension workload stands in: 1024 homologous ~10 kb
pairs with ~10% divergence, the regime AGAThA targets.

Usage:  python bench.py [N_PAIRS [MEAN_LEN [BAND [Z]]]] [--profile [DIR]]

Prints the device and its power limit on stderr, then ONE JSON line:
{"metric", "value", "unit", "device"}.  value = banded DP cell updates
per second (GCUPS), counting exactly the in-band cells of the
antidiagonals each pair swept (Z-drop credit included, padding
excluded), over the best of 3 warm end-to-end ``engine.align`` calls.
Exits non-zero when JAX finds no GPU: a CPU number is not a device
metric.
"""

import json
import sys
import time


def main():
    import jax

    from agatha_jax.config import AlignConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.utils.cache import enable_compilation_cache
    from agatha_jax.utils.workload import (
        gpu_name_power,
        make_workload,
        result_gcups,
    )

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    enable_compilation_cache()
    argv = sys.argv[1:]
    profile_dir = None
    if "--profile" in argv:
        i = argv.index("--profile")
        argv.pop(i)
        profile_dir = (
            argv.pop(i) if i < len(argv) and not argv[i].isdigit()
            else "chiprun_out/trace"
        )
    # Optional args cover the other BASELINE configs: `bench.py 1024
    # 15000` (HiFi), `bench.py 128 75000 2001 400` (ONT wide band).
    n_pairs = int(argv[0]) if len(argv) > 0 else 1024
    mean_len = int(argv[1]) if len(argv) > 1 else 10000
    band = int(argv[2]) if len(argv) > 2 else 751
    zthr = int(argv[3]) if len(argv) > 3 else 400
    cfg = AlignConfig(
        match=1, mismatch=4, gap_open=6, gap_extend=2,
        slice_width=3, z_threshold=zthr, band_width=band,
    )
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device {device}; nvidia-smi: {gpu_name_power()}",
          file=sys.stderr)

    encoded = make_workload(n_pairs, mean_len)
    engine = AlignEngine(cfg)
    engine.align(encoded)  # warm-up: compile every bucket shape

    if profile_dir:
        with jax.profiler.trace(profile_dir):
            prof = engine.align(encoded, per_bucket_times=True)
        print(
            f"# profile trace written to {profile_dir}; per-bucket "
            "(route, completion ms): "
            + " ".join(f"{r}:{m:.1f}" for r, m in
                       zip(prof.routes or [], prof.bucket_ms or [])),
            file=sys.stderr,
        )

    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = engine.align(encoded)
        dt = min(dt, time.perf_counter() - t0)
    gcups = result_gcups(encoded, res, cfg, dt)
    print(json.dumps({
        "metric": "banded_dp_cell_updates_per_second",
        "value": gcups,
        "unit": "GCUPS",
        "device": device,
    }))
    print(
        f"# pairs={n_pairs} mean_len={mean_len} route={engine.route} "
        f"wall={dt * 1e3:.1f}ms buckets={res.n_buckets}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
