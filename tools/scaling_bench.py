"""Weak-scaling benchmark harness (BASELINE.md: efficiency at 1 chip /
1 host / N≥2 hosts).

The harness drives every card from one process and serves two roles:

1. on real multi-chip hardware (``python tools/scaling_bench.py``), it
   measures the sharded pipeline at every mesh size 1..N and reports
   grid-points/s per chip and weak-scaling efficiency;
2. with ``--cpu`` it validates the measurement plumbing and the sharded
   path's correctness/overheads on a virtual 8-device CPU mesh (the
   same strategy the reference uses: multi-node protocols tested with
   mpirun -n N on one box, SURVEY.md §4).

Weak scaling: the per-device tile is fixed (``--tile``), the global grid
grows with the mesh.  Prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=2048,
                    help="per-device tile edge (weak scaling)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-virtual-device CPU mesh "
                         "(plumbing validation, not a scaling result)")
    args = ap.parse_args(argv)

    import os
    if args.cpu and "xla_force_host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_"
                                     "device_count=8").strip()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from richdem_tpu import synth_jax
    from richdem_tpu.parallel import make_mesh, sharded_pipeline
    from richdem_tpu.parallel.mesh import best_factorization

    devices = jax.devices()
    results = []
    n = 1
    while n <= len(devices):
        ny, nx = best_factorization(n)
        mesh = make_mesh(devices[:n], (ny, nx))
        h, w = args.tile * ny, args.tile * nx
        dem = jax.block_until_ready(synth_jax.perlin_dem(h, w))

        def run():
            out = sharded_pipeline(dem, mesh=mesh, eps=args.eps)
            return float(np.asarray(out["accum"][::256, ::256]).sum())

        run()  # warmup/compile
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        cells_per_s = h * w / min(ts)
        per_chip = cells_per_s / n
        eff = per_chip / results[0]["per_chip"] if results else 1.0
        rec = {"devices": n, "mesh": [ny, nx], "grid": [h, w],
               "cells_per_s": round(cells_per_s, 1),
               "per_chip": round(per_chip, 1),
               "weak_scaling_efficiency": round(eff, 3)}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        n *= 2
    return results


if __name__ == "__main__":
    main()
