"""Benchmark driver: grid-points/s for one BASELINE.md configuration.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "cells/s", "vs_baseline": N, ...}

It measures a GPU and refuses to run elsewhere (exit 2), unless the CPU
was asked for explicitly with ``JAX_PLATFORMS=cpu`` — a rehearsal, whose
line names the platform.  Every line names the platform, ``device_kind``,
the device count, the card's name and power limit, and the compile time.
Times are best-of-``BENCH_REPS`` wall clock around one jitted step fenced
with ``jax.block_until_ready``; compilation is set-up and is reported
apart.

``vs_baseline`` divides by a single-core C++ run doing the same work
(richdem_tpu/native/core.cpp — the reference's heap Priority-Flood +
topological-queue design), pinned per config in BASELINE_PINNED.json
(tools/pin_baselines.py).  It is context, not a target.

Env knobs: BENCH_CONFIG (pipeline | fill_flats | dinf_twi | quinn_mfd),
BENCH_SIZE (grid edge; default per config, see SIZES), BENCH_REPS
(default 5), BENCH_TERRAIN (perlin | cone | depressions).
"""

import json
import os
import subprocess
import sys
import time

#: Fallback single-core CPU grid-points/s for fill+flowdir+accum.
BASELINE_CPU_PIPELINE = 5.0e6

#: Peak HBM bandwidth in bytes/s by ``device_kind`` (NVIDIA data sheets:
#: H100 SXM 3.35 TB/s, H100 PCIe 2.0 TB/s, H200 4.8 TB/s).  A device not
#: listed is an error, never a default.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H200": 4.8e12,
}

#: Default grid edge per config: the BASELINE.json north-star size for
#: the D8 pipeline; 4096 for the configs whose multi-flow Jacobi or flat
#: fixpoints converge in O(longest path) iterations.
SIZES = {"pipeline": 10240, "fill_flats": 4096, "dinf_twi": 4096,
         "quinn_mfd": 4096}

#: Where the pinned baseline figures live (committed, so vs_baseline is
#: comparable PR over PR).
PINNED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BASELINE_PINNED.json")


def hbm_peak(device_kind):
    """Peak HBM bytes/s of a GPU kind; raises on a kind not in the table."""
    try:
        return HBM_PEAK[device_kind]
    except KeyError:
        raise KeyError(f"no peak bandwidth for device kind {device_kind!r}; "
                       "add it to bench.HBM_PEAK with its source") from None


def card_info():
    """``"name, power limit"`` as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def require_device(jax):
    """The platform to measure: a GPU, or the CPU when asked for by name.
    Exits 2 otherwise — a bench never falls back to the CPU silently."""
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return platform
    if platform == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return platform
    print(f"bench.py: no GPU (platform {platform!r}); set JAX_PLATFORMS=cpu "
          "for a CPU rehearsal", file=sys.stderr)
    raise SystemExit(2)


def pinned_baseline(config="pipeline"):
    """(cells_per_s, source): env override > committed per-config pin."""
    env = os.environ.get("BENCH_BASELINE_CELLS_S")
    if env:
        return float(env), "env"
    try:
        with open(PINNED_PATH) as f:
            pin = json.load(f)
    except OSError:
        return BASELINE_CPU_PIPELINE, "constant"
    configs = pin.get("configs", {})
    if config in configs:
        return float(configs[config]), "pinned"
    return float(pin["cells_per_s"]), "pinned-pipeline"


def build(config, z):
    """(label, jitted step, check(out) -> iteration info) for a config."""
    import jax
    import jax.numpy as jnp

    from richdem_tpu.ops.fill import fill_depressions_info

    if config == "pipeline":
        from richdem_tpu.pipeline import check_converged, make_pipeline
        step = make_pipeline(z.shape, eps=0.0)

        def check(out):
            check_converged(out)
            return {"fill_iters": int(out["fill_iters"]),
                    "accum_rotations": int(out["accum_rotations"])}
        return "fill+flowdir+accum", step, check

    if config == "fill_flats":
        from richdem_tpu.ops.fill import auto_epsilon
        from richdem_tpu.ops.flats import _resolve_impl
        from richdem_tpu.ops.flowdirs import d8_flowdirs
        eps = auto_epsilon(z)

        @jax.jit
        def step(z):
            filled, fi, fdone = fill_depressions_info(z, eps=eps)
            fd = d8_flowdirs(filled)
            resolved, _, _, (si, sdone) = _resolve_impl(
                filled, fd, jnp.zeros(z.shape, bool), None)
            return resolved, fi, si, fdone & sdone
        label = "epsilon-fill+flat-resolution"
        names = ("fill_iters", "flats_iters")
    elif config == "dinf_twi":
        from richdem_tpu.methods import twi
        from richdem_tpu.ops.accum import dinf_accumulation_from_angles
        from richdem_tpu.ops.flowdirs import dinf_flowdirs
        from richdem_tpu.ops.terrain import terrain_attribute

        @jax.jit
        def step(z):
            filled, fi, fdone = fill_depressions_info(z, eps=1e-2)
            acc, ai, adone = dinf_accumulation_from_angles(
                dinf_flowdirs(filled), return_info=True)
            slope = terrain_attribute(filled, "slope_radians")
            return twi(acc, slope), fi, ai, fdone & adone
        label = "fill+dinf-accum+TWI"
        names = ("fill_iters", "dinf_iters")
    elif config == "quinn_mfd":
        from richdem_tpu.ops.accum import flow_accumulation_from_props
        from richdem_tpu.ops.flowdirs import flow_proportions

        @jax.jit
        def step(z):
            filled, fi, fdone = fill_depressions_info(z, eps=1e-2)
            acc, ai, adone = flow_accumulation_from_props(
                flow_proportions(filled, method="Quinn"), return_info=True)
            return acc, fi, ai, fdone & adone
        label = "fill+quinn-mfd-accum"
        names = ("fill_iters", "mfd_iters")
    else:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")

    def check(out):
        if not bool(out[3]):
            raise RuntimeError(f"{config} fixpoints did not converge")
        return {names[0]: int(out[1]), names[1]: int(out[2])}
    return label, step, check


def main():
    import jax

    platform = require_device(jax)
    dev = jax.devices()[0]
    config = os.environ.get("BENCH_CONFIG", "pipeline")
    if config not in SIZES:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")
    size = int(os.environ.get("BENCH_SIZE", SIZES[config]
                              if platform == "gpu" else 256))
    reps = int(os.environ.get("BENCH_REPS", 5))
    terrain = os.environ.get("BENCH_TERRAIN", "perlin")
    peak = hbm_peak(dev.device_kind) if platform == "gpu" else None

    from richdem_tpu import synth_jax
    gen = {"perlin": synth_jax.perlin_dem,
           "depressions": synth_jax.depression_dem,
           "cone": synth_jax.cone_dem}[terrain]
    z = jax.block_until_ready(gen(size))

    label, step, check = build(config, z)
    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(z).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(z))  # warm-up
    iters = check(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(z))
        times.append(time.perf_counter() - t0)
    best = min(times)
    cells_per_s = size * size / best

    baseline, baseline_source = pinned_baseline(config)
    result = {
        "metric": (f"{label} grid-points/s "
                   f"({size}x{size} {terrain}, {platform})"),
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / baseline, 3),
        "baseline_cells_s": round(baseline, 1),
        "baseline_source": baseline_source,
        "config": config,
        "time_s": best,
        "times_s": times,
        "compile_s": compile_s,
        "platform": platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info(),
        "hbm_peak_bytes_s": peak,
        **iters,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
