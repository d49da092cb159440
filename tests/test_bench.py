"""bench.py's device rules: a GPU or an explicit CPU rehearsal, a peak
table that refuses unknown cards, and one JSON line naming the device."""

import json
import os
import subprocess
import sys
import types

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hbm_peak_known_card():
    assert bench.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12


def test_hbm_peak_unknown_card_raises():
    with pytest.raises(KeyError, match="no peak bandwidth"):
        bench.hbm_peak("Unlisted Card 9000")


def _fake_jax(platform):
    dev = types.SimpleNamespace(platform=platform)
    return types.SimpleNamespace(devices=lambda: [dev])


@pytest.mark.parametrize("platform,env,ok", [
    ("gpu", None, True),
    ("cpu", "cpu", True),    # rehearsal asked for by name
    ("cpu", None, False),    # no silent fallback to the CPU
])
def test_require_device(monkeypatch, platform, env, ok):
    if env is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", env)
    if ok:
        assert bench.require_device(_fake_jax(platform)) == platform
    else:
        with pytest.raises(SystemExit) as exc:
            bench.require_device(_fake_jax(platform))
        assert exc.value.code == 2


def test_cpu_rehearsal_prints_one_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_SIZE="32",
               BENCH_REPS="1")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert "(32x32 perlin, cpu)" in rec["metric"]
    assert rec["accum_rotations"] >= 1 and rec["compile_s"] > 0
