"""chip_smoke.py refuses to print a result without a GPU or outside the
repository, and rehearses its phases on the CPU when asked."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_no_gpu_no_result():
    out = _run([], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no GPU" in out.stderr


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["--rehearse"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "repository" in out.stderr


def test_cpu_rehearsal_runs_every_phase():
    out = _run(["--rehearse", "--size", "96", "--reach-size", "64"], REPO)
    assert out.returncode == 3, out.stdout[-3000:] + out.stderr[-3000:]
    for phase in ("1 identify", "2 compile", "3 main path",
                  "4 against the native engine", "5 card gates",
                  "6 reach"):
        assert f"== {phase}: ok" in out.stdout
    assert '"ok"' not in out.stdout
