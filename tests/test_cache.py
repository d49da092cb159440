"""Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
when set (and nothing else is set), else ``<checkout>/.jax_cache``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, richdem_tpu; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(jax.config.jax_persistent_cache_min_compile_time_secs)")


def _cache_config(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("RICHDEM_TPU_NO_COMPILE_CACHE", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_env_dir_is_used_as_is(tmp_path):
    cache_dir, _ = _cache_config(str(tmp_path))
    assert cache_dir == str(tmp_path)


def test_default_is_inside_the_checkout():
    cache_dir, min_secs = _cache_config(None)
    assert cache_dir == os.path.join(REPO, ".jax_cache")
    assert float(min_secs) == 1.0
