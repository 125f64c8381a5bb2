"""The persistent compilation cache lands where the environment says."""

import os
import subprocess
import sys

from npge_tpu.util.jaxcache import DEFAULT_DIR

_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from npge_tpu.util.jaxcache import enable_compilation_cache\n"
    "print(enable_compilation_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda x: (x * x + 7).sum())(jnp.arange(11)).block_until_ready()\n"
)


def _probe(env):
    root = os.path.dirname(DEFAULT_DIR)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=root,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_cache_dir_env_is_used_exactly(tmp_path):
    d = str(tmp_path / "cc")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=d)
    assert _probe(env) == [d, d]
    # entries sit in that directory itself, not in a per-backend subdir
    assert any(f.startswith("jit_") for f in os.listdir(d))


def test_cache_dir_defaults_to_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert DEFAULT_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    assert _probe(env) == [DEFAULT_DIR, DEFAULT_DIR]
    assert any(f.startswith("jit_") for f in os.listdir(DEFAULT_DIR))
