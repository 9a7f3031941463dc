"""The persistent compile cache lands where compile_cache.enable() says:
JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""

import json
import os
import subprocess
import sys

from mfcc_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from mfcc_tpu.utils import compile_cache
d = compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
before = set(os.listdir(d)) if os.path.isdir(d) else set()
n = int(sys.argv[1])
jax.block_until_ready(jax.jit(lambda x: jnp.cumsum(x * 3.0 + 1.0))(
    jnp.ones((n,), jnp.float32)))
after = set(os.listdir(d)) if os.path.isdir(d) else set()
print(json.dumps({"dir": d, "config": jax.config.jax_compilation_cache_dir,
                  "new": len(after - before)}))
"""


def _probe(env, n):
    env = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _PROBE, str(n)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_dir_unset_uses_checkout():
    env = {k: v for k, v in os.environ.items() if k != compile_cache.ENV}
    out = _probe(env, 1000 + os.getpid() % 50000)
    assert out["dir"] == compile_cache.DEFAULT_DIR
    assert out["dir"] == os.path.join(REPO, ".jax_cache")
    assert out["config"] == out["dir"]
    assert out["new"] >= 1


def test_cache_dir_env_is_used(tmp_path):
    d = str(tmp_path / "cache")
    out = _probe(dict(os.environ, **{compile_cache.ENV: d}), 777)
    assert out["dir"] == out["config"] == d
    assert out["new"] >= 1 and os.listdir(d)
