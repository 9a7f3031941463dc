"""chip_smoke.py refuses to report a result without a GPU, and without
the rest of the repository beside it."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_cpu_backend():
    r = _run(REPO, dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_without_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, dict(env, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
