"""The GPU measurement scripts refuse to run without a GPU: no fallback to
the CPU, and no result line."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(name):
    r = _run(REPO / name, REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert "{" not in r.stdout


def test_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout
