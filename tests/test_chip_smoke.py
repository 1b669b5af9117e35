"""chip_smoke.py must refuse to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_on_cpu():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a gpu backend" in proc.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
