"""chip_smoke.py refuses to run without a GPU: it exits non-zero and
never prints its ``"ok": true`` line (on the CPU, and when the package
is not beside it)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_chip_smoke_fails_on_cpu():
    p = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert p.returncode != 0, p.stdout[-2000:]
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert p.returncode != 0, p.stdout[-2000:]
    assert '"ok": true' not in p.stdout
