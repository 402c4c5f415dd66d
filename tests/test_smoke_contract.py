"""The measurement scripts' contract off the card: ``chip_smoke.py`` and
``bench.py`` exit non-zero and print no result when JAX finds no GPU, and
``chip_smoke.py`` alone (without the package beside it) fails the same
way."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", ()),
    ("chip_smoke.py", ("--chips", "4")),
    ("bench.py", ("--batches", "64")),
    ("tools/bench_suite.py", ("--only", "latency")),
])
def test_fails_without_gpu(script, args):
    res = _run(ROOT / script, ROOT, *args)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr + res.stdout


def test_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
