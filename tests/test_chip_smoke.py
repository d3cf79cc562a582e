"""Off the card, `chip_smoke.py` and `bench.py` must fail and print no
result: a run that finds no GPU, or no copy of the package beside the
script, never reports success."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0, proc.stdout
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


@pytest.mark.parametrize("args", [[], ["--four-gpus"]])
def test_chip_smoke_without_gpu_fails(args):
    _no_result(_run(["chip_smoke.py"] + args, REPO))


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    _no_result(proc)
    assert "cuda_iblb_11_tpu" in proc.stderr


def test_bench_without_gpu_fails():
    proc = _run(["bench.py"], REPO)
    _no_result(proc)
    assert "needs a GPU" in proc.stderr
