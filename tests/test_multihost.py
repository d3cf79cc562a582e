"""Multi-host (multi-process) smoke test — VERDICT r2 item 4.

Two OS processes initialize jax.distributed over a local coordinator
(CPU backend, 4 virtual devices each -> one global 8-device (2, 4) mesh,
exactly what `iblb --distributed --mesh 2,4` does on a real pod), run the
sharded simulation, write/restore a multi-process orbax checkpoint, and
must agree BIT-FOR-BIT with each other and with the same mesh run as a
single process.  This turns the CLI's --distributed flag (cli.py) from an
untested flag into a tested path.
"""

import json
import os
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(mode, ckpt_dir, port=None, proc=0, nprocs=2, local_devices=8):
    env = dict(os.environ)
    env["MH_MODE"] = mode
    env["MH_CKPT"] = str(ckpt_dir)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    if mode == "dist":
        env["MH_COORD"] = f"localhost:{port}"
        env["MH_PROC"] = str(proc)
        env["MH_NPROCS"] = str(nprocs)
    return subprocess.Popen(
        [sys.executable, _WORKER], env=env, cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=420):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"worker failed:\n{err[-4000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def test_two_process_matches_single_process(tmp_path):
    single = _spawn("single", tmp_path / "ck_single")
    try:
        r_single = _result(single)
    finally:
        single.kill()
    assert r_single["resume_ok"], "single-process orbax resume diverged"

    port = _free_port()
    procs = [_spawn("dist", tmp_path / "ck_dist", port=port, proc=p,
                    local_devices=4) for p in range(2)]
    try:
        r0, r1 = (_result(p) for p in procs)
    finally:
        # a failing/hung rank must not leave its peer orphaned (blocked in
        # a collective, holding the coordinator port for later runs)
        for p in procs:
            p.kill()
        for p in procs:
            try:
                p.communicate(timeout=30)
            except Exception:  # noqa: BLE001
                pass
    assert r0["resume_ok"] and r1["resume_ok"], (
        "two-process orbax resume diverged")
    # both ranks see identical replicated scalars
    assert r0["q3"] == r1["q3"] and r0["q5"] == r1["q5"]
    assert r0["checksum"] == r1["checksum"]
    # and the two-process run reproduces the single-process mesh exactly
    assert r0["q3"] == r_single["q3"], (r0["q3"], r_single["q3"])
    assert r0["q5"] == r_single["q5"], (r0["q5"], r_single["q5"])
    assert r0["checksum"] == r_single["checksum"]
