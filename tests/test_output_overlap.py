"""Compute/output overlap: interval snapshots ride a worker thread under
the next chunk's device compute — the counterpart of
the reference's dedicated output stream (main.cu:793-809 o_stream/events,
:938-996 snapshots while the next iterations' kernels are queued).

Contract pinned here:
  * snapshots are byte-identical with overlap on vs off (the fields are
    computed from the pre-chunk state either way);
  * the npz snapshot format is EXACTLY text-recoverable;
  * worker errors are never silently dropped;
  * the summary carries an end-to-end MLUPS (incl. interval I/O) — the
    basis the reference's own 0.62 MLUPS number is on.
"""

import os

import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.io.writers import (
    OutputPaths, write_fluid_snapshot, write_fluid_snapshot_npz,
    write_cilia_snapshot, write_cilia_snapshot_npz,
)
from cuda_iblb_11_tpu.runner import _SnapshotPipeline, run

CFG = SimConfig(c_num=4, c_space=48, t_num=1.0, t_pow=5, i_pow=0.004,
                p_num=4, bigdata=True, dtype="float32")
# ITERATIONS = 400, INTERVAL = 100


def _snapshot_files(root):
    out = {}
    for sub in ("Raw", "Cilia"):
        base = os.path.join(root, sub)
        for dirpath, _, names in os.walk(base):
            for n in names:
                if n.endswith((".dat", ".npz")) and "-" in n:
                    rel = os.path.relpath(os.path.join(dirpath, n), root)
                    out[rel] = os.path.join(dirpath, n)
    return out


def test_overlap_snapshots_byte_identical(tmp_path):
    a = run(CFG, output_root=str(tmp_path / "ov"), quiet=True, overlap=True)
    b = run(CFG, output_root=str(tmp_path / "ser"), quiet=True,
            overlap=False)
    np.testing.assert_allclose(a["q_final"], b["q_final"], rtol=0)
    fa = _snapshot_files(str(tmp_path / "ov"))
    fb = _snapshot_files(str(tmp_path / "ser"))
    assert fa.keys() == fb.keys() and len(fa) == 8  # 4 fluid + 4 cilia
    for rel in fa:
        assert open(fa[rel], "rb").read() == open(fb[rel], "rb").read(), rel


def test_npz_snapshot_exactly_text_recoverable(tmp_path):
    # the npz stores RAW fields + the scale factors the text writer
    # applies, so regenerating the text from the npz payload must be
    # byte-identical to writing the text directly
    rng = np.random.default_rng(0)
    cfg = CFG
    rho = 1.0 + 0.01 * rng.standard_normal((cfg.ydim, cfg.xdim))
    u = 0.01 * rng.standard_normal((2, cfg.ydim, cfg.xdim))
    write_fluid_snapshot(str(tmp_path / "direct.dat"), cfg,
                         rho.astype(np.float32), u.astype(np.float32))
    write_fluid_snapshot_npz(str(tmp_path / "f.npz"), cfg,
                             rho.astype(np.float32), u.astype(np.float32))
    z = np.load(tmp_path / "f.npz")
    assert float(z["x_scale"]) == cfg.x_scale
    write_fluid_snapshot(str(tmp_path / "recovered.dat"), cfg,
                         z["rho"], z["u"])
    assert (open(tmp_path / "direct.dat", "rb").read()
            == open(tmp_path / "recovered.dat", "rb").read())

    ns = 5 * cfg.c_num * 2
    s = rng.standard_normal((ns, 2)).astype(np.float32)
    u_s = rng.standard_normal((ns, 2)).astype(np.float32)
    eps = rng.random(ns).astype(np.float32)
    write_cilia_snapshot(str(tmp_path / "c_direct.dat"), cfg, s, u_s, eps)
    write_cilia_snapshot_npz(str(tmp_path / "c.npz"), cfg, s, u_s, eps)
    zc = np.load(tmp_path / "c.npz")
    write_cilia_snapshot(str(tmp_path / "c_recovered.dat"), cfg,
                         zc["s"], zc["u_s"], zc["eps"])
    assert (open(tmp_path / "c_direct.dat", "rb").read()
            == open(tmp_path / "c_recovered.dat", "rb").read())


def test_runner_writes_npz_snapshots(tmp_path):
    out = run(CFG, output_root=str(tmp_path), quiet=True,
              snapshot_format="npz")
    raw = os.path.join(str(tmp_path), "Raw", "4", "1")
    cil = os.path.join(str(tmp_path), "Cilia", "4", "1")
    for it in (0, 100, 200, 300):
        z = np.load(os.path.join(raw, f"{it}-fluid.npz"))
        assert z["rho"].shape == (CFG.ydim, CFG.xdim)
        assert z["u"].shape == (2, CFG.ydim, CFG.xdim)
        zc = np.load(os.path.join(cil, f"{it}-cilia.npz"))
        assert zc["s"].shape[1] == 2
    assert not os.path.exists(os.path.join(raw, "0-fluid.dat"))
    assert out["iterations"] == 400


def test_end_to_end_mlups_recorded(tmp_path):
    out = run(CFG, output_root=str(tmp_path), quiet=True)
    assert 0 < out["mlups_end_to_end"] <= out["mlups"] * 1.01
    log = open(os.path.join(str(tmp_path), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert "End-to-end MLUPS (incl. interval I/O):" in log


def test_worker_write_errors_surface(tmp_path):
    # a failed write on the worker thread must raise, not vanish
    paths = OutputPaths(str(tmp_path / "out"), CFG)
    # directories deliberately NOT created
    snap = _SnapshotPipeline(paths, CFG, fmt="npz", overlap=True)
    rho = np.ones((CFG.ydim, CFG.xdim), np.float32)
    u = np.zeros((2, CFG.ydim, CFG.xdim), np.float32)
    s = np.zeros((4, 2), np.float32)
    eps = np.zeros(4, np.float32)
    snap.submit(0, rho, u, s, s, eps)
    with pytest.raises(OSError):
        snap.close()


def test_overlap_auto_policy(monkeypatch):
    """--overlap auto: on for npz always; off for the text format only when
    the process may use at most two cores, so the formatter has no spare
    core (the reference's o_stream formatting always had one,
    main.cu:793-809).  Explicit requests — bools from API callers, on/off
    from the CLI — always win."""
    from cuda_iblb_11_tpu.runner import _resolve_overlap

    # the cores this process may run on, not the machine's total
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    on, reason = _resolve_overlap("auto", "npz")
    assert on and reason.startswith("auto")
    off, reason = _resolve_overlap("auto", "dat")
    assert not off and "core" in reason

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    assert _resolve_overlap("auto", "dat")[0]

    # explicit requests are never overridden
    assert _resolve_overlap(True, "dat") == (True, "requested")
    assert _resolve_overlap(False, "npz") == (False, "requested")
    assert _resolve_overlap("on", "dat")[0]
    assert not _resolve_overlap("off", "npz")[0]
    with pytest.raises(ValueError):
        _resolve_overlap("maybe", "dat")


def test_overlap_auto_pick_recorded(tmp_path):
    """The resolved overlap mode + reason land in the run summary and the
    SimLog (the resolved-config contract: every auto policy is
    reproducible from the run's own artifacts)."""
    out = run(CFG, output_root=str(tmp_path), quiet=True,
              snapshot_format="npz", overlap="auto")
    assert out["snapshot_overlap"] is True
    assert out["snapshot_overlap_reason"].startswith("auto")
    log = open(os.path.join(str(tmp_path), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert "Snapshot overlap: on (auto" in log
