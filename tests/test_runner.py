"""End-to-end runner: artifacts, checkpoint/resume equivalence."""

import os

import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.runner import run

CFG = SimConfig(c_num=4, c_space=48, t_num=1.0, t_pow=5, i_pow=0.004,
                p_num=4, bigdata=True, dtype="float32")
# ITERATIONS = 400, INTERVAL = 100


def test_runner_artifacts(tmp_path):
    out = run(CFG, output_root=str(tmp_path), quiet=True)
    assert out["iterations"] == 400
    flux = np.loadtxt(out["flux_path"])
    assert flux.shape == (5, 2)  # samples at it=0,100,200,300 + final row
    assert np.all(np.diff(flux[:, 0]) > 0)
    # snapshots written at each interval
    raw = os.path.join(str(tmp_path), "Raw", "4", "1")
    assert os.path.exists(os.path.join(raw, "0-fluid.dat"))
    assert os.path.exists(os.path.join(raw, "300-fluid.dat"))
    assert os.path.exists(os.path.join(raw, "SimLog.txt"))
    cilia = os.path.join(str(tmp_path), "Cilia", "4", "1")
    assert os.path.exists(os.path.join(cilia, "300-cilia.dat"))
    log = open(os.path.join(raw, "SimLog.txt")).read()
    assert "Size: 192x192" in log
    assert "Completion time:" in log
    assert "Total runtime:" in log


def test_checkpoint_resume_equivalence(tmp_path):
    # Straight 400-step run vs 200 steps + resume-from-checkpoint.
    a = run(CFG, output_root=str(tmp_path / "a"), quiet=True)

    cfg_half = CFG.replace(i_pow=0.002)  # 200 iterations
    run(cfg_half, output_root=str(tmp_path / "b"), quiet=True,
        checkpoint_every=200)
    ck = os.path.join(str(tmp_path / "b"), "Raw", "4", "1", "checkpoint.npz")
    assert os.path.exists(ck)
    b = run(CFG, output_root=str(tmp_path / "b2"), quiet=True,
            resume_from=ck)
    assert b["iterations"] == 400
    np.testing.assert_allclose(a["q_final"], b["q_final"], rtol=1e-6)


def test_resume_preserves_flux_series_and_simlog(tmp_path):
    # Resuming INTO the same output root must keep the flux rows written
    # before the checkpoint and append to SimLog (ADVICE round 1: run()
    # used to truncate both).
    a = run(CFG, output_root=str(tmp_path / "a"), quiet=True)
    flux_a = np.loadtxt(a["flux_path"])

    # Emulate an interrupted run: same interval (100) but stop at it=200.
    cfg_half = CFG.replace(i_pow=0.002, p_num=2)
    run(cfg_half, output_root=str(tmp_path / "b"), quiet=True,
        checkpoint_every=200)
    ck = os.path.join(str(tmp_path / "b"), "Raw", "4", "1", "checkpoint.npz")
    b = run(CFG, output_root=str(tmp_path / "b"), quiet=True,
            resume_from=ck)
    flux_b = np.loadtxt(b["flux_path"])
    assert flux_b.shape == flux_a.shape  # rows 0..200 preserved, rest appended
    np.testing.assert_allclose(flux_b, flux_a, rtol=1e-5, atol=1e-12)
    log = open(os.path.join(str(tmp_path / "b"), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert "Size: 192x192" in log          # original header survived
    assert "Resumed from checkpoint" in log


def test_profile_dir_writes_trace(tmp_path):
    # --profile-dir captures a jax.profiler trace of the first interval
    # (the reference's only tracing was a wall-clock timer, seconds.cpp).
    prof = tmp_path / "trace"
    cfg = CFG.replace(i_pow=0.001, p_num=1, bigdata=False)  # 100 steps
    run(cfg, output_root=str(tmp_path / "out"), quiet=True,
        profile_dir=str(prof))
    found = list(prof.rglob("*.xplane.pb")) + list(prof.rglob("*.trace*"))
    assert found, f"no profiler artifacts under {prof}"


def test_checkpoint_cadence_not_interval_aligned(tmp_path):
    # checkpoint_every=250 with interval=100: the old `it % every == 0`
    # test never fired; the steps-since-last-save rule saves at it=300.
    import cuda_iblb_11_tpu.io.checkpoint as ckpt

    run(CFG, output_root=str(tmp_path), quiet=True, checkpoint_every=250)
    ck = os.path.join(str(tmp_path), "Raw", "4", "1", "checkpoint.npz")
    assert os.path.exists(ck)
    state, _ = ckpt.load(ck, CFG)
    assert int(state.it) == 300


def test_resume_flux_rows_interval_change(tmp_path):
    # Rows are preserved by TIME stamp: resuming with a different output
    # interval (allowed — p_num/i_pow are not state fields) must keep all
    # rows up to the checkpoint, not it0 // new_interval of them.
    from cuda_iblb_11_tpu.io.writers import FluxWriter
    from cuda_iblb_11_tpu.runner import _resume_flux_rows

    cfg = SimConfig(c_num=4, c_space=48)
    path = str(tmp_path / "flux.dat")
    w = FluxWriter(path, cfg)
    for it in range(0, 501, 10):  # saved run's interval = 10
        w.append(it, it * 0.5)

    # resume at it0=500 with interval 20: 500 is a boundary -> the loop
    # rewrites its row; all 50 earlier rows survive
    assert _resume_flux_rows(path, cfg, 500, 20) == 50
    # resume at it0=505 (not a boundary of interval 20): the row at 500
    # is kept as well, and the run appends from the next boundary
    assert _resume_flux_rows(path, cfg, 505, 20) == 51
    # rows written past the checkpoint by the interrupted run are dropped
    assert _resume_flux_rows(path, cfg, 300, 20) == 30
    # missing file: nothing to keep
    assert _resume_flux_rows(str(tmp_path / "none.dat"), cfg, 500, 20) == 0


def test_npz_checkpoint_save_is_atomic(tmp_path):
    # A save over an existing checkpoint must go through a temp file +
    # os.replace, leaving no .tmp behind and a loadable archive.
    import jax.numpy as jnp

    import cuda_iblb_11_tpu.io.checkpoint as ckpt
    from cuda_iblb_11_tpu.core.state import FlowState

    cfg = SimConfig(c_num=4, c_space=48)
    st = FlowState(
        f=jnp.zeros((9, cfg.ydim, cfg.xdim), jnp.float32),
        force=jnp.zeros((2, cfg.force_band, cfg.xdim), jnp.float32),
        lasts=jnp.zeros((cfg.c_num, cfg.length, 2), jnp.float32),
        q=jnp.zeros(()), it=jnp.asarray(7))
    path = str(tmp_path / "checkpoint.npz")
    ckpt.save(path, st, cfg)
    ckpt.save(path, st._replace(it=jnp.asarray(9)), cfg)  # overwrite
    assert not os.path.exists(path + ".tmp")
    st2, _ = ckpt.load(path, cfg)
    assert int(st2.it) == 9


def test_sharc_device_selection(tmp_path):
    # ShARC flag = reference's cudaSetDevice(3) (main.cu:395-396): the
    # single-device run pins to device index 3 when one exists (the CPU
    # test backend exposes 8 virtual devices) and records it in SimLog.
    import jax

    from cuda_iblb_11_tpu.runner import _select_device

    cfg = CFG.replace(sharc=True, bigdata=False, i_pow=0.0005, p_num=1)
    assert _select_device(cfg) == jax.devices()[3]
    assert _select_device(cfg.replace(sharc=False)) is None
    assert _select_device(cfg, mesh="2,4") is None  # mesh spans devices

    run(cfg, output_root=str(tmp_path), quiet=True)
    log = open(os.path.join(str(tmp_path), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert str(jax.devices()[3]) in log


def test_simlog_records_resolved_config(tmp_path):
    # VERDICT r3: SimLog must record the RESOLVED execution configuration
    # (actual backend after every auto decision), not just the requested
    # one — the analogue of the reference logging its real launch config
    # (main.cu:782-783).  On CPU, backend=auto resolves to the jnp path;
    # the log must say so and why.
    cfg = CFG.replace(i_pow=0.0001, p_num=1, bigdata=False)  # 10 steps
    out = run(cfg, output_root=str(tmp_path), backend="auto", quiet=True)
    log = open(os.path.join(str(tmp_path), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert "Backend: auto" in log                  # requested
    assert "Resolved backend: jnp" in log          # actual
    assert "compiles only for gpu" in log          # why
    assert "Storage: " in log
    assert "IB path: band_matmul" in log
    assert out["resolved"]["backend"] == "jnp"


@pytest.mark.parametrize("n,max_scan,want", [
    (10, 4, [4, 4, 2]),   # remainder chunk
    (8, 4, [4, 4]),       # exact multiple
    (3, 4, [3]),          # shorter than one chunk
    (0, 4, []),
])
def test_run_chunk_splits_at_max_scan(n, max_scan, want, monkeypatch):
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    sim = MucociliarySim(SimConfig(c_num=4, c_space=48, dtype="float64",
                                   storage="raw"), backend="jnp")
    calls = []
    real = sim._run_scan

    def spy(state, k):
        calls.append(k)
        return real(state, k)

    monkeypatch.setattr(sim, "_MAX_SCAN", max_scan)
    monkeypatch.setattr(sim, "_run_scan", spy)
    st = sim.run_chunk(sim.init_state(), n)
    assert calls == want
    assert int(st.it) == n


def test_run_chunk_split_matches_one_scan(monkeypatch):
    # splitting a chunk at _MAX_SCAN changes nothing but the compiled
    # scan lengths: the kinematics restart from state.it and lasts
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    cfg = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
    one = MucociliarySim(cfg, backend="jnp")
    a = one.run_chunk(one.init_state(), 7)
    split = MucociliarySim(cfg, backend="jnp")
    monkeypatch.setattr(split, "_MAX_SCAN", 3)
    b = split.run_chunk(split.init_state(), 7)
    np.testing.assert_allclose(np.asarray(b.f), np.asarray(a.f),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(b.lasts), np.asarray(a.lasts),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(b.q), float(a.q), rtol=1e-12)


