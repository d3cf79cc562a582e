"""--mesh auto: pick the most balanced (n_y, n_x) factorization of the
visible devices that divides the grid (pick + reason recorded in SimLog) —
the scale-out analogue of the reference's per-cluster launch scripts
hardcoding a geometry per machine (cilia6.sh:7-17).  Runs on the
8-virtual-device CPU mesh (conftest)."""

import os

import jax
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.runner import _make_sim, _resolve_auto_mesh, run

needs_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

CFG_SMALL = SimConfig(c_num=4, c_space=48, t_num=1.0, t_pow=5,
                      dtype="float32")


@needs_8_devices
@pytest.mark.parametrize("c_num,c_space,ydim,want", [
    (8, 128, 256, "2,4"),    # balanced wins; x-major on the (2,4)/(4,2) tie
    (8, 128, 191, "1,8"),    # prime ydim: only ny=1 divides
    (2, 97, 256, "4,2"),     # xdim=194 takes nx=2 but not nx=4
    (3, 65, 256, "8,1"),     # odd xdim: only nx=1
])
def test_auto_mesh_pick_per_grid(c_num, c_space, ydim, want):
    cfg = SimConfig(c_num=c_num, c_space=c_space, ydim=ydim, t_num=1.0,
                    t_pow=5, dtype="float32")
    mesh, reason = _resolve_auto_mesh(cfg)
    assert mesh == want, (mesh, reason)
    assert "balanced-first" in reason


def test_triton_backend_refuses_a_mesh():
    with pytest.raises(ValueError, match="one device"):
        _make_sim(CFG_SMALL, backend="triton", forcing="trt_split",
                  mesh="2,2")


@needs_8_devices
def test_auto_jnp_backend_picks_balanced():
    mesh, reason = _resolve_auto_mesh(CFG_SMALL)
    assert mesh == "2,4"
    assert "balanced-first" in reason


@needs_8_devices
def test_auto_sim_carries_pick_and_reason():
    sim = _make_sim(CFG_SMALL, backend="jnp", forcing="trt_split",
                    mesh="auto")
    assert sim.mesh_requested == "auto"
    assert sim.mesh_resolved == "2,4"
    assert sim.resolved_config()["mesh"] == [2, 4]
    assert "auto:" in sim.mesh_reason


@needs_8_devices
def test_runner_mesh_auto_records_pick_in_simlog(tmp_path):
    cfg = CFG_SMALL.replace(i_pow=0.0004, p_num=1)  # 40 steps
    out = run(cfg, output_root=str(tmp_path), quiet=True, backend="jnp",
              mesh="auto")
    assert out["resolved"]["mesh"] == [2, 4]
    log = open(os.path.join(str(tmp_path), "Raw", "4", "1",
                            "SimLog.txt")).read()
    assert "Mesh: 2,4 (auto:" in log


def test_auto_unsharded_when_nothing_divides():
    # prime ydim forces ny=1; odd xdim (3*49) rejects every nx>1 of 8
    cfg = SimConfig(c_num=3, c_space=49, ydim=191, t_num=1.0, t_pow=5,
                    dtype="float32")
    if len(jax.devices()) == 1:
        pytest.skip("needs >1 devices")
    mesh, reason = _resolve_auto_mesh(cfg)
    assert mesh is None
    assert "unsharded" in reason
