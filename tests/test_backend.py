"""The LB backend is chosen in one function (models/mucociliary.py:
resolve_backend) from what the code can observe: platform, shape, dtype
and walls.  Its pick and reason reach resolved_config() and SimLog."""

import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim, resolve_backend
from cuda_iblb_11_tpu.ops.reference import REFERENCE_WALLS, WallSpec

REF = SimConfig(c_num=6, c_space=48)                     # 192 x 288
BIG = SimConfig(c_num=16, c_space=128, ydim=2048)        # 2048 x 2048
CAVITY = WallSpec(bottom="noslip", top="moving", left="noslip",
                  right="noslip", u_wall=(0.1, 0.0))


@pytest.mark.parametrize("platform,cfg,dtype,walls,want,reason", [
    ("gpu", REF, "float32", REFERENCE_WALLS, "triton",
     "auto: gpu, float32, 192x288"),
    ("gpu", BIG, "float32", REFERENCE_WALLS, "triton",
     "auto: gpu, float32, 2048x2048"),
    ("gpu", BIG, "bfloat16", REFERENCE_WALLS, "triton",
     "auto: gpu, bfloat16, 2048x2048"),
    ("gpu", REF, "float64", REFERENCE_WALLS, "jnp",
     "auto: dtype float64 runs the jnp path"),
    ("gpu", REF, "float32", WallSpec(top="noslip"), "triton",
     "auto: gpu, float32, 192x288"),
    ("gpu", REF, "float32", CAVITY, "jnp",
     "auto: walls other than the reference channel"),
    ("cpu", REF, "float32", REFERENCE_WALLS, "jnp",
     "auto: platform is cpu; the fused kernel compiles only for gpu"),
    ("cpu", BIG, "float64", REFERENCE_WALLS, "jnp",
     "auto: platform is cpu; the fused kernel compiles only for gpu; "
     "dtype float64 runs the jnp path"),
])
def test_auto_pick_and_reason(platform, cfg, dtype, walls, want, reason):
    assert resolve_backend("auto", platform, cfg, dtype, walls) == (
        want, reason)


@pytest.mark.parametrize("requested,platform,dtype,interpret,want", [
    ("jnp", "gpu", "float32", False, "jnp"),
    ("jnp", "cpu", "float64", False, "jnp"),
    ("triton", "gpu", "float32", False, "triton"),
    ("triton", "gpu", "float64", False, "triton"),   # asked for explicitly
    ("triton", "cpu", "float64", True, "triton"),    # interpret mode (tests)
])
def test_explicit_backend_has_no_reason(requested, platform, dtype,
                                        interpret, want):
    assert resolve_backend(requested, platform, REF, dtype,
                           interpret=interpret) == (want, None)


@pytest.mark.parametrize("platform,walls,match", [
    ("cpu", REFERENCE_WALLS, "compiles only for gpu"),   # never interprets
    ("cpu", CAVITY, "walls other than the reference channel"),
    ("gpu", CAVITY, "walls other than the reference channel"),
])
def test_kernel_requested_where_it_cannot_run_is_an_error(platform, walls,
                                                          match):
    with pytest.raises(ValueError, match=match):
        resolve_backend("triton", platform, REF, "float32", walls)


@pytest.mark.parametrize("requested", ["pallas", "", "TRITON"])
def test_unknown_backend_is_an_error(requested):
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend(requested, "gpu", REF, "float32")


def test_sim_on_cpu_records_pick_and_reason():
    sim = MucociliarySim(REF, backend="auto")
    rc = sim.resolved_config()
    assert rc["backend"] == "jnp"
    assert rc["backend_reason"] == (
        "auto: platform is cpu; the fused kernel compiles only for gpu")
    with pytest.raises(ValueError, match="compiles only for gpu"):
        MucociliarySim(REF, backend="triton")
