"""The float64 mode: the reference's own precision.

The reference computes in f64 end-to-end on the GPU (double throughout
LatticeBoltzmann.cu:30-411, ImmersedBoundary.cu:94-264).  Here `--dtype
float64` runs the jnp path in native f64, on the CPU and on the GPU alike;
chip_smoke.py compares the two on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

CFG64 = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")


def test_f64_without_x64_raises_actionably():
    """Without x64 every f64 array silently truncates to f32; the sim must
    refuse rather than run a fake 'high-precision' mode."""
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="x64"):
            MucociliarySim(CFG64, backend="jnp")
    finally:
        jax.config.update("jax_enable_x64", True)


def test_auto_backend_routes_f64_to_jnp():
    sim = MucociliarySim(CFG64, backend="auto")
    assert sim.backend == "jnp"
    assert "float64" in sim.backend_reason or "gpu" in sim.backend_reason
    assert sim.resolved_config()["dtype"] == "float64"


def test_f64_run_is_finite_and_f64(tmp_path):
    sim = MucociliarySim(CFG64, backend="jnp")
    st = sim.run_chunk(sim.init_state(), 8)
    assert st.f.dtype == jnp.float64
    assert bool(jnp.isfinite(st.f).all())


def test_cli_dtype_float64_enables_x64(tmp_path):
    """`--dtype float64` must enable x64 in-process (cli.py) so the run is
    genuinely f64."""
    from cuda_iblb_11_tpu import cli

    jax.config.update("jax_enable_x64", False)
    try:
        rc = cli.main(["1", "4", "48", "1.0", "1.0", "5", "0.0001", "1",
                       "0", "0", "--dtype", "float64",
                       "--output", str(tmp_path), "--quiet",
                       "--platform", "cpu"])
        assert rc == 0
        assert jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.gpu
def test_auto_backend_routes_f64_to_jnp_on_gpu(gpu):
    # on the card the kernel is available, and f64 still runs the jnp path
    sim = MucociliarySim(CFG64, backend="auto")
    assert sim.backend == "jnp"
    assert sim.backend_reason == "auto: dtype float64 runs the jnp path"
