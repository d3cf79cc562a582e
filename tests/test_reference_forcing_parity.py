"""Short-horizon strict parity of the quirk-exact forcing="reference" mode.

The committed CUDA applies the uniform Guo prefactor (1 - 1/(2 TAU)) to all
populations (LatticeBoltzmann.cu:53-56), which makes the full model
IB-unstable at its own default parameters (see tests/test_stability.py and
ops/reference.guo_forcing): a cold start diverges by ~step 60-100.  That is
exactly why parity of the quirk mode across backends can only be asserted
on a short pre-blowup horizon — this test pins (a) jnp-oracle vs the fused
Triton kernel (interpret mode) agreement to f64 round-off at 48 steps and
(b) the documented divergence onset window of the full model (max|f| ~33
at step 60, NaN by step 100).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

CFG = SimConfig(c_num=4, c_space=48, ydim=256, dtype="float64",
                storage="raw")


@pytest.fixture(scope="module")
def pallas_48():
    sim = MucociliarySim(CFG, backend="triton", forcing="reference",
                         interpret=True)
    return sim.run_chunk(sim.init_state(), 48)


def test_reference_forcing_jnp_vs_pallas_short_horizon(pallas_48):
    a = MucociliarySim(CFG, backend="jnp", forcing="reference")
    sa = a.run_chunk(a.init_state(), 48)
    # f64 round-off class agreement (measured 2e-15 max abs at 48 steps)
    np.testing.assert_allclose(np.asarray(pallas_48.f), np.asarray(sa.f),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(float(pallas_48.q), float(sa.q), rtol=1e-12)


def test_reference_forcing_divergence_onset():
    # the documented instability: finite (already grown ~100x) at step 60,
    # non-finite by step 100 (LatticeBoltzmann.cu:53-56 scheme, default tau)
    sim = MucociliarySim(CFG, backend="jnp", forcing="reference")
    st = sim.run_chunk(sim.init_state(), 60)
    assert float(jnp.max(jnp.abs(st.f))) > 10.0
    st = sim.run_chunk(st, 40)
    assert not bool(jnp.isfinite(st.f).all())
