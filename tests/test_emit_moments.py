"""The fused kernel's emitted band moments (ops/pallas_step.py,
emit_moments=True) must equal what the step would otherwise recompute from
f_new: ib_band.band_moments over the force band.  Checked in interpret mode,
including on a grid taller than the band and with wall-fixed rows (the
emitted moments must see the post-fixup state)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu.ops import ib_band
from cuda_iblb_11_tpu.ops.pallas_step import make_fused_substep

RNG = np.random.default_rng(7)


def _random_state(ydim, xdim, band, dtype):
    from cuda_iblb_11_tpu.core.lattice import W

    f = np.tile(np.asarray(W)[:, None, None], (1, ydim, xdim))
    f = f + 1e-4 * RNG.standard_normal(f.shape) * np.asarray(W)[:, None, None]
    force = 1e-4 * RNG.standard_normal((2, band, xdim))
    return jnp.asarray(f, dtype), jnp.asarray(force, dtype)


@pytest.mark.parametrize("ydim,xdim,block", [
    (32, 256, (8, 128)),     # band == ydim
    (192, 128, (16, 64)),    # band (136) < ydim: moments stop at the band
    (150, 96, (16, 64)),     # partial blocks; band ends inside a block
])
def test_emitted_moments_match_recompute(ydim, xdim, block):
    cfg = SimConfig(c_num=2, c_space=xdim // 2, ydim=ydim, dtype="float64")
    band = cfg.force_band
    f, force = _random_state(ydim, xdim, band, jnp.float64)
    plain = make_fused_substep(cfg, dtype=jnp.float64, interpret=True,
                               block=block)
    emit = make_fused_substep(cfg, dtype=jnp.float64, interpret=True,
                              block=block, emit_moments=True)
    f_ref = np.asarray(plain(f, force))
    f_new, q = emit(f, force)
    np.testing.assert_array_equal(np.asarray(f_new), f_ref)
    assert q.shape == (3, band, xdim)

    rho_ref, mom_ref = ib_band.band_moments(f_new, band)
    np.testing.assert_allclose(np.asarray(q[0]), np.asarray(rho_ref),
                               rtol=1e-13, atol=0)
    np.testing.assert_allclose(np.asarray(q[1:]), np.asarray(mom_ref),
                               rtol=1e-13, atol=1e-18)


def test_emit_step_matches_recompute_step():
    """A full MucociliarySim step with kernel emission equals the same step
    with emission disabled (fluid state exactly; force/q to round-off —
    only the moment summation trees differ)."""
    cfg = SimConfig(c_num=4, c_space=48, ydim=192, dtype="float64")
    sim_e = MucociliarySim(cfg, backend="triton", interpret=True)
    assert sim_e._emit
    sim_p = MucociliarySim(cfg, backend="triton", interpret=True)
    sim_p._emit = False
    sim_p._lb_substep = make_fused_substep(
        cfg, sim_p.walls, sim_p.dtype, forcing=sim_p.forcing,
        storage=sim_p.storage, interpret=True)
    st_e = sim_e.run_chunk(sim_e.init_state(), 4)
    st_p = sim_p.run_chunk(sim_p.init_state(), 4)
    np.testing.assert_allclose(np.asarray(st_e.f), np.asarray(st_p.f),
                               rtol=1e-13, atol=1e-16)
    np.testing.assert_allclose(np.asarray(st_e.force),
                               np.asarray(st_p.force), rtol=1e-11,
                               atol=1e-18)
    np.testing.assert_allclose(float(st_e.q), float(st_p.q), rtol=1e-11)
