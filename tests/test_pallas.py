"""Fused Triton collide+stream kernel vs the pure-jnp oracle: interpret mode
on the CPU, the CUDA lowering checked without a card, and the compiled
kernel on the card (``gpu`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import W
from cuda_iblb_11_tpu.ops import ib_band
from cuda_iblb_11_tpu.ops import reference as ref
from cuda_iblb_11_tpu.ops import pallas_step
from cuda_iblb_11_tpu.ops.pallas_step import make_fused_substep

RNG = np.random.default_rng(11)


def _random_state(ydim, xdim, dtype, band=None):
    rho = 1.0 + 0.02 * RNG.standard_normal((ydim, xdim))
    u = 0.01 * RNG.standard_normal((2, ydim, xdim))
    f = np.asarray(ref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * RNG.standard_normal(f.shape) * np.asarray(W)[:, None, None]
    force = 1e-4 * RNG.standard_normal((2, band or ydim, xdim))
    return jnp.asarray(f, dtype), jnp.asarray(force, dtype)


def _oracle(cfg, f, force_band, walls=ref.REFERENCE_WALLS,
            forcing="trt_split", storage="raw"):
    force = ib_band.pad_band(force_band, cfg.ydim)
    return ref.lb_substep(f, force, cfg.tau, cfg.tau2, walls,
                          forcing=forcing, storage=storage)[0]


@pytest.mark.parametrize("ydim,xdim,block", [
    (32, 256, (8, 128)),   # several blocks each way
    (16, 128, (16, 128)),  # one block
    (24, 128, (8, 64)),    # 3 x 2 blocks
    (20, 96, (8, 64)),     # partial blocks in both directions
])
@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
def test_fused_matches_oracle(ydim, xdim, block, forcing):
    cfg = SimConfig(c_num=2, c_space=xdim // 2, ydim=ydim, dtype="float64")
    f, force = _random_state(ydim, xdim, jnp.float64)
    fused = make_fused_substep(cfg, dtype=jnp.float64, forcing=forcing,
                               interpret=True, block=block)
    got = np.asarray(fused(f, force))
    want = _oracle(cfg, f, force, forcing=forcing)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-15)


def test_fused_matches_oracle_noslip_top():
    ydim, xdim = 32, 128
    walls = ref.WallSpec(bottom="noslip", top="noslip")
    cfg = SimConfig(c_num=2, c_space=64, ydim=ydim, dtype="float64")
    f, force = _random_state(ydim, xdim, jnp.float64)
    fused = make_fused_substep(cfg, walls=walls, dtype=jnp.float64,
                               interpret=True, block=(8, 64))
    got = np.asarray(fused(f, force))
    want = _oracle(cfg, f, force, walls=walls)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("top", ["slip", "noslip"])
@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
@pytest.mark.parametrize("emit", [False, True])
def test_fused_matches_oracle_walls_storage_emit(top, storage, emit):
    # f64 in interpret mode: every wall set x storage mode, with and without
    # the band-moment output, on a grid taller than the force band
    ydim, xdim = 40, 96
    cfg = SimConfig(c_num=2, c_space=xdim // 2, ydim=ydim, length=8,
                    dtype="float64")
    walls = ref.WallSpec(top=top)
    f, force = _random_state(ydim, xdim, jnp.float64, cfg.force_band)
    if storage == "deviatoric":
        f = f - jnp.asarray(W)[:, None, None]
    fused = make_fused_substep(cfg, walls=walls, dtype=jnp.float64,
                               storage=storage, emit_moments=emit,
                               interpret=True, block=(16, 64))
    out = fused(f, force)
    got = out[0] if emit else out
    want = _oracle(cfg, f, force, walls=walls, storage=storage)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-15)
    if emit:
        rho, mom = ib_band.band_moments(want, cfg.force_band, storage)
        np.testing.assert_allclose(np.asarray(out[1][0]), np.asarray(rho),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(np.asarray(out[1][1:]), np.asarray(mom),
                                   rtol=1e-12, atol=1e-15)


def test_fused_multi_step_float32_accuracy():
    # 20 steps f32 fused vs f64 oracle on a small channel with force.
    ydim, xdim = 32, 128
    cfg = SimConfig(c_num=2, c_space=64, ydim=ydim, dtype="float64")
    f64, force64 = _random_state(ydim, xdim, jnp.float64)
    fused32 = make_fused_substep(cfg, dtype=jnp.float32, interpret=True,
                                 block=(8, 64))
    f32 = f64.astype(jnp.float32)
    for _ in range(20):
        f64 = _oracle(cfg, f64, force64)
        f32 = fused32(f32, force64)
    rel = float(jnp.linalg.norm(f32.astype(jnp.float64) - f64)
                / jnp.linalg.norm(f64))
    assert rel < 1e-5, rel


def test_band_smaller_than_grid():
    # force band < ydim: rows above the band must see exactly zero force.
    ydim, xdim = 64, 128
    cfg = SimConfig(c_num=2, c_space=64, ydim=ydim, length=16,
                    dtype="float64")  # force_band = 48 < 64
    assert cfg.force_band == 48
    f, force_band = _random_state(ydim, xdim, jnp.float64, cfg.force_band)
    fused = make_fused_substep(cfg, dtype=jnp.float64, interpret=True,
                               block=(16, 64))
    got = np.asarray(fused(f, force_band))
    want = _oracle(cfg, f, force_band)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-15)


def test_bf16_storage_interpret():
    # bf16 deviatoric storage with f32 in-kernel compute.
    ydim, xdim = 32, 256
    cfg = SimConfig(c_num=2, c_space=xdim // 2, ydim=ydim,
                    dtype="bfloat16")
    f32, force = _random_state(ydim, xdim, jnp.float32, cfg.force_band)
    w = jnp.asarray(np.asarray(W, np.float32))[:, None, None]
    fdev = (f32 - w).astype(jnp.bfloat16)
    fused = make_fused_substep(cfg, dtype=jnp.bfloat16, interpret=True,
                               storage="deviatoric", block=(16, 128))
    raw = fused(fdev, force)
    assert raw.dtype == jnp.bfloat16  # storage dtype round-trips
    got = np.asarray(raw).astype(np.float32)
    want = _oracle(cfg, fdev.astype(jnp.float32), force,
                   storage="deviatoric")
    # bf16 output rounding only: ~0.4% relative on the deviations
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=3e-3)


def test_bf16_needs_deviatoric_storage():
    cfg = SimConfig(c_num=2, c_space=64, ydim=16, dtype="bfloat16")
    with pytest.raises(ValueError, match="deviatoric"):
        make_fused_substep(cfg, dtype=jnp.bfloat16, storage="raw")


@pytest.mark.parametrize("walls", [
    ref.WallSpec(bottom="slip", top="slip"),
    ref.WallSpec(bottom="noslip", top="noslip", left="noslip",
                 right="noslip"),
])
def test_unsupported_walls_are_refused(walls):
    cfg = SimConfig(c_num=2, c_space=64, ydim=16)
    with pytest.raises(NotImplementedError):
        make_fused_substep(cfg, walls=walls)


@pytest.mark.parametrize("c_num,c_space,ydim,dtype,emit", [
    (6, 48, 192, jnp.float32, True),       # the reference's own channel
    (16, 128, 2048, jnp.float32, True),    # BASELINE 2048^2
    (6, 48, 192, jnp.bfloat16, False),
])
def test_kernel_lowers_for_cuda(c_num, c_space, ydim, dtype, emit):
    # the Triton lowering runs here without a card: one Triton custom call
    # over a (rows/BY, cols/BX) grid of independent programs
    cfg = SimConfig(c_num=c_num, c_space=c_space, ydim=ydim)
    k = make_fused_substep(cfg, dtype=dtype, storage="deviatoric",
                           emit_moments=emit)
    f = jax.ShapeDtypeStruct((9, cfg.ydim, cfg.xdim), dtype)
    g = jax.ShapeDtypeStruct((2, cfg.force_band, cfg.xdim), jnp.float32)
    txt = jax.jit(k).trace(f, g).lower(
        lowering_platforms=("cuda",)).as_text()
    assert txt.count("xla.gpu.triton") == 1
    by, bx = pallas_step.BLOCK
    assert f"grid_x = {-(-cfg.ydim // by)}" in txt
    assert f"grid_y = {-(-cfg.xdim // bx)}" in txt


@pytest.mark.gpu
@pytest.mark.parametrize("c_num,c_space,ydim", [(6, 48, 192),
                                                (16, 128, 2048)])
def test_compiled_kernel_matches_xla_on_gpu(gpu, c_num, c_space, ydim):
    cfg = SimConfig(c_num=c_num, c_space=c_space, ydim=ydim)
    f, force = _random_state(ydim, cfg.xdim, jnp.float32, cfg.force_band)
    fused = jax.jit(make_fused_substep(cfg, dtype=jnp.float32))
    want = jax.jit(lambda f, g: _oracle(cfg, f, g))(f, force)
    np.testing.assert_allclose(np.asarray(fused(f, force)),
                               np.asarray(want), rtol=0, atol=1e-6)
