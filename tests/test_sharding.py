"""Multi-chip spatial decomposition: N-shard runs must reproduce the
single-device oracle (BASELINE config 5, tested on a virtual CPU mesh)."""

import jax
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu.parallel.sharded import ShardedMucociliarySim, make_mesh

CFG = SimConfig(c_num=4, c_space=48, t_num=1.0, t_pow=5, dtype="float64")

needs_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@needs_8_devices
@pytest.mark.parametrize("n_y,n_x", [(1, 4), (2, 2), (2, 4), (4, 2)])
def test_sharded_matches_unsharded(n_y, n_x):
    mesh = make_mesh(n_y, n_x)
    ssim = ShardedMucociliarySim(CFG, mesh)
    usim = MucociliarySim(CFG)

    sst = ssim.run(ssim.init_state(), 8)
    ust = usim.init_state()
    for _ in range(8):
        ust = usim.step(ust)

    np.testing.assert_allclose(
        np.asarray(sst.f), np.asarray(ust.f), rtol=1e-12, atol=1e-15)
    # sharded force is full-size; single-chip stores the nonzero band only
    band = CFG.force_band
    sforce = np.asarray(sst.force)
    np.testing.assert_allclose(
        sforce[:, :band], np.asarray(ust.force), rtol=1e-9, atol=1e-18)
    assert np.all(sforce[:, band:] == 0)
    np.testing.assert_allclose(float(sst.q), float(ust.q), rtol=1e-10)
    assert int(sst.it) == int(ust.it) == 8


@needs_8_devices
def test_shard_count_invariance():
    st_a = ShardedMucociliarySim(CFG, make_mesh(1, 2))
    st_b = ShardedMucociliarySim(CFG, make_mesh(2, 4))
    a = st_a.run(st_a.init_state(), 5)
    b = st_b.run(st_b.init_state(), 5)
    np.testing.assert_allclose(
        np.asarray(a.f), np.asarray(b.f), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(a.q), float(b.q), rtol=1e-10)


@needs_8_devices
def test_sharded_is_actually_sharded():
    mesh = make_mesh(2, 4)
    ssim = ShardedMucociliarySim(CFG, mesh)
    st = ssim.init_state()
    # f must be distributed over the 8 devices, one block each.
    assert len(st.f.sharding.device_set) == 8
    st = ssim.step(st)
    assert len(st.f.sharding.device_set) == 8


@needs_8_devices
def test_sharded_rejects_unsupported_walls():
    # The local wall fixups only implement the reference channel; anything
    # else must fail loudly instead of silently simulating fully periodic.
    from cuda_iblb_11_tpu.ops.reference import WallSpec

    with pytest.raises(NotImplementedError):
        ShardedMucociliarySim(
            CFG, make_mesh(2, 2),
            walls=WallSpec(bottom="slip", top="slip", left="periodic",
                           right="periodic"))
    with pytest.raises(NotImplementedError):
        ShardedMucociliarySim(
            CFG, make_mesh(2, 2),
            walls=WallSpec(bottom="noslip", top="noslip", left="noslip",
                           right="noslip"))


@needs_8_devices
def test_sharded_chunk_equals_steps():
    s1 = ShardedMucociliarySim(CFG, make_mesh(2, 4))
    a = s1.run(s1.init_state(), 5)
    b = s1.run_chunk(s1.init_state(), 5)
    np.testing.assert_array_equal(np.asarray(a.f), np.asarray(b.f))
    assert float(a.q) == float(b.q)


@needs_8_devices
def test_sharded_quirk_x_edge_matches_single_device():
    # strict-parity IB x-edge quirk (ImmersedBoundary.cu:119-124 aliasing +
    # :178-231 dropped periodic images) on the jnp sharded path: N-shard
    # quirk runs must reproduce the single-device quirk run, so parity
    # studies of the committed CUDA can run at scale (VERDICT r2 gap 1)
    a = MucociliarySim(CFG, backend="jnp", ib_x_edge="reference")
    sa = a.run_chunk(a.init_state(), 8)
    ssim = ShardedMucociliarySim(CFG, make_mesh(2, 4),
                                 ib_x_edge="reference")
    sb = ssim.run_chunk(ssim.init_state(), 8)
    np.testing.assert_allclose(
        np.asarray(sb.f), np.asarray(sa.f), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(sb.q), float(sa.q), rtol=1e-11,
                               atol=1e-16)
    # and the quirk genuinely bites on this geometry (cilia wrap the
    # x edge): it must differ from the periodic-wrap default
    p = MucociliarySim(CFG, backend="jnp")
    sp = p.run_chunk(p.init_state(), 8)
    assert float(np.abs(np.asarray(sp.f) - np.asarray(sa.f)).max()) > 1e-12


@needs_8_devices
def test_sharded_bf16_keeps_f32_boundary_and_force():
    # bf16 fluid storage must NOT quantize the IB boundary data or the
    # carried force field (same invariant as MucociliarySim.aux_dtype);
    # the jnp sharded chunk path used to allocate a bf16 force inside the
    # fori_loop body (carry dtype mismatch) and built the cilia model at
    # the storage dtype (bf16 point positions are tens of cells off at
    # wide grids)
    import jax.numpy as jnp

    cfgb = SimConfig(c_num=4, c_space=48, dtype="bfloat16")
    sim = ShardedMucociliarySim(cfgb, make_mesh(2, 2))
    assert sim.cilia.dtype == jnp.float32
    st = sim.run_chunk(sim.init_state(), 3)
    assert st.force.dtype == jnp.float32
    assert np.isfinite(np.asarray(st.f, np.float32)).all()

@needs_8_devices
@pytest.mark.parametrize("ib_x_edge", ["periodic", "reference"])
@pytest.mark.parametrize("n_y,n_x", [(2, 1), (2, 2), (2, 4), (4, 2), (8, 1)])
def test_sharded_mesh_matches_single_device(n_y, n_x, ib_x_edge):
    # 2-D meshes, shards thinner than the force band (8 x 32 rows) and the
    # strict-parity IB quirk: the sharded chunk must reproduce the
    # single-device run up to the order of the psum reductions.
    cfg = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw",
                    ydim=256)
    usim = MucociliarySim(cfg, backend="jnp", ib_x_edge=ib_x_edge)
    ssim = ShardedMucociliarySim(cfg, make_mesh(n_y, n_x),
                                 ib_x_edge=ib_x_edge)
    ust = usim.run_chunk(usim.init_state(), 4)
    sst = ssim.run_chunk(ssim.init_state(), 4)
    np.testing.assert_allclose(
        np.asarray(sst.f), np.asarray(ust.f), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(sst.force)[:, :cfg.force_band], np.asarray(ust.force),
        rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(float(sst.q), float(ust.q), rtol=1e-10)


@needs_8_devices
def test_sharded_bf16_matches_single_chip_bf16():
    # bf16 fluid storage on a 2-D mesh: the sharded run quantizes f to
    # bf16 each step like the single-chip bf16 path, so agreement is
    # within a few bf16 ulps, and the aux quantities stay f32.
    import jax.numpy as jnp

    cfgb = SimConfig(c_num=2, c_space=128, ydim=256, dtype="bfloat16")
    usim = MucociliarySim(cfgb, backend="jnp")
    ssim = ShardedMucociliarySim(cfgb, make_mesh(2, 2))
    ust = usim.run_chunk(usim.init_state(), 4)
    sst = ssim.run_chunk(ssim.init_state(), 4)
    assert sst.f.dtype == jnp.bfloat16
    assert sst.force.dtype == jnp.float32
    assert sst.lasts.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(sst.f, dtype=np.float32),
        np.asarray(ust.f, dtype=np.float32), rtol=0.05, atol=1e-2)
    np.testing.assert_allclose(float(sst.q), float(ust.q), rtol=0.05,
                               atol=1e-7)
