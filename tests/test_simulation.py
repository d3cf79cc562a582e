"""End-to-end mucociliary simulation: stability, determinism, physics."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu.ops import reference as ref

# Small/fast config: XDIM=192, T=10000 (10x the real beat rate — quickly
# visible motion while keeping boundary speeds well below the sound speed;
# T=1000 would make cilium tips supersonic and blow up, as the reference
# also would).
CFG = SimConfig(c_num=4, c_space=48, t_num=1.0, t_pow=4, dtype="float64")


@pytest.fixture(scope="module")
def sim():
    return MucociliarySim(CFG)


def test_initial_state(sim):
    st = sim.init_state()
    rho, u = ref.moments(st.f)
    np.testing.assert_allclose(np.asarray(rho), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(u), 0.0, atol=1e-15)
    assert float(st.q) == 0.0


def test_short_run_is_finite_and_active(sim):
    st = sim.init_state()
    st = sim.run_chunk(st, 20)
    f = np.asarray(st.f)
    assert np.all(np.isfinite(f))
    rho, u = sim.fields(st)
    rho = np.asarray(rho)
    assert np.all(rho > 0.5) and np.all(rho < 1.5)
    # IB force active after the first step.
    assert float(jnp.max(jnp.abs(st.force))) > 0
    # The fluid is moving.
    assert float(jnp.max(jnp.abs(u))) > 1e-8
    assert int(st.it) == 20
    assert np.isfinite(float(st.q))


def test_initial_cilia_snapshot_is_phase_zero(sim):
    # at the it=0 output boundary nothing has run: the snapshot must be
    # the phase-0 placement with zero velocity (the reference writes
    # 0-cilia.dat after define_filament(it=0)), NOT the wrapped phase T-1
    # that (it-1) % T would select
    s0, u0, eps0 = sim.boundary_fields(sim.init_state())
    pos0 = sim.cilia.positions(jnp.zeros((), jnp.int32))
    s_ref, u_ref, eps_ref = sim.cilia.place_and_mask(
        pos0, jnp.zeros_like(pos0))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s_ref),
                               rtol=0, atol=1e-12)
    assert float(jnp.abs(u0).max()) == 0.0
    np.testing.assert_array_equal(np.asarray(eps0), np.asarray(eps_ref))


def test_determinism(sim):
    st1 = sim.run_chunk(sim.init_state(), 10)
    st2 = sim.run_chunk(sim.init_state(), 10)
    np.testing.assert_array_equal(np.asarray(st1.f), np.asarray(st2.f))
    assert float(st1.q) == float(st2.q)


def test_chunk_equals_single_steps(sim):
    st_chunk = sim.run_chunk(sim.init_state(), 5)
    st = sim.init_state()
    for _ in range(5):
        st = sim.step(st)
    np.testing.assert_allclose(
        np.asarray(st_chunk.f), np.asarray(st.f), rtol=1e-11, atol=1e-16
    )
    np.testing.assert_allclose(float(st_chunk.q), float(st.q), rtol=1e-12)


def test_q_is_cumulative(sim):
    # Q is a running integral (reference never resets d_Q, main.cu:393):
    # continuing a state for 20 more steps must ACCUMULATE onto its q —
    # a per-chunk reset of q would break the equality below.
    st20 = sim.run_chunk(sim.init_state(), 20)
    q20 = float(st20.q)  # before the continuation (run_chunk donates)
    st40 = sim.run_chunk(sim.init_state(), 40)
    st20_20 = sim.run_chunk(st20, 20)
    assert np.isfinite(float(st40.q))
    np.testing.assert_allclose(float(st20_20.q), float(st40.q), rtol=1e-12)
    # and q genuinely grows (each step adds a flux sample)
    assert q20 != float(st40.q)
    assert abs(float(st20_20.q)) > abs(q20)


def test_float32_path_close_to_float64():
    sim64 = MucociliarySim(CFG)
    sim32 = MucociliarySim(CFG.replace(dtype="float32"))
    st64 = sim64.run_chunk(sim64.init_state(), 20)
    st32 = sim32.run_chunk(sim32.init_state(), 20)
    rho64, u64 = sim64.fields(st64)
    rho32, u32 = sim32.fields(st32)
    l2 = float(
        jnp.linalg.norm(u64 - u32.astype(jnp.float64))
        / jnp.linalg.norm(u64)
    )
    assert l2 < 1e-3, l2


def test_f32_velocity_noise_floor():
    # The precision design (deviatoric storage + f64 kinematics with
    # anchor/fraction position splitting + cancellation-free velocities)
    # must keep the f32 path within ~1e-5 of the f64 oracle over hundreds
    # of steps (BASELINE accuracy gate; naive f32 sits at ~5e-4).
    sim64 = MucociliarySim(SimConfig(c_num=4, c_space=48, dtype="float64"))
    sim32 = MucociliarySim(SimConfig(c_num=4, c_space=48, dtype="float32"))
    st64 = sim64.run_chunk(sim64.init_state(), 500)
    st32 = sim32.run_chunk(sim32.init_state(), 500)
    _, u64 = sim64.fields(st64)
    _, u32 = sim32.fields(st32)
    l2 = float(jnp.linalg.norm(u64 - u32.astype(jnp.float64))
               / jnp.linalg.norm(u64))
    assert l2 < 1.2e-5, l2


def test_bfloat16_fast_mode():
    # bf16 deviatoric storage: exploratory/fast mode — integral quantities
    # stay within ~1% of f32; the velocity field carries ~1-3% noise
    # (documented, never the default).
    simb = MucociliarySim(SimConfig(c_num=4, c_space=48, dtype="bfloat16"))
    sim32 = MucociliarySim(SimConfig(c_num=4, c_space=48, dtype="float32"))
    stb = simb.run_chunk(simb.init_state(), 200)
    st32 = sim32.run_chunk(sim32.init_state(), 200)
    assert stb.f.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(stb.f.astype(jnp.float32)).all())
    assert abs(float(stb.q) - float(st32.q)) < 0.02 * abs(float(st32.q))


def test_equal_sims_share_compiled_chunks():
    # sims built from equal arguments compare equal, so the jitted chunk
    # (self is static) is compiled once per process; any differing
    # argument keeps them apart
    cfg = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
    a = MucociliarySim(cfg, backend="jnp")
    b = MucociliarySim(cfg, backend="jnp")
    assert a == b and hash(a) == hash(b)
    for other in (MucociliarySim(cfg, backend="jnp", forcing="reference"),
                  MucociliarySim(cfg, backend="jnp", ib_x_edge="reference"),
                  MucociliarySim(cfg.replace(c_space=50), backend="jnp"),
                  MucociliarySim(cfg, backend="jnp", pattern="mucus")):
        assert a != other
    a.run_chunk(a.init_state(), 3)
    before = MucociliarySim._run_scan._cache_size()
    b.run_chunk(b.init_state(), 3)
    assert MucociliarySim._run_scan._cache_size() == before
