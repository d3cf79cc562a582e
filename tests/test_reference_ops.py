"""Unit tests for the pure-jnp LB oracle against closed forms computed
independently per cell (straight from the equations, scalar math)."""

import jax.numpy as jnp
import numpy as np

from cuda_iblb_11_tpu.core.lattice import C, CS_KERNEL, OPPOSITE, W
from cuda_iblb_11_tpu.ops import reference as ref

RNG = np.random.default_rng(7)
CS2 = CS_KERNEL**2
CS4 = CS2**2


def scalar_equilibrium(rho, ux, uy):
    f0 = np.zeros(9)
    for i in range(9):
        cu = C[i, 0] * ux + C[i, 1] * uy
        f0[i] = rho * W[i] * (
            1 + cu / CS2 + cu * cu / (2 * CS4) - (ux * ux + uy * uy) / (2 * CS2)
        )
    return f0


def scalar_guo(ux, uy, fx, fy, tau):
    F = np.zeros(9)
    for i in range(9):
        cu = C[i, 0] * ux + C[i, 1] * uy
        vx = (C[i, 0] - ux) / CS2 + cu * C[i, 0] / CS4
        vy = (C[i, 1] - uy) / CS2 + cu * C[i, 1] / CS4
        F[i] = (1 - 1 / (2 * tau)) * W[i] * (vx * fx + vy * fy)
    return F


def scalar_trt(f, f0, F, tau, tau2):
    wp, wm = 1 / tau, 1 / tau2
    f1 = np.zeros(9)
    f1[0] = f[0] - wp * (f[0] - f0[0])  # rest: BGK, no forcing
    for i in range(1, 9):
        o = OPPOSITE[i]
        fp = (f[i] + f[o]) / 2
        fm = (f[i] - f[o]) / 2
        f0p = (f0[i] + f0[o]) / 2
        f0m = (f0[i] - f0[o]) / 2
        f1[i] = f[i] - wp * (fp - f0p) - wm * (fm - f0m) + F[i]
    return f1


def test_equilibrium_matches_scalar():
    rho = RNG.uniform(0.9, 1.1, (3, 4))
    u = RNG.uniform(-0.05, 0.05, (2, 3, 4))
    f0 = np.asarray(ref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    for y in range(3):
        for x in range(4):
            np.testing.assert_allclose(
                f0[:, y, x],
                scalar_equilibrium(rho[y, x], u[0, y, x], u[1, y, x]),
                rtol=1e-14,
            )


def test_guo_forcing_matches_scalar():
    u = RNG.uniform(-0.05, 0.05, (2, 2, 3))
    force = RNG.uniform(-1e-3, 1e-3, (2, 2, 3))
    tau = 2.8068
    F = np.asarray(ref.guo_forcing(jnp.asarray(u), jnp.asarray(force), tau))
    for y in range(2):
        for x in range(3):
            np.testing.assert_allclose(
                F[:, y, x],
                scalar_guo(u[0, y, x], u[1, y, x],
                           force[0, y, x], force[1, y, x], tau),
                rtol=1e-13, atol=1e-18,
            )


def test_trt_matches_scalar():
    f = RNG.uniform(0.01, 0.2, (9, 2, 2))
    f0 = RNG.uniform(0.01, 0.2, (9, 2, 2))
    F = RNG.uniform(-1e-4, 1e-4, (9, 2, 2))
    tau, tau2 = 2.8068, 0.53612
    f1 = np.asarray(
        ref.trt_collide(jnp.asarray(f), jnp.asarray(f0), jnp.asarray(F), tau, tau2)
    )
    for y in range(2):
        for x in range(2):
            np.testing.assert_allclose(
                f1[:, y, x],
                scalar_trt(f[:, y, x], f0[:, y, x], F[:, y, x], tau, tau2),
                rtol=1e-12,
            )


def test_moments_roundtrip():
    rho = RNG.uniform(0.9, 1.1, (4, 4))
    u = RNG.uniform(-0.02, 0.02, (2, 4, 4))
    f0 = ref.equilibrium(jnp.asarray(rho), jnp.asarray(u))
    rho2, u2 = ref.moments(f0)
    # CS_KERNEL^2 is only approximately 1/3, so the roundtrip has a tiny
    # O(u^2 * 3e-6) defect — matches the reference's own discretisation.
    np.testing.assert_allclose(np.asarray(rho2), rho, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(u2), u, rtol=2e-5, atol=1e-9)


def test_collision_conserves_mass_and_adds_guo_momentum():
    rho = RNG.uniform(0.9, 1.1, (4, 4))
    u = RNG.uniform(-0.02, 0.02, (2, 4, 4))
    force = RNG.uniform(-1e-3, 1e-3, (2, 4, 4))
    tau, tau2 = 2.8068, 0.53612
    f = ref.equilibrium(jnp.asarray(rho), jnp.asarray(u))
    F = ref.guo_forcing(jnp.asarray(u), jnp.asarray(force), tau)
    f1 = ref.trt_collide(f, f, F, tau, tau2)
    # REFERENCE QUIRK (LatticeBoltzmann.cu:86): the rest population receives
    # no forcing term, so the collision is NOT exactly mass-conserving under
    # forcing: sum_i>=1 F_i = -F_0 (the full Guo term is mass-neutral).
    # Mass gain per collision = -F_0 = (1 - 1/(2 tau)) w_0 (u.force)/cs^2.
    dmass = np.asarray(jnp.sum(f1 - f, 0))
    np.testing.assert_allclose(dmass, -np.asarray(F[0]), rtol=1e-4, atol=1e-15)
    # Momentum gain = (1 - 1/(2 tau)) * force  (first moment of Guo term;
    # the skipped i=0 term carries no momentum).
    dmom = np.einsum(
        "iyx,ic->cyx", np.asarray(f1 - f), C.astype(float)
    )
    np.testing.assert_allclose(
        dmom, (1 - 1 / (2 * tau)) * force, rtol=1e-4, atol=1e-12
    )


def test_corrected_velocity_identity():
    f = jnp.asarray(RNG.uniform(0.05, 0.2, (9, 3, 3)))
    force = jnp.asarray(RNG.uniform(-1e-3, 1e-3, (2, 3, 3)))
    rho, u_corr = ref.corrected_velocity(f, force)
    rho2, u_plain = ref.moments(f)
    np.testing.assert_allclose(np.asarray(rho), np.asarray(rho2))
    np.testing.assert_allclose(
        np.asarray(u_corr - u_plain),
        np.asarray(0.5 * force / rho[None]),
        rtol=1e-6, atol=1e-15,
    )


# ---- the XLA path in f32 against the f64 oracle --------------------------

import jax  # noqa: E402
import pytest  # noqa: E402


def _random_f(ydim, xdim, storage, rng):
    rho = 1.0 + 0.01 * rng.standard_normal((ydim, xdim))
    u = 0.02 * rng.standard_normal((2, ydim, xdim))
    f = np.asarray(ref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * rng.standard_normal(f.shape) * W[:, None, None]
    if storage == "deviatoric":
        f = f - W[:, None, None]
    force = 1e-4 * rng.standard_normal((2, ydim, xdim))
    return f, force


@pytest.mark.parametrize("ydim,xdim", [(16, 32), (24, 40)])
@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
@pytest.mark.parametrize("top", ["slip", "noslip"])
def test_xla_path_f32_matches_f64_oracle(ydim, xdim, forcing, storage,
                                         top):
    # one step of the production XLA path in f32 against the same step in
    # f64: the error is f32 rounding of the state (relative to the
    # deviation from w_i under deviatoric storage), no worse
    rng = np.random.default_rng(ydim * xdim)
    f, force = _random_f(ydim, xdim, storage, rng)
    walls = ref.WallSpec(top=top)
    want = np.asarray(ref.lb_substep(
        jnp.asarray(f), jnp.asarray(force), 2.8, 0.536, walls,
        forcing=forcing, storage=storage)[0])
    got = np.asarray(jax.jit(
        lambda f, g: ref.lb_substep(f, g, 2.8, 0.536, walls,
                                    forcing=forcing, storage=storage)[0])(
        jnp.asarray(f, jnp.float32), jnp.asarray(force, jnp.float32)),
        np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < (1e-6 if storage == "deviatoric" else 2e-7), rel


@pytest.mark.parametrize("shape", [(9,), (9, 5), (9, 4, 6), (9, 3, 2, 7)])
def test_lattice_sums_equal_einsum(shape):
    # the written-out sums are the contractions they replace, exactly in f64
    x = RNG.standard_normal(shape)
    mom = np.einsum("i...,ic->c...", x, C.astype(np.float64))
    np.testing.assert_allclose(np.asarray(ref.lattice_momentum(x)), mom,
                               rtol=1e-14, atol=1e-14)
    u = RNG.standard_normal((2,) + shape[1:])
    cu = np.einsum("ic,c...->i...", C.astype(np.float64), u)
    np.testing.assert_allclose(np.asarray(ref.lattice_cu(u)), cu,
                               rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equilibrium_parts_are_even_and_odd(storage, dtype):
    rho = jnp.asarray(RNG.uniform(0.95, 1.05, (5, 6)), dtype)
    u = jnp.asarray(0.05 * RNG.standard_normal((2, 5, 6)), dtype)
    even, odd = ref.equilibrium_parts(rho, u, storage)
    opp = np.asarray(OPPOSITE)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(np.asarray(even), np.asarray(even)[opp],
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(odd), -np.asarray(odd)[opp],
                               rtol=0, atol=0)
    full = np.asarray(ref.equilibrium(rho, u, storage))
    w = W[:, None, None] if storage == "deviatoric" else 0.0
    want = np.stack([scalar_equilibrium(float(r), float(a), float(b))
                     for r, a, b in zip(np.ravel(rho), np.ravel(u[0]),
                                        np.ravel(u[1]))], -1).reshape(
        9, 5, 6) - w
    np.testing.assert_allclose(full, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("tau", [0.8, 2.8068, 231.18])
def test_trt_split_forcing_equals_pair_average(tau):
    # the even/odd parts written out equal (s_i +- s_opp)/2 of the uniform
    # Guo source, with (1 - 1/2tau) on the even part and (1 - 1/2tau2) on
    # the odd part
    tau2 = 1.0 / (12.0 * (tau - 0.5)) + 0.5
    u = jnp.asarray(0.03 * RNG.standard_normal((2, 4, 5)))
    g = jnp.asarray(1e-3 * RNG.standard_normal((2, 4, 5)))
    s = np.asarray(ref.guo_forcing(u, g, tau, scheme="reference")) / (
        1.0 - 1.0 / (2.0 * tau))
    s_opp = s[np.asarray(OPPOSITE)]
    want = ((1.0 - 1.0 / (2.0 * tau)) * 0.5 * (s + s_opp)
            + (1.0 - 1.0 / (2.0 * tau2)) * 0.5 * (s - s_opp))
    got = np.asarray(ref.guo_forcing(u, g, tau, tau2, scheme="trt_split"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-18)
