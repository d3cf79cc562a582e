"""IB coupling: delta function closed forms, interpolation, spreading, flux."""

import jax.numpy as jnp
import numpy as np

from cuda_iblb_11_tpu.ops import ib

RNG = np.random.default_rng(42)


def test_delta_closed_forms():
    # r=0: 0.33333*(1+1) (ImmersedBoundary.cu:35-39)
    assert abs(float(ib.delta_1d(jnp.float64(0.0))) - 0.66666) < 1e-12
    # Continuity at r=0.5: both branches give 0.5 (with exact 1/3, 1/6
    # coefficients; the truncated literals give ~0.49999/0.50001).
    lo = float(ib.delta_1d(jnp.float64(0.5)))
    hi = float(ib.delta_1d(jnp.float64(0.5 + 1e-12)))
    assert abs(lo - 0.5) < 1e-4 and abs(hi - lo) < 1e-4
    # Compact support.
    assert float(ib.delta_1d(jnp.float64(1.5))) < 1e-12
    assert float(ib.delta_1d(jnp.float64(2.3))) == 0.0


def test_delta_partition_of_unity():
    # sum over integer cells of delta(x - j) == 1 up to the reference's
    # truncated 0.33333/0.16667 coefficients (error ~2e-5).
    for x in [0.0, 0.25, 0.37, 0.5, 0.81]:
        cells = jnp.arange(-3, 4, dtype=jnp.float64)
        total = float(jnp.sum(ib.delta_1d(cells - x)))
        assert abs(total - 1.0) < 5e-5, (x, total)


def test_interpolate_constant_field():
    # Uniform rho/u: F_s = 2 rho (u_s - u) * sum(delta) ~ 2 rho (u_s - u).
    ydim, xdim = 32, 48
    rho = jnp.full((ydim, xdim), 1.05)
    u = jnp.stack([jnp.full((ydim, xdim), 0.01), jnp.full((ydim, xdim), -0.02)])
    s = jnp.asarray([[10.3, 12.7], [20.0, 5.5]])
    u_s = jnp.asarray([[0.03, 0.0], [0.0, 0.04]])
    f_s = np.asarray(ib.interpolate(rho, u, s, u_s))
    expected = 2 * 1.05 * (np.asarray(u_s) - np.array([0.01, -0.02]))
    np.testing.assert_allclose(f_s, expected, rtol=2e-4)


def test_spread_total_force_and_locality():
    ydim, xdim = 24, 36
    s = jnp.asarray([[5.2, 7.9], [30.6, 3.1]])
    f_s = jnp.asarray([[1.0, -2.0], [0.5, 0.25]])
    eps = jnp.asarray([1, 1])
    force = np.asarray(ib.spread(f_s, s, eps, xdim, ydim))
    # Total spread force = sum_k F_s_k (partition of unity per point).
    np.testing.assert_allclose(
        force.sum(axis=(1, 2)), np.asarray(f_s).sum(axis=0), rtol=1e-4
    )
    # Locality: nothing farther than 1.5 cells from any point.
    yy, xx = np.mgrid[0:ydim, 0:xdim]
    near = np.zeros((ydim, xdim), bool)
    for (xs, ys) in np.asarray(s):
        near |= (np.abs(xx - xs) <= 1.5) & (np.abs(yy - ys) <= 1.5)
    assert np.all(force[:, ~near] == 0)


def test_spread_epsilon_masks_points():
    ydim, xdim = 16, 16
    s = jnp.asarray([[8.0, 8.0], [3.0, 3.0]])
    f_s = jnp.asarray([[1.0, 1.0], [5.0, 5.0]])
    force = np.asarray(ib.spread(f_s, s, jnp.asarray([1, 0]), xdim, ydim))
    np.testing.assert_allclose(force.sum(axis=(1, 2)), [1.0, 1.0], rtol=1e-4)


def test_spread_periodic_x_wrap():
    ydim, xdim = 16, 16
    # Point at x=0.2: its patch wraps to x=15.
    s = jnp.asarray([[0.2, 8.0]])
    f_s = jnp.asarray([[1.0, 0.0]])
    force = np.asarray(ib.spread(f_s, s, jnp.asarray([1]), xdim, ydim))
    assert force[0, :, xdim - 1].sum() > 0  # wrapped column received force
    np.testing.assert_allclose(force[0].sum(), 1.0, rtol=1e-4)


def test_interpolate_spread_consistency():
    # spread(interpolate(...)) pushes u toward u_s where the points sit.
    ydim, xdim = 32, 32
    rho = jnp.ones((ydim, xdim))
    u = jnp.zeros((2, ydim, xdim))
    s = jnp.asarray([[16.0, 16.0]])
    u_s = jnp.asarray([[0.05, 0.0]])
    f_s = ib.interpolate(rho, u, s, u_s)
    force = ib.spread(f_s, s, jnp.asarray([1]), xdim, ydim)
    # force should accelerate the fluid toward +x at the point.
    assert float(force[0, 16, 16]) > 0
    assert abs(float(force[1]. sum())) < 1e-12


def test_flux_increment_uniform_flow():
    # f at equilibrium for u=(u0, 0): flux = sum_y u0 / 192.
    from cuda_iblb_11_tpu.ops import reference as ref

    ydim, xdim = 192, 288
    u0 = 0.01
    rho = jnp.ones((ydim, xdim))
    u = jnp.zeros((2, ydim, xdim)).at[0].set(u0)
    f = ref.equilibrium(rho, u)
    force = jnp.zeros((2, ydim, xdim))
    q = float(ib.flux_increment(f, force, xdim - 5))
    assert abs(q - u0 * ydim / 192.0) < 1e-6


def test_reference_x_edge_interpolate_row_aliases():
    # Strict-parity mode: the reference's flat j = y*XDIM + x with x = -1
    # reads cell (y-1, XDIM-1) (ImmersedBoundary.cu:119-124).  Emulate that
    # indexing in numpy and compare.
    xdim, ydim = 16, 12
    rng = np.random.RandomState(0)
    rho = jnp.asarray(1.0 + 0.1 * rng.rand(ydim, xdim))
    u = jnp.asarray(0.01 * rng.randn(2, ydim, xdim))
    s = jnp.asarray([[0.2, 5.0]])   # stencil x in {-1, 0, 1}
    u_s = jnp.asarray([[0.03, -0.01]])

    got = np.asarray(ib.interpolate(rho, u, s, u_s, x_edge="reference"))[0]

    rho_n, u_n = np.asarray(rho), np.asarray(u)
    from cuda_iblb_11_tpu.core.lattice import C as CL
    xs, ys = 0.2, 5.0
    x0, y0 = round(xs), round(ys)
    want = np.zeros(2)
    for i in range(9):
        x = x0 + int(CL[i, 0])
        y = y0 + int(CL[i, 1])
        j = y * xdim + x                      # flat, unwrapped
        dl = (float(ib.delta_1d(jnp.asarray(abs(x - xs))))
              * float(ib.delta_1d(jnp.asarray(abs(y - ys)))))
        ya, xa = divmod(j, xdim)              # row-aliased cell
        want += 2.0 * dl * rho_n[ya, xa] * (np.asarray(u_s)[0]
                                            - u_n[:, ya, xa])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # and it must differ from the periodic treatment for this edge point
    per = np.asarray(ib.interpolate(rho, u, s, u_s))[0]
    assert np.abs(got - per).max() > 1e-9


def test_reference_x_edge_spread_drops_periodic_image():
    xdim, ydim = 16, 12
    s = jnp.asarray([[0.2, 5.0]])
    f_s = jnp.asarray([[1.0, 0.5]])
    eps = jnp.asarray([1])
    per = np.asarray(ib.spread(f_s, s, eps, xdim, ydim))
    refm = np.asarray(ib.spread(f_s, s, eps, xdim, ydim,
                                x_edge="reference"))
    # periodic mode wraps the x=-1 column of the stencil to x=XDIM-1;
    # the reference never sees it
    assert np.abs(per[:, :, xdim - 1]).max() > 0
    assert np.abs(refm[:, :, xdim - 1]).max() == 0
    # interior columns agree exactly
    np.testing.assert_array_equal(per[:, :, :2], refm[:, :, :2])


def test_mucociliary_strict_parity_mode_runs():
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    cfg = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
    sim = MucociliarySim(cfg, backend="jnp", ib_x_edge="reference")
    st = sim.run_chunk(sim.init_state(), 5)
    assert int(st.it) == 5
    assert np.isfinite(float(st.q))
    assert np.isfinite(np.asarray(st.f)).all()
