"""IB coupling: gather/scatter recast as band matmuls.

The reference brute-forces spreading as an O(size x Ns) all-pairs loop with
shared-memory tiling (ImmersedBoundary.cu:150-231) and interpolation as one
thread per point (:94-133).  Here the 2-D regularized delta is SEPARABLE:
delta2(x - xs, y - ys) = delta(x - xs) * delta(y - ys).  All Lagrangian
points also live in a fixed y-band (cilium base y=1, tip <= ~97+1.5 rows),
so with dense per-axis delta factor matrices

    DY[k, y] = delta(y - ys_k)         [Ns, BAND]
    DX[k, x] = delta(min |x - xs_k| periodic in x)   [Ns, X]

the coupling becomes pure matmuls over the band:

  interpolate:  T_q[k, x] = sum_y DY[k, y] q[y, x]   (q in {rho, mom_x, mom_y})
                I_q[k]    = sum_x DX[k, x] T_q[k, x]
                F_s[k]    = 2 (u_s_k * I_rho - I_mom)     (== 2 sum delta rho (u_s - u))
  spread:       force[c, y, x] = sum_k (F_s[k,c] eps_k DY[k,y]) DX[k,x]
                -> one [2*BAND, Ns] @ [Ns, X] matmul.

Both are mathematically identical to ops/ib.py's stencil forms (the delta's
1.5 support means every cell outside the 3x3 stencil has exactly zero
weight); tests/test_ib_band.py checks equality to f64 round-off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_iblb_11_tpu.ops.ib import delta_1d
from cuda_iblb_11_tpu.ops.reference import lattice_momentum

# Measured on an H100 (a [3, 136, 2048] x [1536, 2048] band contraction vs
# f64): XLA hands these dots to cuBLAS, where DEFAULT and HIGH both run in
# TF32 (rel 3.0e-4, which would break the <1e-5 velocity bound) and
# HIGHEST runs full f32 (rel 5.7e-8) and was the fastest of the three.
_PREC = jax.lax.Precision.HIGHEST

DEFAULT_BAND = 128  # >= max cilium tip height (~97.5) + delta support


def _delta_factors(s, xdim, band, dtype):
    """(DY [Ns, band], DX [Ns, X]) dense separable delta factors."""
    xs = s[:, 0][:, None]
    ys = s[:, 1][:, None]
    xg = jnp.arange(xdim, dtype=dtype)[None, :]
    yg = jnp.arange(band, dtype=dtype)[None, :]
    dx = xg - xs
    # periodic minimal distance in x
    dx = jnp.abs(jnp.mod(dx + xdim / 2.0, float(xdim)) - xdim / 2.0)
    dy = jnp.abs(yg - ys)
    return delta_1d(dy), delta_1d(dx)


def _delta_factors_anchored(anchor, frac, xdim, band, dtype):
    """Precision-preserving delta factors from the (integer anchor,
    sub-cell fraction) position split (models/cilia.py:anchored_nodes).

    The grid-to-anchor distances are exact int32 arithmetic (with an
    integer periodic fold in x); only the |frac| <= 0.5 part touches the
    storage dtype, so the delta argument keeps full precision instead of
    the XDIM * 2^-24 rounding of absolute f32 coordinates."""
    half = jnp.int32(xdim // 2)
    xx = jnp.int32(xdim)
    xg = jnp.arange(xdim, dtype=jnp.int32)[None, :]
    v = xg - anchor[:, 0][:, None].astype(jnp.int32)
    # exact integer periodic fold to [-X/2, X/2); |v| < 2X always (the
    # anchor is within one wrap of the domain), so two conditional
    # adjustments suffice.
    for _ in range(2):
        v = jnp.where(v >= half, v - xx, v)
        v = jnp.where(v < -half, v + xx, v)
    dx = v.astype(dtype) - frac[:, 0][:, None]
    yg = jnp.arange(band, dtype=jnp.int32)[None, :]
    dy = (yg - anchor[:, 1][:, None].astype(jnp.int32)).astype(dtype) \
        - frac[:, 1][:, None]
    return delta_1d(jnp.abs(dy)), delta_1d(jnp.abs(dx))


def delta_factors(anchored, xdim, band, dtype):
    """Public precomputation of the (DY, DX) anchored delta factors so a
    step can evaluate them ONCE and share them between interpolate and
    spread (they are identical); DX alone is [Ns, X] — the largest IB
    intermediate — so sharing halves the delta-evaluation traffic."""
    return _delta_factors_anchored(anchored[0], anchored[1], xdim, band,
                                   dtype)


def band_moments(f, band, storage="raw"):
    """(rho, mom) of the first `band` rows only (computed in >=f32)."""
    fb = f[:, :band, :].astype(jnp.promote_types(f.dtype, jnp.float32))
    rho = jnp.sum(fb, axis=0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    return rho, lattice_momentum(fb)


def interpolate(f, s, u_s, band=DEFAULT_BAND, storage="raw", anchored=None,
                factors=None):
    """Direct-forcing IB force, F_s [Ns, 2] — band-matmul formulation of
    ImmersedBoundary.cu:94-133 (2 delta rho (u_s - u) summed over support).

    anchored: optional (anchor_x int32 [Ns], local [Ns,2]) pair for the
    precision-preserving position split; `s` is then ignored for the delta
    evaluation.  factors: optional precomputed (DY, DX) from
    delta_factors(), shared with spread()."""
    rho, mom = band_moments(f, band, storage)
    cdt = rho.dtype
    if factors is not None:
        dy, dx = factors
    elif anchored is not None:
        dy, dx = _delta_factors_anchored(
            anchored[0], anchored[1], f.shape[2], band, cdt)
    else:
        dy, dx = _delta_factors(s, f.shape[2], band, cdt)
    q = jnp.concatenate([rho[None], mom], axis=0)        # [3, band, X]
    # Contract the LONG (x) axis first: the intermediate is
    # [3, band, Ns] (a few MB) instead of the [3, Ns, X] outer-product
    # slab (~37 MB at 2048^2 / 16 cilia) the naive order materializes —
    # same flops, ~15x less memory traffic.
    t = jnp.einsum("qyx,kx->qky", q, dx, precision=_PREC,
                   preferred_element_type=cdt)            # [3, band, Ns]
    i_q = jnp.einsum("ky,qky->qk", dy, t, precision=_PREC,
                     preferred_element_type=cdt)          # [3, Ns]
    return finish_interpolate(i_q, u_s)                   # [Ns, 2]


def interpolate_from_moments(q, u_s, factors):
    """Direct-forcing IB force from KERNEL-EMITTED band moments.

    q [3, band, X] = (rho, mom_x, mom_y) of the streamed state over the
    force band, produced by the fused kernel's output pass
    (ops/pallas_step.py, emit_moments=True) — identical values to
    band_moments(f_new) without re-reading the 9 f planes.
    factors = delta_factors(...), shared with spread()."""
    dy, dx = factors
    cdt = q.dtype
    t = jnp.einsum("qyx,kx->qky", q, dx.astype(cdt), precision=_PREC,
                   preferred_element_type=cdt)            # [3, band, Ns]
    i_q = jnp.einsum("ky,qky->qk", dy.astype(cdt), t, precision=_PREC,
                     preferred_element_type=cdt)          # [3, Ns]
    return finish_interpolate(i_q, u_s)


def spread(f_s, s, eps, xdim, band=DEFAULT_BAND, anchored=None,
           factors=None):
    """Eulerian band force field [2, band, X] — one matmul
    (ImmersedBoundary.cu:178-231 recast; full-field rows above the band are
    identically zero)."""
    if factors is not None:
        dy, dx = factors
        dy = dy.astype(f_s.dtype)
        dx = dx.astype(f_s.dtype)
    elif anchored is not None:
        dy, dx = _delta_factors_anchored(
            anchored[0], anchored[1], xdim, band, f_s.dtype)
    else:
        dy, dx = _delta_factors(s, xdim, band, f_s.dtype)
    lhs = (f_s * eps[:, None].astype(f_s.dtype))          # [Ns, 2]
    a = lhs.T[:, None, :] * dy.T[None]                    # [2, band, Ns]
    return jnp.einsum("cyk,kx->cyx", a, dx, precision=_PREC,
                      preferred_element_type=f_s.dtype)   # [2, band, X]


def finish_interpolate(i_q, u_s):
    """F_s [Ns, 2] from the psummed delta integrals."""
    cdt = i_q.dtype
    return (2.0 * (u_s.astype(cdt).T * i_q[0][None] - i_q[1:])).T


def pad_band(force_band, ydim):
    """Embed a band force field into the full [2, Y, X] grid."""
    band = force_band.shape[1]
    if band >= ydim:
        return force_band[:, :ydim, :]
    pad = jnp.zeros(
        (2, ydim - band, force_band.shape[2]), force_band.dtype)
    return jnp.concatenate([force_band, pad], axis=1)
