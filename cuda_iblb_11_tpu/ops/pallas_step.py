"""Fused D2Q9 TRT collide+stream as one Pallas kernel through Triton.

One read and one write of ``f`` per step: each program owns a
``BY x BX`` block of output cells and, for every population ``d``, pulls
the post-collision value ``f1_d`` from its source cell ``(y - cy, x - cx)``
(pull-form streaming, ops/reference.py:stream).  Programs run in no order
and share nothing, so a program cannot take its neighbours' post-collision
values: it re-collides the source cell of each population itself, from the
pre-collision ``f`` and force (nine loads that hit L1/L2 after the first).
The periodic x wrap is an index modulo; the walls replace the incoming
populations of the first and last row with the cell's own permuted ``f1``
(LatticeBoltzmann.cu:328-353).  The input is read by other programs'
halos, so the output is a separate buffer.

With ``emit_moments`` the kernel also writes the streamed state's
``(rho, mom_x, mom_y)`` over the IB force band, the moments the IB
interpolation needs (ops/ib_band.interpolate_from_moments), so the step
does not read ``f_new`` back for them.

Interpret mode (``interpret=True``) runs the same kernel on the CPU for the
tests; it is never chosen implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from cuda_iblb_11_tpu.core.lattice import C, CS_KERNEL, W
from cuda_iblb_11_tpu.ops.reference import (
    REFERENCE_WALLS, WallSpec, lattice_sum,
)

CS2 = CS_KERNEL * CS_KERNEL
CS4 = CS2 * CS2

CX = [int(c) for c in C[:, 0]]
CY = [int(c) for c in C[:, 1]]
WI = [float(w) for w in W]
PAIRS = ((1, 3), (2, 4), (5, 7), (6, 8))
PAIR_OF = {d: k for k, pair in enumerate(PAIRS) for d in pair}

# Output cells per program (rows, columns), powers of two for Triton, and
# warps per program: the fastest of 20 (block, warps) pairs timed on an H100
# at both 288x192 and 2048^2 (PERF.md).
BLOCK = (8, 64)
NUM_WARPS = 8


def _cdot(d, x, y):
    """c_d . (x, y) as a sum: the lattice coefficients are 0 or +-1."""
    terms = [v if cd > 0 else -v for cd, v in ((CX[d], x), (CY[d], y)) if cd]
    return terms[0] if len(terms) == 1 else terms[0] + terms[1]


def _collide(f, gx, gy, dirs, *, tau, tau2, forcing, storage):
    """Post-collision populations ``{d: f1_d}`` for ``d in dirs`` of one
    block of cells: TRT with the Guo source in pair form, as
    ops/reference.py:collide evaluates it.  ``f`` is the list of the nine pre-collision planes, gx/gy
    the previous step's IB force.  Equal to the reference in exact
    arithmetic; the constants keep its truncated C_S literal."""
    p57 = f[5] - f[7]
    d68 = f[6] - f[8]
    fsum = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8]
    deviatoric = storage == "deviatoric"
    rho = 1.0 + fsum if deviatoric else fsum
    mom_x = (f[1] - f[3]) + p57 - d68
    mom_y = (f[2] - f[4]) + p57 + d68
    inv_rho = 1.0 / rho
    # previous step's spread-corrected velocity (ImmersedBoundary.cu:249-255)
    ux = (mom_x + 0.5 * gx) * inv_rho
    uy = (mom_y + 0.5 * gy) * inv_rho
    ug = (1.0 / CS2) * (ux * gx + uy * gy)
    u2h = (0.5 / CS2) * (ux * ux + uy * uy)

    omega_p = 1.0 / tau
    omega_m = 1.0 / tau2
    lam_p = 1.0 - 1.0 / (2.0 * tau)
    lam_odd = lam_p if forcing == "reference" else 1.0 - 1.0 / (2.0 * tau2)

    out = {}
    if 0 in dirs:
        # rest population: BGK with omega+, no forcing (LatticeBoltzmann.cu:86)
        if deviatoric:
            f0_0 = WI[0] * fsum - rho * (WI[0] * u2h)
        else:
            f0_0 = rho * (WI[0] * (1.0 - u2h))
        out[0] = f[0] - omega_p * (f[0] - f0_0)
    for k in sorted({PAIR_OF[d] for d in dirs if d}):
        a, b = PAIRS[k]
        cu = _cdot(a, ux, uy)
        w = WI[a]
        tp = (0.5 / CS4) * (cu * cu) - u2h
        # doubled pair equilibria 2 f0+ and 2 f0- (the 0.5 of the even/odd
        # projections folds into omega/2)
        base = fsum if deviatoric else rho
        f0p2 = (2.0 * w) * base + (2.0 * w) * rho * tp
        f0m2 = (2.0 * w / CS2) * rho * cu
        even = (0.5 * omega_p) * ((f[a] + f[b]) - f0p2)
        odd = (0.5 * omega_m) * ((f[a] - f[b]) - f0m2)
        cg = _cdot(a, gx, gy)
        s_even = lam_p * (w * (cu * cg * (1.0 / CS4) - ug))
        s_odd = lam_odd * ((w / CS2) * cg)
        out[a] = f[a] - (even + odd) + (s_even + s_odd)
        out[b] = f[b] - (even - odd) + (s_even - s_odd)
    return {d: out[d] for d in dirs}


def _wall_sources(walls):
    """{(row, d): source direction} — the incoming populations of the wall
    rows come from the same cell's permuted f1 (bottom halfway bounce-back,
    top specular slip or bounce-back)."""
    src = {}
    if walls.bottom == "noslip":
        src.update({("bottom", 2): 4, ("bottom", 5): 7, ("bottom", 6): 8})
    if walls.top == "slip":
        src.update({("top", 4): 2, ("top", 8): 5, ("top", 7): 6})
    elif walls.top == "noslip":
        src.update({("top", 4): 2, ("top", 7): 5, ("top", 8): 6})
    return src


def _kernel(f_ref, g_ref, out_ref, *q_ref, ydim, xdim, band, by, bx, cdt,
            walls, storage, collide):
    plane = ydim * xdim
    r = pl.program_id(0) * by + jax.lax.broadcasted_iota(jnp.int32, (by, bx), 0)
    c = pl.program_id(1) * bx + jax.lax.broadcasted_iota(jnp.int32, (by, bx), 1)
    live = (r < ydim) & (c < xdim)
    # cells past the grid edge load a clamped cell and are never stored
    rc = jnp.minimum(r, ydim - 1)
    cc = jnp.minimum(c, xdim - 1)

    def cell(y, x):
        """Pre-collision planes and force at cells (y, x)."""
        idx = y * xdim + x
        f = [pltriton.load(f_ref.at[idx + d * plane]).astype(cdt)
             for d in range(9)]
        in_band = y < band
        gidx = jnp.minimum(y, band - 1) * xdim + x
        gx = pltriton.load(g_ref.at[gidx], mask=in_band, other=0.0)
        gy = pltriton.load(g_ref.at[gidx + band * xdim], mask=in_band,
                           other=0.0)
        return f, gx.astype(cdt), gy.astype(cdt)

    own = collide(*cell(rc, cc), tuple(range(9)))
    at_row = {"bottom": r == 0, "top": r == ydim - 1}
    new = [own[0]] + [None] * 8
    for d in range(1, 9):
        sy = jnp.clip(rc - CY[d], 0, ydim - 1)
        sx = cc - CX[d]
        sx = jnp.where(sx < 0, sx + xdim, jnp.where(sx >= xdim, sx - xdim, sx))
        v = collide(*cell(sy, sx), (d,))[d]
        for (row, dst), s in _wall_sources(walls).items():
            if dst == d:
                v = jnp.where(at_row[row], own[s], v)
        new[d] = v
    # masked-off cells keep their own (out-of-range) index, so no store
    # of theirs aliases a live cell
    out_idx = r * xdim + c
    for d in range(9):
        pltriton.store(out_ref.at[out_idx + d * plane],
                       new[d].astype(out_ref.dtype), mask=live)
    if q_ref:
        (q_ref,) = q_ref
        fsum = new[0]
        for d in range(1, 9):
            fsum = fsum + new[d]
        rho = 1.0 + fsum if storage == "deviatoric" else fsum
        mom_x = lattice_sum(new, C[:, 0])
        mom_y = lattice_sum(new, C[:, 1])
        qmask = live & (r < band)
        qidx = r * xdim + c
        bplane = band * xdim
        for i, v in enumerate((rho, mom_x, mom_y)):
            pltriton.store(q_ref.at[qidx + i * bplane], v.astype(q_ref.dtype),
                           mask=qmask)


def make_fused_substep(cfg, walls: WallSpec = REFERENCE_WALLS,
                       dtype=jnp.float32, forcing: str = "trt_split",
                       storage: str = "raw", emit_moments: bool = False,
                       interpret: bool = False, block=BLOCK):
    """The jittable fused ``(f, force_band) -> f_new`` update for one config.

    ``force_band`` is ``[2, band, X]`` (zero above ``cfg.force_band``).  With
    ``emit_moments`` the call returns ``(f_new, q)`` where ``q [3, band, X]``
    holds the streamed state's ``(rho, mom_x, mom_y)`` over the band, the
    values ``ib_band.band_moments(f_new, band)`` computes.  Walls: periodic
    x, bottom no-slip, top slip or no-slip (the reference channel and the
    cavity-style top); other wall sets run the jnp path.  bf16 storage
    (deviatoric) computes in f32."""
    if walls.left != "periodic":
        raise NotImplementedError("the fused kernel needs periodic x walls")
    if walls.bottom != "noslip" or walls.top not in ("slip", "noslip"):
        raise NotImplementedError(
            "the fused kernel supports bottom=noslip, top=slip|noslip")
    dtype = jnp.dtype(dtype)
    if dtype.itemsize == 2 and storage != "deviatoric":
        raise ValueError("bf16 storage requires deviatoric mode")
    cdt = jnp.dtype(jnp.float32) if dtype.itemsize < 4 else dtype
    ydim, xdim, band = cfg.ydim, cfg.xdim, cfg.force_band
    by, bx = block
    collide = functools.partial(_collide, tau=float(cfg.tau),
                                tau2=float(cfg.tau2), forcing=forcing,
                                storage=storage)
    kernel = functools.partial(_kernel, ydim=ydim, xdim=xdim, band=band,
                               by=by, bx=bx, cdt=cdt, walls=walls,
                               storage=storage, collide=collide)
    out_shape = [jax.ShapeDtypeStruct((9 * ydim * xdim,), dtype)]
    if emit_moments:
        out_shape.append(jax.ShapeDtypeStruct((3 * band * xdim,), cdt))
    call = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(ydim, by), pl.cdiv(xdim, bx)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="iblb_fused_collide_stream",
    )

    def substep(f, force_band):
        outs = call(f.astype(dtype).reshape(-1),
                    force_band.astype(cdt).reshape(-1))
        f_new = outs[0].reshape(9, ydim, xdim)
        if emit_moments:
            return f_new, outs[1].reshape(3, band, xdim)
        return f_new

    return substep
