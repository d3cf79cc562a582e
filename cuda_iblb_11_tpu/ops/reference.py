"""Pure-jnp D2Q9 TRT oracle — the golden model every faster path is tested against.

Replicates the four LB kernels of the reference
(CUDA_IBLB_11/LatticeBoltzmann.cu): ``equilibrium`` (+ Guo forcing),
``collision`` (two-relaxation-time), ``streaming`` (converted from the
reference's push-form scatter with wall branches to an equivalent pull-form
gather — proven equal cell-by-cell in tests/test_streaming_walls.py), and
``macro``.

Semantics preserved exactly:
  * TRT split with omega+ = 1/TAU, omega- = 1/TAU2, pairs (1,3),(2,4),(5,7),
    (6,8)  (LatticeBoltzmann.cu:72-134).
  * The rest population i=0 relaxes with omega+ only and receives NO forcing
    term (LatticeBoltzmann.cu:86) even though F[0] is computed (:56).
  * Speed of sound 0.57735 inside the kernels (LatticeBoltzmann.cu:11).
  * Walls: bottom halfway bounce-back (no-slip), top specular reflection
    (free-slip), x periodic; corner precedence slip/back > thru
    (LatticeBoltzmann.cu:199-365).

Generalisations beyond the reference (needed for the Poiseuille / lid-driven
cavity validation configs): per-edge wall types including no-slip side walls
and a moving lid (bounce-back with wall-velocity momentum correction).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from cuda_iblb_11_tpu.core import lattice
from cuda_iblb_11_tpu.core.lattice import (
    C, CS_KERNEL, MIRROR_X, MIRROR_Y, OPPOSITE, RHO_0, W,
)

CS2 = CS_KERNEL * CS_KERNEL
CS4 = CS2 * CS2


@dataclass(frozen=True)
class WallSpec:
    """Boundary condition per edge.

    'periodic' | 'noslip' (halfway bounce-back) | 'slip' (specular) |
    'moving' (bounce-back with wall velocity ``u_wall``, new vs reference).
    The reference channel is the default: bottom no-slip, top free-slip,
    periodic left/right (LatticeBoltzmann.cu:199-353).
    """

    bottom: str = "noslip"
    top: str = "slip"
    left: str = "periodic"
    right: str = "periodic"
    u_wall: tuple[float, float] = (0.0, 0.0)  # lid velocity for 'moving' edges

    def __post_init__(self):
        for e in (self.bottom, self.top, self.left, self.right):
            if e not in ("periodic", "noslip", "slip", "moving"):
                raise ValueError(f"unknown wall type {e!r}")
        if (self.left == "periodic") != (self.right == "periodic"):
            raise ValueError("x-periodicity must match on both edges")
        if (self.bottom == "periodic") != (self.top == "periodic"):
            raise ValueError("y-periodicity must match on both edges")


REFERENCE_WALLS = WallSpec()


def lattice_sum(f, coef):
    """sum_i coef_i f_i over the leading (population) axis, written out as
    adds and subtracts.  The D2Q9 coefficients are 0 or +-1, so the sum is
    exact in any dtype and fuses with its neighbours; as an einsum, XLA:GPU
    may lower it to a matrix product that runs in TF32."""
    out = None
    for i, ci in enumerate(coef):
        if ci == 0:
            continue
        if out is None:
            out = f[i] if ci > 0 else -f[i]
        else:
            out = out + f[i] if ci > 0 else out - f[i]
    return out


def lattice_momentum(f):
    """sum_i c_i f_i -> [2, ...] (exact, see lattice_sum)."""
    return jnp.stack([lattice_sum(f, C[:, 0]), lattice_sum(f, C[:, 1])])


def lattice_cu(u):
    """c_i . u for the nine velocities -> [9, ...] (exact, see lattice_sum)."""
    return jnp.stack([lattice_sum(u, C[i]) if i else jnp.zeros_like(u[0])
                      for i in range(9)])


def moments(f, storage="raw"):
    """rho = sum_i f_i ; u = sum_i c_i f_i / rho  (LatticeBoltzmann.cu:396-405).

    storage="deviatoric": f holds f_i - w_i (well-balanced storage); rho is
    then 1 + sum f_dev (sum w = 1) and the momentum sum is unchanged
    (sum w c = 0), with the f32 cancellation error of the large constant
    part eliminated."""
    rho = jnp.sum(f, axis=0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    return rho, lattice_momentum(f) / rho


def corrected_velocity(f, force, storage="raw"):
    """u = (sum_i c_i f_i + force/2) / rho — the IB half-force correction
    applied at the end of the reference's spread kernel
    (ImmersedBoundary.cu:249-255)."""
    rho = jnp.sum(f, axis=0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    return rho, (lattice_momentum(f) + 0.5 * force) / rho


def equilibrium(rho, u, storage="raw"):
    """D2Q9 second-order equilibrium (LatticeBoltzmann.cu:47-50).

    storage="deviatoric": returns f0_i - w_i computed WITHOUT forming the
    large constant part: w_i [(rho-1) + rho (cu/cs^2 + cu^2/2cs^4
    - u^2/2cs^2)]."""
    even, odd = equilibrium_parts(rho, u, storage)
    return even + odd


def equilibrium_parts(rho, u, storage="raw", drho=None):
    """The equilibrium's even and odd parts over (i, opposite(i)), each
    evaluated directly: even = w_i rho (1 + cu^2/2cs^4 - u^2/2cs^2) (its
    deviatoric form with rho-1 in place of the 1), odd = w_i rho cu/cs^2.
    Forming them as (f0_i +- f0_opp)/2 instead would cancel the O(u) odd
    term out of the much smaller even part in f32.  drho = sum_i (f_i - w_i)
    gives rho-1 exactly under deviatoric storage; forming it as rho - 1
    from the rounded rho would cost the deviation the bits that deviatoric
    storage exists to keep."""
    w = jnp.asarray(W, u.dtype)[:, None, None]
    cu = lattice_cu(u)
    u2 = jnp.sum(u * u, axis=0)
    even_poly = cu * cu / (2.0 * CS4) - u2[None] / (2.0 * CS2)
    odd = w * (rho[None] * cu / CS2)
    if storage == "deviatoric":
        drho = rho - 1.0 if drho is None else drho
        return w * (drho[None] + rho[None] * even_poly), odd
    return w * (rho[None] * (1.0 + even_poly)), odd


def guo_forcing(u, force, tau, tau2=None, scheme="reference"):
    """Guo force term.

    scheme="reference": F_i = (1 - 1/(2 tau)) w_i [(c-u)/cs^2 + (c.u)c/cs^4].g
    exactly as LatticeBoltzmann.cu:53-56 — the (1 - omega+/2) prefactor is
    applied to ALL populations.  Under TRT this is inconsistent with the
    odd-moment relaxation omega- and amplifies the effective body force to
    g_eff = g (1 + (omega- - omega+)/2) (~1.75x at the default tau; derived
    and verified in tests/test_poiseuille.py), which also makes the
    IB direct-forcing feedback loop linearly UNSTABLE at the reference's
    default parameters (tests/test_stability.py).

    scheme="trt_split": the TRT-consistent Guo split (Ginzburg): the odd part
    of the source gets (1 - omega-/2) and the even part (1 - omega+/2), which
    restores g_eff = g exactly and stabilizes the IB coupling.  This is the
    framework's default for production runs; "reference" reproduces the
    committed CUDA bit-for-bit in structure.

    Computed for all 9 populations, exactly as the reference does; the
    collision step then ignores F[0].
    """
    dtype = u.dtype
    c = jnp.asarray(C, dtype)
    w = jnp.asarray(W, dtype)[:, None, None]
    cu = lattice_cu(u)                  # [9, Y, X]
    if scheme == "reference":
        # vec_ic = (c_ic - u_c)/cs^2 + cu_i * c_ic / cs^4
        vec = (c[:, :, None, None] - u[None]) / CS2 + (
            cu[:, None] * c[:, :, None, None] / CS4
        )
        proj = jnp.sum(vec * force[None], axis=1)  # [9, Y, X]
        return (1.0 - 1.0 / (2.0 * tau)) * w * proj
    if scheme == "trt_split":
        if tau2 is None:
            raise ValueError("trt_split forcing needs tau2")
        # The even and odd parts of w_i [(c_i-u).g/cs^2 + (c_i.u)(c_i.g)/cs^4]
        # over (i, opposite(i)), written out: the even part is O(|u||g|),
        # and forming it as (s_i + s_opp)/2 from two O(|g|) terms cancels
        # about |log10 |u|| digits in f32.
        cg = lattice_cu(force)          # c_i . g
        ug = jnp.sum(u * force, axis=0)
        s_even = w * (cu * cg / CS4 - ug[None] / CS2)
        s_odd = w * cg / CS2
        return (1.0 - 1.0 / (2.0 * tau)) * s_even + (
            1.0 - 1.0 / (2.0 * tau2)
        ) * s_odd
    raise ValueError(f"unknown forcing scheme {scheme!r}")


def trt_collide(f, f0, F, tau, tau2):
    """Two-relaxation-time collision (LatticeBoltzmann.cu:86-134).

    Even/odd decomposition against the opposite population; i=0 relaxes with
    omega+ only and gets no forcing term (:86)."""
    f0_opp = f0[jnp.asarray(OPPOSITE)]
    return _trt_relax(f, 0.5 * (f0 + f0_opp), 0.5 * (f0 - f0_opp), F, tau,
                      tau2)


def _trt_relax(f, f0_plus, f0_minus, F, tau, tau2):
    """trt_collide given the equilibrium's even and odd parts."""
    omega_p = 1.0 / tau
    omega_m = 1.0 / tau2
    f_opp = f[jnp.asarray(OPPOSITE)]
    f_plus = 0.5 * (f + f_opp)
    f_minus = 0.5 * (f - f_opp)
    f1 = f - omega_p * (f_plus - f0_plus) - omega_m * (f_minus - f0_minus) + F
    # Rest population: plain BGK relaxation, no forcing (its odd part is 0).
    f1_0 = f[0] - omega_p * (f[0] - f0_plus[0])
    return f1.at[0].set(f1_0)


def collide(f, force, tau, tau2, forcing="reference", storage="raw"):
    """Post-collision populations: equilibrium + Guo forcing + TRT
    relaxation of (f, force) (LatticeBoltzmann.cu:47-134).

    The (rho, u) entering the equilibrium are recomputed from (f, force) and
    equal the reference's buffered values: rho is the previous macro output
    and u the previous spread-corrected velocity.  The TRT relaxation is
    affine with identical structure in raw and deviatoric form (pair
    weights are equal, so the constant parts cancel in f_minus and shift
    f_plus/f0_plus identically)."""
    rho, u = corrected_velocity(f, force, storage)
    f0_plus, f0_minus = equilibrium_parts(rho, u, storage,
                                          drho=jnp.sum(f, axis=0))
    F = guo_forcing(u, force, tau, tau2, scheme=forcing)
    return _trt_relax(f, f0_plus, f0_minus, F, tau, tau2)


def stream(f1, walls: WallSpec = REFERENCE_WALLS, rho_wall: float = RHO_0):
    """Pull-form streaming with in-array wall fix-ups.

    Equivalent to the reference's push-form scatter with per-cell wall
    branching (LatticeBoltzmann.cu:173-373).  Derivation: the interior push
    ``f[j + c_i, i] = f1[j, i]`` inverts to the gather
    ``f[d, i] = f1[d - c_i, i]``; the periodic "thru" stream is the same
    gather with x wrapped; the wall "back"/"slip" streams write the
    *same* cell with a permuted index, so in pull form the wall rows are
    overwritten with ``f1[perm(i)]`` of the same row.  Corner precedence
    (slip/back beat thru, LatticeBoltzmann.cu:215-323) falls out because the
    wall-row overwrite happens after the roll.
    """
    y_per = walls.bottom == "periodic"

    # Interior + periodic gather: src = (y - cy [mod Y]), (x - cx mod X).
    out = jnp.stack(
        [
            jnp.roll(f1[i], (int(C[i, 1]), int(C[i, 0])), axis=(0, 1))
            for i in range(9)
        ]
    )

    def edge_fixup(out, edge, row_idx, incoming, axis):
        """Overwrite `incoming` populations on one boundary row/col."""
        if edge == "periodic":
            return out
        if edge == "noslip":
            perm = OPPOSITE
        elif edge == "slip":
            perm = MIRROR_Y if axis == 0 else MIRROR_X
        elif edge == "moving":
            perm = OPPOSITE
        for i in incoming:
            src = int(perm[i])
            if axis == 0:
                val = f1[src, row_idx, :]
            else:
                val = f1[src, :, row_idx]
            if edge == "moving":
                # Halfway bounce-back with wall momentum: standard Ladd term
                # 2 w_i rho_w (c_i . u_w) / cs^2 with exact cs^2 = 1/3.
                cu_w = (
                    float(C[i, 0]) * walls.u_wall[0]
                    + float(C[i, 1]) * walls.u_wall[1]
                )
                val = val + jnp.asarray(
                    2.0 * float(W[i]) * rho_wall * cu_w * 3.0, f1.dtype
                )
            if axis == 0:
                out = out.at[i, row_idx, :].set(val)
            else:
                out = out.at[i, :, row_idx].set(val)
        return out

    ydim = f1.shape[1]
    xdim = f1.shape[2]
    if not y_per:
        # Bottom row: populations with cy>0 come from the wall, not from y=-1.
        out = edge_fixup(out, walls.bottom, 0, lattice.UP_GOING, axis=0)
        # Top row: populations with cy<0.
        out = edge_fixup(out, walls.top, ydim - 1, lattice.DOWN_GOING, axis=0)
    if walls.left != "periodic":
        out = edge_fixup(out, walls.left, 0, np.array([1, 5, 8]), axis=1)
        out = edge_fixup(out, walls.right, xdim - 1, np.array([3, 6, 7]), axis=1)
    return out


def lb_substep(f, force, tau, tau2, walls: WallSpec = REFERENCE_WALLS,
               forcing: str = "reference", storage: str = "raw"):
    """One full fluid update: equilibrium -> TRT collide -> stream.

    Inputs are this step's f and the *previous* step's IB force (one-step
    force lag, main.cu:852 reading spread's output of the prior iteration).
    Returns (f_new, rho_new, u_new) with the *uncorrected* macro moments that
    the reference's interpolate kernel reads (main.cu:880,900).  Streaming
    and walls are weight-preserving permutations, so they act identically
    on raw and deviatoric storage.
    """
    f1 = collide(f, force, tau, tau2, forcing, storage)
    f_new = stream(f1, walls)
    rho_new, u_new = moments(f_new, storage)
    return f_new, rho_new, u_new
