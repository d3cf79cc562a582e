"""Cilium beat kinematics, boundary placement and overlap masking.

Replicates the reference's ``define_filament`` and ``boundary_check`` kernels
(CUDA_IBLB_11/main.cu:77-252) as pure-JAX batched math over
[c_num, nodes] arrays.

Beat pattern: each cilium is a filament whose shape is a truncated Fourier
series in the beat phase with arc-length-dependent coefficients — the
Fulford/Blake-style fit.  Coefficient tensors A_mn/B_mn hold
[3 arc-length powers x 2 coordinates x 7 harmonics] (main.cu:56-74; the
mucus-loaded variant commented out at main.cu:36-54 is also provided).

    a_n(arcl) = sum_p A[p,coord,n] * arcl^(p+1)        (main.cu:109-135)
    pos(arcl, phase) = 111 * ( a_0/2
        + sum_{n=1..6} a_n cos(2 pi n phase/T) + b_n sin(2 pi n phase/T) )
                                                        (main.cu:137-145)
    phase_m = (it + m*p_step) mod T, p_step = T*c_fraction//c_num
              (metachronal wave, main.cu:102-103,336)

Node selection: the reference evaluates 9600 fine samples per cilium and
keeps the ~96 whose scaled arc length 111*k/9600 is within 0.01 of an integer
(main.cu:158-172), with a benign last-writer-wins race when two samples
match.  Here each node j evaluates directly at arcl_j = round(j*9600/111)/9600
— the unique fine sample nearest the integer arc length, always within the
reference's 0.01 tolerance and deterministic.

Placement and masking (``boundary_check``, main.cu:176-252): shift into the
domain frame x += c_space*c_num/2 (single periodic wrap into [0, XDIM]),
y += 1; boundary velocity is the backward difference of node positions
(zero at it=0); epsilon deactivates any node within <1 lattice unit (both
axes) of any node of the up-to r_max-1 = 2*length/c_space - 1 cilia to its
left (cyclically), preventing double-counted IB force during overlap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import PI_REF

# Arc-length rescale: ~96/0.865 so the unit beat envelope spans ~96 lattice
# units (main.cu:137-139).  A fixed constant in the reference.
BEAT_SCALE = 111.0
FINE_SAMPLES = 9600
N_HARMONICS = 7

# Fourier coefficient tensors, flat in the reference's layout
# index = n + 14*p + 7*coord  =>  reshape(3, 2, 7) -> [power, coord, harmonic].
# "WITHOUT MUCUS" set (main.cu:56-74).
A_MN_NO_MUCUS = np.array([
    -0.654,  0.393, -0.097,  0.079,  0.119,  0.119,  0.009,
     1.895, -0.018,  0.158,  0.010,  0.003,  0.013,  0.040,
     0.787, -1.516,  0.032, -0.302, -0.252, -0.015,  0.035,
    -0.552, -0.126, -0.341,  0.035,  0.006, -0.029, -0.068,
     0.202,  0.716, -0.118,  0.142,  0.110, -0.013, -0.043,
     0.096,  0.263,  0.186, -0.067, -0.032, -0.002,  0.015,
]).reshape(3, 2, 7)

B_MN_NO_MUCUS = np.array([
    0.0,  0.284,  0.006, -0.059,  0.018,  0.053,  0.009,
    0.0,  0.192, -0.050,  0.012, -0.007, -0.014, -0.017,
    0.0,  1.045,  0.317,  0.226,  0.004, -0.082, -0.040,
    0.0, -0.499,  0.423,  0.138,  0.125,  0.075,  0.067,
    0.0, -1.017, -0.276, -0.196, -0.037,  0.025,  0.023,
    0.0,  0.339, -0.327, -0.114, -0.105, -0.057, -0.055,
]).reshape(3, 2, 7)

# "WITH MUCUS PRESENT" set (commented out in the reference, main.cu:36-54),
# exposed as an alternative beat pattern.
A_MN_MUCUS = np.array([
    -0.449,  0.130, -0.169,  0.063, -0.050, -0.040, -0.068,
     2.076, -0.003,  0.054,  0.007,  0.026,  0.022,  0.010,
    -0.072, -1.502,  0.260, -0.123,  0.011, -0.009,  0.196,
    -1.074, -0.230, -0.305, -0.180, -0.069,  0.001, -0.080,
     0.658,  0.793, -0.251,  0.049,  0.009,  0.023, -0.111,
     0.381,  0.331,  0.193,  0.082,  0.029,  0.002,  0.048,
]).reshape(3, 2, 7)

B_MN_MUCUS = np.array([
    0.0, -0.030, -0.093,  0.037,  0.062,  0.016, -0.065,
    0.0,  0.080, -0.044, -0.017,  0.052,  0.007,  0.051,
    0.0,  1.285, -0.036, -0.244, -0.093, -0.137,  0.095,
    0.0, -0.298,  0.513,  0.004, -0.222,  0.035, -0.128,
    0.0, -1.034,  0.050,  0.143,  0.043,  0.098, -0.054,
    0.0,  0.210, -0.367,  0.009,  0.120, -0.024,  0.102,
]).reshape(3, 2, 7)

PATTERNS = {
    "no_mucus": (A_MN_NO_MUCUS, B_MN_NO_MUCUS),
    "mucus": (A_MN_MUCUS, B_MN_MUCUS),
}


def node_arclengths(length: int) -> np.ndarray:
    """arcl_j = k_j / 9600 with k_j = round(j * 9600 / 111): the fine sample
    the reference's selection loop (main.cu:158-172) keeps for node j."""
    j = np.arange(length)
    k = np.rint(j * FINE_SAMPLES / BEAT_SCALE)
    return k / FINE_SAMPLES


class CiliaModel:
    """Batched beat kinematics for all cilia.

    Per step produces absolute node positions s [Ns,2], boundary velocities
    u_s [Ns,2] and the overlap mask eps [Ns], plus the updated ``lasts``
    carry (previous positions in the beat frame, for the backward-difference
    velocity — main.cu:147-155).
    """

    def __init__(self, cfg: SimConfig, dtype=jnp.float32, pattern="no_mucus"):
        self.cfg = cfg
        self.dtype = jnp.dtype(dtype)
        # High-precision dtype for the kinematics: the Fourier sums are
        # scaled by 111, so f32 summation noise alone is ~1e-4 lattice units
        # on the node positions.  The arrays are O(c_num*96) — negligible
        # in f64 — and the results are handed to the
        # f32 fluid as (integer anchor, sub-cell fraction) pairs so no
        # precision is lost in the cast (see anchored_nodes).  f64 is used
        # via the scoped jax.enable_x64 context so the f32 fluid kernels
        # are unaffected by the global x64 flag.
        self.hp = jnp.dtype(jnp.float64)

        a_mn, b_mn = PATTERNS[pattern]
        arcl = node_arclengths(cfg.length)  # [nodes]
        powers = arcl[:, None] ** np.array([1.0, 2.0, 3.0])[None, :]  # [nodes,3]
        with jax.enable_x64(True):
            # a_pre[j, n, coord] = sum_p A[p, coord, n] * arcl_j^(p+1)
            self.a_pre = jnp.asarray(
                np.einsum("jp,pcn->jnc", powers, a_mn), self.hp)
            self.b_pre = jnp.asarray(
                np.einsum("jp,pcn->jnc", powers, b_mn), self.hp)
            # Cilium base offsets (m - (c_num-1)/2)*c_space  (main.cu:105).
            m = np.arange(cfg.c_num)
            self.offsets = jnp.asarray(
                (m - (cfg.c_num - 1) / 2.0) * cfg.c_space, self.hp)
            # Absolute domain shift c_space*c_num/2 (main.cu:193); the
            # per-cilium base offset is already inside positions().
            self.shift_x = jnp.asarray(
                (cfg.c_space * cfg.c_num) / 2.0, self.hp)
            self.harmonics = jnp.arange(N_HARMONICS, dtype=self.hp)
        # r_max for the overlap mask (main.cu:185); integer division.
        self.r_max = 2 * cfg.length // cfg.c_space

    def positions(self, it):
        """Node positions in the beat frame (x includes the base offset),
        shape [c_num, nodes, 2], in the high-precision dtype.  `it` may be
        traced (int32)."""

        with jax.enable_x64(True):
            return self._positions_x64(it)

    def _positions_x64(self, it):
        cfg = self.cfg
        m = jnp.arange(cfg.c_num, dtype=jnp.int32)
        total = it.astype(jnp.int32) + m * jnp.int32(cfg.p_step)
        # Reference quirk (main.cu:102-103): phase stays T (not 0) when the
        # total equals T exactly; with the truncated PI literal this differs
        # from phase 0 by ~1e-10.
        phase = jnp.where(total == cfg.T, cfg.T, total % cfg.T)
        theta = (2.0 * PI_REF / cfg.T) * phase.astype(self.hp)  # [c_num]
        ang = self.harmonics[None, :] * theta[:, None]  # [c_num, 7]
        cosn = jnp.cos(ang)
        sinn = jnp.sin(ang)
        # n=0 term is a_0/2 (cos(0)=1 exactly, so fold the 1/2 into the sum
        # by halving the n=0 column); b_0 = 0 in all patterns.
        scale = jnp.concatenate(
            [jnp.array([0.5], self.hp), jnp.ones((6,), self.hp)])
        pos = BEAT_SCALE * (
            jnp.einsum("jnc,mn->mjc", self.a_pre, cosn * scale[None],
           precision=jax.lax.Precision.HIGHEST)
            + jnp.einsum("jnc,mn->mjc", self.b_pre, sinn * scale[None],
             precision=jax.lax.Precision.HIGHEST)
        )
        pos = pos.at[:, :, 0].add(self.offsets[:, None])
        return pos

    def velocities(self, it):
        """Backward-difference node velocity pos(it) - pos(it-1), evaluated
        via the trig identity
            cos(n th_t) - cos(n th_p) = -2 sin(n (th_t+th_p)/2) sin(n dth/2)
        instead of subtracting two O(100)-lattice-unit positions — in f32 the
        naive difference loses ~3 decimal digits of the ~1e-3 velocity to
        cancellation (the reference, computing in CUDA float, has exactly
        that noise; main.cu:147-155).  Algebraically identical: the offset
        and n=0 terms cancel in the difference."""

        with jax.enable_x64(True):
            return self._velocities_x64(it)

    def _velocities_x64(self, it):
        cfg = self.cfg
        m = jnp.arange(cfg.c_num, dtype=jnp.int32)
        tot_t = it.astype(jnp.int32) + m * jnp.int32(cfg.p_step)
        tot_p = tot_t - 1
        phase_t = jnp.where(tot_t == cfg.T, cfg.T, tot_t % cfg.T)
        phase_p = jnp.where(tot_p == cfg.T, cfg.T, tot_p % cfg.T)
        k = jnp.asarray(2.0 * PI_REF / cfg.T, self.hp)
        half_sum = 0.5 * k * (phase_t + phase_p).astype(self.hp)
        half_dif = 0.5 * k * (phase_t - phase_p).astype(self.hp)
        n = self.harmonics[None, :]
        # cos diff and sin diff per harmonic, [c_num, 7]
        dcos = -2.0 * jnp.sin(n * half_sum[:, None]) * jnp.sin(
            n * half_dif[:, None])
        dsin = 2.0 * jnp.cos(n * half_sum[:, None]) * jnp.sin(
            n * half_dif[:, None])
        vel = BEAT_SCALE * (
            jnp.einsum("jnc,mn->mjc", self.a_pre, dcos,
           precision=jax.lax.Precision.HIGHEST)
            + jnp.einsum("jnc,mn->mjc", self.b_pre, dsin,
             precision=jax.lax.Precision.HIGHEST)
        )
        return vel

    def kinematics(self, it, lasts):
        """positions + backward-difference velocity.  Returns (pos, vel, lasts_new);
        vel is zero at it=0 (main.cu:147-151, boundary_check :200-209)."""
        pos = self.positions(it)
        vel = jnp.where(it > 0, self.velocities(it), jnp.zeros_like(pos))
        return pos, vel, pos

    def place_and_mask(self, pos, vel):
        """boundary_check (main.cu:176-252): domain placement, velocity
        passthrough, epsilon overlap mask.  Returns (s [Ns,2], u_s [Ns,2],
        eps [Ns]) flattened over (cilium, node), in self.dtype."""
        cfg = self.cfg
        pos = pos.astype(self.dtype)
        vel = vel.astype(self.dtype)
        xdim = self.dtype.type(cfg.xdim)
        x = self.dtype.type(
            (cfg.c_space * cfg.c_num) / 2.0) + pos[:, :, 0]
        # Single wrap, thresholds exactly as the reference (<0, >XDIM).
        x = jnp.where(x < 0, x + xdim, jnp.where(x > xdim, x - xdim, x))
        y = pos[:, :, 1] + 1.0
        s = jnp.stack([x, y], axis=-1)  # [c_num, nodes, 2]

        # Overlap mask: node j of cilium m is deactivated if within <1 lattice
        # unit (both axes) of ANY node of cilia m-1 .. m-(r_max-1) (cyclic).
        eps = jnp.ones(x.shape, jnp.int32)
        for r in range(1, self.r_max):
            xo = jnp.roll(x, r, axis=0)  # [m] -> cilium (m - r) mod c_num
            yo = jnp.roll(y, r, axis=0)
            close = (
                (jnp.abs(xo[:, None, :] - x[:, :, None]) < 1.0)
                & (jnp.abs(yo[:, None, :] - y[:, :, None]) < 1.0)
            ).any(axis=-1)  # [c_num, nodes]
            eps = jnp.where(close, 0, eps)

        ns = cfg.c_num * cfg.length
        return s.reshape(ns, 2), vel.reshape(ns, 2), eps.reshape(ns)

    def anchored_nodes(self, pos):
        """(anchor [Ns,2] int32, frac [Ns,2] self.dtype) such that the
        absolute (pre-wrap) node position is anchor + frac with
        |frac| <= 0.5: the precision-preserving form consumed by the
        anchored IB delta factors (ops/ib_band.py).  Computed from the
        high-precision positions, so casting frac to f32 loses nothing
        (|frac| <= 0.5 => cast error ~3e-8 lattice units)."""
        cfg = self.cfg
        ns = cfg.c_num * cfg.length
        abs_x = self.shift_x + pos[:, :, 0]
        abs_y = pos[:, :, 1] + 1.0
        ab = jnp.stack([abs_x, abs_y], axis=-1).reshape(ns, 2)
        anchor = jnp.rint(ab)
        frac = (ab - anchor).astype(self.dtype)
        return anchor.astype(jnp.int32), frac

    def boundary_state(self, it, lasts):
        """Full cilia substep: kinematics -> placement -> mask."""
        pos, vel, lasts_new = self.kinematics(it, lasts)
        s, u_s, eps = self.place_and_mask(pos, vel)
        return s, u_s, eps, lasts_new
