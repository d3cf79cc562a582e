"""The flagship model: mucociliary pumping — D2Q9 TRT fluid + IB cilia array.

One jitted ``step`` reproduces the reference's 8-kernel per-iteration pipeline
(main.cu:817-934) with its exact ordering semantics:

  1. cilia kinematics + placement + overlap mask      (define_filament,
     boundary_check — independent of this step's fluid)
  2. equilibrium + Guo forcing using the PREVIOUS step's IB force (one-step
     force lag: spread writes ``force`` at step it, equilibrium reads it at
     it+1 — main.cu:852 vs ImmersedBoundary.cu:166-231) and the previous
     spread-corrected velocity (recomputed here from (f, force), exactly
     equal to the reference's buffered u)
  3. TRT collision, pull-form streaming with walls, macro moments
  4. IB interpolation on the UNCORRECTED macro velocity (interpolate runs
     before spread — main.cu:900,909)
  5. IB spreading -> new force field; velocity half-force correction;
     cumulative flux increment Q += sum_col u_x / 192 (never reset,
     main.cu:393)

The LB sub-step is pluggable: 'jnp' (the XLA path, any dtype) or 'triton'
(the fused Pallas kernel of ops/pallas_step.py, GPU only); resolve_backend
makes the choice.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.state import FlowState, initial_state
from cuda_iblb_11_tpu.models.cilia import CiliaModel
from cuda_iblb_11_tpu.ops import ib, ib_band
from cuda_iblb_11_tpu.ops import reference as ref


KERNEL_DTYPES = ("float32", "bfloat16")


def resolve_backend(requested: str, platform: str, cfg: SimConfig, dtype,
                    walls: ref.WallSpec = ref.REFERENCE_WALLS,
                    interpret: bool = False):
    """The LB backend for one run, and why: ``(backend, reason)``.

    ``requested`` is "auto", "jnp" or "triton"; ``platform`` is
    ``jax.default_backend()``.  "auto" takes the fused kernel where it can
    compile (gpu) and covers the run (f32/bf16 storage, the reference
    channel's walls): on an H100 it beat the jnp path at 2048^2 and at
    288x192 (PERF.md).  float64 runs the jnp path.  An explicit "triton"
    where the kernel cannot run is an error; interpret mode is only ever
    asked for explicitly (``interpret=True``, for tests)."""
    dtype = str(jnp.dtype(dtype))
    blockers = []
    if platform != "gpu" and not interpret:
        blockers.append(f"platform is {platform}; the fused kernel "
                        "compiles only for gpu")
    if not (walls.left == "periodic" and walls.bottom == "noslip"
            and walls.top in ("slip", "noslip")):
        blockers.append("walls other than the reference channel")
    if requested == "jnp":
        return "jnp", None
    if requested == "triton":
        if blockers:
            raise ValueError("backend 'triton' cannot run here: "
                             + "; ".join(blockers))
        return "triton", None
    if requested != "auto":
        raise ValueError(f"unknown backend {requested!r}")
    if dtype not in KERNEL_DTYPES:
        # the reference's own precision: the XLA path, native on the GPU
        blockers.append(f"dtype {dtype} runs the jnp path")
    if blockers:
        return "jnp", "auto: " + "; ".join(blockers)
    return "triton", f"auto: {platform}, {dtype}, {cfg.ydim}x{cfg.xdim}"


class MucociliarySim:
    def __init__(
        self,
        cfg: SimConfig,
        walls: ref.WallSpec = ref.REFERENCE_WALLS,
        backend: str = "jnp",
        pattern: str = "no_mucus",
        forcing: str = "trt_split",
        dtype=None,
        ib_x_edge: str = "periodic",
        interpret: bool = False,
    ):
        """backend: "jnp", "triton" or "auto" (resolve_backend; the pick and
        its reason land in resolved_config() and SimLog).  interpret runs
        the triton kernel in Pallas interpret mode (tests only).

        forcing: "trt_split" (default; TRT-consistent Guo forcing, stable
        at the reference's default parameters) or "reference" (the committed
        CUDA's uniform (1-1/(2 TAU)) prefactor, which amplifies the effective
        IB force ~1.75x and is linearly unstable for dense boundary nodes —
        see ops/reference.py:guo_forcing and tests/test_stability.py).

        ib_x_edge: "periodic" (default; physically-correct periodic wrap
        of the IB stencil in x) or "reference" (quirk-exact strict-parity
        mode: interpolation row-aliases like the CUDA's unwrapped flat
        index, ImmersedBoundary.cu:119-124, and spreading drops the
        periodic images — see ops/ib.py).  The quirk mode uses the stencil
        gather/scatter forms instead of the band matmuls and is meant for
        parity studies, not production."""
        cfg.validate()
        self.cfg = cfg
        self.walls = walls
        self.forcing = forcing
        self.dtype = jnp.dtype(dtype or cfg.dtype)
        if self.dtype == jnp.dtype("float64") and not jax.config.jax_enable_x64:
            # without x64 every jnp.zeros(..., float64) silently truncates
            # to f32 and the "high-precision" run would be an f32 run
            raise ValueError(
                "dtype float64 needs jax x64 enabled: run via the CLI "
                "(--dtype float64 enables it), or set "
                "jax.config.update('jax_enable_x64', True) / use the "
                "scoped jax.enable_x64(True) context before constructing "
                "the sim.")
        # boundary/IB quantities stay >= f32 even with bf16 fluid storage
        self.aux_dtype = jnp.promote_types(self.dtype, jnp.float32)
        self.cilia = CiliaModel(cfg, dtype=self.aux_dtype, pattern=pattern)
        self.pattern = pattern
        self._interpret = interpret
        self.backend, self.backend_reason = resolve_backend(
            backend, jax.default_backend(), cfg, self.dtype, walls,
            interpret)
        self.storage = cfg.storage_resolved
        if ib_x_edge not in ("periodic", "reference"):
            raise ValueError(f"unknown ib_x_edge {ib_x_edge!r}")
        self.ib_x_edge = ib_x_edge
        # With the band-matmul IB path the fused kernel also emits the band
        # moments, so the step never reads f_new back for them.
        self._emit = self.backend == "triton" and ib_x_edge == "periodic"
        if self.backend == "triton":
            from cuda_iblb_11_tpu.ops.pallas_step import make_fused_substep

            self._lb_substep = make_fused_substep(
                cfg, walls, self.dtype, forcing=forcing,
                storage=self.storage, emit_moments=self._emit,
                interpret=interpret)
        else:
            def _substep(f, force_band):
                force = ib_band.pad_band(force_band, cfg.ydim)
                # compute in >= f32 even with bf16 storage
                f_new, _, _ = ref.lb_substep(
                    f.astype(self.aux_dtype), force, cfg.tau, cfg.tau2,
                    walls, forcing=forcing, storage=self.storage)
                return f_new.astype(self.dtype)

            self._lb_substep = _substep

    # Sims built from equal arguments compute the same functions, so they
    # compare equal and share jit-compiled chunks (self is a static jit
    # argument): a second run of a configuration in one process, as in a
    # sweep, compiles nothing.
    def _key(self):
        return (self.cfg, self.walls, self.backend, self.forcing,
                str(self.dtype), self.ib_x_edge, self.pattern,
                self._interpret)

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def init_state(self) -> FlowState:
        return initial_state(self.cfg, self.dtype)

    def resolved_config(self) -> dict:
        """The ACTUAL execution configuration after every auto/fallback
        decision — the analogue of the reference logging its real launch
        config (threads/blocks, main.cu:782-783) rather than what was
        asked for.  Written into SimLog and the runner summary so perf
        claims are reproducible from a run's own artifacts."""
        return {
            "backend": self.backend,
            "backend_reason": self.backend_reason,
            "storage": self.storage,
            "dtype": str(self.dtype),
            "forcing": self.forcing,
            "ib_path": ("stencil_quirk" if self.ib_x_edge == "reference"
                        else "band_matmul"),
            "mesh": None,
        }

    def _fluid_ib_step(self, f, force, q, u_s, eps, anchored, s=None):
        """Fluid + IB + flux for one step, given this step's boundary data.

        Boundary positions arrive in the precision-preserving
        (integer anchor, small local) split (models/cilia.py:place_precise)
        so the f32 delta evaluation keeps full precision at any XDIM; the
        strict-parity quirk mode additionally receives the raw positions s
        and uses the stencil gather/scatter forms."""
        cfg = self.cfg
        band = cfg.force_band
        if self._emit:
            f_new, q_band = self._lb_substep(f, force)
        else:
            f_new = self._lb_substep(f, force)
        if self.ib_x_edge == "reference":
            # quirk-exact x-edge treatment (ops/ib.py docstring)
            f_s = ib.interpolate_from_f(f_new, s, u_s, storage=self.storage,
                                        x_edge="reference")
            force_new = ib.spread(f_s, s, eps, cfg.xdim, band,
                                  x_edge="reference")
        else:
            # IB coupling in the band-matmul form (ops/ib_band.py), mathematically identical to the stencil
            # gather/scatter (ops/ib.py).  The delta factors are evaluated
            # once and shared between interpolate and spread.
            factors = ib_band.delta_factors(anchored, cfg.xdim, band,
                                            self.aux_dtype)
            if self._emit:
                f_s = ib_band.interpolate_from_moments(q_band, u_s, factors)
            else:
                f_s = ib_band.interpolate(f_new, None, u_s, band,
                                          storage=self.storage,
                                          factors=factors)
            force_new = ib_band.spread(f_s, None, eps, cfg.xdim, band,
                                       factors=factors)
        q_new = q + ib.flux_increment(f_new, force_new, cfg.flux_x,
                                      storage=self.storage)
        return f_new, force_new, q_new

    def step(self, state: FlowState) -> FlowState:
        pos, vel, lasts_new = self.cilia.kinematics(state.it, state.lasts)
        s, u_s, eps = self.cilia.place_and_mask(pos, vel)
        anchored = self.cilia.anchored_nodes(pos)
        f_new, force_new, q_new = self._fluid_ib_step(
            state.f, state.force, state.q, u_s, eps, anchored, s)
        return FlowState(
            f=f_new, force=force_new,
            lasts=lasts_new.astype(self.aux_dtype),
            q=q_new, it=state.it + 1,
        )

    # Keep xs arrays for a scanned chunk below ~32 MB.
    _MAX_SCAN = 512

    @partial(jax.jit, static_argnums=(0, 2), donate_argnums=(1,))
    def _run_scan(self, state: FlowState, n_steps: int) -> FlowState:
        """n_steps iterations in one compiled region.

        The cilia kinematics (many tiny ops) are batched over all steps of
        the chunk OUTSIDE the scan — vmapped positions + backward-difference
        velocities + placement/epsilon — so the scan body is only the LB
        step, the IB band matmuls and the flux sample."""
        cfg = self.cfg
        its = state.it + jnp.arange(n_steps, dtype=jnp.int32)
        pos = jax.vmap(self.cilia.positions)(its)          # [n, c, nodes, 2]
        vel = jnp.where((its > 0)[:, None, None, None],
                        jax.vmap(self.cilia.velocities)(its),
                        jnp.zeros_like(pos))
        s_all, u_s, eps = jax.vmap(self.cilia.place_and_mask)(pos, vel)
        anchor, frac = jax.vmap(self.cilia.anchored_nodes)(pos)

        def body(carry, xs):
            f, force, q = carry
            u_k, e_k, a_k, fr_k, s_k = xs
            f, force, q = self._fluid_ib_step(
                f, force, q, u_k, e_k, (a_k, fr_k), s_k)
            return (f, force, q), None

        (f, force, q), _ = jax.lax.scan(
            body, (state.f, state.force, state.q),
            (u_s, eps, anchor, frac, s_all))
        return FlowState(f=f, force=force,
                         lasts=pos[-1].astype(self.aux_dtype), q=q,
                         it=state.it + n_steps)

    def run_chunk(self, state: FlowState, n_steps: int) -> FlowState:
        """n_steps iterations inside compiled scan(s) of at most _MAX_SCAN
        steps each."""
        while n_steps > 0:
            k = min(n_steps, self._MAX_SCAN)
            state = self._run_scan(state, k)
            n_steps -= k
        return state

    def fields(self, state: FlowState):
        """(rho, u_corrected) for output — the values the reference snapshots
        (main.cu:944-971): macro rho and the spread-corrected velocity."""
        force = ib_band.pad_band(state.force, self.cfg.ydim)
        rho, u = ref.corrected_velocity(state.f, force, self.storage)
        return rho, u

    def boundary_fields(self, state: FlowState):
        """(s, u_s, eps) as of the LAST COMPLETED step, for cilia snapshots.
        state.it is the next step index, so re-evaluate at it-1 using the
        positions stored in ``lasts`` (which are exactly step it-1's).
        Clamped at the it=0 boundary (nothing has run yet): emit the
        phase-0 placement with zero velocity — the reference's
        0-cilia.dat after define_filament(it=0) — not the wrapped
        phase T-1 that (it-1) % T would select."""
        it_prev = jnp.maximum(state.it - 1, 0)
        pos = self.cilia.positions(it_prev)
        # velocity at it_prev: pos(it_prev) - pos(it_prev - 1), zero at it=0
        pos_before = self.cilia.positions(jnp.maximum(it_prev - 1, 0))
        vel = jnp.where(it_prev > 0, pos - pos_before, jnp.zeros_like(pos))
        return self.cilia.place_and_mask(pos, vel)
