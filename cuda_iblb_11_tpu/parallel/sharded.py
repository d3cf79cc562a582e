"""Multi-chip spatial domain decomposition (the stencil analogue of DP+SP).

The reference is strictly single-GPU (cudaSetDevice + no MPI/NCCL anywhere,
main.cu:395-396); scale-out is a new first-class capability of this
framework: the [9, Y, X] lattice is sharded over a 2-D device mesh
('y', 'x'), each step exchanges a 1-cell halo of the distributions and the
IB force field with the 4 neighbours via ring `jax.lax.ppermute` (which
XLA hands to NCCL on GPUs), and the scalar reductions (IB force gather, flux integral)
ride `jax.lax.psum`.

Design notes
  * x is globally periodic, so the x-halo ring is exact.  y has walls; the
    y-ring delivers wrapped junk to the outermost shards, which is harmless
    because the only rows that would read it are wall rows, overwritten by
    the bounce-back / slip fixups.
  * The cilia kinematics are O(c_num*96) and run replicated on every shard.
  * IB interpolation gathers each Lagrangian point's 3x3 stencil from the
    shard that owns each cell (ownership-masked local gather + psum);
    spreading scatters the masked 3x3 patches into the local force block.
    Every stencil cell is owned by exactly one shard, so the psum is exact.
  * The flux column x = XDIM-5 lives in one x-shard; a masked column sum +
    psum reproduces the reference's Q accumulation (ImmersedBoundary.cu:
    259-264) bit-for-bit across shard counts (verified in
    tests/test_sharding.py: 1-shard vs N-shard equality).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import C, MIRROR_Y, OPPOSITE
from cuda_iblb_11_tpu.core.state import FlowState, initial_state
from cuda_iblb_11_tpu.models.cilia import CiliaModel
from cuda_iblb_11_tpu.ops import ib
from cuda_iblb_11_tpu.ops import reference as ref


def make_mesh(n_y: int, n_x: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < n_y * n_x:
        raise ValueError(f"need {n_y * n_x} devices, have {devices.size}")
    return Mesh(devices[: n_y * n_x].reshape(n_y, n_x), ("y", "x"))


def _exchange_halo(arr, axis_name, axis):
    """Ring-exchange 1-cell halos along `axis` over mesh axis `axis_name`.
    Returns the array extended by one slot on each side of `axis`."""
    n = jax.lax.psum(1, axis_name)
    idx = [slice(None)] * arr.ndim
    idx_lo = list(idx)
    idx_lo[axis] = slice(0, 1)
    idx_hi = list(idx)
    idx_hi[axis] = slice(arr.shape[axis] - 1, arr.shape[axis])
    lo_edge = arr[tuple(idx_lo)]
    hi_edge = arr[tuple(idx_hi)]
    # halo below comes from the previous shard's top edge, and vice versa
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    halo_lo = jax.lax.ppermute(hi_edge, axis_name, fwd)
    halo_hi = jax.lax.ppermute(lo_edge, axis_name, bwd)
    return jnp.concatenate([halo_lo, arr, halo_hi], axis=axis)


def _local_lb_substep(f_loc, force_loc, tau, tau2, walls, forcing,
                      is_bottom, is_top, storage="raw"):
    """One fluid update on a local block with halo exchange.

    f_loc [9, Yl, Xl] -> f_new [9, Yl, Xl].  Equivalent to
    ops.reference.lb_substep on the assembled global array.
    """
    f_ext = _exchange_halo(_exchange_halo(f_loc, "x", 2), "y", 1)
    fo_ext = _exchange_halo(_exchange_halo(force_loc, "x", 2), "y", 1)

    f1 = ref.collide(f_ext, fo_ext, tau, tau2, forcing, storage)

    yl = f_loc.shape[1]
    xl = f_loc.shape[2]
    # Pull-form gather from the extended block (interior + periodic-x are
    # both plain shifted slices thanks to the halos).
    pulled = [
        f1[d, 1 - int(C[d, 1]):1 - int(C[d, 1]) + yl,
           1 - int(C[d, 0]):1 - int(C[d, 0]) + xl]
        for d in range(9)
    ]
    f_new = jnp.stack(pulled)

    # Wall fixups on the outermost shards (same-cell permuted populations,
    # LatticeBoltzmann.cu:328-353).  f1's interior offset is +1.
    def fix_row(f_new, row_loc, row_ext, perm, incoming, active):
        for d in incoming:
            src = int(perm[d])
            wall_val = f1[src, row_ext, 1:1 + xl]
            cur = f_new[d, row_loc, :]
            f_new = f_new.at[d, row_loc, :].set(
                jnp.where(active, wall_val, cur))
        return f_new

    if walls.bottom == "noslip":
        f_new = fix_row(f_new, 0, 1, OPPOSITE, (2, 5, 6), is_bottom)
    if walls.top == "slip":
        f_new = fix_row(f_new, yl - 1, yl, MIRROR_Y, (4, 7, 8), is_top)
    elif walls.top == "noslip":
        f_new = fix_row(f_new, yl - 1, yl, OPPOSITE, (4, 7, 8), is_top)
    return f_new


class ShardedMucociliarySim:
    """Sharded counterpart of models.mucociliary.MucociliarySim: the whole
    step (fluid + IB + cilia + flux) runs inside one shard_map."""

    def __init__(self, cfg: SimConfig, mesh: Mesh,
                 walls: ref.WallSpec = ref.REFERENCE_WALLS,
                 forcing: str = "trt_split", pattern: str = "no_mucus",
                 dtype=None, *, ib_x_edge: str = "periodic"):
        cfg.validate()
        if ib_x_edge not in ("periodic", "reference"):
            raise ValueError(f"unknown ib_x_edge {ib_x_edge!r}")
        # "reference" = the CUDA's row-aliasing/drop quirk at the periodic
        # x edges (ops/ib.py docstring), so strict-parity studies of the
        # committed CUDA can run at scale.
        self.ib_x_edge = ib_x_edge
        # _local_lb_substep only implements the reference channel's wall
        # fixups; reject anything else rather than silently simulating it
        # as fully periodic.
        if walls.left != "periodic":
            raise NotImplementedError(
                "sharded backend requires periodic x walls")
        if walls.bottom != "noslip" or walls.top not in ("slip", "noslip"):
            raise NotImplementedError(
                "sharded backend supports bottom=noslip, top=slip|noslip "
                f"(got bottom={walls.bottom!r}, top={walls.top!r})")
        self.cfg = cfg
        self.mesh = mesh
        self.walls = walls
        self.forcing = forcing
        self.storage = cfg.storage_resolved
        self.dtype = jnp.dtype(dtype or cfg.dtype)
        # boundary/IB quantities stay >= f32 even with bf16 fluid storage
        # (same invariant as MucociliarySim.aux_dtype: bf16 point positions
        # would put the 3x3 stencils tens of cells off at 8192-wide grids)
        self.aux_dtype = jnp.promote_types(self.dtype, jnp.float32)
        self.cilia = CiliaModel(cfg, dtype=self.aux_dtype, pattern=pattern)
        self.n_y, self.n_x = mesh.devices.shape
        if cfg.ydim % self.n_y or cfg.xdim % self.n_x:
            raise ValueError("grid dims must divide the mesh dims")
        self.yl = cfg.ydim // self.n_y
        self.xl = cfg.xdim // self.n_x
        self._chunk_cache = {}
        self._step_sharded = None

    def resolved_config(self) -> dict:
        """The ACTUAL execution configuration after every fallback — see
        models.mucociliary.MucociliarySim.resolved_config (same contract;
        recorded into SimLog + the runner summary)."""
        return {
            "backend": "jnp",
            "backend_reason": None,
            "storage": self.storage,
            "dtype": str(self.dtype),
            "forcing": self.forcing,
            "ib_path": ("stencil_quirk" if self.ib_x_edge == "reference"
                        else "stencil"),
            "mesh": [self.n_y, self.n_x],
        }

    # -- sharding helpers ---------------------------------------------------

    def grid_sharding(self):
        return NamedSharding(self.mesh, P(None, "y", "x"))

    def replicated(self):
        return NamedSharding(self.mesh, P())

    def init_state(self) -> FlowState:
        # This path keeps the force field full-size [2, Y, X] (the
        # single-chip path stores only the nonzero band) so it shards
        # identically to f for the halo exchange; place_state pads.
        return self.place_state(initial_state(self.cfg, self.dtype))

    # -- the per-shard step ---------------------------------------------------

    def _step_local(self, f_loc, force_loc, lasts, q, it):
        cfg = self.cfg
        iy = jax.lax.axis_index("y")
        ix = jax.lax.axis_index("x")
        is_bottom = iy == 0
        is_top = iy == self.n_y - 1
        y0 = iy * self.yl
        x0 = ix * self.xl

        # Cilia kinematics: replicated (tiny).  lasts_new can come out of
        # the scoped-x64 kinematics as f64; the loop carry must keep the
        # state dtype (found by the multi-host CPU test, which runs
        # without the test suite's global x64).
        s, u_s, eps, lasts_new = self.cilia.boundary_state(it, lasts)
        lasts_new = lasts_new.astype(lasts.dtype)

        # compute in >= f32 even with bf16 fluid storage (mirrors the
        # single-chip jnp backend), then cast back for the carry
        f_new = _local_lb_substep(
            f_loc.astype(self.aux_dtype), force_loc.astype(self.aux_dtype),
            cfg.tau, cfg.tau2, self.walls, self.forcing,
            is_bottom, is_top, self.storage).astype(f_loc.dtype)

        # --- IB interpolation: ownership-masked local gather + psum ------
        f_s = _stencil_interp_block(
            f_new, s, u_s, cfg, y0, self.yl, x0, self.xl, self.storage,
            mode=ib._alias_mode(self.ib_x_edge, "interp"))
        f_s = jax.lax.psum(jax.lax.psum(f_s, "x"), "y")    # [Ns, 2]

        # --- IB spreading into the local block ---------------------------
        # periodic: interp and spread share the wrapped stencil; quirk
        # mode: spread DROPS the periodic images while interp row-aliases
        # — two different stencils (ops/ib.py)
        xw2, yc2, w2, valid2 = ib._stencil(
            s, cfg.xdim, cfg.ydim,
            ib._alias_mode(self.ib_x_edge, "spread"))
        own2 = ((yc2 >= y0) & (yc2 < y0 + self.yl)
                & (xw2 >= x0) & (xw2 < x0 + self.xl))
        ws_w = jnp.where(valid2 & own2, w2, 0.0)
        ws_yloc = jnp.clip(yc2 - y0, 0, self.yl - 1)
        ws_xloc = jnp.clip(xw2 - x0, 0, self.xl - 1)
        ws = ws_w * eps[:, None].astype(ws_w.dtype)
        flat = (ws_yloc * self.xl + ws_xloc).reshape(-1)
        vals = (f_s.T[:, :, None] * ws[None]).reshape(2, -1)
        # force stays at the carry's (>= f32) dtype under bf16 f storage
        force_new = jnp.zeros((2, self.yl * self.xl), force_loc.dtype)
        force_new = force_new.at[:, flat].add(
            vals.astype(force_loc.dtype)).reshape(2, self.yl, self.xl)

        # --- flux: masked column sum + psum (cumulative Q) ---------------
        fx = cfg.flux_x
        col_owned = (fx >= x0) & (fx < x0 + self.xl)
        xf = jnp.clip(fx - x0, 0, self.xl - 1)
        cdt = jnp.promote_types(f_new.dtype, jnp.float32)
        col_f = f_new[:, :, xf].astype(cdt)
        rho_col = jnp.sum(col_f, axis=0)
        if self.storage == "deviatoric":
            rho_col = 1.0 + rho_col
        mom_col = ref.lattice_sum(col_f, C[:, 0])
        ux_col = (mom_col + 0.5 * force_new[0, :, xf]) / rho_col
        contrib = jnp.where(col_owned, jnp.sum(ux_col), 0.0) / 192.0
        q_new = q + jax.lax.psum(jax.lax.psum(contrib, "x"), "y")

        return f_new, force_new, lasts_new, q_new, it + 1

    # -- public API -----------------------------------------------------------

    def step(self, state: FlowState) -> FlowState:
        if self._step_sharded is None:
            self._step_sharded = jax.jit(
                jax.shard_map(
                    self._step_local,
                    mesh=self.mesh,
                    in_specs=self._chunk_specs(),
                    out_specs=self._chunk_specs(),
                    check_vma=False,
                ),
                donate_argnums=(0, 1),
            )
        f, force, lasts, q, it = self._step_sharded(
            state.f, state.force, state.lasts, state.q, state.it)
        return FlowState(f=f, force=force, lasts=lasts, q=q, it=it)

    def _force_sharding(self):
        return NamedSharding(self.mesh, P(None, "y", "x"))

    def _force_shape(self, force):
        """Adapt a checkpointed force field to this backend's layout
        (full [2, Y, X]; the single-device layout is band-only)."""
        from cuda_iblb_11_tpu.ops import ib_band

        if force.shape[1] < self.cfg.ydim:
            force = ib_band.pad_band(force, self.cfg.ydim)
        return force

    def place_state(self, state: FlowState) -> FlowState:
        """device_put a (host or single-device) FlowState onto the mesh —
        used when resuming a checkpoint into a sharded run."""
        return FlowState(
            f=jax.device_put(state.f, self.grid_sharding()),
            force=jax.device_put(self._force_shape(state.force),
                                 self._force_sharding()),
            lasts=jax.device_put(state.lasts, self.replicated()),
            q=jax.device_put(state.q, self.replicated()),
            it=jax.device_put(state.it, self.replicated()),
        )

    def fields(self, state: FlowState):
        """(rho, u_corrected) for snapshots (main.cu:944-971 semantics)."""
        from cuda_iblb_11_tpu.ops import ib_band

        force = state.force
        if force.shape[1] < self.cfg.ydim:
            force = ib_band.pad_band(force, self.cfg.ydim)
        return ref.corrected_velocity(state.f, force[:, :self.cfg.ydim],
                                      self.storage)

    def boundary_fields(self, state: FlowState):
        """(s, u_s, eps) of the last completed step, for cilia snapshots —
        identical semantics to the single-chip snapshot path, so delegate
        (the kinematics are replicated; only self.cilia is touched)."""
        from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

        return MucociliarySim.boundary_fields(self, state)

    def _make_chunk(self, n_steps: int):
        """One shard_map whose body runs n_steps iterations in a local
        fori_loop — removes per-step dispatch and lets XLA overlap the
        halo collectives with compute across iterations."""

        local_step = self._step_local

        def local_chunk(f, force, lasts, q, it):
            def body(_, carry):
                return local_step(*carry)

            return jax.lax.fori_loop(
                0, n_steps, body, (f, force, lasts, q, it))

        return jax.jit(
            jax.shard_map(
                local_chunk,
                mesh=self.mesh,
                in_specs=self._chunk_specs(),
                out_specs=self._chunk_specs(),
                check_vma=False,
            ),
            donate_argnums=(0, 1),
        )

    def _chunk_specs(self):
        return (P(None, "y", "x"), P(None, "y", "x"), P(), P(), P())

    # Keep the replicated per-step boundary series of one compiled chunk
    # below ~32 MB (mirrors MucociliarySim._MAX_SCAN: a whole multi-
    # thousand-step output interval in one chunk would materialize
    # [n, c_num, 96, 2]-and-friends xs arrays on EVERY device).
    _MAX_SCAN = 512

    def run_chunk(self, state: FlowState, n_steps: int) -> FlowState:
        """n_steps iterations in compiled sharded loops of at most
        _MAX_SCAN steps each."""
        while n_steps > 0:
            k = min(n_steps, self._MAX_SCAN)
            state = self._run_chunk_once(state, k)
            n_steps -= k
        return state

    def _run_chunk_once(self, state: FlowState, n_steps: int) -> FlowState:
        fn = self._chunk_cache.get(n_steps)
        if fn is None:
            fn = self._make_chunk(n_steps)
            self._chunk_cache[n_steps] = fn
        f, force, lasts, q, it = fn(
            state.f, state.force, state.lasts, state.q, state.it)
        return FlowState(f=f, force=force, lasts=lasts, q=q, it=it)

    def run(self, state: FlowState, n_steps: int) -> FlowState:
        for _ in range(n_steps):
            state = self.step(state)
        return state


def _stencil_interp_block(f_block, s, u_s, cfg, y0, rows, x0, xl, storage,
                          mode="reference_alias"):
    """PARTIAL stencil-form IB interpolation over a local block
    [9, rows, xl] holding global rows [y0, y0+rows) x columns
    [x0, x0+xl): the stencil (`mode`: "periodic" or the strict-parity
    "reference_alias" quirk, ops/ib.py) is evaluated globally, cells not
    owned by this block contribute zero, and the caller psums the result
    over the mesh axes that partition ownership.  Matches ops/ib.interpolate_from_f up to the
    psum re-association.  The gather is promoted to >= f32 (bf16 storage
    must not quantize the stiff IB feedback — same invariant as
    ops/ib_band.band_moments)."""
    cdt = jnp.promote_types(f_block.dtype, jnp.float32)
    xw, yc, w, valid = ib._stencil(s, cfg.xdim, cfg.ydim, mode)
    w = jnp.where(valid, w, 0.0)
    own = ((yc >= y0) & (yc < y0 + rows)
           & (xw >= x0) & (xw < x0 + xl))
    yloc = jnp.clip(yc - y0, 0, rows - 1)
    xloc = jnp.clip(xw - x0, 0, xl - 1)
    f_cells = f_block[:, yloc, xloc].astype(cdt)       # [9, Ns, 9cells]
    rho_c = jnp.sum(f_cells, axis=0)
    if storage == "deviatoric":
        rho_c = 1.0 + rho_c
    u_c = ref.lattice_momentum(f_cells) / rho_c[None]
    diff = u_s.astype(cdt).T[:, :, None] - u_c         # [2, Ns, 9cells]
    wm = jnp.where(own, w, 0.0).astype(cdt)
    return jnp.sum(2.0 * wm[None] * rho_c[None] * diff, axis=-1).T
