"""Run driver — the counterpart of the reference's host loop
(main.cu:263-1066): interval-chunked jitted execution, flux series, optional
full-field + cilia snapshots, SimLog with completion-time prediction, and
(new) checkpoint/resume and throughput reporting."""

from __future__ import annotations

import os
import sys
import time

from concurrent.futures import ThreadPoolExecutor

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.io import checkpoint as ckpt
from cuda_iblb_11_tpu.io.writers import (
    FluxWriter, OutputPaths, SimLog, write_cilia_snapshot,
    write_cilia_snapshot_npz, write_fluid_snapshot,
    write_fluid_snapshot_npz,
)
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu.utils.timing import ThroughputMeter, predict_completion, seconds


class _SnapshotPipeline:
    """Interval snapshot writer that overlaps host I/O with device compute.

    The reference dedicates a CUDA stream to output so interval snapshots
    ride alongside the next iterations' enqueued kernels (main.cu:793-809
    o_stream/events, :926-933 async flux D2H, :938-996 snapshots while
    compute is queued).  Here the runner computes the output fields ON
    DEVICE at the boundary, dispatches the next chunk (JAX async dispatch
    returns immediately), kicks off the device→host copies
    (``copy_to_host_async``), and hands the arrays to a single worker
    thread that formats and writes the files while the device runs the
    chunk.
    At 8192² a text snapshot is ~0.8 GB of transfer plus multi-GB of
    formatted text — strictly serial, that all happened with the device
    idle (the pre-r5 loop at runner.py history: pull → format → write →
    only then dispatch).

    One write may be outstanding at a time (``submit`` joins the previous
    future first): bounds host memory to a single snapshot's arrays and
    keeps file completion ordered.  Worker exceptions surface at the next
    ``submit``/``close`` — never silently dropped.  ``overlap=False``
    restores the strictly serial order (write completes before the chunk
    is dispatched) for A/B measurement; bytes are identical either way
    because the fields are computed from the SAME device state before the
    chunk touches it (functional arrays — nothing mutates in place at the
    JAX level)."""

    def __init__(self, paths: OutputPaths, cfg: SimConfig,
                 fmt: str = "dat", overlap: bool = True):
        if fmt == "npz":
            self._fluid, self._cilia = (write_fluid_snapshot_npz,
                                        write_cilia_snapshot_npz)
            self._ext = ".npz"
        else:
            from cuda_iblb_11_tpu.io import native

            self._fluid = (native.write_fluid_snapshot if native.available()
                           else write_fluid_snapshot)
            self._cilia = (native.write_cilia_snapshot if native.available()
                           else write_cilia_snapshot)
            self._ext = ".dat"
        self.paths, self.cfg, self.overlap = paths, cfg, overlap
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="iblb-snap")
                      if overlap else None)
        self._pending = None

    def _write(self, it, rho, u, s, u_s, eps):
        self._fluid(os.path.join(self.paths.raw_dir,
                                 f"{it}-fluid{self._ext}"),
                    self.cfg, rho, u)
        self._cilia(os.path.join(self.paths.cilia_dir,
                                 f"{it}-cilia{self._ext}"),
                    self.cfg, s, u_s, eps)

    def submit(self, it, rho, u, s, u_s, eps):
        """Overlap mode: start the D2H copies, join the previous write,
        enqueue this one on the worker.  Called AFTER the next chunk is
        dispatched, so the transfer + format + write all run under it."""
        for a in (rho, u, s, u_s, eps):
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
        if self._pending is not None:
            self._pending.result()  # re-raises worker errors loudly
        self._pending = self._pool.submit(self._write, it, rho, u,
                                          s, u_s, eps)

    def write_sync(self, it, rho, u, s, u_s, eps):
        """Serial mode: write inline (device_get inside the writers)."""
        self._write(it, rho, u, s, u_s, eps)

    def close(self):
        """Join the outstanding write (re-raising its error, if any)."""
        try:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


def _host_cores() -> int:
    """CPU cores this process may run on (not the machine's total)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # platforms without sched_getaffinity
        return os.cpu_count() or 1


def _resolve_overlap(overlap, snapshot_format: str):
    """``--overlap auto``: overlap interval output with compute, except
    text snapshots on a host with at most two cores, where the float
    formatting of a snapshot takes a whole core and starves the loop that
    dispatches the next chunk (the reference's o_stream formatting had a
    spare core, main.cu:793-809).  The pick and its reason go to SimLog.

    Accepts bools (API callers pin the mode for A/B runs) and the CLI
    strings {"auto", "on", "off"}.  Returns (bool, reason)."""
    if isinstance(overlap, bool):
        return overlap, "requested"
    if overlap == "on":
        return True, "requested"
    if overlap == "off":
        return False, "requested"
    if overlap != "auto":
        raise ValueError(f"overlap must be a bool or one of "
                         f"auto/on/off, got {overlap!r}")
    cores = _host_cores()
    if snapshot_format == "dat" and cores <= 2:
        return False, (f"auto: serial — text formatting on a {cores}-core "
                       f"host would starve the dispatch loop")
    return True, ("auto: overlapped — snapshot write rides under the next "
                  "chunk's device compute")


def _resolve_auto_mesh(cfg):
    """``--mesh auto``: the most balanced (n_y, n_x) factorization of the
    visible devices that divides the grid, x-major on ties (halo perimeter
    grows with the aspect ratio).  The pick and its reason go to SimLog;
    pass an explicit Y,X for runs that must pin their decomposition.

    Returns (mesh_str_or_None, reason).  None = run unsharded."""
    import jax

    n = len(jax.devices())
    if n == 1:
        return None, "auto: single visible device — unsharded"
    cands = [(y, n // y) for y in range(1, n + 1) if n % y == 0]
    cands.sort(key=lambda t: (abs(t[0] - t[1]), -t[1]))
    for ny, nx in cands:
        if cfg.ydim % ny == 0 and cfg.xdim % nx == 0:
            return f"{ny},{nx}", (f"auto: ({ny},{nx}) over {n} devices — "
                                  f"balanced-first, x-major on ties")
    return None, (f"auto: no factorization of {n} devices divides the "
                  f"{cfg.ydim}x{cfg.xdim} grid — unsharded")


def _make_sim(cfg, backend, forcing, mesh, ib_x_edge="periodic",
              pattern="no_mucus"):
    """Build the simulation: single-device MucociliarySim, or the sharded
    XLA sim over a (Y, X) device mesh when `mesh` is given ("2,4", or
    "auto" to pick a factorization of the visible devices)."""
    mesh_reason = None
    if str(mesh) == "auto":
        mesh, mesh_reason = _resolve_auto_mesh(cfg)
    if not mesh:
        sim = MucociliarySim(cfg, backend=backend, forcing=forcing,
                             ib_x_edge=ib_x_edge, pattern=pattern)
    else:
        if backend == "triton":
            raise ValueError("backend 'triton' runs on one device; --mesh "
                             "runs the sharded XLA path")
        from cuda_iblb_11_tpu.parallel.sharded import (
            ShardedMucociliarySim, make_mesh,
        )

        parts = [int(v) for v in str(mesh).split(",")]
        if len(parts) != 2 or min(parts) < 1:
            raise ValueError(
                f"--mesh must be 'Y,X' positive ints, got {mesh!r}")
        sim = ShardedMucociliarySim(cfg, make_mesh(*parts), forcing=forcing,
                                    ib_x_edge=ib_x_edge, pattern=pattern)
    if mesh_reason is not None:
        sim.mesh_requested = "auto"
        sim.mesh_reason = mesh_reason
        sim.mesh_resolved = mesh
    return sim


def _select_device(cfg: SimConfig, mesh=None):
    """Reference device-selection semantics (main.cu:395-396): the ShARC
    flag picks device 3 (the cluster's assigned GPU) instead of device 0.
    Returns the jax device the single-device run should be
    pinned to, or None when no override applies (mesh runs span devices;
    ShARC on a host with < 4 devices falls back to the default, loudly)."""
    if mesh or not cfg.sharc:
        return None
    import jax

    devs = jax.devices()
    if len(devs) > 3:
        return devs[3]
    print(f"warning: ShARC flag requests device 3 but only {len(devs)} "
          f"device(s) are visible; using the default device",
          file=sys.stderr)
    return None


def _resume_flux_rows(flux_path: str, cfg: SimConfig, it0: int,
                      interval: int) -> int:
    """Count the leading flux rows still valid at a resume from step it0.

    Rows carry the time stamp it*t_scale of the run that WROTE them, whose
    output interval may differ from the resuming run's — so rows are kept
    by time, not by dividing it0 by the new interval.  A row at exactly
    it0 is kept only when it0 is NOT a boundary of the new interval (the
    resumed loop rewrites boundary rows itself)."""
    t0 = it0 * cfg.t_scale
    # %.6g-formatted stamps carry ~5e-7 relative error; the tolerance must
    # dominate it while staying below the row spacing.  The two bounds can
    # collide (interval=1 runs past ~2.5e5 steps: the stamp quantization
    # exceeds the spacing), so the tolerance is clamped per row by the
    # OBSERVED spacing to the previous row, erring toward KEEPING rows —
    # a duplicated boundary row after resume beats silently truncating
    # valid data rows.
    stamp_tol = max(0.5 * cfg.t_scale, 2e-6 * t0)
    keep = 0
    prev = None
    try:
        with open(flux_path) as fh:
            for line in fh:
                try:
                    t = float(line.split()[0])
                except (ValueError, IndexError):
                    break
                spacing = t - prev if prev is not None else cfg.t_scale
                tol = min(stamp_tol,
                          max(0.45 * spacing, 0.45 * cfg.t_scale))
                if t < t0 - tol or (abs(t - t0) <= tol and it0 % interval):
                    keep += 1
                    prev = t
                else:
                    break
    except FileNotFoundError:
        pass
    return keep


def run(cfg: SimConfig, output_root: str = "Data/Test", backend: str = "auto",
        forcing: str = "trt_split", resume_from: str | None = None,
        checkpoint_every: int = 0, quiet: bool = False,
        profile_dir: str | None = None,
        mesh: str | None = None, ib_x_edge: str = "periodic",
        checkpoint_format: str = "npz", pattern: str = "no_mucus",
        snapshot_format: str = "dat",
        overlap: bool | str = "auto") -> dict:
    """See _run_body; this wrapper applies the ShARC device-selection
    semantics (pin single-device runs to device 3 when cfg.sharc, the
    reference's cudaSetDevice behaviour at main.cu:395-396)."""
    device = _select_device(cfg, mesh)
    kw = dict(
        output_root=output_root, backend=backend, forcing=forcing,
        resume_from=resume_from, checkpoint_every=checkpoint_every,
        quiet=quiet, profile_dir=profile_dir, mesh=mesh,
        ib_x_edge=ib_x_edge, checkpoint_format=checkpoint_format,
        pattern=pattern, snapshot_format=snapshot_format, overlap=overlap,
        device=device)
    if device is not None:
        import jax

        with jax.default_device(device):
            return _run_body(cfg, **kw)
    return _run_body(cfg, **kw)


def _run_body(cfg: SimConfig, output_root: str = "Data/Test",
              backend: str = "auto",
              forcing: str = "trt_split", resume_from: str | None = None,
              checkpoint_every: int = 0, quiet: bool = False,
              profile_dir: str | None = None,
              mesh: str | None = None, ib_x_edge: str = "periodic",
              checkpoint_format: str = "npz", pattern: str = "no_mucus",
              snapshot_format: str = "dat", overlap: bool | str = "auto",
              device=None) -> dict:
    """Execute cfg.iterations steps with interval outputs.

    profile_dir: if set, capture a jax.profiler trace of the first interval
    (the reference's only tracing was a wall-clock timer, seconds.cpp).
    mesh: "Y,X" device-mesh shape for multi-chip spatial sharding.
    checkpoint_format: "npz" (single host-gathered archive) or "orbax"
    (sharded: each host writes its own shards; resume restores directly
    onto the mesh).  --resume auto-detects the format (orbax checkpoints
    are directories).
    snapshot_format: "dat" (reference-byte-compatible text) or "npz"
    (binary, for scale — an 8192² text snapshot is multi-GB).
    overlap: write interval snapshots on a worker thread while the next
    chunk runs on the device (the reference's o_stream analogue); False
    restores the strictly serial pull→write→dispatch order; "auto"
    (default) picks per format + host cores from the measured tradeoff
    (_resolve_overlap) and records the pick + reason in SimLog.
    Returns a summary dict (runtime, MLUPS incl. end-to-end, final Q)."""
    cfg.validate()
    overlap, overlap_reason = _resolve_overlap(overlap, snapshot_format)
    sim = _make_sim(cfg, backend, forcing, mesh, ib_x_edge, pattern)
    profiling = False
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
        profiling = True

    paths = OutputPaths(output_root, cfg)
    paths.makedirs()
    interval = max(cfg.interval, 1)
    simlog = SimLog(paths.simlog_path, cfg)
    extra = {"Backend": backend, "Forcing": forcing,
             "Dtype": str(sim.dtype)}
    if pattern != "no_mucus":
        extra["Pattern"] = pattern
    if getattr(sim, "mesh_requested", None) == "auto":
        # resolved pick + reason (policy decisions are reproducible from
        # the run's own artifacts)
        extra["Mesh"] = (f"{sim.mesh_resolved or 'unsharded'} "
                         f"({sim.mesh_reason})")
    elif mesh:
        extra["Mesh"] = mesh
    if device is not None:
        extra["Device"] = str(device)
    # The RESOLVED execution configuration, after every auto/fallback
    # decision — the analogue of the reference recording its real launch
    # config (main.cu:782-783), so a run's perf class is reproducible
    # from its own artifacts.
    resolved = sim.resolved_config()
    extra["Resolved backend"] = resolved["backend"] + (
        f" ({resolved['backend_reason']})"
        if resolved["backend_reason"] else "")
    extra["Storage"] = resolved["storage"]
    extra["IB path"] = resolved["ib_path"]
    if cfg.bigdata:
        extra["Snapshot overlap"] = (
            f"{'on' if overlap else 'off'} ({overlap_reason})")
    if not quiet:
        print(f"Execution: backend={extra['Resolved backend']} "
              f"storage={resolved['storage']} "
              f"ib={resolved['ib_path']}")

    if resume_from:
        if os.path.isdir(resume_from):  # orbax checkpoints are directories
            state, _ = ckpt.load_orbax(resume_from, cfg,
                                       sim=sim if mesh else None)
        else:
            state, _ = ckpt.load(resume_from, cfg)
            if mesh:
                state = sim.place_state(state)  # re-shard onto the mesh
        if not mesh and state.force.shape[1] == cfg.ydim:
            # mesh-saved checkpoints keep the force full-size [2, Y, X];
            # the single-device layout is band-only (zero above the band
            # by construction — ImmersedBoundary.cu:166-231)
            state = state._replace(force=state.force[:, :cfg.force_band])
        it0 = int(state.it)
        # Preserve the flux rows already written up to the checkpoint and
        # append to SimLog instead of truncating it.  The kept rows are
        # identified by their TIME stamps (they were written at the SAVED
        # run's interval, which may differ from this run's); the resumed
        # loop rewrites the row at it0 itself iff it0 is a boundary of the
        # new interval.
        keep = _resume_flux_rows(paths.flux_path, cfg, it0, interval)
        flux = FluxWriter(paths.flux_path, cfg, keep_rows=keep)
        simlog.write_resume_note(it0)
        # a resume may change the execution path (different backend /
        # mesh / machine) — record the resumed run's resolved config too
        simlog.write_extra({k: v for k, v in extra.items()
                            if k.startswith(("Resolved", "Storage",
                                             "IB path"))})
        if not quiet:
            print(f"Resumed from {resume_from} at it={it0}")
    else:
        state = sim.init_state()
        flux = FluxWriter(paths.flux_path, cfg)
        simlog.write_header(extra=extra)
    meter = ThroughputMeter(cells=cfg.size)
    start_epoch = time.time()
    t_start = seconds()
    if not quiet:
        print("Running Simulation...")

    it = int(state.it)
    it_start = it
    first_interval_logged = it > 0
    last_ckpt = it
    snap = _SnapshotPipeline(paths, cfg, fmt=snapshot_format,
                             overlap=overlap)
    try:
        _loop(cfg, sim, snap, flux, meter, simlog, interval, quiet,
              profiling, profile_dir, checkpoint_every, checkpoint_format,
              paths, start_epoch, t_start, state, it, first_interval_logged,
              last_ckpt, summary_out := {})
    finally:
        snap.close()
    state, it = summary_out["state"], summary_out["it"]

    # Final flux row after the loop (main.cu:1030-1034).
    flux.append(it, float(state.q))
    runtime = seconds() - t_start
    simlog.write_runtime(runtime)
    steps_run = max(it - it_start, 0)
    # end-to-end rate INCLUDING interval I/O — the basis the reference's
    # derived 0.62 MLUPS is on (its SimLog runtime covers snapshot writes);
    # meter.mlups remains the pure-compute rate (write time excluded)
    mlups_e2e = (cfg.size * steps_run / runtime / 1e6) if runtime > 0 else 0.0
    simlog.write_extra({"End-to-end MLUPS (incl. interval I/O)":
                        f"{mlups_e2e:.1f}"})
    summary = {
        "iterations": it,
        "runtime_s": runtime,
        "mlups": meter.mlups,
        "mlups_end_to_end": mlups_e2e,
        "q_final": float(state.q),
        "flux_path": paths.flux_path,
        "resolved": resolved,
        "snapshot_overlap": overlap,
        "snapshot_overlap_reason": overlap_reason,
    }
    if not quiet:
        print(f"Total runtime: {runtime:.2f}s  ({meter.mlups:.1f} MLUPS "
              f"compute, {mlups_e2e:.1f} end-to-end)")
    return summary


def _loop(cfg, sim, snap, flux, meter, simlog, interval, quiet, profiling,
          profile_dir, checkpoint_every, checkpoint_format, paths,
          start_epoch, t_start, state, it, first_interval_logged, last_ckpt,
          summary_out):
    """The interval loop body (split out so the snapshot pipeline's
    try/finally in _run_body stays flat)."""
    while it < cfg.iterations:
        # Output at the START of each interval boundary, like the reference
        # (it % INTERVAL == 0 inside the loop, main.cu:938).
        boundary = it % interval == 0
        if boundary:
            if cfg.bigdata:
                # compute the output fields ON DEVICE from the pre-chunk
                # state; the host copy + write happen under the next chunk
                rho, u = sim.fields(state)
                s, u_s, eps = sim.boundary_fields(state)
                if not snap.overlap:
                    snap.write_sync(it, rho, u, s, u_s, eps)
            flux.append(it, float(state.q))

        n = min(interval - it % interval, cfg.iterations - it)
        meter.start()
        state = sim.run_chunk(state, n)
        if boundary and cfg.bigdata and snap.overlap:
            # chunk is dispatched (async) — overlap the snapshot with it
            snap.submit(it, rho, u, s, u_s, eps)
        state.q.block_until_ready()
        meter.stop(n)
        it = int(state.it)

        if profiling and it >= interval:
            import jax

            jax.profiler.stop_trace()
            profiling = False
            if not quiet:
                print(f"Profiler trace written to {profile_dir}")

        if not first_interval_logged and it >= interval:
            pred = predict_completion(
                start_epoch, seconds() - t_start, cfg.iterations // interval)
            simlog.write_completion_estimate(pred)
            if not quiet:
                print("Completion time:",
                      time.asctime(time.localtime(pred)))
            first_interval_logged = True

        # "every N iterations" tracked against the last save (the loop only
        # ever stops on interval boundaries, so a modulo test could miss
        # every save when N is not a multiple of the interval).
        if checkpoint_every and it - last_ckpt >= checkpoint_every:
            if checkpoint_format == "orbax":
                ckpt.save_orbax(
                    os.path.join(paths.raw_dir, "checkpoint_orbax"),
                    state, cfg)
            else:
                ckpt.save(os.path.join(paths.raw_dir, "checkpoint.npz"),
                          state, cfg)
            last_ckpt = it

    summary_out["state"] = state
    summary_out["it"] = it
