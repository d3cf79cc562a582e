"""Smoke test of the simulator on one GPU, through the entry points a user
calls (``cli.main`` and ``runner.run``), in one process.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-gpus   # four GPUs: the sharded 8192^2 path

Phases (one GPU):
  1. device: JAX must run on a GPU; prints the card's name and power limit.
  2. the reference's own run through the CLI (288x192, 2,000 steps of the
     reference's T = 10^5 beat, npz snapshots, checkpoints), then the same
     run split in two by --resume.
  3. the BASELINE 2048^2 run through the CLI, with its end-to-end MLUPS.
  (A beat of T = 10^3 steps, T_pow 3, would drive the cilia tips past
  Mach 1: the run is NaN within 100 steps on any backend.)
  4. comparisons on the card: the f32 main path against the f64 oracle at
     2048^2; f64 on the GPU against f64 on the CPU; the fused Triton kernel
     against the f32 jnp path.
  5. the fused kernel against the XLA path, end to end through runner.run.

Any failure raises, so the exit code is nonzero and the last line is not
printed.  The last line of standard output is one JSON object with the
device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(name, value, bound):
    ok = value <= bound
    log(f"  {name}: {value:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {bound:.0e}")


def velocity(sim, state):
    """Spread-corrected velocity [2, Y, X] as the sim snapshots it."""
    return np.asarray(sim.fields(state)[1], np.float64)


def flux_rows(path):
    rows = np.loadtxt(path, ndmin=2)
    if rows.size == 0 or not np.isfinite(rows).all():
        raise AssertionError(f"{path}: empty or non-finite flux rows")
    return rows


def simlog_value(path, key):
    with open(path) as fh:
        for line in fh:
            if line.startswith(key + ":"):
                return line.split(":", 1)[1].strip()
    raise AssertionError(f"{path}: no '{key}' line")


def phase_device(jax):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devs[0].platform}")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, devices {devs}")


def phase_reference_cli(cli, tmp):
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.io.writers import OutputPaths

    log("phase 2: reference run 1 6 48 1.0 1.0 5 0.02 20 0 1 (288x192, "
        "2,000 steps) through the CLI")
    pos = ["1", "6", "48", "1.0", "1.0", "5", "0.02", "20", "0", "1"]
    opts = ["--snapshot-format", "npz", "--checkpoint-every", "1000",
            "--quiet"]
    full = os.path.join(tmp, "ref_full")
    t0 = time.perf_counter()
    if cli.main(pos + opts + ["--output", full]) != 0:
        raise AssertionError("reference CLI run failed")
    log(f"  full run: {time.perf_counter() - t0:.1f} s incl. compilation")
    cfg = SimConfig.from_argv(pos)
    paths = OutputPaths(full, cfg)
    rows = flux_rows(paths.flux_path)
    if rows.shape[0] != cfg.p_num + 1:
        raise AssertionError(f"{rows.shape[0]} flux rows, want "
                             f"{cfg.p_num + 1}")
    snaps = sorted(f for f in os.listdir(paths.raw_dir)
                   if f.endswith("-fluid.npz"))
    if len(snaps) != cfg.p_num:
        raise AssertionError(f"{len(snaps)} fluid snapshots, want "
                             f"{cfg.p_num}")
    for name in (snaps[0], snaps[-1]):
        with np.load(os.path.join(paths.raw_dir, name)) as z:
            for k in z.files:
                if z[k].dtype.kind == "f" and not np.isfinite(z[k]).all():
                    raise AssertionError(f"{name}:{k} is not finite")
    log(f"  {rows.shape[0]} flux rows, {len(snaps)} npz snapshots, finite; "
        f"final Q {rows[-1, 1]:.6e}")

    # the same run in two legs: 1,000 steps with a checkpoint, then resume
    split = os.path.join(tmp, "ref_split")
    half = ["1", "6", "48", "1.0", "1.0", "5", "0.01", "10", "0", "1"]
    if cli.main(half + opts + ["--output", split]) != 0:
        raise AssertionError("first leg failed")
    ckpt = os.path.join(OutputPaths(split, cfg).raw_dir, "checkpoint.npz")
    if cli.main(pos + opts + ["--output", split, "--resume", ckpt]) != 0:
        raise AssertionError("resumed leg failed")
    rows_r = flux_rows(OutputPaths(split, cfg).flux_path)
    if rows_r.shape != rows.shape:
        raise AssertionError(f"resumed flux rows {rows_r.shape} vs "
                             f"{rows.shape}")
    check("resumed vs uninterrupted flux series, max rel",
          float(np.max(np.abs(rows_r[:, 1] - rows[:, 1]))
                / np.max(np.abs(rows[:, 1]))), 1e-5)


def phase_baseline_cli(cli, tmp):
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.io.writers import OutputPaths

    log("phase 3: BASELINE 1 16 128 1.0 1.0 5 0.01 4 0 0 --ydim 2048 "
        "through the CLI")
    pos = ["1", "16", "128", "1.0", "1.0", "5", "0.01", "4", "0", "0"]
    cfg = SimConfig.from_argv(pos).replace(ydim=2048)
    for leg in ("first (compiles)", "second"):
        out = os.path.join(tmp, "baseline_" + leg.split()[0])
        t0 = time.perf_counter()
        if cli.main(pos + ["--ydim", "2048", "--quiet", "--output",
                           out]) != 0:
            raise AssertionError("BASELINE CLI run failed")
        wall = time.perf_counter() - t0
        paths = OutputPaths(out, cfg)
        flux_rows(paths.flux_path)
        mlups = simlog_value(paths.simlog_path,
                             "End-to-end MLUPS (incl. interval I/O)")
        backend = simlog_value(paths.simlog_path, "Resolved backend")
        log(f"  {leg} run: {cfg.iterations} steps, end-to-end {mlups} "
            f"MLUPS ({wall:.1f} s wall in cli.main), backend {backend}")
    log(f"  card: {card_line()}")


def phase_compare(jax):
    """The comparisons, with x64 on for the f64 runs (as --dtype float64
    turns it on in the CLI)."""
    jax.config.update("jax_enable_x64", True)
    try:
        _compare(jax)
    finally:
        jax.config.update("jax_enable_x64", False)


def _compare(jax):
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    log("phase 4: comparisons on the card (LB contractions: exact sums; "
        "IB band matmuls: Precision.HIGHEST, full f32 on cuBLAS)")
    cfg = SimConfig(c_num=16, c_space=128, ydim=2048, dtype="float32")
    s64 = MucociliarySim(cfg.replace(dtype="float64", storage="raw"),
                         backend="jnp")
    u64 = velocity(s64, s64.run_chunk(s64.init_state(), 512))
    for backend in ("triton", "jnp"):
        s32 = MucociliarySim(cfg, backend=backend)
        u32 = velocity(s32, s32.run_chunk(s32.init_state(), 512))
        check(f"2048^2 f32 {backend} vs f64 oracle on the GPU, 512 steps, "
              "velocity rel-L2", rel_l2(u32, u64), 1e-5)
    del s64, u64, u32

    small = SimConfig(c_num=6, c_space=48, dtype="float64", storage="raw")
    gpu_sim = MucociliarySim(small, backend="jnp")
    u_gpu = velocity(gpu_sim, gpu_sim.run_chunk(gpu_sim.init_state(), 512))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_sim = MucociliarySim(small, backend="jnp")
        u_cpu = velocity(cpu_sim,
                         cpu_sim.run_chunk(cpu_sim.init_state(), 512))
    check("288x192 f64 GPU vs f64 CPU, 512 steps, velocity rel-L2",
          rel_l2(u_gpu, u_cpu), 1e-12)

    for c in (cfg, small.replace(dtype="float32", storage="auto")):
        sk = MucociliarySim(c, backend="triton")
        sj = MucociliarySim(c, backend="jnp")
        uk = velocity(sk, sk.run_chunk(sk.init_state(), 64))
        uj = velocity(sj, sj.run_chunk(sj.init_state(), 64))
        s64 = MucociliarySim(c.replace(dtype="float64", storage="raw"),
                             backend="jnp")
        u64 = velocity(s64, s64.run_chunk(s64.init_state(), 64))
        log(f"  {c.ydim}x{c.xdim}, 64 steps, velocity rel-L2 vs f64: "
            f"triton {rel_l2(uk, u64):.3e}, f32 jnp {rel_l2(uj, u64):.3e}")
        check(f"{c.ydim}x{c.xdim} triton vs f32 jnp, 64 steps, velocity "
              "rel-L2", rel_l2(uk, uj), 1e-6)


def phase_kernel_timing(tmp):
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.runner import run

    log("phase 5: fused Triton kernel vs XLA, end to end through "
        "runner.run: the first run compiles, the second reuses it")
    cells = (
        ("2048^2", SimConfig(c_num=16, c_space=128, ydim=2048,
                             i_pow=0.1, p_num=10)),
        ("288x192", SimConfig(c_num=6, c_space=48, i_pow=0.2, p_num=2)),
    )
    for name, cfg in cells:
        for backend in ("jnp", "triton"):
            for leg in ("first", "second"):
                out = run(cfg, output_root=os.path.join(tmp, "t"),
                          backend=backend, quiet=True)
                log(f"  {name} {cfg.iterations} steps {backend:6s} {leg}: "
                    f"{out['mlups']:.0f} MLUPS compute, "
                    f"{out['mlups_end_to_end']:.0f} end-to-end")
    log(f"  card: {card_line()}")


def phase_four_gpus(jax):
    """BASELINE config 5 on a 2x2 mesh against the same steps on one card:
    rates in f32 (one card runs the main path, backend auto); the check
    in f64, where the sharded run and the one-card run differ only in the
    order of sums, so any fault of the decomposition (halos, ownership
    masks, psums) shows above the round-off."""
    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
    from cuda_iblb_11_tpu.parallel.sharded import (
        ShardedMucociliarySim, make_mesh,
    )

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-gpus needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    log("four GPUs: BASELINE config 5 (1 64 128 1.0 1.0 5 ... --ydim 8192), "
        "--mesh 2,2 vs one card, 200 steps")
    cfg = SimConfig(c_num=64, c_space=128, ydim=8192, dtype="float32")
    steps = 200

    def timed(sim):
        """The state after `steps` steps, and the rate of a second run of
        the same steps (the first compiles; run_chunk donates its input)."""
        jax.block_until_ready(sim.run_chunk(sim.init_state(), steps))
        st = jax.block_until_ready(sim.init_state())
        t0 = time.perf_counter()
        st = jax.block_until_ready(sim.run_chunk(st, steps))
        return st, cfg.size * steps / (time.perf_counter() - t0) / 1e6

    def compare(mesh_sim, one, label, bound):
        st_m, rate_m = timed(mesh_sim)
        u_m, q_m = velocity(mesh_sim, st_m), float(st_m.q)
        del st_m
        st_1, rate_1 = timed(one)
        u_1, q_1 = velocity(one, st_1), float(st_1.q)
        del st_1
        log(f"  {label}: mesh 2,2 (XLA sharded) {rate_m:.0f} MLUPS; one "
            f"card ({one.backend}) {rate_1:.0f} MLUPS")
        log(f"  {label}: Q after {steps} steps: mesh {q_m:.12e}, one card "
            f"{q_1:.12e}, difference {abs(q_m - q_1):.3e}")
        check(f"{label} 8192^2 mesh 2,2 vs one card, {steps} steps, "
              "velocity rel-L2", rel_l2(u_m, u_1), bound)

    # f32: the two programs differ in IB form (stencil scatter with
    # atomics vs band matmuls) and LB implementation, so they agree to the
    # f32 floor (BASELINE's 1e-5 bound against f64), not closer
    compare(ShardedMucociliarySim(cfg, make_mesh(2, 2)),
            MucociliarySim(cfg, backend="auto"), "f32", 1e-5)
    jax.config.update("jax_enable_x64", True)
    try:
        c64 = cfg.replace(dtype="float64", storage="raw")
        compare(ShardedMucociliarySim(c64, make_mesh(2, 2)),
                MucociliarySim(c64, backend="jnp"), "f64", 1e-6)
    finally:
        jax.config.update("jax_enable_x64", False)
    log(f"  card: {card_line()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on four GPUs and what "
                         "it is compared with")
    args = ap.parse_args(argv)

    import jax

    # before the first backend use; the CPU backend too, because phase 4
    # compares f64 on the GPU with f64 on the CPU
    jax.config.update("jax_platforms", "cuda,cpu")
    from cuda_iblb_11_tpu import cli
    from cuda_iblb_11_tpu.utils.compile_cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    phase_device(jax)
    if args.four_gpus:
        phase_four_gpus(jax)
    else:
        with tempfile.TemporaryDirectory(prefix="iblb_smoke_") as tmp:
            phase_reference_cli(cli, tmp)
            phase_baseline_cli(cli, tmp)
            phase_compare(jax)
            phase_kernel_timing(tmp)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
