"""Command-line interface.

Positional arguments exactly as the reference binary (main.cu:284-296):

    c_fraction c_num c_space Re T_num T_pow I_pow P_num ShARC BigData

plus framework flags (output root instead of the reference's hardcoded
local/cluster directories, backend/precision/forcing selection,
checkpointing).
"""

from __future__ import annotations

import argparse
import sys

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.runner import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iblb",
        description="immersed-boundary lattice-Boltzmann "
                    "(mucociliary pumping) simulator",
    )
    p.add_argument("positionals", nargs="*", metavar="ARG",
                   help="c_fraction c_num c_space Re T_num T_pow I_pow "
                        "P_num ShARC BigData")
    p.add_argument("--output", default="Data/Test",
                   help="output root directory (default: Data/Test)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "triton"],
                   help="LB step: 'jnp' (XLA), 'triton' (the fused Pallas "
                        "kernel, GPU only) or 'auto' (the pick and its "
                        "reason go to SimLog)")
    p.add_argument("--forcing", default="trt_split",
                   choices=["trt_split", "reference"],
                   help="Guo forcing scheme; 'reference' replicates the CUDA "
                        "exactly but is IB-unstable at default parameters")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64", "bfloat16"],
                   help="state precision.  float64 (the reference's "
                        "own) runs the jnp path")
    p.add_argument("--pattern", default="no_mucus",
                   choices=["no_mucus", "mucus"],
                   help="cilia beat pattern: the reference's active "
                        "A_mn/B_mn tables (no_mucus, main.cu:56-74) or the "
                        "mucus-loaded variant it keeps commented out "
                        "(main.cu:36-54)")
    p.add_argument("--ib-x-edge", default="periodic",
                   choices=["periodic", "reference"],
                   help="IB stencil treatment at the periodic x edges: "
                        "'periodic' wraps (physically correct); 'reference' "
                        "replicates the CUDA's row-aliasing/drop quirk "
                        "exactly (ImmersedBoundary.cu:119-124)")
    p.add_argument("--mesh", default=None, metavar="Y,X",
                   help="device-mesh shape for multi-chip spatial domain "
                        "decomposition (e.g. 2,4); halos ride ppermute. "
                        "'auto' picks the largest eligible factorization "
                        "of the visible devices (balanced-first, x-major "
                        "on ties) and records the pick in SimLog")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every N iterations")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=["npz", "orbax"],
                   help="npz: single host-gathered archive; orbax: sharded "
                        "(each host writes its own shards, resume restores "
                        "directly onto the mesh).  --resume auto-detects")
    p.add_argument("--ydim", type=int, default=None,
                   help="override the channel height (default 192, "
                        "main.cu:271) — e.g. for scale-out runs where "
                        "each y-shard needs >= force_band + 16 rows")
    p.add_argument("--distributed", action="store_true",
                   help="call jax.distributed.initialize() before running "
                        "(multi-host pods: coordinator/process env vars or "
                        "the platform's auto-detection must be set; the "
                        "--mesh shape then spans all hosts' devices)")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="pin the jax platform before first backend use; "
                        "'gpu' fails when no GPU is found")
    p.add_argument("--snapshot-format", default="dat",
                   choices=["dat", "npz"],
                   help="BigData interval snapshots: 'dat' is the "
                        "reference's byte-compatible text (main.cu:938-996);"
                        " 'npz' stores the raw fields + scale factors "
                        "binary (exactly text-recoverable) — at 8192² a "
                        "text snapshot is multi-GB, the npz ~0.8 GB")
    p.add_argument("--overlap", default="auto",
                   choices=["auto", "on", "off"],
                   help="interval snapshots on a worker thread under the "
                        "next chunk's device compute ('on', the "
                        "reference's o_stream analogue, main.cu:793-809) "
                        "vs strictly serial pull → write → dispatch "
                        "('off'); bytes are identical either way.  'auto' "
                        "(default): on, except text snapshots on hosts "
                        "with <=2 cores, where formatting would starve "
                        "the dispatch loop; the pick goes to SimLog")
    p.add_argument("--no-overlap", dest="overlap", action="store_const",
                   const="off", help="alias for --overlap off")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the first interval")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    from cuda_iblb_11_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if args.platform != "auto":
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    if args.dtype == "float64":
        # without x64 every f64 array silently truncates to f32
        jax.config.update("jax_enable_x64", True)
    if args.distributed:
        # must run before any backend use; every process then sees the
        # global device set, and shard_map meshes built from jax.devices()
        # span all hosts (the orbax checkpoint path writes shard-local and
        # restores onto the mesh)
        jax.distributed.initialize()
    if args.platform != "auto":
        try:
            found = jax.default_backend()
        except RuntimeError as e:
            print(f"--platform {args.platform}: {e}", file=sys.stderr)
            return 1
        if found != args.platform:
            print(f"--platform {args.platform}: jax runs on {found}",
                  file=sys.stderr)
            return 1
    try:
        cfg = SimConfig.from_argv(args.positionals)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.ydim is not None:
        cfg = cfg.replace(ydim=args.ydim)
    run(cfg, output_root=args.output, backend=args.backend,
        forcing=args.forcing, resume_from=args.resume,
        checkpoint_every=args.checkpoint_every, quiet=args.quiet,
        profile_dir=args.profile_dir, mesh=args.mesh, ib_x_edge=args.ib_x_edge,
        checkpoint_format=args.checkpoint_format, pattern=args.pattern,
        snapshot_format=args.snapshot_format, overlap=args.overlap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
