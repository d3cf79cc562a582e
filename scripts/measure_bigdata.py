"""End-to-end BigData-on throughput measurement.

Runs the FULL BEAT (T=1e5 steps) at 2048^2 with BigData=1, P_num=100
(interval snapshots every 1000 steps, 100 fluid + 100 cilia files) on a
GPU, in four configurations:

    snapshot_format x overlap   in  {dat, npz} x {on, off}

and records wall time, pure-compute MLUPS, end-to-end MLUPS (incl. all
interval I/O — the basis the reference's derived 0.62 MLUPS is on: its
SimLog runtime covers snapshot writes, main.cu:1007-1022), and bytes
written, to validation/bigdata_e2e.json.

The reference overlaps output with compute via a dedicated CUDA stream
(main.cu:793-809, 938-996); the runner's worker-thread pipeline is its
counterpart.  This script measures the end-to-end rate and the value of
the overlap on the host that drives the card.

Usage:  python scripts/measure_bigdata.py [--steps-scale S] [--out PATH]
        (--steps-scale 0.01 for a 1k-step shakedown run)
"""

from __future__ import annotations

import argparse
import json
import os as _os
import shutil
import sys as _sys
import time

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.runner import run


def _tree_bytes(root):
    total = 0
    for dirpath, _, names in _os.walk(root):
        for n in names:
            try:
                total += _os.path.getsize(_os.path.join(dirpath, n))
            except OSError:
                pass
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale i_pow (1.0 = the full 1e5-step beat)")
    ap.add_argument("--p-num", type=int, default=100,
                    help="snapshot count (reference P_num; default 100)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default validation/bigdata_e2e.json)")
    ap.add_argument("--work", default="/tmp/iblb_bigdata",
                    help="scratch output root (deleted between configs)")
    ap.add_argument("--only", default=None,
                    help="comma list of configs to (re)run, e.g. "
                         "'npz_on,npz_off'; others keep their rows from "
                         "an existing result JSON")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {jax.default_backend()}")
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    out_path = args.out or _os.path.join(repo, "validation",
                                         "bigdata_e2e.json")

    cfg = SimConfig(c_num=16, c_space=128, ydim=2048, t_num=1.0, t_pow=5,
                    i_pow=args.steps_scale, p_num=args.p_num, bigdata=True,
                    dtype="float32")
    print(f"grid {cfg.xdim}x{cfg.ydim}, {cfg.iterations} steps, "
          f"interval {cfg.interval} ({cfg.p_num} snapshots)")

    # warmup: pay backend discovery + the jit trace/compile OUTSIDE the
    # measured matrix (the shakedown showed the first run eating ~40 s of
    # compile in its meter window and ~5 min of first-time trace/discovery
    # in its wall clock)
    wcfg = cfg.replace(i_pow=cfg.i_pow * 64 / cfg.iterations, p_num=1)
    warm_root = _os.path.join(args.work, "warmup")
    shutil.rmtree(warm_root, ignore_errors=True)
    run(wcfg, output_root=warm_root, backend="auto",
        quiet=True, snapshot_format="dat", overlap=True)
    shutil.rmtree(warm_root, ignore_errors=True)
    print("warmup done")

    # merge with any earlier partial record so the matrix can be filled
    # in across invocations (--only), and write after EVERY config — a
    # timeout or device fault must not lose a 25-minute measurement
    results = []
    if _os.path.exists(out_path):
        try:
            with open(out_path) as fh:
                results = json.load(fh).get("runs", [])
        except (OSError, ValueError):
            results = []
    wanted = [w for w in (args.only.split(",") if args.only else [])]
    for fmt in ("dat", "npz"):
        for overlap in (True, False):
            key = f"{fmt}_{'on' if overlap else 'off'}"
            if wanted and key not in wanted:
                continue
            results = [r for r in results
                       if (r["format"], r["overlap"]) != (fmt, overlap)]
            root = _os.path.join(args.work, f"{fmt}_{overlap}")
            shutil.rmtree(root, ignore_errors=True)
            t0 = time.time()
            summary = run(cfg, output_root=root, backend="auto",
                          quiet=True, snapshot_format=fmt, overlap=overlap)
            wall = time.time() - t0
            nbytes = _tree_bytes(root)
            row = {
                "format": fmt,
                "overlap": overlap,
                "wall_s": round(wall, 2),
                "runtime_s": round(summary["runtime_s"], 2),
                "mlups_compute": round(summary["mlups"], 1),
                "mlups_end_to_end": round(summary["mlups_end_to_end"], 1),
                "bytes_written": nbytes,
                "resolved": summary["resolved"],
            }
            print(json.dumps(row), flush=True)
            results.append(row)
            shutil.rmtree(root, ignore_errors=True)
            _write_record(out_path, cfg, results)

    _write_record(out_path, cfg, results)
    print(f"wrote {out_path}")


def _write_record(out_path, cfg, results):
    import jax

    record = {
        "config": {"grid": f"{cfg.xdim}x{cfg.ydim}",
                   "iterations": cfg.iterations, "p_num": cfg.p_num,
                   "interval": cfg.interval, "dtype": "float32",
                   "backend": "auto"},
        "when": time.strftime("%Y-%m-%d"),
        "device": jax.devices()[0].device_kind,
        "jax": jax.__version__,
        "note": ("end-to-end = size*steps/runtime incl. interval I/O; "
                 "compute = chunk time only (but measured under the "
                 "writer thread's host-core contention).  Reference "
                 "basis: its 0.62 MLUPS derived rate includes interval "
                 "output (main.cu:1007-1022)."),
        "runs": results,
    }
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)


if __name__ == "__main__":
    main()
