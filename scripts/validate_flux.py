"""Golden-flux validation: run a full beat period at the reference's
configuration and compare the net-flux pumping curve against
Data/Nominals/flux_nom.dat (shape-level: the nominals are from a 2017 run
with LENGTH=100 / 300x200, so only the normalized curve is comparable —
SURVEY.md §4).

Usage:  python scripts/validate_flux.py [--steps N] [--backend auto|jnp|triton]

Writes flux samples to stdout and prints the comparison metrics.
"""

from __future__ import annotations

# allow `python scripts/<this>.py` from anywhere: the package lives at
# the repo root, which is NOT on sys.path when the script dir is
import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import sys

import numpy as np


def load_nominal():
    path = "/root/reference/CUDA_IBLB_11/Data/Nominals/flux_nom.dat"
    if not os.path.exists(path):
        return None
    data = np.loadtxt(path)
    return data  # [101, 2]: t_ms, Q*x_scale


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100000)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--backend", default="jnp",
                    choices=["auto", "jnp", "triton"])
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()

    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    cfg = SimConfig(c_num=6, c_space=48, dtype=args.dtype)  # app.sh config
    sim = MucociliarySim(cfg, backend=args.backend)
    state = sim.init_state()

    interval = max(1, args.steps // args.samples)
    if interval * args.samples != args.steps:
        print(f"note: running {interval * args.samples} steps "
              f"({args.samples} x {interval}; --steps {args.steps} is not "
              f"divisible by --samples)", file=sys.stderr)
    ts, qs = [0.0], [0.0]
    for k in range(args.samples):
        state = sim.run_chunk(state, interval)
        q = float(state.q)
        t = float(state.it) * cfg.t_scale
        ts.append(t)
        qs.append(q * cfg.x_scale)
        if (k + 1) % 10 == 0:
            print(f"it={int(state.it)} t={t:.2f}ms Q={qs[-1]:.4f}",
                  file=sys.stderr)
    ts, qs = np.array(ts), np.array(qs)

    print("# t_ms\tQ_scaled")
    for t, q in zip(ts, qs):
        print(f"{t:.6g}\t{q:.6g}")

    nom = load_nominal()
    if nom is not None and len(qs) > 10:
        # Interpolate ours onto nominal times, compare normalized shapes.
        t_max = min(ts[-1], nom[-1, 0])
        grid = np.linspace(0, t_max, 80)
        ours = np.interp(grid, ts, qs)
        theirs = np.interp(grid, nom[:, 0], nom[:, 1])
        ours_n = ours / (np.abs(ours).max() or 1.0)
        theirs_n = theirs / (np.abs(theirs).max() or 1.0)
        corr = float(np.corrcoef(ours_n, theirs_n)[0, 1])
        print(f"# shape correlation vs flux_nom: {corr:.4f}", file=sys.stderr)
        print(f"# final Q: ours={qs[-1]:.2f}  nominal={nom[-1,1]:.2f}",
              file=sys.stderr)
        print(f"# monotone fraction ours: "
              f"{float(np.mean(np.diff(qs) > 0)):.3f}", file=sys.stderr)


if __name__ == "__main__":
    main()
