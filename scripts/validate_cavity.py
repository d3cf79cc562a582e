"""Lid-driven cavity validation sweep: Re in {100, 400, 1000} vs Ghia,
Ghia & Shin (1982) centreline benchmarks (BASELINE config 2).

Writes validation/cavity_metrics.json with the max |u_x - Ghia| deviation
(in lid-speed units) on the vertical centreline per Re; the README table
records the sweep.  tests/test_cavity.py runs Re=100 always and Re=400/1000
under IBLB_SLOW_TESTS=1 (they take minutes).

Run:  python scripts/validate_cavity.py
"""

from __future__ import annotations

# allow `python scripts/<this>.py` from anywhere: the package lives at
# the repo root, which is NOT on sys.path when the script dir is
import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Ghia, Ghia & Shin (1982), u_x on the vertical centreline at y/N.
GHIA = {
    100: (np.array([0.0625, 0.1016, 0.2813, 0.4531, 0.6172, 0.7344,
                    0.9531]),
          np.array([-0.04192, -0.06434, -0.15662, -0.21090, -0.13641,
                    0.00332, 0.68717])),
    400: (np.array([0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609]),
          np.array([-0.09266, -0.24299, -0.32726, -0.17119, -0.11477,
                    0.02135, 0.61756])),
    1000: (np.array([0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609]),
           np.array([-0.18109, -0.38289, -0.27805, -0.10648, -0.06080,
                     0.05702, 0.51117])),
}
RUNS = {100: (64, 30000), 400: (96, 80000), 1000: (128, 200000)}


def main():
    import jax

    # reduced-precision f32 matmuls (TF32 on a GPU) compound over 1e5
    # steps into O(0.1) centreline errors; force full f32 precision for
    # validation runs.
    jax.config.update("jax_default_matmul_precision", "highest")
    from cuda_iblb_11_tpu.models.cavity import LidDrivenCavity

    metrics = {}
    for re_n, (n, steps) in RUNS.items():
        t0 = time.perf_counter()
        cav = LidDrivenCavity(n=n, re=float(re_n), u_lid=0.1)
        f = cav.run(cav.init_f(), steps)
        ux, _ = cav.centreline_profiles(f)
        y = (np.arange(n) + 0.5) / n
        gy, gux = GHIA[re_n]
        ux_i = np.interp(gy, y, np.asarray(ux))
        dev = float(np.max(np.abs(ux_i - gux)))
        metrics[str(re_n)] = {
            "grid": n, "steps": steps, "tau": cav.tau,
            "max_dev_ux": dev,
            "ux_centreline_at_ghia_y": [round(float(v), 5) for v in ux_i],
        }
        print(f"Re={re_n} (N={n}, tau={cav.tau:.4f}, {steps} steps): "
              f"max|ux - Ghia| = {dev:.4f} lid units "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    out = os.path.join(REPO, "validation", "cavity_metrics.json")
    with open(out, "w") as fh:
        json.dump(metrics, fh, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
