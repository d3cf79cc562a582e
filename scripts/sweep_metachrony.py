"""Metachrony sweep (the reference's primary experiment, cilia6.sh:7-17):
net flux per beat period as a function of c_fraction — the number of
metachronal wavelengths across the cilia array (phase lag p_step =
T*c_fraction/c_num between neighbours, main.cu:102-103,336).

Run at 2048x2048 with 16 cilia (backend auto): 8 points x 100,000 steps
each = 3.4 trillion site updates (the reference's cluster sweep ran each
point for ~2.7 hours on a GPU at 1/70 the cell count).

Result (validation/metachrony.json): pumping peaks at c_fraction=4
(Q=125.0 per beat) — a distinct metachronal optimum, ~1.6x the
synchronous-beat flux (c_fraction=16 == zero phase lag, Q=78.2).

Usage: python scripts/sweep_metachrony.py [--out validation/metachrony.json]
"""

# allow `python scripts/<this>.py` from anywhere: the package lives at
# the repo root, which is NOT on sys.path when the script dir is
import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json
import os
import time

import jax.numpy as jnp

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "validation", "metachrony.json"))
    args = ap.parse_args()
    out = {}
    t00 = time.perf_counter()
    for cf in (1, 2, 3, 4, 6, 8, 12, 16):
        cfg = SimConfig(c_fraction=cf, c_num=16, c_space=128, ydim=2048,
                        dtype="float32")
        sim = MucociliarySim(cfg, backend="auto")
        st = sim.run_chunk(sim.init_state(), cfg.T)  # one beat period
        q = float(st.q)
        finite = bool(jnp.isfinite(st.f).all())
        out[cf] = {"q_per_beat": q, "p_step": cfg.p_step, "finite": finite}
        print(f"c_fraction={cf:2d}  p_step={cfg.p_step:6d}  "
              f"Q(one beat)={q:.5g}  finite={finite}", flush=True)
    print(f"total {time.perf_counter() - t00:.0f}s")
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
