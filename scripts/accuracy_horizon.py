"""Long-horizon accuracy characterization.

Measures velocity rel-L2 error growth of f32 (deviatoric, trt_split)
against the f64 oracle on the reference channel (192^2, 4 cilia):

  cpu leg  — horizons out to 20k steps (a fifth of the reference's
             100k-step beat).  Establishes the f32-vs-f64 growth law at
             small scale.

Writes validation/accuracy_horizon.json (one entry per horizon per pair)
and prints the fitted power law error ~ a * steps^p for each pair.

Run:  python scripts/accuracy_horizon.py cpu
      python scripts/accuracy_horizon.py cpu_full   # full 100k-step beat, 192^2
      python scripts/accuracy_horizon.py cpu_mid    # full beat, 384x192 mid grid

The cpu_full / cpu_mid legs measure (not extrapolate) the f32-vs-f64
error over the reference's complete 100,000-step beat period
(`CUDA_IBLB_11/main.cu:300` ITERATIONS = T*I_pow with the
default T=1e5, I_pow=1): VERDICT r3 item 1.
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

LEG = sys.argv[1] if len(sys.argv) > 1 else "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cuda_iblb_11_tpu.core.config import SimConfig  # noqa: E402
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim  # noqa: E402
from cuda_iblb_11_tpu.ops import ib_band  # noqa: E402
from cuda_iblb_11_tpu.ops import reference as ref  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "validation",
                   "accuracy_horizon.json")


def velocity(sim, st):
    force = ib_band.pad_band(st.force, sim.cfg.ydim)
    _, u = ref.corrected_velocity(st.f.astype(jnp.float64),
                                  force.astype(jnp.float64), sim.storage)
    return u


def rel_l2(u, u_ref):
    return float(jnp.linalg.norm(u - u_ref) / jnp.linalg.norm(u_ref))


def fit_power(horizons, errs):
    """err ~ a * n^p (least squares in log space)."""
    x = np.log(np.asarray(horizons, float))
    y = np.log(np.asarray(errs, float))
    p, loga = np.polyfit(x, y, 1)
    return float(np.exp(loga)), float(p)


def walk(pairs, horizons, label):
    """Advance every sim in lockstep, recording pairwise errors."""
    rows = []
    states = {k: s.init_state() for k, s in pairs.items()}
    it = 0
    for n in horizons:
        t0 = time.time()
        for k, s in pairs.items():
            states[k] = s.run_chunk(states[k], n - it)
            states[k].q.block_until_ready()
        it = n
        us = {k: velocity(pairs[k], states[k]) for k in pairs}
        keys = list(pairs)
        e = rel_l2(us[keys[1]], us[keys[0]])
        rows.append({"pair": f"{keys[1]}_vs_{keys[0]}", "steps": n,
                     "rel_l2": e, "label": label})
        qd = abs(float(states[keys[1]].q) - float(states[keys[0]].q))
        qm = max(abs(float(states[keys[0]].q)), 1e-30)
        rows.append({"pair": f"{keys[1]}_vs_{keys[0]}_flux", "steps": n,
                     "rel_l2": qd / qm, "label": label})
        print(f"[{label}] n={n}: u rel-L2={e:.3e}  q rel={qd / qm:.2e}  "
              f"({time.time() - t0:.0f}s)", flush=True)
    return rows


def main():
    rows = []
    if LEG == "cpu":
        cfg64 = SimConfig(c_num=4, c_space=48, dtype="float64",
                          storage="raw")
        pairs = {
            "f64_oracle": MucociliarySim(cfg64, backend="jnp"),
            "f32": MucociliarySim(
                cfg64.replace(dtype="float32", storage="auto"),
                backend="jnp"),
        }
        horizons = [500, 1000, 2000, 4000, 8000, 12000, 20000]
        rows += walk(pairs, horizons, "cpu_192sq_f32_vs_f64")
    elif LEG == "cpu_full":
        # the reference's own full beat: 100k steps at its minimum legal
        # grid height (YDIM=192, main.cu:271), 4 cilia -> XDIM=192
        cfg64 = SimConfig(c_num=4, c_space=48, dtype="float64",
                          storage="raw")
        pairs = {
            "f64_oracle": MucociliarySim(cfg64, backend="jnp"),
            "f32": MucociliarySim(
                cfg64.replace(dtype="float32", storage="auto"),
                backend="jnp"),
        }
        horizons = [500, 1000, 2000, 4000, 8000, 12000, 20000,
                    35000, 50000, 70000, 100000]
        rows += walk(pairs, horizons, "cpu_full_192sq_f32_vs_f64")
    elif LEG == "cpu_mid":
        # mid-size grid (384x192, 8 cilia) to show the growth law is not
        # grid-specific; full beat
        cfg64 = SimConfig(c_num=8, c_space=48, dtype="float64",
                          storage="raw")
        pairs = {
            "f64_oracle": MucociliarySim(cfg64, backend="jnp"),
            "f32": MucociliarySim(
                cfg64.replace(dtype="float32", storage="auto"),
                backend="jnp"),
        }
        horizons = [5000, 20000, 50000, 100000]
        rows += walk(pairs, horizons, "cpu_mid_384x192_f32_vs_f64")
    else:
        raise SystemExit(f"unknown leg {LEG!r}")

    # growth-law fits per pair
    fits = {}
    for pair in {r["pair"] for r in rows}:
        hs = [r["steps"] for r in rows if r["pair"] == pair]
        es = [r["rel_l2"] for r in rows if r["pair"] == pair]
        if len(hs) >= 3 and min(es) > 0:
            a, p = fit_power(hs, es)
            fits[pair] = {"a": a, "p": p}
            print(f"fit {pair}: err ~ {a:.3e} * n^{p:.2f}  "
                  f"(=> {a * 100_000 ** p:.2e} @ 100k steps)")

    data = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            data = json.load(fh)
    data[LEG] = {"rows": rows, "fits": fits,
                 "backend": jax.default_backend()}
    with open(OUT, "w") as fh:
        json.dump(data, fh, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
