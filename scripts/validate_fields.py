"""Field-snapshot golden validation against the reference nominals.

Reruns the nominal configuration (300x200 grid: c_num=6, c_space=50,
Re=1, T=100k — Data/Nominals/SimLog_nom.txt) and compares the velocity
magnitude and density fields at it = 1000 / 50000 / 99000 against
`Data/Nominals/{it}-vector_nom.dat` (written per main.cu:954-971).

The nominals are a Nov-2017 run at LENGTH=100 (TAU=2.90291 era), while the
current source fixes LENGTH=96 (main.cu:279), so this is a SHAPE-level
physics check (normalized-field correlation), exactly like the flux-curve
regression — not a bit-level one.  Writes validation/fields_metrics.json;
tests/test_golden_fields.py asserts the recorded correlation floors.

Run:  python scripts/validate_fields.py
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

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOMINAL_DIR = "/root/reference/CUDA_IBLB_11/Data/Nominals"
EPOCHS = (1000, 50000, 99000)


def load_nominal(it):
    """(ux, uy, |u|, rho) as [Y, X] arrays from <it>-vector_nom.dat."""
    raw = np.loadtxt(os.path.join(NOMINAL_DIR, f"{it}-vector_nom.dat"))
    x = raw[:, 0].astype(int)
    y = raw[:, 1].astype(int)
    nx, ny = x.max() + 1, y.max() + 1
    fields = np.zeros((4, ny, nx))
    for c in range(4):
        fields[c, y, x] = raw[:, 2 + c]
    return fields  # ux, uy, |u|, rho


def main():
    import jax

    # full f32 matmul precision (TF32 on a GPU otherwise)
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    cfg = SimConfig(c_fraction=1, c_num=6, c_space=50, re=1.0,
                    t_num=1.0, t_pow=5, i_pow=1.0, ydim=200,
                    dtype="float32")
    sim = MucociliarySim(cfg, backend="jnp")
    state = sim.init_state()
    metrics = {}
    it = 0
    for epoch in EPOCHS:
        state = sim.run_chunk(state, epoch - it)
        it = epoch
        rho, u = sim.fields(state)  # the exact snapshot quantities
        ours_mag = np.asarray(jnp.sqrt(u[0] ** 2 + u[1] ** 2))
        ours_rho = np.asarray(rho)
        nom = load_nominal(epoch)
        nom_mag, nom_rho = nom[2], nom[3]

        def corr(a, b):
            a = (a - a.mean()) / (a.std() + 1e-30)
            b = (b - b.mean()) / (b.std() + 1e-30)
            return float(np.mean(a * b))

        def block(a, k=10):
            ny, nx = (a.shape[0] // k) * k, (a.shape[1] // k) * k
            return a[:ny, :nx].reshape(ny // k, k, nx // k, k).mean((1, 3))

        ours_ux = np.asarray(u[0])
        m = {
            # pointwise correlations are fragile: the nominals predate the
            # committed code (LENGTH=100 era) and the instantaneous field
            # is dominated by thin shear layers around the cilia, which a
            # 4% length change displaces entirely.
            "corr_umag": corr(ours_mag, nom_mag),
            "corr_ux": corr(ours_ux, nom[0]),
            # robust shape metrics: 10x10 block-averaged fields and the
            # x-averaged pumping profile u_x(y)
            "corr_umag_coarse": corr(block(ours_mag), block(nom_mag)),
            "corr_ux_coarse": corr(block(ours_ux), block(nom[0])),
            "corr_ux_profile": corr(ours_ux.mean(1), nom[0].mean(1)),
            "corr_rho_dev": corr(ours_rho - 1.0, nom_rho - nom_rho.mean()),
            "rho_channel_ours": float(ours_rho[: cfg.length].mean()),
            "rho_channel_nom": float(nom_rho[:100].mean()),
        }
        metrics[str(epoch)] = m
        print(f"it={epoch}: corr(|u|)={m['corr_umag']:.4f} "
              f"coarse(|u|)={m['corr_umag_coarse']:.4f} "
              f"coarse(ux)={m['corr_ux_coarse']:.4f} "
              f"profile(ux)={m['corr_ux_profile']:.4f} "
              f"rho_channel {m['rho_channel_ours']:.4f} vs "
              f"{m['rho_channel_nom']:.4f}", flush=True)
    out = os.path.join(REPO, "validation", "fields_metrics.json")
    with open(out, "w") as fh:
        json.dump({"config": "c6 c_space=50 Re=1 T=1e5 ydim=200 f32 jnp",
                   "note": "shape-level vs LENGTH=100-era nominals",
                   "epochs": metrics}, fh, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
