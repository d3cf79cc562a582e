"""Benchmark: MLUPS of the main path on one GPU — the mucociliary model
(D2Q9 TRT fluid + IB cilia array + cumulative flux) on a 2048^2 grid in
f32, with the backend ``auto`` picks (the fused Triton kernel on a GPU).

    python bench.py

Needs a GPU and fails without one.  Times whole ``run_chunk`` calls of
512 steps after a warm-up chunk, over a window of at least one second,
each chunk synced with ``block_until_ready``.  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "MLUPS", "vs_baseline": N,
     "diag": {...}}

vs_baseline is against the reference's derived throughput of ~0.62 MLUPS
(SimLog_nom.txt: 100k iterations on 300x200 in 9,636 s — BASELINE.md).
"""

from __future__ import annotations

import json
import sys
import time

from chip_smoke import card_line

REFERENCE_MLUPS = 0.62
CHUNK = 512
WINDOW_S = 1.0
METRIC = ("MLUPS on one GPU, 2048x2048 D2Q9 TRT + IB cilia "
          "(full step, f32)")


def main() -> int:
    import jax

    from cuda_iblb_11_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {dev.platform}",
              file=sys.stderr)
        return 1

    from cuda_iblb_11_tpu.core.config import SimConfig
    from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

    cfg = SimConfig(c_num=16, c_space=128, ydim=2048, dtype="float32")
    sim = MucociliarySim(cfg, backend="auto")
    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.run_chunk(sim.init_state(), CHUNK))
    warm_s = time.perf_counter() - t0

    steps = 0
    t0 = time.perf_counter()
    while True:
        state = jax.block_until_ready(sim.run_chunk(state, CHUNK))
        steps += CHUNK
        window = time.perf_counter() - t0
        if window >= WINDOW_S:
            break
    mlups = cfg.size * steps / window / 1e6
    finite = bool(jax.numpy.isfinite(state.f).all())
    if not finite:
        print("benchmark state is not finite", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": METRIC,
        "value": round(mlups, 1),
        "unit": "MLUPS",
        "vs_baseline": round(mlups / REFERENCE_MLUPS, 1),
        "diag": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card_line(),
            "resolved": sim.resolved_config(),
            "steps": steps,
            "window_s": round(window, 4),
            "warmup_s_incl_compile": round(warm_s, 2),
            "compile_cache": cache,
            "q_final": float(state.q),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
