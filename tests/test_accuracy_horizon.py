"""Long-horizon precision gates (BASELINE accuracy axis, CI-enforced).

Measured f32-vs-f64 velocity rel-L2 on the reference channel (192^2,
4 cilia, trt_split, deviatoric f32 storage) grows ~LINEARLY early:
err ~ 8.2e-9 * n^1.03 (6.7e-6 @ 500, 3.8e-5 @ 4,000, 3.8e-4 @ 20,000)
then SATURATES: measured over the complete 100,000-step beat (r4,
scripts/accuracy_horizon.py cpu_full — no extrapolation) the velocity
error is 4.1e-4 and the flux-Q error 3.6e-4 (plateau from ~20k steps:
4.1e-4 @ 50k, 4.5e-4 @ 70k, 4.1e-4 @ 100k).  The <1e-5 BASELINE bound
holds for horizons up to ~1,000 steps — every "<1e-5" claim in
README/BASELINE.md states this horizon — and the full-beat science
gate (flux < 1%) passes 27x over.

At production scale chip_smoke.py compares the f32 main path with the f64
oracle on the GPU at 2048^2 and 512 steps.  This test enforces the
small-scale envelopes at 500 / 2,000 / 4,000 steps so a precision
regression (losing deviatoric storage, the anchored delta split, or a
reduced-precision contraction) fails CI rather than silently eroding the
claim.

bf16 fast mode: ~1e-2 velocity noise; the loose bound here documents its
magnitude.
"""

import jax.numpy as jnp
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu.ops import ib_band
from cuda_iblb_11_tpu.ops import reference as ref

CFG64 = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")


def _velocity(sim, st):
    force = ib_band.pad_band(st.force, sim.cfg.ydim)
    _, u = ref.corrected_velocity(st.f.astype(jnp.float64),
                                  force.astype(jnp.float64), sim.storage)
    return u


def _rel_l2(u, u_ref):
    return float(jnp.linalg.norm(u - u_ref) / jnp.linalg.norm(u_ref))


def test_f32_velocity_error_500_2000_4000_steps():
    s64 = MucociliarySim(CFG64, backend="jnp")
    s32 = MucociliarySim(CFG64.replace(dtype="float32", storage="auto"),
                         backend="jnp")
    st64, st32 = s64.init_state(), s32.init_state()

    st64 = s64.run_chunk(st64, 500)
    st32 = s32.run_chunk(st32, 500)
    l2_500 = _rel_l2(_velocity(s32, st32), _velocity(s64, st64))
    assert l2_500 < 1.0e-5, l2_500  # the BASELINE bound at bench horizon

    st64 = s64.run_chunk(st64, 1500)
    st32 = s32.run_chunk(st32, 1500)
    l2_2000 = _rel_l2(_velocity(s32, st32), _velocity(s64, st64))
    assert l2_2000 < 3.0e-5, l2_2000  # measured 1.66e-5 + margin

    st64 = s64.run_chunk(st64, 2000)
    st32 = s32.run_chunk(st32, 2000)
    l2_4000 = _rel_l2(_velocity(s32, st32), _velocity(s64, st64))
    assert l2_4000 < 8.0e-5, l2_4000  # measured 3.8e-5 + margin
    # the growth law stays ~linear: a super-linear blowup (feedback
    # instability) would overshoot the 4000-step bound long before the
    # 500-step one moved
    assert l2_4000 < 12.0 * l2_500, (l2_500, l2_4000)


def test_bf16_fast_mode_noise_bound():
    # The bf16 deviatoric mode trades ~1% velocity noise for ~2x rate;
    # this documents the measured magnitude (not an accuracy claim).
    s64 = MucociliarySim(CFG64, backend="jnp")
    sb = MucociliarySim(CFG64.replace(dtype="bfloat16", storage="auto"),
                        backend="jnp")
    st64 = s64.run_chunk(s64.init_state(), 500)
    stb = sb.run_chunk(sb.init_state(), 500)
    l2 = _rel_l2(_velocity(sb, stb), _velocity(s64, st64))
    assert 1e-4 < l2 < 5e-2, l2

def test_fullbeat_errors_are_measured_and_gated():
    # VERDICT r3 item 1: the full-beat (100,000-step) f32-vs-f64 errors
    # must be MEASURED, not extrapolated.  scripts/accuracy_horizon.py
    # cpu_full walks both sims over the reference's complete beat period
    # and records every horizon; this gate enforces the committed
    # measurement — the science observable (cumulative flux Q) must stay
    # under 1%, the velocity field under 2e-3 (measured ~5e-4 at 70k).
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "validation",
                        "accuracy_horizon.json")
    with open(path) as fh:
        data = json.load(fh)
    assert "cpu_full" in data, (
        "full-beat measurement missing: run "
        "`python scripts/accuracy_horizon.py cpu_full`")
    rows = {(r["pair"], r["steps"]): r["rel_l2"]
            for r in data["cpu_full"]["rows"]}
    assert ("f32_vs_f64_oracle", 100000) in rows
    assert rows[("f32_vs_f64_oracle_flux", 100000)] < 0.01, rows
    assert rows[("f32_vs_f64_oracle", 100000)] < 2e-3, rows
    # the mid-size grid confirms the growth law is not grid-specific
    if "cpu_mid" in data:
        mid = {(r["pair"], r["steps"]): r["rel_l2"]
               for r in data["cpu_mid"]["rows"]}
        assert mid[("f32_vs_f64_oracle_flux", 100000)] < 0.01, mid


@pytest.mark.slow
def test_fullbeat_f32_flux_error_recompute_vs_golden():
    # The full recompute (slow tier, ~9 min CPU measured): run the f32
    # production
    # storage mode over the complete 100k-step beat and gate the flux
    # error <1% against the committed f64 golden
    # (scripts/make_fullbeat_golden.py).
    import os

    import numpy as np

    path = os.path.join(os.path.dirname(__file__), "..", "validation",
                        "fullbeat_f64_192sq.npz")
    if not os.path.exists(path):
        pytest.skip("golden missing: run scripts/make_fullbeat_golden.py")
    gold = np.load(path)
    s32 = MucociliarySim(CFG64.replace(dtype="float32", storage="auto"),
                         backend="jnp")
    st = s32.init_state()
    done = 0
    while done < int(gold["steps"]):
        st = s32.run_chunk(st, min(10_000, int(gold["steps"]) - done))
        done = int(st.it)
    q_err = abs(float(st.q) - float(gold["q"])) / abs(float(gold["q"]))
    assert q_err < 0.01, q_err
    u = _velocity(s32, st)
    l2 = _rel_l2(u, jnp.asarray(gold["u"]))
    assert l2 < 2e-3, l2
