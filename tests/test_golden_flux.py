"""Golden-flux shape regression against the checked-in validation curve
(produced by scripts/validate_flux.py; see validation/README.md).

The fast test checks OUR physics reproduces the checked-in curve's early
segment; the full-beat golden comparison lives in validation/."""

import os

import numpy as np
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim

CURVE = os.path.join(os.path.dirname(__file__), "..", "validation",
                     "flux_trt_split_c6.dat")
NOMINAL = "/root/reference/CUDA_IBLB_11/Data/Nominals/flux_nom.dat"


def test_checked_in_curve_is_monotone_pumping():
    # independent of the (possibly absent) reference goldens: the
    # committed curve itself must show monotone cumulative pumping
    ours = np.loadtxt(CURVE)
    assert np.all(np.diff(ours[:, 1]) > -1e-9)


def test_checked_in_curve_matches_nominal_shape():
    ours = np.loadtxt(CURVE)
    if not os.path.exists(NOMINAL):
        pytest.skip("reference goldens unavailable")
    nom = np.loadtxt(NOMINAL)
    grid = np.linspace(0, min(ours[-1, 0], nom[-1, 0]), 90)
    a = np.interp(grid, ours[:, 0], ours[:, 1])
    b = np.interp(grid, nom[:, 0], nom[:, 1])
    a /= np.abs(a).max()
    b /= np.abs(b).max()
    assert float(np.corrcoef(a, b)[0, 1]) > 0.99


GOLD_F64 = os.path.join(os.path.dirname(__file__), "..", "validation",
                        "flux_early_f64_c6.dat")


def test_early_flux_matches_f64_golden():
    # 2000 steps (2% of a beat) in f32 against a committed f64-ORACLE
    # golden (validation/flux_early_f64_c6.dat, 100-step samples).  The
    # measured f32 flux drift at 2000 steps is ~1e-5 relative (growth law
    # in tests/test_accuracy_horizon.py), so a 1e-3 gate has 100x margin
    # while catching a 0.1% physics regression.
    cfg = SimConfig(c_num=6, c_space=48, dtype="float32")
    sim = MucociliarySim(cfg, backend="jnp")
    gold = np.loadtxt(GOLD_F64)
    st = sim.init_state()
    qs = [(0, 0.0)]
    for _ in range(4):
        st = sim.run_chunk(st, 500)
        qs.append((int(st.it), float(st.q)))
    for it, q in qs[1:]:
        q_ref = float(gold[gold[:, 0] == it, 1][0])
        assert abs(q - q_ref) < 1e-3 * abs(q_ref), (it, q, q_ref)
    assert qs[-1][1] > 0  # pumping in the right direction
