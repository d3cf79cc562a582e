"""Config 2: lid-driven cavity at Re=100 vs Ghia, Ghia & Shin (1982)
centreline values (coarse subset; 64^2 grid, moderate tolerance)."""

import os

import numpy as np
import pytest

from cuda_iblb_11_tpu.models.cavity import LidDrivenCavity

# Ghia, Ghia & Shin (1982), Re=100: u_x on the vertical centreline at
# selected y/N, and u_y on the horizontal centreline at selected x/N.
GHIA_Y = np.array([0.0625, 0.1016, 0.2813, 0.4531, 0.6172, 0.7344, 0.9531])
GHIA_UX = np.array([-0.04192, -0.06434, -0.15662, -0.21090, -0.13641,
                    0.00332, 0.68717])
GHIA_X = np.array([0.0703, 0.2344, 0.5000, 0.8047, 0.9063, 0.9453])
GHIA_UY = np.array([0.10091, 0.17527, 0.05454, -0.24533, -0.16914,
                    -0.10313])


def test_cavity_re100_centrelines():
    cav = LidDrivenCavity(n=64, re=100.0, u_lid=0.1)
    f = cav.run(cav.init_f(), 30000)
    ux, uy = cav.centreline_profiles(f)
    ux, uy = np.asarray(ux), np.asarray(uy)
    y = (np.arange(cav.n) + 0.5) / cav.n
    x = (np.arange(cav.n) + 0.5) / cav.n
    ux_i = np.interp(GHIA_Y, y, ux)
    uy_i = np.interp(GHIA_X, x, uy)
    # 64^2 grid + halfway walls: within 2.5% of lid speed.
    np.testing.assert_allclose(ux_i, GHIA_UX, atol=0.025)
    np.testing.assert_allclose(uy_i, GHIA_UY, atol=0.025)


def test_cavity_is_steady():
    cav = LidDrivenCavity(n=32, re=100.0, u_lid=0.1)
    f = cav.run(cav.init_f(), 12000)
    f2 = cav.run(f, 1000)
    ux1, _ = cav.centreline_profiles(f)
    ux2, _ = cav.centreline_profiles(f2)
    assert float(np.max(np.abs(np.asarray(ux1 - ux2)))) < 1e-5


def test_recorded_cavity_sweep_metrics():
    # scripts/validate_cavity.py records the full Re in {100,400,1000}
    # sweep (full matmul precision); assert the checked-in deviations
    # vs Ghia.  Measured 2026-08-16: 0.0097 / 0.0083 / 0.0175 lid units.
    # Guards against committing a degraded regeneration; the live physics
    # is covered by the Re=100 run below (and the slow-marked full sweep).
    import json

    path = os.path.join(os.path.dirname(__file__), "..", "validation",
                        "cavity_metrics.json")
    with open(path) as fh:
        m = json.load(fh)
    assert m["100"]["max_dev_ux"] < 0.02
    assert m["400"]["max_dev_ux"] < 0.02
    assert m["1000"]["max_dev_ux"] < 0.03


@pytest.mark.skipif(not os.environ.get("IBLB_SLOW_TESTS"),
                    reason="set IBLB_SLOW_TESTS=1 for the Re sweep")
def test_cavity_re400_centrelines():
    # Ghia et al. Re=400, u_x on the vertical centreline.
    ghia_y = np.array([0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609])
    ghia_ux = np.array([-0.09266, -0.24299, -0.32726, -0.17119, -0.11477,
                        0.02135, 0.61756])
    cav = LidDrivenCavity(n=96, re=400.0, u_lid=0.1)
    f = cav.run(cav.init_f(), 80000)
    ux, _ = cav.centreline_profiles(f)
    y = (np.arange(cav.n) + 0.5) / cav.n
    ux_i = np.interp(ghia_y, y, np.asarray(ux))
    np.testing.assert_allclose(ux_i, ghia_ux, atol=0.03)


@pytest.mark.skipif(not os.environ.get("IBLB_SLOW_TESTS"),
                    reason="set IBLB_SLOW_TESTS=1 for the Re sweep")
def test_cavity_re1000_centrelines():
    # Ghia et al. Re=1000, u_x on the vertical centreline.  TRT at 128^2
    # (tau = 0.538) resolves this to <2% of lid speed (recorded sweep:
    # validation/cavity_metrics.json, 0.0175).
    ghia_y = np.array([0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609])
    ghia_ux = np.array([-0.18109, -0.38289, -0.27805, -0.10648, -0.06080,
                        0.05702, 0.51117])
    cav = LidDrivenCavity(n=128, re=1000.0, u_lid=0.1)
    f = cav.run(cav.init_f(), 200000)
    ux, _ = cav.centreline_profiles(f)
    y = (np.arange(cav.n) + 0.5) / cav.n
    ux_i = np.interp(ghia_y, y, np.asarray(ux))
    np.testing.assert_allclose(ux_i, ghia_ux, atol=0.03)
