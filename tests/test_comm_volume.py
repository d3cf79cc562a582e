"""Machine-checked communication volume of the sharded step.

Every step of ShardedMucociliarySim (parallel/sharded.py) exchanges 1-cell
halos of f and of the force field with the four mesh neighbours (x ring
first, then y ring over the x-extended block) and reduces the IB force
gather and the flux column with psums over both mesh axes.  docs/PODS.md
states the per-step count; this test holds the traced program to it.

The claims are audited on the traced jaxpr of the compiled chunk on the
virtual-device mesh: every `ppermute`/`psum` equation is counted (scan trip
counts multiplied through) together with its operand byte volume.  The
numbers are per device: a ppermute of a [9, r, c] f32 operand is one
message of 36*r*c bytes to one neighbour.
"""

import jax
import pytest

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.parallel.sharded import ShardedMucociliarySim, make_mesh

needs8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs >= 8 virtual devices")

CFG = SimConfig(c_num=4, c_space=48, ydim=256, dtype="float32")


def collective_entries(jaxpr, mult=1, acc=None):
    """Every collective equation in a (nested) jaxpr as (prim, mult,
    operand_bytes) entries — scan trip counts carried in `mult`."""
    if acc is None:
        acc = []
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        m = mult * eqn.params["length"] if prim == "scan" else mult
        key = "psum" if prim.startswith("psum") else prim
        if key in ("ppermute", "psum"):
            nbytes = sum(v.aval.size * v.aval.dtype.itemsize
                         for v in eqn.invars if hasattr(v.aval, "size"))
            acc.append((key, mult, nbytes))
        for val in eqn.params.values():
            for v in (val if isinstance(val, (list, tuple)) else [val]):
                if hasattr(v, "eqns"):           # raw Jaxpr
                    collective_entries(v, m, acc)
                elif hasattr(v, "jaxpr"):        # ClosedJaxpr
                    collective_entries(v.jaxpr, m, acc)
    return acc


def collective_stats(jaxpr, mult=1):
    """Count collective equations and operand bytes in a (nested) jaxpr,
    multiplying through scan trip counts."""
    acc = {"ppermute": [0, 0], "psum": [0, 0]}
    for key, m, nbytes in collective_entries(jaxpr, mult):
        acc[key][0] += m
        acc[key][1] += m * nbytes
    return acc


def _chunk_jaxpr(sim, n_steps):
    st = sim.init_state()
    fn = sim._make_chunk(n_steps)
    return jax.make_jaxpr(fn)(st.f, st.force, st.lasts, st.q, st.it).jaxpr


def _halo_bytes(sim):
    """Per-step ppermute operand bytes: f (9 planes) and force (2 planes),
    each an x-ring of [c, yl, 1] columns then a y-ring of [c, 1, xl + 2]
    rows, in both directions."""
    yl, xl = sim.yl, sim.xl
    item = 4
    per_plane = 2 * yl + 2 * (xl + 2)
    return sorted(item * n for c in (9, 2) for n in (
        c * yl, c * yl, c * (xl + 2), c * (xl + 2))), per_plane * 11 * item


@needs8
@pytest.mark.parametrize("n_y,n_x", [(2, 1), (2, 2), (2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_per_step_halo_messages_and_bytes(n_y, n_x, n_steps):
    sim = ShardedMucociliarySim(CFG, make_mesh(n_y, n_x))
    entries = [e for e in collective_entries(_chunk_jaxpr(sim, n_steps))
               if e[0] == "ppermute"]
    # 8 messages per step: f and force, x ring and y ring, both directions
    assert sum(m for _, m, _ in entries) == 8 * n_steps
    assert all(m == n_steps for _, m, _ in entries)
    want, per_step = _halo_bytes(sim)
    assert sorted(b for _, _, b in entries) == want
    assert sum(b for _, _, b in entries) == per_step


@needs8
@pytest.mark.parametrize("n_steps", [1, 5])
def test_per_step_reductions(n_steps):
    # IB force gather psum over x then y, flux psum over x then y
    sim = ShardedMucociliarySim(CFG, make_mesh(2, 4))
    entries = collective_entries(_chunk_jaxpr(sim, n_steps))
    psums = sorted(b for prim, _, b in entries if prim == "psum")
    assert psums == [4, 4] + [4 * CFG.ns * 2] * 2   # flux; F_s [Ns, 2]
    assert collective_stats(_chunk_jaxpr(sim, n_steps))["psum"][0] == (
        4 * n_steps)
