"""State pytrees.

The reference keeps AoS arrays ``f[9*j+i]`` plus separate ``u, rho, force``
device buffers (main.cu:414-459).  The layout here is planar SoA:

    f      [9, Y, X]   distribution functions
    force  [2, Y, X]   Eulerian IB body force (recomputed every step by spread)
    lasts  [c_num, nodes, 2]  previous-step cilium node positions
    q      []          cumulative flux integral (the reference never resets d_Q,
                       so Q is a running time-integral — main.cu:393 + CAS adds)
    it     []          step counter

``rho`` and the corrected velocity are *not* state: they are exact functions
of (f, force) and are recomputed where needed, which removes 12 bytes/cell of
memory traffic from the hot loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import Q as NQ, RHO_0, W


class FlowState(NamedTuple):
    f: jax.Array       # [9, Y, X]
    force: jax.Array   # [2, BAND, X] — IB force band (zero above cfg.force_band)
    lasts: jax.Array   # [c_num, nodes, 2] previous node positions (beat frame)
    q: jax.Array       # [] cumulative flux
    it: jax.Array      # [] int32 step counter


def initial_state(cfg: SimConfig, dtype=None) -> FlowState:
    """Cold start: rho=1, u=0, force=0  =>  f = f0 = rho*w_i.

    Matches the reference bootstrap (main.cu:636-654,722-754): host init to
    rho=RHO_0, u=0, one equilibrium kernel launch, then f <- f0.
    """
    dtype = jnp.dtype(dtype or cfg.dtype)
    y, x = cfg.ydim, cfg.xdim
    if cfg.storage_resolved == "deviatoric":
        # f stores f_i - w_i: the cold-start state is exactly zero.
        f = jnp.zeros((NQ, y, x), dtype)
    else:
        f = jnp.broadcast_to(
            (RHO_0 * W).astype(dtype)[:, None, None], (NQ, y, x)
        ).copy()
    # force / boundary / flux stay at least f32 even under bf16 f storage
    aux = jnp.promote_types(dtype, jnp.float32)
    force = jnp.zeros((2, cfg.force_band, x), aux)
    lasts = jnp.zeros((cfg.c_num, cfg.length, 2), aux)
    q = jnp.zeros((), aux)
    it = jnp.zeros((), jnp.int32)
    return FlowState(f=f, force=force, lasts=lasts, q=q, it=it)
