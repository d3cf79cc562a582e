"""Checkpoint/resume (new capability — the reference restarts from scratch
after a crash; SURVEY.md §5).

The full restartable state is (f, force, lasts, q, it) plus the config needed
to validate compatibility.  Two formats:

  * .npz (``save``/``load``): a single host-gathered archive — simple,
    portable, fine for single-host runs of any grid size.
  * orbax (``save_orbax``/``load_orbax``): each host writes only its own
    shards and restore places arrays directly onto the target mesh without
    a host gather — the multi-host / large-grid path (SURVEY.md §5).
    ``load_orbax`` takes the target simulation so restoration can build
    the abstract pytree with the right shardings (sim.place_state's layout).
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.state import FlowState


def save(path: str, state: FlowState, cfg: SimConfig) -> None:
    """Atomic save: write to a temp file in the same directory, then
    os.replace — a crash mid-save must never destroy the previous good
    checkpoint (the whole point of checkpointing)."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            f=np.asarray(state.f),
            force=np.asarray(state.force),
            lasts=np.asarray(state.lasts),
            q=np.asarray(state.q),
            it=np.asarray(state.it),
            config=json.dumps(dataclasses.asdict(cfg)),
        )
    os.replace(tmp, path)


# Fields that determine state compatibility; run-length / output knobs
# (i_pow, p_num, bigdata, sharc) may differ between save and resume.
_STATE_FIELDS = ("c_fraction", "c_num", "c_space", "re", "t_num", "t_pow",
                 "length", "ydim", "dtype", "storage")


def _check_compat(saved_cfg: SimConfig, cfg: SimConfig | None) -> None:
    if cfg is None:
        return
    bad = [f for f in _STATE_FIELDS
           if getattr(cfg, f) != getattr(saved_cfg, f)]
    if bad:
        raise ValueError(
            f"checkpoint incompatible in fields {bad}:\n"
            f" saved: {saved_cfg}\n asked: {cfg}")


def load(path: str, cfg: SimConfig | None = None) -> tuple[FlowState, SimConfig]:
    with np.load(path, allow_pickle=False) as z:
        saved_cfg = SimConfig(**json.loads(str(z["config"])))
        _check_compat(saved_cfg, cfg)
        state = FlowState(
            f=jnp.asarray(z["f"]),
            force=jnp.asarray(z["force"]),
            lasts=jnp.asarray(z["lasts"]),
            q=jnp.asarray(z["q"]),
            it=jnp.asarray(z["it"]),
        )
    return state, saved_cfg


# ---- orbax (sharded / multi-host) format ----------------------------------

def save_orbax(path: str, state: FlowState, cfg: SimConfig) -> None:
    """Sharded checkpoint: every host writes only its own array shards
    (no host gather).  `path` is a directory.

    Crash-safe like save(): orbax's own commit protocol makes the WRITE
    atomic, but ``force=True`` on the final path would delete the previous
    good checkpoint before writing — so the new one is written beside it
    and swapped in with directory renames.  In a multi-process job the
    checkpoint directory is shared storage and orbax coordinates the
    commit across processes; the swap itself must then run on exactly ONE
    process (process 0), fenced by barriers so no rank races the rename
    (found by tests/test_multihost.py)."""
    import os
    import shutil

    import jax
    import orbax.checkpoint as ocp

    multi = jax.process_count() > 1

    def barrier(tag):
        if multi:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"iblb_orbax_{tag}")

    path = os.path.abspath(path)
    tmp = path + ".tmp"
    old = path + ".old"
    if jax.process_index() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    barrier("clean")
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        ckptr.save(
            tmp,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(state._asdict()),
                config=ocp.args.JsonSave(dataclasses.asdict(cfg)),
            ),
            force=True,
        )
    if jax.process_index() == 0:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    barrier("swap")


def load_orbax(path: str, cfg: SimConfig | None = None,
               sim=None) -> tuple[FlowState, SimConfig]:
    """Restore a sharded checkpoint.  If `sim` is given (any of the
    simulation classes), arrays are restored DIRECTLY onto its mesh/layout
    (via the shardings of sim.init_state()); otherwise they come back as
    single-device arrays."""
    import os

    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        meta = ckptr.restore(
            path, args=ocp.args.Composite(config=ocp.args.JsonRestore()))
        saved_cfg = SimConfig(**meta["config"])
        _check_compat(saved_cfg, cfg)
        if sim is not None:
            # abstract target only: eval_shape allocates nothing, so the
            # restore never holds two copies of the state on device
            abstract = jax.eval_shape(sim.init_state)._asdict()
            shardings = {
                "f": sim.grid_sharding(),
                "force": sim._force_sharding(),
                "lasts": sim.replicated(),
                "q": sim.replicated(),
                "it": sim.replicated(),
            }
            target = {
                k: jax.ShapeDtypeStruct(v.shape, v.dtype,
                                        sharding=shardings[k])
                for k, v in abstract.items()
            }
            try:
                restored = ckptr.restore(
                    path, args=ocp.args.Composite(
                        state=ocp.args.StandardRestore(target)))
            except Exception:  # noqa: BLE001 — orbax's mismatch error type
                # Force-layout mismatch between the SAVING sim and this
                # one: the force is band-only [2, band, X] for the
                # single-device layout but full [2, Y, X] for the
                # sharded layout.  Retry with the alternate saved
                # shape (replicated), then adapt onto this sim's layout.
                band = saved_cfg.force_band
                cur = target["force"].shape[1]
                alt = saved_cfg.ydim if cur == band else band
                target["force"] = jax.ShapeDtypeStruct(
                    (2, alt, saved_cfg.xdim), abstract["force"].dtype,
                    sharding=sim.replicated())
                restored = ckptr.restore(
                    path, args=ocp.args.Composite(
                        state=ocp.args.StandardRestore(target)))
                st = dict(restored["state"])
                st["force"] = jax.device_put(
                    sim._force_shape(st["force"]), sim._force_sharding())
                restored = {"state": st}
        else:
            restored = ckptr.restore(
                path, args=ocp.args.Composite(
                    state=ocp.args.StandardRestore()))
    return FlowState(**restored["state"]), saved_cfg
