"""Worker process for tests/test_multihost.py (not a test module).

Runs a ShardedMucociliarySim over a (2, 4) mesh either as one process
with 8 virtual CPU devices (MH_MODE=single) or as one rank of a
two-process jax.distributed job with 4 local devices each (MH_MODE=dist),
plus an orbax save/restore roundtrip.  Emits one JSON line with the flux
scalar after 3 and 5 steps, a state checksum, and the resume-equality
verdict — the parent asserts the single-process and two-process runs
agree bit-for-bit.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
MODE = os.environ["MH_MODE"]
if MODE == "dist":
    jax.distributed.initialize(
        coordinator_address=os.environ["MH_COORD"],
        num_processes=int(os.environ["MH_NPROCS"]),
        process_id=int(os.environ["MH_PROC"]),
    )

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from cuda_iblb_11_tpu.core.config import SimConfig  # noqa: E402
from cuda_iblb_11_tpu.io import checkpoint as ckpt  # noqa: E402
from cuda_iblb_11_tpu.parallel.sharded import (  # noqa: E402
    ShardedMucociliarySim, make_mesh,
)


def main():
    assert jax.device_count() == 8, jax.devices()
    cfg = SimConfig(c_num=4, c_space=48, dtype="float32")
    sim = ShardedMucociliarySim(cfg, make_mesh(2, 4))
    st = sim.run_chunk(sim.init_state(), 3)
    q3 = float(st.q)

    # orbax roundtrip: every process writes its own shards; restore
    # places arrays directly onto the mesh
    path = os.path.join(os.environ["MH_CKPT"], "orbax")
    ckpt.save_orbax(path, st, cfg)
    st_r, _ = ckpt.load_orbax(path, cfg, sim=sim)
    a = sim.run_chunk(st_r, 2)
    b = sim.run_chunk(st, 2)
    resume_ok = bool(jnp.array_equal(a.f, b.f)) and bool(
        jnp.array_equal(a.q, b.q))
    # gathered to the host and summed there in f64, so the checksum does
    # not depend on how the cross-device reduction orders its partials
    f_all = multihost_utils.process_allgather(b.f, tiled=True)
    checksum = float(np.sum(np.abs(np.asarray(f_all, np.float64))))

    print(json.dumps({
        "mode": MODE,
        "proc": int(os.environ.get("MH_PROC", 0)),
        "q3": q3,
        "q5": float(b.q),
        "checksum": checksum,
        "resume_ok": resume_ok,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
