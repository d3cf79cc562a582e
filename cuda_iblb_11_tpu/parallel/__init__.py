from cuda_iblb_11_tpu.parallel.sharded import (  # noqa: F401
    ShardedMucociliarySim,
    make_mesh,
)
