"""Immersed-boundary lattice-Boltzmann framework in JAX.

A JAX/XLA/Pallas re-design of the capabilities of
``ptheywood/CUDA_IBLB_11``:
a 2D D2Q9 two-relaxation-time LBM fluid coupled to direct-forcing
immersed-boundary cilia with a Fourier-series beat pattern and
metachronal phase lag.

Layout:
    core/      lattice constants, SimConfig (CLI parity), state pytrees
    ops/       fluid ops: pure-jnp oracle, IB coupling, fused Triton kernel
    models/    cilia kinematics + full simulation model families
    parallel/  device-mesh sharding (shard_map + halo exchange)
    io/        SimLog/flux/field writers (reference formats), checkpointing
    utils/     timing / throughput counters, compile cache
"""

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core import lattice

__version__ = "0.1.0"
__all__ = ["SimConfig", "lattice", "__version__"]

def main():
    from cuda_iblb_11_tpu.cli import main as _main
    return _main()
