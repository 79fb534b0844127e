"""pion_tpu: a JAX finite-volume MHD framework for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of PION
(photoionization + MHD nebular dynamics): dense sharded grids, vectorized
MUSCL/Riemann sweeps, batched stiff chemistry, scan-based raytracing, and
``shard_map`` halo exchange in place of MPI.
"""
from .config import SimConfig
from .constants import AV, BC, Coord, Eqn, Solver
from .grid import Geometry, make_geometry
from .sim import Simulation

__version__ = "0.1.0"

__all__ = [
    "AV", "BC", "Coord", "Eqn", "Solver",
    "SimConfig", "Geometry", "make_geometry", "Simulation",
]
