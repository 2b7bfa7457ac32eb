"""Parallelism: the device mesh and its collectives, process-group
initialisation, the Monte-Carlo engine (one device or data-parallel over
a mesh) and the rank-staged pipeline."""
from .mesh import (Mesh, NamedSharding, P, local_device_count, make_mesh,
                   shard_map)
from .montecarlo import MonteCarloResult, make_round_fn, montecarlo_ber
from .pipeline import pipeline_map
from . import distributed

__all__ = [
    "pipeline_map",
    "Mesh",
    "NamedSharding",
    "P",
    "local_device_count",
    "make_mesh",
    "shard_map",
    "MonteCarloResult",
    "make_round_fn",
    "montecarlo_ber",
    "distributed",
]
