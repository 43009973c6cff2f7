"""The mesh: the distributed exact and embedded fits on
``torch.distributed`` (the port of ``repro/distributed``)."""
from .mesh import axis_size, ghost_row_ids, make_test_mesh, row_axes_of
from .embed import DistributedEmbedKMeans
from .inner import (DistributedInnerConfig, collectives_per_iteration,
                    distributed_kkmeans_fit)
from .outer import DistributedMiniBatchKMeans

__all__ = [
    "axis_size", "ghost_row_ids", "make_test_mesh", "row_axes_of",
    "DistributedEmbedKMeans",
    "DistributedInnerConfig", "collectives_per_iteration",
    "distributed_kkmeans_fit",
    "DistributedMiniBatchKMeans",
]
