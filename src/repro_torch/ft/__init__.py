"""Fault tolerance: checkpoints, elastic resume and the straggler monitor
(the port of ``repro/ft``)."""
from .checkpoint import CheckpointManager
from .elastic import ElasticClusteringRunner, SimulatedFailure
from .straggler import WorkerStatus, replan_rows

__all__ = ["CheckpointManager", "ElasticClusteringRunner",
           "SimulatedFailure", "WorkerStatus", "replan_rows"]
