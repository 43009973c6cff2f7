"""Fault tolerance: checkpoints and elastic resume (the port of
``repro/ft``; the straggler monitor waits for the recorder, ROADMAP Queue 1
item 10)."""
from .checkpoint import CheckpointManager
from .elastic import ElasticClusteringRunner, SimulatedFailure

__all__ = ["CheckpointManager", "ElasticClusteringRunner",
           "SimulatedFailure"]
