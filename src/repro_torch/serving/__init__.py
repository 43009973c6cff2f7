"""Serving: continuous-batching LM serving (the port of ``repro/serving``'s
engine and samplers) and assignment serving off frozen clustering
artifacts (``artifact``, ``assign``)."""
from .artifact import (FUSED_KINDS, KINDS, FrozenArtifact, artifact_nbytes,
                       freeze, freeze_map, load_artifact, save_artifact)
from .assign import (DEFAULT_BUCKETS, AssignServeConfig, AssignService,
                     QueueFull, bucket_for)
from .assign import predict as predict_frozen
from .engine import Request, ServeConfig, ServingEngine
from .sampling import greedy, sample_top_p

__all__ = ["Request", "ServeConfig", "ServingEngine", "greedy",
           "sample_top_p",
           "FUSED_KINDS", "KINDS", "FrozenArtifact", "freeze", "freeze_map",
           "artifact_nbytes", "save_artifact", "load_artifact",
           "DEFAULT_BUCKETS", "AssignServeConfig", "AssignService",
           "QueueFull", "bucket_for", "predict_frozen"]
