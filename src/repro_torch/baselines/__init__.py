"""The paper's linear baselines: Lloyd k-means with k-means++ seeding and
Sculley's SGD mini-batch k-means, ports of ``repro/baselines``."""
from .lloyd import kmeans as lloyd_kmeans
from .sculley import sgd_minibatch_kmeans

__all__ = ["lloyd_kmeans", "sgd_minibatch_kmeans"]
