"""Carry the outer loop's state across packages as numpy arrays.

``global_state_from_numpy`` builds the port's ``GlobalState`` from the
fields of a ``GlobalState`` of the JAX package (converted to numpy by the
caller), so a fit begun there can resume here; ``state_to_numpy`` goes the
other way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.minibatch import GlobalState


def global_state_from_numpy(medoids, medoid_diag, cardinalities,
                            batches_done, device) -> GlobalState:
    """numpy fields -> a ``GlobalState`` on ``device`` (f32 tensors)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return GlobalState(medoids=f32(medoids), medoid_diag=f32(medoid_diag),
                       cardinalities=f32(cardinalities),
                       batches_done=int(batches_done))


def state_to_numpy(state: GlobalState) -> dict:
    """A ``GlobalState`` -> {medoids, medoid_diag, cardinalities,
    batches_done} as numpy arrays."""
    return {"medoids": state.medoids.cpu().numpy(),
            "medoid_diag": state.medoid_diag.cpu().numpy(),
            "cardinalities": state.cardinalities.cpu().numpy(),
            "batches_done": np.int32(state.batches_done)}
