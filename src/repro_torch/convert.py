"""Carry the outer loop's state and feature maps across packages as numpy
arrays.

``global_state_from_numpy`` builds the port's ``GlobalState`` from the
fields of a ``GlobalState`` of the JAX package (converted to numpy by the
caller), so a fit begun there can resume here; ``state_to_numpy`` goes the
other way. ``embed_state_from_numpy`` / ``embed_state_to_numpy`` do the same
for the embedded methods' ``EmbedState``, and ``feature_map_from_numpy``
rebuilds a sampled feature map from its tables, so a map drawn by the JAX
package can be used here: randomness does not cross the port.
``csr_from_numpy`` / ``csr_to_numpy`` carry a CSR batch (the reference's
``CSRBatch`` fields) across. ``lm_params_from_numpy`` turns the LM zoo's
``init_lm`` tree into the port's parameters, and ``adamw_state_from_numpy``
/ ``adamw_state_to_numpy`` carry the optimizer's ``AdamWState`` across.
``stack_lm`` / ``unstack_lm`` move an LM tree of tensors between the
port's per-layer list and the reference's stacked [n_groups, period, ...]
layout (the layout of its checkpoints).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.approx import (CountSketchMap, EmbedState, NystromMap,
                                RFFMap, TensorSketchMap)
from repro_torch.core.kernels import KernelSpec
from repro_torch.core.minibatch import GlobalState
from repro_torch.data.sparse import CSRBatch
from repro_torch.training.optim import AdamWState


def global_state_from_numpy(medoids, medoid_diag, cardinalities,
                            batches_done, device) -> GlobalState:
    """numpy fields -> a ``GlobalState`` on ``device`` (f32 tensors)."""
    return GlobalState(medoids=_f32(medoids, device),
                       medoid_diag=_f32(medoid_diag, device),
                       cardinalities=_f32(cardinalities, device),
                       batches_done=int(batches_done))


def state_to_numpy(state: GlobalState) -> dict:
    """A ``GlobalState`` -> {medoids, medoid_diag, cardinalities,
    batches_done} as numpy arrays."""
    return {"medoids": state.medoids.cpu().numpy(),
            "medoid_diag": state.medoid_diag.cpu().numpy(),
            "cardinalities": state.cardinalities.cpu().numpy(),
            "batches_done": np.int32(state.batches_done)}


def _f32(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _i32(a, device):
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def feature_map_from_numpy(kind: str, arrays: dict, statics: dict, device):
    """A feature map from its numpy tables and static fields, on ``device``:
      rff:          arrays w [m, d], b [m];          statics scale
      nystrom:      arrays landmarks [m, d], proj [m, m];
                    statics the KernelSpec fields (name, gamma, coef0, degree)
      sketch:       arrays h [d], sign [d];          statics m
      tensorsketch: arrays hs [p, d+1], signs [p, d+1];
                    statics m, degree, gamma, coef0"""
    if kind == "rff":
        return RFFMap(w=_f32(arrays["w"], device), b=_f32(arrays["b"], device),
                      scale=float(statics["scale"]))
    if kind == "nystrom":
        return NystromMap(landmarks=_f32(arrays["landmarks"], device),
                          proj=_f32(arrays["proj"], device),
                          spec=KernelSpec(**statics))
    if kind == "sketch":
        return CountSketchMap(h=_i32(arrays["h"], device),
                              sign=_f32(arrays["sign"], device),
                              m=int(statics["m"]))
    if kind == "tensorsketch":
        return TensorSketchMap(hs=_i32(arrays["hs"], device),
                               signs=_f32(arrays["signs"], device),
                               m=int(statics["m"]),
                               degree=int(statics["degree"]),
                               gamma=float(statics["gamma"]),
                               coef0=float(statics["coef0"]))
    raise ValueError(f"unknown feature-map kind {kind!r}")


def csr_from_numpy(data, indices, indptr, shape, device) -> CSRBatch:
    """A CSR batch's numpy fields -> the port's ``CSRBatch`` on ``device``
    (data f32, indices int32, indptr int64)."""
    return CSRBatch(_f32(data, device), _i32(indices, device),
                    torch.tensor(np.asarray(indptr, dtype=np.int64),
                                 device=device),
                    (int(shape[0]), int(shape[1])))


def csr_to_numpy(batch: CSRBatch) -> dict:
    """A ``CSRBatch`` -> {data, indices, indptr, shape}, numpy arrays in the
    reference's dtypes (f32, int32, int32) and the shape tuple."""
    return {"data": batch.data.cpu().numpy(),
            "indices": batch.indices.cpu().numpy().astype(np.int32),
            "indptr": batch.indptr.cpu().numpy().astype(np.int32),
            "shape": tuple(batch.shape)}


def embed_state_from_numpy(centroids, cardinalities, batches_done,
                           device) -> EmbedState:
    """numpy fields -> an ``EmbedState`` on ``device`` (f32 tensors)."""
    return EmbedState(centroids=_f32(centroids, device),
                      cardinalities=_f32(cardinalities, device),
                      batches_done=int(batches_done))


def embed_state_to_numpy(state: EmbedState) -> dict:
    """An ``EmbedState`` -> {centroids, cardinalities, batches_done}."""
    return {"centroids": state.centroids.cpu().numpy(),
            "cardinalities": state.cardinalities.cpu().numpy(),
            "batches_done": np.int32(state.batches_done)}


#: LM weights drawn in the model dtype; every other leaf (the norm weights,
#: the MoE router) is f32 whatever the dtype, as in the reference's
#: ``init_lm``
_LM_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed",
             "lm_head", "e_gate", "e_up", "e_down")


def _unstack(tree: dict, cfg, leaf) -> dict:
    """The reference's layout (``layers`` stacked [n_groups, period, ...])
    -> the port's, ``leaf(name, array)`` making each leaf: ``layers`` a
    list in which layer i is slot i % period of group i // period."""
    period = max(cfg.local_global_period, 1)
    stacked = tree["layers"]
    layers = [{name: leaf(name, a[i // period, i % period])
               for name, a in stacked.items()}
              for i in range(cfg.n_layers)]
    out = {name: leaf(name, a) for name, a in tree.items() if name != "layers"}
    out["layers"] = layers
    return out


def lm_params_from_numpy(params: dict, cfg, device,
                         dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's ``init_lm`` tree (leaves converted to numpy; the
    layers stacked [n_groups, period, ...]) -> the port's parameters: the
    same names in the same [in, out] orientation, ``layers`` unstacked to a
    list. Dense and expert weights go to ``dtype``; norm weights and the
    MoE router stay f32."""
    def leaf(name, a):
        t = torch.as_tensor(np.array(a, np.float32), device=device)
        return t.to(dtype) if name in _LM_DENSE else t
    return _unstack(params, cfg, leaf)


def stack_lm(tree: dict, cfg) -> dict:
    """The port's LM tree of tensors (parameters or a moment tree) -> the
    reference's layout on the host: ``layers`` stacked [n_groups, period,
    ...], every leaf a CPU tensor in its dtype."""
    period = max(cfg.local_global_period, 1)
    layers = tree["layers"]
    g = len(layers) // period
    stacked = {name: torch.stack([lay[name].detach().cpu()
                                  for lay in layers]).reshape(
                   g, period, *layers[0][name].shape)
               for name in layers[0]}
    out = {k: v.detach().cpu() for k, v in tree.items() if k != "layers"}
    out["layers"] = stacked
    return out


def unstack_lm(tree: dict, cfg, device) -> dict:
    """``stack_lm``'s inverse: every leaf copied to ``device``."""
    return _unstack(tree, cfg,
                    lambda name, a: a.to(device=device, copy=True))


def adamw_state_from_numpy(step, m: dict, v: dict, cfg, device,
                           dtype: torch.dtype = torch.float32) -> AdamWState:
    """The reference's ``AdamWState`` fields (numpy; m and v ``init_lm``
    trees) -> the port's on ``device``, the moments in ``dtype`` (the
    ``opt_state_dtype``)."""
    def leaf(name, a):
        return torch.as_tensor(np.array(a, np.float32), device=device).to(
            dtype)
    return AdamWState(step=torch.tensor(int(step), dtype=torch.int32,
                                        device=device),
                      m=_unstack(m, cfg, leaf), v=_unstack(v, cfg, leaf))


def adamw_state_to_numpy(state: AdamWState, cfg) -> dict:
    """An ``AdamWState`` -> {step (int32), m, v} in the reference's layout
    (layers stacked), f32 numpy leaves (bf16 moments are exact in f32)."""
    def arrays(tree):
        st = stack_lm(tree, cfg)
        out = {k: t.to(torch.float32).numpy() for k, t in st.items()
               if k != "layers"}
        out["layers"] = {k: t.to(torch.float32).numpy()
                         for k, t in st["layers"].items()}
        return out
    return {"step": np.int32(int(state.step)), "m": arrays(state.m),
            "v": arrays(state.v)}
