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
``CSRBatch`` fields) across. ``lm_params_from_numpy`` turns a parameter
tree of the LM zoo (any family's ``init_*``) into the port's parameters,
``lm_cache_from_numpy`` a prefill or decode cache, and
``adamw_state_from_numpy`` / ``adamw_state_to_numpy`` carry the optimizer's
``AdamWState`` across. ``stack_lm`` / ``unstack_lm`` move an LM tree of
tensors between the port's per-layer lists and the reference's stacked
layout (the layout of its checkpoints), ``lm_skeleton`` gives that layout
with empty leaves.

The stacked subtrees, by family (``_stacks``): dense and moe ``layers``
[n_groups, period, ...]; hybrid ``layers`` [n_groups, attn_period, ...]
(its ``shared`` block is one dict in both packages); ssm ``layers`` [L,
...]; encdec ``encoder`` [n_enc_layers, ...] and ``decoder``
[n_dec_layers, ...].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.approx import (CountSketchMap, EmbedState, NystromMap,
                                RFFMap, TensorSketchMap)
from repro_torch.core.kernels import KernelSpec
from repro_torch.core.minibatch import GlobalState
from repro_torch.data.sparse import CSRBatch
from repro_torch.training.optim import AdamWState, tree_map


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


#: LM weights drawn in the model dtype; every other leaf (the norm
#: weights, the MoE router, Mamba2's A_log / D / dt_bias / conv_b, RWKV's
#: mu_* / cmu_* / w0 / u) is f32 whatever the dtype, as in the reference
LM_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed",
             "lm_head", "e_gate", "e_up", "e_down",
             "x_wq", "x_wk", "x_wv", "x_wo",                      # encdec
             "in_proj", "conv_w", "out_proj",                     # mamba2
             "wr", "wg", "w1", "w2", "ck", "cv", "cr")            # rwkv6


def _stacks(cfg) -> dict:
    """{subtree stacked in the reference's layout: its leading dims}."""
    if cfg.family == "encdec":
        return {"encoder": (cfg.n_enc_layers,),
                "decoder": (cfg.n_dec_layers,)}
    if cfg.family == "hybrid":
        return {"layers": (cfg.n_layers // cfg.attn_period,
                           cfg.attn_period)}
    if cfg.family == "ssm":
        return {"layers": (cfg.n_layers,)}
    period = max(cfg.local_global_period, 1)
    return {"layers": (cfg.n_layers // period, period)}


def _unstack(tree: dict, cfg, leaf) -> dict:
    """The reference's layout -> the port's, ``leaf(name, array)`` making
    each leaf: a stacked subtree becomes a list in which layer i is entry
    i of the leading dims flattened (layer i of a [n_groups, period, ...]
    stack is slot i % period of group i // period); any other dict (the
    hybrid's ``shared``) stays a dict."""
    out = {}
    for key, node in tree.items():
        lead = _stacks(cfg).get(key)
        if lead is not None:
            n = math.prod(lead)
            flat = {name: a.reshape(n, *a.shape[len(lead):])
                    for name, a in node.items()}
            out[key] = [{name: leaf(name, a[i]) for name, a in flat.items()}
                        for i in range(n)]
        elif isinstance(node, dict):
            out[key] = {name: leaf(name, a) for name, a in node.items()}
        else:
            out[key] = leaf(key, node)
    return out


def lm_params_from_numpy(params: dict, cfg, device,
                         dtype: torch.dtype = torch.float32) -> dict:
    """A parameter tree of the JAX package's LM zoo (leaves converted to
    numpy; layers stacked, ``_stacks``) -> the port's parameters: the same
    names in the same [in, out] orientation, the stacks unstacked to
    lists. Dense weights go to ``dtype``; the other leaves stay f32."""
    def leaf(name, a):
        t = torch.as_tensor(np.array(a, np.float32), device=device)
        return t.to(dtype) if name in LM_DENSE else t
    return _unstack(params, cfg, leaf)


def lm_cache_from_numpy(cache: dict, device) -> dict:
    """A JAX prefill or decode cache (numpy leaves) -> the port's names,
    f32 tensors on ``device``: the hybrid's per-slot tuples ``ssm`` and
    ``conv`` become leaves ``ssm{j}`` and ``conv{j}``; the other families'
    names are the reference's."""
    out = {}
    for name, node in cache.items():
        items = enumerate(node) if isinstance(node, (tuple, list)) \
            else [("", node)]
        for j, a in items:
            out[f"{name}{j}"] = torch.as_tensor(np.array(a, np.float32),
                                                device=device)
    return out


def stack_lm(tree: dict, cfg) -> dict:
    """The port's LM tree of tensors (parameters or a moment tree) -> the
    reference's layout on the host: the per-layer lists stacked
    (``_stacks``), every leaf a CPU tensor in its dtype."""
    out = {}
    for key, node in tree.items():
        lead = _stacks(cfg).get(key)
        if lead is not None:
            out[key] = {name: torch.stack([lay[name].detach().cpu()
                                           for lay in node]).reshape(
                            *lead, *node[0][name].shape)
                        for name in node[0]}
        else:
            out[key] = tree_map(lambda t: t.detach().cpu(), node)
    return out


def unstack_lm(tree: dict, cfg, device) -> dict:
    """``stack_lm``'s inverse: every leaf copied to ``device``."""
    return _unstack(tree, cfg,
                    lambda name, a: a.to(device=device, copy=True))


def lm_skeleton(tree: dict, cfg) -> dict:
    """The reference layout of the port's ``tree`` with empty leaves (what
    a checkpoint restore reads: the structure)."""
    empty = torch.empty(0)
    return {key: ({name: empty for name in node[0]}
                  if key in _stacks(cfg) else tree_map(lambda _: empty, node))
            for key, node in tree.items()}


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
        return tree_map(lambda t: t.to(torch.float32).numpy(),
                        stack_lm(tree, cfg))
    return {"step": np.int32(int(state.step)), "m": arrays(state.m),
            "v": arrays(state.v)}
