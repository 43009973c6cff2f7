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

``shard_lm(params, cfg, rank, size)`` cuts the port's LM tree (parameters
or a moment tree) for rank ``rank`` of a model axis of ``size`` ranks, and
``gather_lm(shards, cfg)`` reassembles the ranks' trees bitwise
(``tp_layout`` names each leaf's cut). Each leaf splits into ``size``
equal blocks along the dim the reference's spec tree marks ``"model"``,
with these exceptions:

* wk / wv stay whole under the ``seq`` K/V policy (KH % size != 0);
* the Mamba2 in_proj, conv_w and conv_b, whose reference specs split
  the concatenated last dim evenly, follow the head split: in_proj [D, z
  | x | B | C | dt] becomes [D, z_r | x_r | B | C | dt_r] (rank r's
  heads' z and x channels and dt columns, B and C whole), conv_w [k, x |
  B | C] and conv_b [x | B | C] become [.., x_r | B | C];
* the leaves the reference splits over ``data`` only, or not at all,
  stay whole (norms, the router, qn / kn, dt_bias, A_log, D).

``tp_square_sums`` splits a tree's f32 sum of squares into the part that
is split over the ranks and the part every rank holds whole.
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
from repro_torch.training.optim import (AdamWState, tree_leaves, tree_map,
                                        tree_unflatten)


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


# ---------------------------------------------------------------------------
# the model axis: cutting and reassembling an LM tree
# ---------------------------------------------------------------------------

#: leaf name -> the dim it splits along over the model axis
_TP_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1,
            "w_down": 0, "e_gate": 2, "e_up": 2, "e_down": 1, "embed": 0,
            "lm_head": 1, "ssm_norm": 0, "out_proj": 0,
            # the encoder-decoder's cross-attention
            "x_wq": 1, "x_wk": 1, "x_wv": 1, "x_wo": 0}
#: RWKV6's leaves (its wk / wv are the time mix's, not attention's): the
#: per-channel leaves of the time mix (u, w0, ln_x, w2's columns) are cut
#: to the rank's heads, where the reference's specs keep them whole
_TP_RWKV = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w2": 1, "u": 0,
            "w0": 0, "ln_x": 0, "ck": 1, "cv": 0, "cr": 1, "embed": 0}
#: Mamba2 leaves whose last dim is a concatenation of head-split and whole
#: parts
_TP_MAMBA = ("in_proj", "conv_w", "conv_b")


def tp_layout(cfg, size: int) -> dict:
    """{leaf name: its cut}: a dim, ``"mamba"`` (the in_proj / conv
    layout) or None (whole); names absent are whole."""
    from repro_torch.models.attention import kv_policy
    if cfg.family == "ssm":
        return dict(_TP_RWKV)
    out = dict(_TP_DIMS)
    if kv_policy(cfg, size) == "seq":      # attention's K/V: whole
        out["wk"] = out["wv"] = out["x_wk"] = out["x_wv"] = None
    if cfg.family == "hybrid":
        out.update({name: "mamba" for name in _TP_MAMBA})
    return out


def _mamba_parts(cfg, name: str, size: int):
    """[(width, split?)] of a Mamba2 leaf's last dim: in_proj z | x | B |
    C | dt, conv x | B | C. dt's columns split by whole heads, and stay
    whole when the model axis splits each head (more ranks than heads)."""
    from repro_torch.models.ssm import ssm_dims
    d_inner, n_heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    parts = [(d_inner, True), (d_inner, True), (n, False), (n, False),
             (n_heads, n_heads % size == 0)]
    parts = parts if name == "in_proj" else parts[1:4]
    return [(w // size if cut else w, cut) for w, cut in parts]


def _walk(trees, fn, name=None):
    """``fn(name, leaves)`` over the same leaf of every tree in ``trees``
    (nested dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _walk([t[k] for t in trees], fn, k) for k in first}
    if isinstance(first, (list, tuple)):
        return [_walk([t[i] for t in trees], fn, name)
                for i in range(len(first))]
    return fn(name, trees)


def _blocks(t: torch.Tensor, dim: int, size: int, name: str):
    if t.shape[dim] % size:
        raise ValueError(f"{name} {tuple(t.shape)} does not split over a "
                         f"model axis of {size} along dim {dim}")
    return t.chunk(size, dim=dim)


def shard_lm(params: dict, cfg, rank: int, size: int) -> dict:
    """Rank ``rank``'s cut of an LM tree for a model axis of ``size``
    (every leaf a fresh tensor)."""
    layout = tp_layout(cfg, size)

    def cut(name, leaves):
        t, how = leaves[0].detach(), layout.get(name)
        if how is None or size == 1:
            return t.clone()
        if how == "mamba":
            full = [(w * size if c else w, c)
                    for w, c in _mamba_parts(cfg, name, size)]
            pieces = torch.split(t, [w for w, _ in full], dim=-1)
            return torch.cat([_blocks(x, -1, size, name)[rank] if c else x
                              for x, (_, c) in zip(pieces, full)], dim=-1)
        return _blocks(t, how, size, name)[rank].clone()
    return _walk([params], cut)


def gather_lm(shards: list, cfg) -> dict:
    """``shard_lm``'s inverse: the ranks' trees (in rank order) -> the
    whole tree."""
    size = len(shards)
    layout = tp_layout(cfg, size)

    def join(name, leaves):
        how = layout.get(name)
        leaves = [t.detach() for t in leaves]
        if how is None or size == 1:
            return leaves[0].clone()
        if how == "mamba":
            parts = _mamba_parts(cfg, name, size)
            split = [torch.split(t, [w for w, _ in parts], dim=-1)
                     for t in leaves]
            return torch.cat([torch.cat([s[i] for s in split], dim=-1)
                              if c else split[0][i]
                              for i, (_, c) in enumerate(parts)], dim=-1)
        return torch.cat(leaves, dim=how)
    return _walk(shards, join)


def whole_lm(tree: dict, cfg, tp) -> dict:
    """The whole tree from every model rank's cut of it, on every rank
    (each rank calls: one all_gather over ``model`` a leaf); the tree
    itself when ``tp`` has one rank."""
    if tp.size == 1:
        return tree
    from repro_torch.distributed import mesh as dmesh
    leaves = [dmesh.all_gather(t.detach()[None], tp.mesh, "model")
              for t in tree_leaves(tree)]
    return gather_lm([tree_unflatten(tree, [g[r] for g in leaves])
                      for r in range(tp.size)], cfg)


def tp_square_sums(tree: dict, cfg, size: int):
    """(sum of f32 squares of the leaves' split parts, of their whole
    parts) of one rank's tree: the global norm all-reduces the first over
    the model axis and adds the second once."""
    layout = tp_layout(cfg, size)
    split, whole = [], []

    def add(name, leaves):
        t = leaves[0].to(torch.float32)
        how = layout.get(name)
        if how == "mamba":
            parts = _mamba_parts(cfg, name, size)
            for x, (_, c) in zip(torch.split(t, [w for w, _ in parts], -1),
                                 parts):
                (split if c else whole).append(torch.sum(torch.square(x)))
        else:
            (whole if how is None else split).append(
                torch.sum(torch.square(t)))
    _walk([tree], add)
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(tree)[0].device)
    return sum(split, zero), sum(whole, zero)
