"""AdamW as plain functions on tensors (the port of
``repro/training/optim.py``).

Each leaf is worked in f32 and cast back to its dtype, as the reference
does: ``torch.optim.AdamW`` would run a bf16 parameter's arithmetic in
bf16. The update goes leaf by leaf and in place (parameters and moments),
so its temporaries are two f32 copies of the largest leaf: one qwen3-moe
expert leaf is [128, 4096, 1536], 3.22 GB in f32. ``opt_state_dtype=
"bfloat16"`` keeps the moments in bf16, as the reference's switch for its
314B config does.

Parameter, gradient and moment trees are nests of dicts and lists with
tensor leaves (the models' ``params``); ``tree_leaves`` walks them in one
fixed order (dict keys sorted, as the reference's pytrees are).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """The tensor leaves of a nest of dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(like, leaves: list):
    """A tree shaped as ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def adamw_init(params, tcfg: TrainConfig) -> AdamWState:
    dt = _DTYPES[tcfg.opt_state_dtype]
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(step, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(tcfg.warmup_steps, 1)
    frac = (step - tcfg.warmup_steps) / max(
        tcfg.total_steps - tcfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return tcfg.learning_rate * torch.where(
        step < tcfg.warmup_steps, torch.clamp(warm, max=1.0), cos)


def global_norm(tree, tp_sums=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares. Over a model axis
    ``tp_sums(tree)`` gives (the split leaves' square sum, all-reduced over
    the axis, the whole leaves' counted once), and the norm is the
    unsplit tree's."""
    if tp_sums is not None:
        split, whole = tp_sums(tree)
        return torch.sqrt(split + whole)
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_leaf(p, g, m, v, scale, lr, bc1, bc2, tcfg: TrainConfig):
    """One leaf's AdamW step in f32, written back in place: p, m, v. Every
    product and sum is its own operation, in the reference's order, so the
    f32 results round as the reference's do; two f32 temporaries of the
    leaf's size."""
    b1, b2 = tcfg.b1, tcfg.b2
    g32 = g.to(torch.float32, copy=True).mul_(scale)
    m32 = m if m.dtype == torch.float32 else m.to(torch.float32)
    v32 = v if v.dtype == torch.float32 else v.to(torch.float32)
    tmp = torch.mul(g32, 1 - b1)
    m32.mul_(b1).add_(tmp)                            # b1 m + (1 - b1) g
    torch.mul(g32, 1 - b2, out=tmp).mul_(g32)
    v32.mul_(b2).add_(tmp)                            # b2 v + (1 - b2) g g
    torch.div(v32, bc2, out=tmp).sqrt_().add_(tcfg.eps)
    delta = torch.div(m32, bc1, out=g32).div_(tmp)    # m^ / (sqrt(v^) + eps)
    delta.add_(tmp.copy_(p).mul_(tcfg.weight_decay))  # + wd p
    p.copy_(tmp.copy_(p).sub_(delta.mul_(lr)))        # p - lr delta
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


def adamw_update(params, grads, state: AdamWState, tcfg: TrainConfig,
                 tp_sums=None):
    """Returns (params, new state, metrics {"grad_norm", "lr"}); the
    parameters and the moments are updated in place, the gradients clipped
    to a global norm of ``grad_clip`` (``global_norm(grads, tp_sums)``)."""
    gnorm = global_norm(grads, tp_sums)
    if tcfg.grad_clip:
        scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    lr = lr_schedule(step, tcfg)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(tcfg.b1, t)
    bc2 = 1.0 - torch.pow(tcfg.b2, t)
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            _update_leaf(p, g, m, v, scale, lr, bc1, bc2, tcfg)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
