"""train_step factory: loss and grads -> clip -> AdamW, with optional
microbatch gradient accumulation (the port of ``repro/training/step.py``).

``microbatches = n > 1`` slices the batch into n equal parts along its
first dim, sums each part's grads in f32 and multiplies the sums (and the
loss) by 1/n, as the reference's ``lax.scan`` does. With a ``mesh`` whose
data axes (``data``, and ``pod`` on the multi-pod mesh) have D > 1 ranks,
each rank passes its own slice of the global batch; the f32 grads and the
loss are all_reduced over the data axes and multiplied by 1/D before the
clip, which is the global batch's mean loss
and its grads when every rank's slice holds as many labels.

Over a model axis (``api.tp`` of M > 1 ranks, the ranks of one data
index holding the same batch) each rank's grads are those of its cut of
the parameters, and a leaf every rank holds whole gets the same, whole
grad on each (the model code sums it, ``models/common.py``); the grads
are all-reduced over ``data`` only. The global norm adds the split
leaves' square sums over ``model`` and the whole leaves' once
(``convert.tp_square_sums``), so the clip is the world-1 run's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import mesh as dmesh

from .optim import AdamWState, adamw_update, tree_leaves, tree_unflatten


def make_train_step(api, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics hold f32 scalars ``loss``, ``grad_norm`` and ``lr``.
    The parameters are made to require grad on the first call and are
    updated in place."""

    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = api.loss(params, batch, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def compute_grads(params, batch):
        n = tcfg.microbatches
        if n <= 1:
            return loss_and_grads(params, batch)
        loss_sum, acc = None, None
        for i in range(n):
            mb = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, grads = loss_and_grads(params, mb)
            if acc is None:
                loss_sum = loss
                acc = [g.to(torch.float32, copy=True) for g in grads]
            else:
                loss_sum = loss_sum + loss
                for a, g in zip(acc, grads):
                    a.add_(g)
            del grads
        inv = 1.0 / n
        return loss_sum * inv, [a.mul_(inv) for a in acc]

    data, dp = ((), 1) if mesh is None else dmesh.data_axes(mesh)

    def data_mean(loss, grads):
        """The mean of every rank's loss and f32 grads over the data axes
        (``data``, and ``pod`` on the multi-pod mesh)."""
        inv = 1.0 / dp
        grads = [dmesh.all_reduce(g.to(torch.float32), mesh, data).mul_(inv)
                 for g in grads]
        return dmesh.all_reduce(loss, mesh, data) * inv, grads

    tp = getattr(api, "tp", None)
    tp_sums = None
    if tp is not None and tp.size > 1:
        from repro_torch.convert import tp_square_sums

        def tp_sums(tree):
            split, whole = tp_square_sums(tree, api.cfg, tp.size)
            return dmesh.all_reduce(split, tp.mesh, "model"), whole

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = compute_grads(params, batch)
        if dp > 1:
            loss, grads = data_mean(loss, grads)
        params, opt_state, metrics = adamw_update(
            params, tree_unflatten(params, grads), opt_state, tcfg,
            tp_sums=tp_sums)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
