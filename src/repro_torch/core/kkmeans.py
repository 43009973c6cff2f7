"""Kernel k-means inner loop (paper §2, Eq.4-7; landmark variant §3.2,
Eq.14-17), the port of ``repro/core/kkmeans.py``.

    u_i <- argmin_j  g_j - 2 f_{i,j}                                   (Eq.4)
    g_j   = (1/|w_j|^2) sum_{m,n in L} K_{m,n} d(u_m,j) d(u_n,j)       (Eq.5/16)
    f_i,j = (1/|w_j|)   sum_{m in L}   K_{i,m} d(u_m,j)                (Eq.6/17)

The reference's ``lax.while_loop`` is a Python loop here. Its condition
reads one ``changed`` flag from the device per iteration: one host sync per
iteration, which stalls the launch queue while the flag is copied back.
The loop runs in ``analysis.dispatch.loop()`` and ticks
``iteration()`` at the top of each pass, so a program audit can tell its
iterations from the stats pass after it (a no-op outside an audit). Each
iteration is an ``obs:sweep`` span and its flag read an
``obs:host_read[changed]`` span (``obs/trace.py``).

The landmarks are rows ``l_idx`` of the batch, so the landmark side of
every fit here is a ``GramRows`` view of the batch block and g comes from
f's landmark rows (``core/engine.py``): one Gram block a batch, one
product a sweep. Only fused mode's one-pass kernel, which needs g before
it computes f, contracts the landmarks' own block.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.obs.trace import span

from .engine import BIG, GramEngine, GramRows, engine_step, resolve_engine


class InnerState(NamedTuple):
    labels: torch.Tensor   # [n] int32 current labels
    changed: bool          # did the last sweep change anything
    t: int                 # iteration counter
    cost: torch.Tensor     # [] f32 current mini-batch cost Omega(W^i)


class InnerResult(NamedTuple):
    labels: torch.Tensor   # [n] int32 converged labels
    f: torch.Tensor        # [n, C] f32 cluster average similarity
    g: torch.Tensor        # [C] f32 cluster compactness
    counts: torch.Tensor   # [C] f32 landmark cardinality per cluster
    n_iter: int
    cost: torch.Tensor     # [] f32 converged mini-batch cost


def _cost(diag_k: torch.Tensor, mind: torch.Tensor) -> torch.Tensor:
    """Omega = sum_i K_ii + min_j(g_j - 2 f_ij)."""
    return torch.sum(diag_k.to(torch.float32) + mind)


def _run_inner(engine: GramEngine, spec, op_xl, op_ll, l_idx, diag_k,
               labels0, *, n_clusters: int, max_iters: int) -> InnerResult:
    state = InnerState(labels0.to(torch.int32), True, 0,
                       torch.tensor(float("inf"), device=diag_k.device))
    with loop("kkmeans"):
        while state.changed and state.t < max_iters:
            with span("obs:sweep"):
                iteration()
                _, _, _, labels, mind = engine_step(
                    engine, spec, op_xl, op_ll, state.labels[l_idx],
                    n_clusters)
                moved = torch.any(labels != state.labels)
                with span("obs:host_read[changed]"):
                    changed = bool(moved)                       # host sync
                state = InnerState(labels, changed, state.t + 1,
                                   _cost(diag_k, mind))
    # one more stats pass at the fixpoint so f/g match the final labels
    f, g, counts, _, _ = engine_step(
        engine, spec, op_xl, op_ll, state.labels[l_idx], n_clusters)
    return InnerResult(state.labels, f, g, counts, state.t, state.cost)


def kkmeans_fit(x: torch.Tensor, l_idx: torch.Tensor, diag_k: torch.Tensor,
                labels0: torch.Tensor, *, spec, n_clusters: int,
                max_iters: int = 100,
                engine: GramEngine = GramEngine()) -> InnerResult:
    """Run the inner loop (Eq.4) to its label fixpoint on one mini-batch.

    x: [n, d] rows; l_idx: [L] landmark indices into x; diag_k: [n]
    K(x_i, x_i); labels0: [n] initial labels; the engine names where the
    Gram blocks live. Runs on the device the tensors are on.
    """
    engine = resolve_engine(engine)
    landmarks = x[l_idx]
    op_xl = engine.prepare(spec, x, landmarks)
    if engine.wants_fused_assign(spec, op_xl):
        # the one-pass kernel needs g before f: contract the landmarks
        op_ll = engine.prepare(spec, landmarks, landmarks)
    else:
        # the landmark block is rows l_idx of the batch block
        op_ll = GramRows(op_xl, l_idx)
    return _run_inner(engine, spec, op_xl, op_ll, l_idx, diag_k, labels0,
                      n_clusters=n_clusters, max_iters=max_iters)


def kkmeans_fit_gram(k_xl: torch.Tensor, l_idx: torch.Tensor,
                     diag_k: torch.Tensor, labels0: torch.Tensor, *,
                     n_clusters: int, max_iters: int = 100) -> InnerResult:
    """The inner loop on a caller-precomputed [n, L] block."""
    op_xl = GramEngine.from_matrix(k_xl)
    return _run_inner(GramEngine("materialize"), None, op_xl,
                      GramRows(op_xl, l_idx), l_idx, diag_k, labels0,
                      n_clusters=n_clusters, max_iters=max_iters)


def kkmeans_fit_full(k: torch.Tensor, diag_k: torch.Tensor,
                     labels0: torch.Tensor, *, n_clusters: int,
                     max_iters: int = 100) -> InnerResult:
    """Exact (s = 1) kernel k-means on a full Gram matrix."""
    l_idx = torch.arange(k.shape[0], device=k.device)
    return kkmeans_fit_gram(k, l_idx, diag_k, labels0,
                            n_clusters=n_clusters, max_iters=max_iters)


def medoid_indices(diag_k: torch.Tensor, f: torch.Tensor,
                   labels: torch.Tensor, counts: torch.Tensor, *,
                   restrict_to_members: bool = False) -> torch.Tensor:
    """Eq.7: m_j = argmin_l K_ll - 2 f_{l,j} -> [C] indices. Empty clusters
    get index 0; callers mask on ``counts == 0``. ``restrict_to_members``
    runs the argmin over each cluster's members only."""
    score = diag_k.to(torch.float32)[:, None] - 2.0 * f
    if restrict_to_members:
        member = torch.nn.functional.one_hot(labels.long(), f.shape[1]).bool()
        score = torch.where(member, score, torch.full_like(score, BIG))
    return torch.argmin(score, dim=0)
