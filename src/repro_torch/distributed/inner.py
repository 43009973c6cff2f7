"""Distributed inner loop, the port of ``repro/distributed/inner.py``: the
paper's Alg.1 lines 9-16 on a mesh of processes, restructured as an s-step
communication-avoiding iteration.

Faithful mapping (1-D, paper §3.3): the mini-batch rows are split over the
row axes; every rank owns its rows of K^i and f and its slice of U. The
paper's two collectives (line 10 allgather U, line 13 allreduce g) are
exactly ONE all_gather + ONE all_reduce per global sync:

    all_gather: the new labels U
    all_reduce: one flat [C + 2] buffer over the row axes, the g partials
                with the local cost and changed count appended (counts and
                f are local totals once U is gathered)

The kernel block never crosses the network: it is built and consumed on
the rank, so a sync moves Q*(N/(B*P) + 2C) bytes. It is the rank's ONE
block a batch: the landmarks are rows of the batch, so the rank takes
K_ll @ H for the landmarks in its own row block from the rows of its
f_raw = K_xl @ H (a ``GramRows`` view, masked to the landmarks it holds;
``core/engine.py``), and the all_reduce of g adds each landmark once.

2-D (a ``model`` axis): the landmark columns are split over ``model`` as
well; the landmark-row block K_ll is built beside K_xl and replicated over
the row axes ([|L|, |L|/M] on a rank: the landmark rows of f lie on other
row ranks), which makes g local over the rows after the label
gather, so counts / f / g share ONE flat [rows_p + 2, C] all_reduce over
the model axis, and the cost and changed scalars ride the label all_gather
bit-packed into its int32 buffer (``Tensor.view``). Still exactly 1
all_gather + 1 all_reduce per sync; a model axis of 1 is the faithful
algorithm.

s-step mode (``DistributedInnerConfig.s_step = s``, after the
communication-avoiding kernel k-means of Bellavita et al., PAPERS.md):
each sync covers one globally consistent assignment plus s-1 LOCAL Lloyd
refinements against the frozen remote partials of the last sync, so a
Lloyd iteration costs (1 all_gather + 1 all_reduce) / s. On 2-D the
refinements are column-local, so the model replicas of one row block
refine against different estimates: the sync widens the label gather to
the model axis and takes model shard 0's labels, cost and changed as THE
canonical refinement, and every replica leaves the sync with the same
labels.

The loop body is pipelined: it assigns from the stats of the last sync,
then syncs the stats of the labels it just wrote. One PROLOGUE sync before
the loop seeds the stats from u0, and there is no epilogue: at exit the
stats already describe the final labels. The cost returned is the one
synced with the final labels (each row's minimum against the stats it was
assigned from; one sync stale where ``max_iters`` cuts the loop).

The reference's ``lax.while_loop`` is a host loop here. It reads the
changed count from the device once per sync (1/s of the Lloyd
iterations), never more. Each pass of the loop is an ``obs:sweep`` span
and its read an ``obs:host_read[changed]`` span; the prologue sync is
not a sweep. The stats are the single-host loop's
(``core/engine.py``: ``engine_stats_raw``, ``finalize_stats``,
``assign_from_stats``), so in ``fused`` mode on the card the shard's f and
g are ``gram_matvec`` launches of the ``assign_fused`` kernel and the
materialize blocks come from ``kernel_matrix``.

Per sync and rank (D row shards, M model shards, rows_p = N/(B*D)):

==============  =====================  ===================================
mesh layout     collectives per sync   payload bytes per sync (per rank)
==============  =====================  ===================================
1-D (data)      1 all_gather +         all_gather 4*N/B (labels);
                1 all_reduce           all_reduce 4*(C + 2)
2-D (+model)    1 all_gather +         all_gather 4*(N/B + 2*D) (x M when
                1 all_reduce           s > 1); all_reduce 4*C*(rows_p + 2)
==============  =====================  ===================================
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.core.engine import (GramRows, ReducePlan,
                                     assign_from_stats, engine_stats_raw,
                                     finalize_stats, resolve_engine)
from repro_torch.core.kernels import KernelSpec
from repro_torch.obs.trace import span

from .mesh import all_gather, all_reduce, axis_rank, axis_size


@dataclasses.dataclass(frozen=True)
class DistributedInnerConfig:
    n_clusters: int
    kernel: KernelSpec = KernelSpec("rbf", gamma=1.0)
    max_iters: int = 100
    # Gram residency: "materialize" | "fused" | "tiled" or a GramEngine
    engine: object = "materialize"
    # tile dtype "f32" | "bf16"; every sum and every collective payload
    # stays f32
    precision: str = "f32"
    row_axes: tuple[str, ...] = ("data",)
    col_axis: Optional[str] = "model"   # None: the faithful 1-D layout
    # Lloyd refinements per global sync; 1 is the synchronous loop
    s_step: int = 1

    def __post_init__(self):
        if self.s_step < 1:
            raise ValueError(f"s_step must be >= 1, got {self.s_step}")
        resolve_engine(self.engine, self.precision)   # validates both


class DistInnerResult(NamedTuple):
    labels: torch.Tensor   # [n] int32, the whole batch (the last gather)
    f: torch.Tensor        # [rows_p, C] f32, this rank's row block
    g: torch.Tensor        # [C] replicated
    counts: torch.Tensor   # [C] replicated
    n_iter: int            # syncs of the loop (the prologue not counted)
    cost: torch.Tensor     # [] f32


def collectives_per_iteration(cfg: DistributedInnerConfig,
                              n_local_rows: int | None = None) -> dict:
    """The analytic per-SYNC collective bill of the loop body: ``{
    "allgather": 1, "psum": 1, "psum_bytes": ...}`` (the reference's
    names; "psum" is the all_reduce). With ``s_step = s`` a sync covers s
    Lloyd iterations. ``psum_bytes``: the flat [C + 2] buffer in 1-D, the
    flat [rows_p + 2, C] one in 2-D (``n_local_rows`` = rows_p, C where it
    is unknown)."""
    c = cfg.n_clusters
    if cfg.col_axis is None:
        psum_bytes = 4 * (c + 2)
    else:
        rows = c if n_local_rows is None else n_local_rows
        psum_bytes = 4 * c * (rows + 2)
    return {"allgather": 1, "psum": 1, "psum_bytes": psum_bytes}


def _bits(v: torch.Tensor) -> torch.Tensor:
    """An f32 scalar's bits as a [1] int32 tensor."""
    return v.to(torch.float32).reshape(1).view(torch.int32)


def _inner_local(mesh, x_local: torch.Tensor, landmarks: torch.Tensor,
                 l_idx: torch.Tensor, diag_local: torch.Tensor,
                 u0_local: torch.Tensor, wgt_local: torch.Tensor, *,
                 cfg: DistributedInnerConfig) -> DistInnerResult:
    """The loop on this rank's row block (x_local [rows_p, d], diag_local,
    u0_local, wgt_local [rows_p]); ``landmarks`` [L, d] and ``l_idx`` [L]
    (indices into the padded batch) are replicated."""
    spec, c, s = cfg.kernel, cfg.n_clusters, cfg.s_step
    row_axes, col_axis = tuple(cfg.row_axes), cfg.col_axis
    engine = resolve_engine(cfg.engine, cfg.precision)
    two_d = col_axis is not None
    d_size = axis_size(mesh, row_axes)
    m_size = axis_size(mesh, col_axis) if two_d else 1
    n_l = landmarks.shape[0]
    rows = x_local.shape[0]
    r = axis_rank(mesh, row_axes)
    row_off = r * rows
    l_idx = l_idx.to(x_local.device).long()

    # the per-batch Gram operators (module docstring): 2-D builds K_xl over
    # this rank's column slice and K_ll beside it; 1-D builds K_xl alone
    # and masks its landmark rows to those in this rank's row block
    if two_d:
        mr = axis_rank(mesh, col_axis)
        cols = slice(mr * n_l // m_size, (mr + 1) * n_l // m_size)
        idx_cols = l_idx[cols]
        op_xl = engine.prepare(spec, x_local, landmarks[cols])  # rows_p x L/M
        op_ll = engine.prepare(spec, landmarks, landmarks[cols])  # L x L/M
    else:
        idx_cols = l_idx
        op_xl = engine.prepare(spec, x_local, landmarks)        # rows_p x L
        local = l_idx - row_off
        op_ll = GramRows(op_xl, local.clamp(0, rows - 1),
                         ((local >= 0) & (local < rows)).to(torch.float32))

    def local_stats(u_full):
        return engine_stats_raw(engine, spec, op_xl, op_ll, u_full[idx_cols],
                                u_full[l_idx], c)

    if two_d:
        def _fused_reduce(counts_p, f_p, g_p):
            with span("obs:psum_fused"):
                flat = all_reduce(torch.cat([f_p, counts_p[None],
                                             g_p[None]]), mesh, (col_axis,))
            return flat[-2], flat[:-2], flat[-1]
        reduce_plan = ReducePlan(_fused_reduce)

    def sync(u_local, cost_loc, changed_loc):
        """THE sync: 1 all_gather + 1 all_reduce. -> (u_loc, u_full,
        totals, locals, cost, changed)."""
        if not two_d:
            with span("obs:allgather_u"):
                u_full = all_gather(u_local, mesh, row_axes)
            locs = local_stats(u_full)
            with span("obs:psum_fused"):
                flat = all_reduce(torch.cat([
                    locs[2], torch.stack([cost_loc.to(torch.float32),
                                          changed_loc.to(torch.float32)])]),
                    mesh, row_axes)
            totals = (locs[0], locs[1], flat[:-2])
            return (u_local, u_full, totals, locs, flat[-2],
                    flat[-1].to(torch.int32))
        packed = torch.cat([u_local, _bits(cost_loc),
                            changed_loc.to(torch.int32).reshape(1)])
        with span("obs:allgather_u"):
            if s > 1:
                # replicas arrive with different refinements: gather over
                # the model axis too and take model shard 0's as canonical
                buf = all_gather(packed, mesh, row_axes + (col_axis,))
                buf = buf.reshape(d_size, m_size, rows + 2)[:, 0]
            else:
                buf = all_gather(packed, mesh, row_axes).reshape(d_size,
                                                                 rows + 2)
        u_full = buf[:, :rows].reshape(-1)
        cost = buf[:, rows].contiguous().view(torch.float32).sum()
        changed = buf[:, rows + 1].sum()
        u_loc = u_full[row_off:row_off + rows] if s > 1 else u_local
        locs = local_stats(u_full)
        return u_loc, u_full, reduce_plan(*locs), locs, cost, changed

    def remote(totals, locs):
        """Frozen remote partials = reduced totals - own partials (1-D:
        counts and f are local totals, only g has a remote part)."""
        if two_d:
            return tuple(t - l for t, l in zip(totals, locs))
        zero = torch.zeros((), device=x_local.device)
        return (zero, zero, totals[2] - locs[2])

    dev = x_local.device
    u, u_full, totals, locs, _, _ = sync(
        u0_local.to(torch.int32), torch.zeros((), device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))
    rem = remote(totals, locs) if s > 1 else None
    t, cost, changed = 0, torch.tensor(float("inf"), device=dev), True
    with loop("distributed_inner"):
        while changed and t < cfg.max_iters:
            with span("obs:sweep"):
                iteration()
                f, g, counts = finalize_stats(*totals)
                u_new, mind = assign_from_stats(f, g, counts)
                for _ in range(s - 1):
                    # a local refinement: scatter the fresh labels into the
                    # carried global estimate, stats = frozen remote + fresh
                    # local partials
                    u_full = u_full.clone()
                    u_full[row_off:row_off + rows] = u_new
                    est = tuple(a + b for a, b in
                                zip(rem, local_stats(u_full)))
                    u_new, mind = assign_from_stats(*finalize_stats(*est))
                changed_loc = torch.sum((u_new != u).to(torch.int32))
                # ghost rows (weight 0) follow their source row but add no
                # cost
                cost_loc = torch.sum(
                    wgt_local * (diag_local.to(torch.float32) + mind))
                u, u_full, totals, locs, cost, changed_t = sync(
                    u_new, cost_loc, changed_loc)
                if s > 1:
                    rem = remote(totals, locs)
                t += 1
                with span("obs:host_read[changed]"):
                    changed = int(changed_t) > 0    # the one host read a sync
    f, g, counts = finalize_stats(*totals)
    return DistInnerResult(u_full, f, g, counts, t, cost)


def split_rows(mesh, row_axes, n: int) -> slice:
    """This rank's contiguous block of an n-row (padded) batch."""
    rows = n // axis_size(mesh, tuple(row_axes))
    r = axis_rank(mesh, tuple(row_axes))
    return slice(r * rows, (r + 1) * rows)


def distributed_kkmeans_fit(mesh, x: torch.Tensor, landmarks: torch.Tensor,
                            l_idx: torch.Tensor, diag_k: torch.Tensor,
                            u0: torch.Tensor, *, cfg: DistributedInnerConfig,
                            wgt: torch.Tensor | None = None
                            ) -> DistInnerResult:
    """Run the distributed inner loop on ``mesh``. Every rank passes the
    whole batch, as the reference's single controller does, and keeps its
    row block:

    x [n, d] rows; landmarks [L, d] (replicated); l_idx [L] landmark
    indices into x; diag_k [n] K(x_i, x_i); u0 [n] initial labels; wgt [n]
    row weights, 0 on the ghost rows that pad a batch to the mesh (default
    all ones). Returns the labels of all n rows, f of this rank's rows.
    """
    row_axes, col_axis = tuple(cfg.row_axes), cfg.col_axis
    d_size = axis_size(mesh, row_axes)
    m_size = axis_size(mesh, col_axis) if col_axis is not None else 1
    n, n_l = x.shape[0], landmarks.shape[0]
    if n % d_size or n_l % d_size or n_l % m_size:
        raise ValueError(
            f"n={n} must divide row-axes size {d_size} and |L|={n_l} must "
            f"divide both {d_size} and {m_size}; round |L| up with "
            f"num_landmarks(multiple_of=lcm(D, M))")
    if wgt is None:
        wgt = torch.ones((n,), dtype=torch.float32, device=x.device)
    blk = split_rows(mesh, row_axes, n)
    return _inner_local(mesh, x[blk], landmarks, l_idx, diag_k[blk], u0[blk],
                        wgt[blk].to(torch.float32), cfg=cfg)
