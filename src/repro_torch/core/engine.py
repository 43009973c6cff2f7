"""One Gram engine for the exact path, the port of ``repro/core/engine.py``.

The inner-loop step (Eq.4-7 / Eq.14-17) is two contractions against the
label one-hot H and an argmin:

    f = K_xl @ H / counts             [n, C]   (Eq.6/17)
    g = diag(H^T K_ll H) / counts^2   [C]      (Eq.5/16)
    u = argmin_j (g_j - 2 f_ij)       [n]      (Eq.4/15)

``GramEngine`` decides where the Gram blocks live while that runs:

================  ==========================  ===========================
mode              residency                   per-iteration cost
================  ==========================  ===========================
``materialize``   K_xl in device memory,      one product with K_xl;
                  built once per batch        peak memory O(rows*|L|)
``fused``         K tiles in shared memory    K_xl and K_ll rebuilt every
                  only (``assign_fused``)     iteration; peak O(rows*C)
``tiled``         one [tile_rows, |L|] panel  K_xl rebuilt every
                  at a time                   iteration; peak
                                              O(tile_rows*|L| + rows*C)
================  ==========================  ===========================

materialize builds its block through ``KernelSpec`` (the ``kernel_matrix``
kernel on the card) and stores it in the tile dtype; its K@H product is a
plain ``torch.matmul`` outside any kernel, as the reference left it to XLA
(it is f32 only while TF32 is off: ``torch.backends.cuda.matmul.allow_tf32``
is False by default and ``chip_smoke.py`` sets it so). fused runs the
``assign_fused`` kernel for the assignment and ``gram_matvec`` for the g
stats. Dispatch between kernel and plain version is by the tensors' device
(``kernels/ops.py``); the reference's ``pallas``/``interpret`` switches have
no counterpart. Kinds without an in-tile epilogue (laplacian) recompute the
block with ``KernelSpec`` and contract it, in fused as in tiled mode.

The landmarks are rows of the batch, so K_ll is rows ``l_idx`` of K_xl and
K_ll @ H is rows ``l_idx`` of f_raw = K_xl @ H. Where the caller holds
those rows, it passes ``op_ll`` as a ``GramRows`` view of ``op_xl``, and
``engine_stats_raw`` takes g from the f_raw it has just computed (an
``obs:g_from_rows`` span): no landmark block is built, copied or
contracted. The single-host fit does so wherever fused mode's one-pass
kernel does not run, and the 1-D mesh always. Two callers keep a block:
that one-pass sweep (``engine_step``) needs g before its kernel computes
f, so it contracts ``gram_matvec`` over the landmarks; and the 2-D mesh
keeps its replicated K_ll [|L|, |L|/M], whose landmark rows of f lie on
other row ranks.

Every mode runs the same stats code and the same argmin, lowest cluster
index on ties, but the modes sum in different orders (fused contracts
against H / counts, materialize divides K @ H by the counts, tiled sums per
row panel). So the final labels agree where the margins are clear; at
near-ties a rounding difference can move a label, and with it the
trajectory and the iteration count of the inner loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ops import BIG
from repro_torch.kernels.precision import PRECISIONS, resolve_precision
from repro_torch.obs.trace import span

from .kernels import KERNEL_KINDS

ENGINE_MODES = ("materialize", "fused", "tiled")


class GramOp(NamedTuple):
    """One side of the inner-loop contraction, prepared per mini-batch:
    the resident block ``k`` (materialize / precomputed), or the row and
    column features ``x``/``y`` the other modes rebuild it from."""
    x: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    k: Optional[torch.Tensor]


class GramRows(NamedTuple):
    """The landmark side as rows of another operator: row i is row
    ``pos[i]`` of ``of``. ``mask`` (0/1 f32 [|L|], or None for all) zeroes
    the rows this process does not own, so that a sum over processes counts
    each landmark once (the 1-D mesh)."""
    of: GramOp
    pos: torch.Tensor
    mask: Optional[torch.Tensor] = None

    def take(self, prod: torch.Tensor) -> torch.Tensor:
        """These rows of ``of``'s product ``prod`` [rows, C]."""
        t = prod[self.pos]
        return t if self.mask is None else t * self.mask[:, None]


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """A cross-device reduction of the raw stats payload (counts [C],
    f_raw [rows, C], g_raw [C]); ``None`` in ``engine_stats`` means one
    device. The mesh slice supplies it."""
    fn: Callable

    def __call__(self, counts, f_raw, g_raw):
        return self.fn(counts, f_raw, g_raw)


@dataclasses.dataclass(frozen=True)
class GramEngine:
    """Strategy handle for the exact inner loop.

    mode:      Gram residency — "materialize" | "fused" | "tiled".
    tile_rows: row-panel height of the tiled mode.
    precision: tile dtype — "f32" | "bf16". ``prepare`` rounds the feature
               panels once, so every mode contracts the same rounded
               values; materialize also stores its block in it.

    The reference's ``double_buffer`` has no counterpart: eager PyTorch
    runs the tiled panels in order on one stream, and the fused kernel
    always stages its next feature chunk while multiplying the current one.
    """
    mode: str = "materialize"
    tile_rows: int = 256
    precision: str = "f32"

    def __post_init__(self):
        if self.mode not in ENGINE_MODES:
            raise ValueError(
                f"unknown engine mode {self.mode!r}; have {ENGINE_MODES}")
        if self.tile_rows < 1:
            raise ValueError(f"tile_rows must be >= 1, got {self.tile_rows}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; have {PRECISIONS}")

    def prepare(self, spec, x: torch.Tensor, y: torch.Tensor) -> GramOp:
        """Round the feature panels to the tile dtype; materialize also
        evaluates the block (f32 sums) and keeps it in the tile dtype."""
        p = resolve_precision(self.precision)
        x, y = p.cast_tiles(x), p.cast_tiles(y)
        if self.mode == "materialize":
            # named profiler span: the once-a-batch Gram panel build
            with span("obs:gram_panel_build"):
                return GramOp(x=x, y=y, k=spec(x, y).to(p.tile_dtype))
        return GramOp(x=x, y=y, k=None)

    @staticmethod
    def from_matrix(k: torch.Tensor) -> GramOp:
        """Wrap a caller-precomputed Gram block (always resident)."""
        return GramOp(x=None, y=None, k=k)

    @staticmethod
    def _has_kernel(spec) -> bool:
        return spec is not None and spec.name in KERNEL_KINDS

    def matvec(self, spec, op, h: torch.Tensor) -> torch.Tensor:
        """(K @ h) -> [rows, C] f32 under this mode's residency; a
        ``GramRows`` view takes its rows of its operator's product."""
        if isinstance(op, GramRows):
            return op.take(self.matvec(spec, op.of, h))
        h = h.to(torch.float32)
        if op.k is not None:
            return op.k.to(torch.float32) @ h
        if self.mode == "fused" and self._has_kernel(spec):
            return ops.gram_matvec(op.x, op.y, h, kind=spec.name,
                                   gamma=spec.gamma, coef0=spec.coef0,
                                   degree=spec.degree,
                                   precision=self.precision)
        if self.mode == "tiled":
            return torch.cat([spec(xt, op.y).to(torch.float32) @ h
                              for xt in torch.split(op.x, self.tile_rows)])
        return spec(op.x, op.y).to(torch.float32) @ h

    def wants_fused_assign(self, spec, op: GramOp) -> bool:
        """True when the one-pass f + argmin kernel applies."""
        return self.mode == "fused" and op.k is None and self._has_kernel(spec)


def resolve_engine(engine, precision: Optional[str] = None) -> GramEngine:
    """A GramEngine or a mode name -> GramEngine; ``precision`` (the
    config-level tile dtype) replaces the engine's when given."""
    if isinstance(engine, str) and engine in ENGINE_MODES:
        engine = GramEngine(mode=engine)
    if not isinstance(engine, GramEngine):
        raise ValueError(
            f"engine must be a GramEngine or one of {ENGINE_MODES}, "
            f"got {engine!r}")
    if precision is not None and precision != engine.precision:
        engine = dataclasses.replace(engine, precision=precision)
    return engine


def _one_hot(labels: torch.Tensor, n_clusters: int) -> torch.Tensor:
    return F.one_hot(labels.long(), n_clusters).to(torch.float32)


def engine_stats_raw(engine: GramEngine, spec, op_xl: GramOp, op_ll,
                     labels_l_cols: torch.Tensor, labels_l_rows: torch.Tensor,
                     n_clusters: int):
    """Raw (un-normalized) partials: (counts [C], f_raw = K_xl @ H [rows, C],
    g_raw = diag(H^T K_ll H) [C]). K_ll @ H is ``op_ll``'s rows of f_raw
    where ``op_ll`` is a ``GramRows`` view of ``op_xl``, else a contraction
    of the block ``op_ll``."""
    with span(f"obs:engine_stats[{engine.mode}]"):
        h_cols = _one_hot(labels_l_cols, n_clusters)
        counts = torch.sum(h_cols, dim=0)
        f_raw = engine.matvec(spec, op_xl, h_cols)
        h_rows = _one_hot(labels_l_rows, n_clusters)
        if isinstance(op_ll, GramRows) and op_ll.of is op_xl:
            with span("obs:g_from_rows"):
                t = op_ll.take(f_raw)
        else:
            t = engine.matvec(spec, op_ll, h_cols)
        g_raw = torch.sum(h_rows * t, dim=0)
        return counts, f_raw, g_raw


def finalize_stats(counts, f_raw, g_raw):
    """Normalize raw partials into (f, g, counts); empty clusters divide by 1."""
    safe = torch.clamp(counts, min=1.0)
    return f_raw / safe[None, :], g_raw / (safe * safe), counts


def engine_stats(engine: GramEngine, spec, op_xl: GramOp, op_ll: GramOp,
                 labels_l_cols, labels_l_rows, n_clusters: int, *,
                 reduce: Optional[ReducePlan] = None):
    """Eq.5-6/16-17 stats -> (f [rows, C], g [C], counts [C]), all f32."""
    counts, f_raw, g_raw = engine_stats_raw(
        engine, spec, op_xl, op_ll, labels_l_cols, labels_l_rows, n_clusters)
    if reduce is not None:
        counts, f_raw, g_raw = reduce(counts, f_raw, g_raw)
    return finalize_stats(counts, f_raw, g_raw)


def assign_from_stats(f: torch.Tensor, g: torch.Tensor, counts: torch.Tensor):
    """Eq.4/15 argmin, lowest cluster index on ties; empty clusters are
    unjoinable (+1e30). Returns (labels [n] int32, mind [n] f32)."""
    dist = torch.where(counts[None, :] > 0, g[None, :] - 2.0 * f,
                       torch.full_like(f, BIG))
    return torch.argmin(dist, dim=1).to(torch.int32), torch.amin(dist, dim=1)


def engine_step(engine: GramEngine, spec, op_xl: GramOp, op_ll: GramOp,
                labels_l: torch.Tensor, n_clusters: int):
    """One inner-loop sweep -> (f, g, counts, labels, mind): f/g/counts
    consistent with the INPUT labels, labels/mind the Eq.4 update. fused
    folds f and the argmin into one kernel pass after the g stats."""
    if engine.wants_fused_assign(spec, op_xl):
        h = _one_hot(labels_l, n_clusters)
        counts = torch.sum(h, dim=0)
        safe = torch.clamp(counts, min=1.0)
        t = engine.matvec(spec, op_ll, h)
        g = torch.sum(h * t, dim=0) / (safe * safe)
        labels, mind, f = ops.assign_fused(
            op_xl.x, op_xl.y, labels_l, counts, g, n_clusters=n_clusters,
            kind=spec.name, gamma=spec.gamma, coef0=spec.coef0,
            degree=spec.degree, precision=engine.precision)
        return f, g, counts, labels, mind
    f, g, counts = engine_stats(engine, spec, op_xl, op_ll,
                                labels_l, labels_l, n_clusters)
    labels, mind = assign_from_stats(f, g, counts)
    return f, g, counts, labels, mind
