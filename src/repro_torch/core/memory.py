"""Memory-aware planning of (B, s), the port of ``repro/core/memory.py``
(the paper's Eq.19 and §4.2 rationale).

The per-node footprint of one mini-batch iteration (paper §3.3, s = 1) is

    M(B) = Q * ( N/(B*P) * (N/B + C) + N/B + 2C )        [bytes]

(K rows + f rows + labels + g + medoid bookkeeping). Setting M(B) <= R and
solving for B gives B_min. The paper's printed Eq.19 drops a 4/P factor on
R/Q under the square root; ``b_min_paper`` reproduces the printed formula,
``b_min`` solves the quadratic exactly. With landmarks the K-row term
shrinks by s; with the fused assignment the K term disappears.

The exact path's Gram residency is a priced strategy (``core.engine``):
``engine_footprint_bytes`` gives the per-node bytes of one inner iteration
under each GramEngine mode,

    materialize:  rows*|L| (K resident)         + rows*C (f)
    fused:        0        (K tiles on chip)    + rows*C
    tiled:        bm*|L|   (streamed panels)    + rows*C

and ``plan`` names the cheapest-FLOP mode that fits as ``Plan.engine``.

Explicit feature maps (``approx``) are linear in the batch size,

    M_embed(B) = Q * ( N/(B*P) * m + C*m + map )         [bytes]

and the sketch maps shrink the map term to O(d) integer tables and, on
sparse rows, the batch to O(nnz):

    M_sketch(B) = Q * ( N/(B*P) * m + C*m ) + 5*d + 2*Q*rho*d*N/(B*P).

Streaming adds a host term: the resident batch plus ``prefetch_depth``
staged ones (``host_staging_bytes``). Landmark selection
(``approx.selectors``) is costed too,

    M_sel(uniform) = 4m
    M_sel(rls)     = Q * (3 m^2 + 2 N/(B*P))
    M_sel(kpp)     = Q * (N/(B*P) * (2 + ln m) + 2 N/(B*P)),

and ``Plan.frontier()`` ranks the strategies by predicted accuracy per byte
at a fixed budget (a coarse model: RLS landmarks cover the kernel's
spectrum like ~1.6x as many uniform ones, kpp ~1.25x, a count sketch's
error ~ sqrt(C/m); only the ordering is trusted). Serving prices a frozen
artifact plus one request bucket (``serve_footprint_bytes``, measured by
``serving.artifact_nbytes``).

The formulas and their numbers are the reference's, term for term. Only
the default machine differs: ``MachineSpec()`` is one NVIDIA H100 SXM
(80 GB, 3.35 TB/s, 989 TFLOP/s bf16 dense, 50 GB/s per NVLink link; its
data sheet), where the reference's is a TPU v5e.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Per-processor memory budget. Defaults: one NVIDIA H100 SXM (data
    sheet constants; ``ici_gbps_per_link`` keeps the reference's field name
    and holds one NVLink link's rate)."""
    memory_bytes: float = 80e9        # R
    n_processors: int = 1             # P
    bytes_per_scalar: int = 4         # Q (fp32 kernel rows)
    hbm_gbps: float = 3350.0
    peak_tflops_bf16: float = 989.0
    ici_gbps_per_link: float = 50.0


def footprint_bytes(n: int, b: int, c: int, p: int, q: int = 4, *,
                    s: float = 1.0, d: int = 0, fused: bool = False) -> float:
    """Per-node bytes for one mini-batch inner-loop iteration.

    Paper formula plus: landmark scaling of the K-block columns (s), optional
    feature storage (d > 0: the batch itself + landmarks live on-node for
    kernel evaluation), and the fused path that never materializes K.
    """
    nb = n / b                       # mini-batch size
    rows = nb / p                    # rows owned by this node
    cols = s * nb                    # landmark columns
    k_term = 0.0 if fused else rows * (cols + c)   # K rows + f rows
    feat = d * (rows + cols) if d else 0.0         # X rows + landmark rows
    return q * (k_term + nb + 2 * c + feat)


ENGINE_MODES = ("materialize", "fused", "tiled")

# bytes per element of the kernel-layer TILE dtype
# (kernels.precision.Precision.tile_itemsize). Accumulators are always
# f32: only tile terms reprice.
_TILE_BYTES = {"f32": 4, "bf16": 2}


def engine_footprint_bytes(n: int, b: int, c: int, p: int, q: int = 4, *,
                           s: float = 1.0, d: int = 0,
                           mode: str = "materialize",
                           tile_rows: int = 256,
                           q_tile: int | None = None) -> float:
    """Per-node bytes of one exact inner-loop iteration under a GramEngine
    mode (module docstring, engine paragraph).

    materialize keeps the [rows, |L|] block resident; fused rebuilds it on
    chip (nothing but the [rows, C] f panel in device memory); tiled streams
    ``tile_rows``-high panels. All modes pay the f panel, the label/medoid
    bookkeeping, and (d > 0) the feature rows the rebuild needs on-node.

    ``q_tile`` is the dtype-aware half of the price (default: ``q``): bytes
    per element of the TILE terms — the Gram block/panels and the feature
    rows, exactly the arrays the precision policy
    (``kernels.precision``) stores in the tile dtype. Under bf16
    (``q_tile=2``) the dominant ``rows*cols`` materialize term and the
    feature term halve while the f panel and bookkeeping stay f32-priced
    (they are accumulator outputs, never tiles) — which is why a bf16
    policy can move the planner's materialize/tiled/fused frontier: a
    resident block that misses the budget at q=4 may fit at q_tile=2, and
    ``plan(precision="bf16")`` prices exactly that.
    """
    qt = q if q_tile is None else q_tile
    nb = n / b
    rows = nb / p
    cols = s * nb
    feat = d * (rows + cols) if d else 0.0
    if mode == "materialize":
        k_term = rows * cols
    elif mode == "fused":
        k_term = 0.0
    elif mode == "tiled":
        # two panels live at once: the tiled matvec is double-buffered
        # (GramEngine.double_buffer — panel i+1 builds while i contracts).
        k_term = 2.0 * min(tile_rows, rows) * cols
    else:
        raise ValueError(f"unknown engine mode {mode!r}; have {ENGINE_MODES}")
    return qt * (k_term + feat) + q * (rows * c + nb + 2 * c)


def s_step_state_bytes(n: int, b: int, c: int, p: int, q: int = 4, *,
                       s_step: int = 1) -> float:
    """Per-device bytes of the s-step communication-avoiding carry
    (the reference's ``distributed.inner``, ``s_step > 1``; the port's mesh
    is ROADMAP Queue 1 item 8): the replicated global-label
    estimate u_full [N/B] (int32) each shard scatters its refinements
    into, plus the frozen remote raw partials it holds between syncs
    (F_rem [rows, C] + the counts/g remainders [2C]). ``s_step == 1``
    carries nothing beyond the engine footprint — the stats the loop
    carries then are the same arrays the engine already prices. (The 2-D
    layout's canonicalizing sync gathers an M-fold label buffer, but that
    is a TRANSIENT freed inside the sync, not carried state; it is ~q*M*
    N/B bytes, negligible against F_rem whenever M*D << rows*C.)"""
    if s_step <= 1:
        return 0.0
    nb = n / b
    rows = nb / p
    return q * (nb + rows * c + 2 * c)


def embed_footprint_bytes(n: int, b: int, c: int, p: int, q: int = 4, *,
                          m: int, d: int = 0) -> float:
    """Per-node bytes for one embedded-space (RFF/Nystrom) batch iteration.

    Embedded rows Z [rows, m] + centroids [C, m] + the replicated map
    parameters (frequencies/landmarks [m, d] and, generously, an [m, m]
    whitening block for Nystrom) + the dense input rows themselves (d > 0:
    the batch must live on-node to be projected — the term the sparse
    sketch path shrinks to O(nnz)). The fused embed+assign kernel would
    drop the Z term too, but this reports the materialized (default) path.
    """
    nb = n / b
    rows = nb / p
    map_params = (m * d + m * m + rows * d) if d else 0.0
    return q * (rows * m + c * m + rows + map_params)


def sketch_footprint_bytes(n: int, b: int, c: int, p: int, q: int = 4, *,
                           m: int, d: int = 0,
                           density: float = 1.0) -> float:
    """Per-node bytes for one sketch-embedded (count-sketch) batch iteration.

    Embedded rows Z [rows, m] + centroids [C, m] like the dense-embedded
    path, but the map parameters are two O(d) tables (int32 hash + int8
    sign = 5 bytes/dim, replicated) instead of the [m, d] float projection,
    and the input rows are stored sparse: ``density`` * d (value, index)
    pairs per row. At RCV1-like density (~1e-2) this is what makes d ~ 50k
    workloads fit where the dense-embedded path cannot even hold X.
    """
    nb = n / b
    rows = nb / p
    sparse_rows = 2.0 * q * rows * d * density if d else 0.0
    tables = 5.0 * d
    return q * (rows * m + c * m + rows) + tables + sparse_rows


def serve_footprint_bytes(c: int, m: int, d: int, *, method: str = "rff",
                          q: int = 4, q_tile: int | None = None,
                          degree: int = 2, bucket: int = 0) -> float:
    """Resident bytes of a frozen predict artifact
    (``serving.artifact``) plus the transient working set of one
    ``bucket``-row request — the serving-side counterpart of the fit-side
    footprints above, and what ``artifact_nbytes`` measures at bucket=0.

    Every embedded method carries the value panel v [m, C], the centroids
    [C, m] and the csq/counts vectors (f32 — accumulator-side, never
    tiles); the map tables are the method-shaped term and the only one
    ``q_tile`` (bf16 = 2) reprices:

        rff/nystrom:   q_tile*m*d  (frequencies / landmarks) + q*m (phases
                       / landmark norms)
        sketch:        4d int32 hash + sign (int8 under bf16, else f32)
        tensorsketch:  degree stacked (d+1)-wide hash+sign tables
        exact:         q*(C*d + C)  (medoids + kernel diagonal; no panels)

    The transient term is one padded query tile (q_tile*bucket*d) + the
    score panel (q*bucket*C) — plus the materialized embedding
    q*bucket*m for tensorsketch, whose FFT path has no fused kernel.
    """
    qt = q if q_tile is None else q_tile
    sign_b = 1.0 if qt < 4 else 4.0
    if method == "exact":
        return q * (c * d + c) + qt * bucket * d + q * bucket * c
    panels = q * (2.0 * m * c + 2.0 * c)          # v + centroids + csq/counts
    if method in ("rff", "nystrom"):
        tables = qt * m * d + q * float(m)
    elif method == "sketch":
        tables = (4.0 + sign_b) * d
    elif method == "tensorsketch":
        tables = degree * (d + 1) * (4.0 + sign_b)
    else:
        raise ValueError(f"unknown serve method {method!r}")
    z_term = q * bucket * m if method == "tensorsketch" else 0.0
    return tables + panels + qt * bucket * d + z_term + q * bucket * c


_SELECTOR_EFF = {"uniform": 1.0, "kpp": 1.25, "rls": 1.6}


def selector_footprint_bytes(n: int, b: int, p: int, q: int = 4, *,
                             m: int, selector: str = "uniform") -> float:
    """Per-node bytes the landmark-selection strategy needs on top of the
    embedded footprint (module docstring, selection paragraph)."""
    rows = n / b / p
    if selector == "uniform":
        return 4.0 * m
    if selector == "rls":
        return q * (3.0 * m * m + 2.0 * rows)
    if selector == "kpp":
        return q * (rows * (2.0 + math.log(max(m, 2))) + 2.0 * rows)
    raise ValueError(f"unknown selector {selector!r}; "
                     f"have {tuple(_SELECTOR_EFF)}")


def predicted_accuracy(method: str, selector: str | None, m: int,
                       c: int) -> float:
    """Coarse accuracy model behind ``Plan.frontier()`` (module docstring):
    landmark methods (nystrom AND the exact-tiled Eq.14 expansion, which is
    a landmark approximation of the same rank) ~ 1 - (1 + m_eff/C)^-1 with
    the selector's effective-landmark multiplier; sketch ~ 1 - sqrt(C/m).
    Only the *ordering* is trusted."""
    if m < 1:
        return 0.0
    if method == "sketch":
        return 1.0 - min(1.0, math.sqrt(c / m))
    eff = _SELECTOR_EFF.get(selector or "uniform")
    if eff is None:
        raise ValueError(f"unknown selector {selector!r}; "
                         f"have {tuple(_SELECTOR_EFF)}")
    return 1.0 - 1.0 / (1.0 + m * eff / max(c, 1))


def b_min(n: int, c: int, machine: MachineSpec, *, s: float = 1.0) -> int:
    """Smallest B such that footprint fits in machine.memory_bytes (exact).

    Solves  Q*( s*N^2/(B^2*P) + C*N/(B*P) + N/B + 2C ) <= R  for 1/B.
    """
    p, q, r = machine.n_processors, machine.bytes_per_scalar, machine.memory_bytes
    # quadratic a*x^2 + b*x + c0 <= 0 with x = 1/B
    a = q * s * n * n / p
    b = q * n * (c / p + 1.0)
    c0 = q * 2.0 * c - r
    if c0 >= 0:
        raise ValueError("machine cannot hold even the O(C) bookkeeping")
    x = (-b + math.sqrt(b * b - 4.0 * a * c0)) / (2.0 * a)
    return max(1, math.ceil(1.0 / x))


def b_min_paper(n: int, c: int, machine: MachineSpec) -> int:
    """The paper's printed Eq.19 (kept verbatim for fidelity; see module doc)."""
    p, q, r = machine.n_processors, machine.bytes_per_scalar, machine.memory_bytes
    t = c / p + 1.0
    disc = t * t - 8.0 * c / p + r / q
    denom = -t + math.sqrt(disc)
    return max(1, math.ceil((2.0 * n / p) / denom))


def host_staging_bytes(n: int, b: int, q: int = 4, *, d: int = 0,
                       density: float = 1.0, sparse: bool = False,
                       prefetch_depth: int = 2) -> float:
    """Host bytes for the streaming ingest pipeline: the resident batch plus
    ``prefetch_depth`` staged batches in the producer queue.

    Dense batches cost ``Q * (N/B) * d`` each; CSR batches cost the
    (value, index) pairs of their nonzeros — Q-byte values plus int32
    (4-byte) indices, whatever Q is — plus the int32 indptr."""
    nb = n / b
    if sparse:
        batch = (q + 4.0) * density * nb * d + 4.0 * (nb + 1)
    else:
        batch = q * nb * d
    return (1.0 + max(0, prefetch_depth)) * batch


@dataclasses.dataclass(frozen=True)
class Plan:
    b: int
    s: float
    footprint: float
    fused_footprint: float
    note: str
    embed_dim: int = 0                   # m used for the embedded estimate
    embed_footprint: float = float("inf")
    method: str = "exact"        # "exact" | "embed" | "sketch" (cheapest)
    sketch_footprint: float = float("inf")
    host_footprint: float = 0.0  # ingest node: (1 + prefetch_depth) batches
    selector: str = "uniform"    # landmark-selection strategy priced in
    selector_footprint: float = 0.0
    # -- exact-path Gram residency (core.engine): the cheapest-FLOP
    #    mode that fits the budget, plus the full per-mode bill.
    engine: str = "materialize"
    engine_footprints: dict = dataclasses.field(default_factory=dict)
    tile_rows: int = 256
    # -- kernel-layer tile dtype the engine bills were priced at
    #    (kernels.precision): "bf16" halves the Gram/feature terms.
    precision: str = "f32"
    # -- s-step communication-avoiding depth (distributed.inner.s_step):
    #    Lloyd refinements per global sync, and the replicated-carry bytes
    #    that depth costs per device (s_step_state_bytes).
    s_step: int = 1
    s_step_footprint: float = 0.0

    def gram_engine(self):
        """The priced pick as a runnable ``GramEngine`` — mode AND the
        ``tile_rows`` the tiled footprint was validated with (threading the
        bare ``Plan.engine`` string would silently run default-height
        panels the budget check never saw), AND the tile ``precision`` the
        bills were priced at (a bf16-priced materialize plan run at f32
        would carry twice the Gram bytes the budget check approved). Hand
        this to ``MiniBatchConfig(engine=plan.gram_engine())``."""
        from .engine import GramEngine
        return GramEngine(self.engine, tile_rows=self.tile_rows,
                          precision=self.precision)
    # -- the workload this plan was made for (frontier() re-prices with it)
    n: int = 0
    c: int = 0
    d: int = 0
    p: int = 1
    q: int = 4
    density: float = 1.0
    sketchable: bool = False

    def frontier(self, budget_bytes: float | None = None) -> list[dict]:
        """Rank landmark/sketch strategies by predicted accuracy-per-byte
        at a fixed per-node byte budget.

        Every candidate — Nystrom with each selector, the exact path under
        the tiled engine (|L| = m landmarks, streamed Gram panels), plus
        the count-sketch when the workload was declared ``sketchable`` —
        gets the largest
        embedding dim m its footprint affords within ``budget_bytes``
        (default: what this plan already spends on the embedded method);
        the coarse accuracy model (``predicted_accuracy``) then prices what
        those bytes buy. Returns records sorted best-first:
        ``{"method", "selector", "m", "bytes", "predicted_accuracy",
        "accuracy_per_byte"}``. Only the ordering is meaningful — the
        the reference's ``fig5_approx_sweep`` selector grid measures it.
        """
        if self.n <= 0:
            raise ValueError("frontier() needs a plan built by plan() — "
                             "workload context (n, c, ...) is missing")
        budget = budget_bytes if budget_bytes is not None else (
            self.embed_footprint + self.selector_footprint)

        def nystrom_bytes(m: int, sel: str) -> float:
            return (embed_footprint_bytes(self.n, self.b, self.c, self.p,
                                          self.q, m=m, d=self.d)
                    + selector_footprint_bytes(self.n, self.b, self.p,
                                               self.q, m=m, selector=sel))

        def sketch_bytes(m: int, sel) -> float:
            return sketch_footprint_bytes(self.n, self.b, self.c, self.p,
                                          self.q, m=m, d=self.d,
                                          density=self.density)

        nb = self.n / self.b

        def exact_tiled_bytes(m: int, sel: str) -> float:
            # the Eq.14 expansion at |L| = m landmarks under the tiled
            # engine: one streamed [tile_rows, m] panel instead of a
            # resident [rows, m] block, plus the selection bill the exact
            # path pays for its own landmarks.
            return (engine_footprint_bytes(self.n, self.b, self.c, self.p,
                                           self.q, s=m / nb, d=self.d,
                                           mode="tiled",
                                           tile_rows=self.tile_rows,
                                           q_tile=_TILE_BYTES.get(
                                               self.precision, self.q))
                    + selector_footprint_bytes(self.n, self.b, self.p,
                                               self.q, m=m, selector=sel))

        cands = [("nystrom", s, nystrom_bytes)
                 for s in ("rls", "kpp", "uniform")]
        # the exact path competes at the SAME budget: landmarks cost panel
        # bytes, not resident-block bytes, and buy nystrom-grade accuracy.
        cands.append(("exact-tiled", self.selector, exact_tiled_bytes))
        if self.sketchable:
            cands.append(("sketch", None, sketch_bytes))
        out = []
        for method, sel, bytes_fn in cands:
            m = _max_m_within(lambda mm: bytes_fn(mm, sel), budget)
            if method == "exact-tiled":
                m = min(m, int(nb))     # |L| cannot exceed the mini-batch
            if m < 1:
                continue
            cost = bytes_fn(m, sel)
            acc = predicted_accuracy(method, sel, m, self.c)
            out.append({"method": method, "selector": sel or "-", "m": m,
                        "bytes": cost, "predicted_accuracy": acc,
                        "accuracy_per_byte": acc / max(cost, 1.0)})
        out.sort(key=lambda r: r["accuracy_per_byte"], reverse=True)
        return out


def _max_m_within(bytes_fn, budget: float, *, m_cap: int = 1 << 20) -> int:
    """Largest m with bytes_fn(m) <= budget (bytes_fn monotone in m)."""
    if bytes_fn(1) > budget:
        return 0
    lo, hi = 1, 2
    while hi < m_cap and bytes_fn(hi) <= budget:
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if bytes_fn(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def plan(n: int, c: int, machine: MachineSpec, *, d: int = 0,
         b: int | None = None,
         embed_dim: int | None = None,
         sketchable: bool = False, density: float = 1.0,
         selector: str = "uniform",
         prefetch_depth: int = 2,
         tile_rows: int = 256,
         precision: str = "f32",
         s_step: int = 1,
         target_batch_seconds: float | None = None,
         measured_batch_seconds: float | None = None) -> Plan:
    """§4.2 model-selection rationale, automated.

    Start at (B_min, s=1). If a target per-batch time is given together with a
    measured single-batch time, first shrink s (down to 0.2 — the paper's
    accuracy cliff), then increase B. Passing ``b`` pins the batch count
    instead (a pipeline constraint the planner must live with) — B_min is
    skipped and the GramEngine pick below absorbs the memory pressure.

    The exact path's Gram residency is priced per mode
    (``engine_footprint_bytes``, ``tile_rows`` sizing the tiled panels) and
    ``Plan.engine`` names the cheapest-FLOP mode that fits: ``materialize``
    when the resident block fits (it amortizes the kernel evaluations over
    every inner iteration), else ``tiled`` (portable streamed panels —
    rebuilds the Gram every iteration), else ``fused`` (tiles on chip
    only). On the card the fused and tiled modes never build the [rows,
    |L|] block (the ``assign_fused`` kernel rebuilds its tiles in shared
    memory and registers); on the CPU the plain path of ``fused``
    (``kernels/ref.py``) does build it, transiently, so there the degrade
    order effectively stops at tiled. All three bills are in
    ``Plan.engine_footprints``; thread the pick as
    ``MiniBatchConfig(engine=plan.gram_engine())`` (mode plus
    the validated ``tile_rows``).

    The embedded-space footprint (RFF/Nystrom at ``embed_dim``; default
    m = 4*C, the tested accuracy floor) is always reported alongside, and
    ``method`` names the cheaper representation at the chosen (B, s):
    ``"exact"`` or ``"embed"``. ``"embed"`` means pick one of
    ``MiniBatchConfig(method="rff")`` / ``method="nystrom"`` — the memory
    model cannot choose between them (same footprint shape); that choice
    follows from the kernel (rbf -> either; anything else -> nystrom).

    ``sketchable=True`` declares the workload sketch-compatible (linear or
    polynomial kernel — the planner cannot infer that from shapes): the
    sketch footprint (O(d) map tables + ``density``-sparse input rows,
    ``sketch_footprint_bytes``) then competes in the auto-pick and
    ``method`` may come back ``"sketch"`` — i.e.
    ``MiniBatchConfig(method="sketch" | "tensorsketch")`` on CSR batches.

    ``prefetch_depth`` sizes the streaming host footprint
    (``Plan.host_footprint``): the resident batch plus that many staged
    batches in the prefetch queue, CSR-priced when the sketch method wins
    (the stream then never densifies) and dense-priced otherwise.

    ``selector`` names the landmark-selection strategy
    (``approx.selectors``); its footprint
    (``selector_footprint_bytes``) joins the embedded method in the
    auto-pick, and ``Plan.frontier()`` ranks all strategies by what their
    bytes buy at a fixed budget.

    ``precision`` is the kernel-layer tile dtype
    (``kernels.precision``): "bf16" prices the Gram-block/panel and
    feature terms of every engine mode at 2 bytes/element instead of 4
    (``engine_footprint_bytes(q_tile=2)``) — accumulator outputs stay
    f32-priced — which can move the materialize/tiled/fused pick: a
    resident block over budget at f32 may fit at bf16. The pick is
    threaded back out via ``Plan.precision`` / ``plan.gram_engine()`` so
    the runtime engine actually stores tiles at the priced dtype.

    ``s_step`` is the communication-avoiding depth of the distributed
    inner loop (``DistributedInnerConfig.s_step``): s Lloyd refinements
    per global sync cut the collective bill to (1 allgather + 1 psum)/s
    but cost the replicated carry ``s_step_state_bytes`` per device —
    priced into every engine-mode budget check below and reported as
    ``Plan.s_step_footprint``.
    """
    if b is None:
        b = b_min(n, c, machine)
        note = "B_min at s=1 (optimal for the available memory)"
    else:
        note = f"B={b} pinned by caller"
    s = 1.0
    if target_batch_seconds and measured_batch_seconds:
        ratio = measured_batch_seconds / target_batch_seconds
        if ratio > 1.0:
            # kernel evaluations scale ~ s * (N/B)^2: first knob is s ...
            s = max(0.2, 1.0 / ratio)
            residual = ratio * s
            if residual > 1.0:
                # ... then B (execution time ~ 1/B per batch).
                b = math.ceil(b * residual)
                note = f"s floored at 0.2 (accuracy cliff), B raised x{residual:.2f}"
            else:
                note = f"s lowered to {s:.3f} to hit the time target"
    m = embed_dim if embed_dim is not None else 4 * c
    p, q = machine.n_processors, machine.bytes_per_scalar
    fp = footprint_bytes(n, b, c, p, q, s=s, d=d)
    # -- Gram residency of the exact inner loop: cheapest-FLOP mode that
    #    fits (materialize amortizes the kernel evaluations; tiled/fused
    #    rebuild per iteration but cap the resident bytes).
    if precision not in _TILE_BYTES:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"have {tuple(_TILE_BYTES)}")
    q_tile = _TILE_BYTES[precision]
    eng_fp = {mode: engine_footprint_bytes(n, b, c, p, q, s=s, d=d,
                                           mode=mode, tile_rows=tile_rows,
                                           q_tile=q_tile)
              for mode in ENGINE_MODES}
    if precision != "f32":
        note += (f"; tiles priced at {precision} "
                 f"({q_tile} B/elem; accumulators stay f32)")
    # the s-step replicated carry rides along whatever the Gram residency
    # is, so it tightens every mode's budget check equally.
    fp_sstep = s_step_state_bytes(n, b, c, p, q, s_step=s_step)
    if s_step > 1:
        note += (f"; s_step={s_step} (collectives /{s_step}, replicated "
                 f"carry {fp_sstep / 1e6:.1f} MB/device)")
    if eng_fp["materialize"] + fp_sstep <= machine.memory_bytes:
        engine = "materialize"
    elif eng_fp["tiled"] + fp_sstep <= machine.memory_bytes:
        engine = "tiled"
        note += (f"; exact engine: tiled (resident Gram block "
                 f"{eng_fp['materialize']/1e6:.0f} MB > budget — streaming "
                 f"{tile_rows}-row panels)")
    elif eng_fp["fused"] + fp_sstep <= machine.memory_bytes:
        engine = "fused"
        note += ("; exact engine: fused (even one Gram panel is tight — "
                 "needs the on-chip tiles of the assign_fused kernel; the "
                 "CPU plain path transiently materializes the block)")
    else:
        # nothing fits — report the smallest bill honestly instead of
        # pretending a mode rescues this (B, s); the caller must grow B,
        # shrink s, or switch representation (see Plan.method/frontier()).
        engine = "fused"
        note += (f"; exact path DOES NOT FIT: even the fused f panel is "
                 f"{eng_fp['fused']/1e6:.1f} MB > budget — raise B, lower "
                 f"s, or use an embedded method")
    fp_embed = embed_footprint_bytes(n, b, c, p, q, m=m, d=d)
    fp_sel = selector_footprint_bytes(n, b, p, q, m=m, selector=selector)
    # the exact path selects |L| = s*N/B landmarks per batch with the SAME
    # strategy (MiniBatchConfig.selector drives Eq.14 too), so it pays its
    # own — typically larger — selection bill in the comparison.
    fp_sel_exact = selector_footprint_bytes(
        n, b, p, q, m=max(c, int(s * n / b)), selector=selector)
    fp_sketch = (sketch_footprint_bytes(n, b, c, p, q, m=m, d=d,
                                        density=density)
                 if sketchable else float("inf"))
    method = "exact"
    if fp_sketch < min(fp + fp_sel_exact, fp_embed + fp_sel):
        method = "sketch"
        note += (f"; O(nnz) sketch (m={m}, density={density:g}) is cheapest "
                 "— consider method='sketch'/'tensorsketch' on CSR batches")
    elif fp_embed + fp_sel < fp + fp_sel_exact:
        method = "embed"
        note += f"; embedded space (m={m}) is cheaper — consider method='rff'/'nystrom'"
    return Plan(
        b=b, s=s,
        footprint=fp,
        fused_footprint=footprint_bytes(n, b, c, p, q, s=s, d=d, fused=True),
        note=note,
        embed_dim=m,
        embed_footprint=fp_embed,
        method=method,
        sketch_footprint=fp_sketch,
        host_footprint=host_staging_bytes(
            n, b, q, d=d, density=density, sparse=(method == "sketch"),
            prefetch_depth=prefetch_depth),
        selector=selector,
        selector_footprint=fp_sel,
        engine=engine,
        engine_footprints=eng_fp,
        tile_rows=tile_rows,
        precision=precision,
        s_step=s_step,
        s_step_footprint=fp_sstep,
        n=n, c=c, d=d, p=p, q=q, density=density, sketchable=sketchable,
    )
