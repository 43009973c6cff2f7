"""Cost terms of one run, the port's counterpart of
``repro/launch/hlocost.py``.

The reference re-derives per-device FLOPs, HBM bytes and collective bytes
from compiled HLO text, with while-loop trip counts multiplied through.
The port compiles no program: ``compiled_cost_terms(fn, *args)`` RUNS
``fn`` once under ``analysis.audit`` (eager loops count as they run, so a
7-pass Python loop of matmuls costs 7 matmuls), and ``cost_terms(report)``
reads the same terms from any ``ProgramReport``, so an audited run needs
no second run to be priced. Per device:

* **flops** of every aten op outside kernel scope, from the formulas of
  ``torch.utils.flop_counter`` (``flop_registry``, what
  ``FlopCounterMode`` sums), split by the precision of the op's output
  (the audit's ``op_flops``);
* **bytes** as the input plus output bytes of every such op (each eager op
  reads its inputs from device memory and writes its outputs back; views
  and ``empty`` move nothing; the audit's ``op_bytes``);
* **kernel work**: a ctypes launch is invisible to the dispatcher, so the
  wrappers in ``kernels/ops.py`` tell ``WORK_OBSERVERS`` each launch's
  shapes (and, on the CPU, those of the plain call standing in for it,
  whose own ops are kernel scope and not counted), and ``KERNEL_WORK``
  prices them: the one count of each kernel's work, which ``chip_smoke.py``
  turns into each kernel's ``bound_ms``;
* **collectives**: the run's counts and payload bytes per rank, from
  ``distributed.mesh.tally()``: ``all-reduce`` (the bytes summed),
  ``all-gather`` (the bytes returned), ``reduce-scatter`` (the bytes sent
  in) and ``all-to-all`` (the bytes sent). The reference charges ring
  link bytes; the port reports payload here, and ``launch.dryrun`` prices
  the tally's calls by the reference's ring formulas.

``analyze(hlo)``, ``xla_cost`` and ``xla_memory`` read HLO text and XLA's
own cost and memory analyses; there is no counterpart, since nothing is
compiled. The terms are roofline inputs, not a profile.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
#: the audit's collective names -> the reference's HLO names
_HLO_NAMES = {"psum": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


class Work(NamedTuple):
    """A kernel's work: ``flops`` as [(precision, n)], ``bytes`` moved
    (each input read once, each output written once)."""
    flops: list
    bytes: float


def _tile(prec: str) -> int:
    return 2 if prec == "bf16" else 4


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps (top-left causal)."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def kernel_matrix_work(*, m, n, d, prec, **_) -> Work:
    """K(X [m, d], Y [n, d]) -> [m, n] f32: X, Y and K once (either body
    sums the row norms in the launch)."""
    return Work([(prec, 2.0 * m * n * d)],
                (m + n) * d * _tile(prec) + m * n * 4)


def assign_fused_work(*, m, l, d, c, prec, **_) -> Work:
    """The Gram tiles in the tile dtype, the contraction with H in f32;
    X, L, their norms, H, g read, labels, mind and f written."""
    return Work([(prec, 2.0 * m * l * d), ("f32", 2.0 * m * l * c)],
                (m + l) * d * _tile(prec) + (m + l) * 4 + l * c * 4
                + c * 4 + m * (8 + 4 * c))


def gram_matvec_work(*, m, l, d, c, prec, shared=False, **_) -> Work:
    """K(X, L) @ H through the assign_fused kernel with g = 0, only f
    written; ``shared``: the g stats' one panel as both operands, read
    once."""
    if shared:
        return Work([(prec, 2.0 * l * l * d), ("f32", 2.0 * l * l * c)],
                    l * d * _tile(prec) + l * 4 + 2 * l * c * 4)
    return Work([(prec, 2.0 * m * l * d), ("f32", 2.0 * m * l * c)],
                (m + l) * d * _tile(prec) + (m + l) * 4 + l * c * 4
                + m * c * 4)


def embed_assign_work(*, n, d, m, c, prec, **_) -> Work:
    """phi(X W^T) in the tile dtype, the value panel in f32; X, W, their
    norms or phases, V and |c|^2 read, labels and scores written."""
    return Work([(prec, 2.0 * n * m * d), ("f32", 2.0 * n * m * c)],
                (n + m) * d * _tile(prec) + (n + m) * 4 + (m + 1) * c * 4
                + n * 8)


def sketch_assign_work(*, n, d, m, c, prec, **_) -> Work:
    """The sketch's signed adds and Z V in f32; X, the hash and sign
    tables (int8 signs under bf16), the bucket offsets, V and |c|^2 read,
    labels and scores written."""
    sign = 1 if prec == "bf16" else 4
    return Work([("f32", 2.0 * n * m * c + n * d)],
                n * d * _tile(prec) + d * (4 + sign) + (m + 1) * 4
                + (m + 1) * c * 4 + n * 8)


def flash_attention_work(*, b, h, kh, sq, sk, dh, causal, prec, **_) -> Work:
    """QK^T and PV over the pairs the mask keeps; q, k, v read and the
    output written in the tile dtype."""
    pairs = attention_pairs(sq, sk, causal)
    return Work([(prec, 4.0 * b * h * dh * pairs)],
                (2 * b * h * sq * dh + 2 * b * kh * sk * dh) * _tile(prec))


#: work kind -> its pricing; the kinds the ops wrappers report
KERNEL_WORK = {
    "kernel_matrix": kernel_matrix_work,
    "assign_fused": assign_fused_work,
    "gram_matvec": gram_matvec_work,
    "embed_assign": embed_assign_work,
    "sketch_assign": sketch_assign_work,
    "flash_attention": flash_attention_work,
}
#: the kernel each work kind launches
KERNEL_OF = {"gram_matvec": "assign_fused"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    flops_by_precision: dict = dataclasses.field(default_factory=dict)

    def add_flops(self, prec: str, n: float) -> None:
        self.flops += n
        self.flops_by_precision[prec] = \
            self.flops_by_precision.get(prec, 0.0) + n

    def __iadd__(self, other):
        self.bytes += other.bytes
        for prec, n in other.flops_by_precision.items():
            self.add_flops(prec, n)
        for k in self.coll:
            self.coll[k] += other.coll[k]
            self.coll_counts[k] += other.coll_counts[k]
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m,
                    {k: v * m for k, v in self.coll.items()},
                    {k: int(v * m) for k, v in self.coll_counts.items()},
                    {k: v * m for k, v in self.flops_by_precision.items()})

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def compiled_cost_terms(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under ``analysis.audit`` and return
    its ``cost_terms``."""
    from repro_torch.analysis import audit
    return cost_terms(audit(fn, *args, **kwargs))


def cost_terms(report) -> dict:
    """A ``ProgramReport``'s cost terms in one dict (module docstring):
    ``flops`` and ``flops_by_precision``, ``hbm_bytes``, ``coll_bytes`` and
    ``coll_counts``, the ``kernel_work`` items with their priced flops and
    bytes, and ``allocated_bytes`` (the bytes of op outputs with real
    storage; 0 under ``FakeTensorMode``)."""
    cost = report_cost(report)
    return {
        "flops": cost.flops,
        "flops_by_precision": dict(cost.flops_by_precision),
        "hbm_bytes": cost.bytes,
        "coll_bytes": cost.coll_bytes,
        "coll_counts": {k: v for k, v in cost.coll_counts.items() if v},
        "kernel_work": cost.kernel_work,
        "allocated_bytes": cost.allocated,
    }


def cost_of(fn, *args, **kwargs) -> Cost:
    """The ``Cost`` of one audited run of ``fn``."""
    from repro_torch.analysis import audit
    return report_cost(audit(fn, *args, **kwargs))


def report_cost(report) -> Cost:
    """The ``Cost`` of an audited run: its op-level terms, each launch's
    ``KERNEL_WORK``, its collective totals; with ``kernel_work`` (the
    priced items) and ``allocated`` attached."""
    cost = Cost()
    for prec, n in report.op_flops.items():
        cost.add_flops(prec, n)
    cost.bytes += report.op_bytes
    items = []
    for item in report.kernel_work:
        shapes = {k: v for k, v in item.items() if k != "work"}
        w = KERNEL_WORK[item["work"]](**shapes)
        for prec, n in w.flops:
            cost.add_flops(prec, n)
        cost.bytes += w.bytes
        items.append({"work": item["work"],
                      "kernel": KERNEL_OF.get(item["work"], item["work"]),
                      **shapes, "flops": sum(n for _, n in w.flops),
                      "bytes": w.bytes})
    for prim, hlo in _HLO_NAMES.items():
        cost.coll_counts[hlo] += report.collectives_total.get(prim, 0)
        cost.coll[hlo] += report.collective_bytes_total.get(prim, 0)
    cost.kernel_work = items
    cost.allocated = report.allocated_bytes
    return cost
