"""Program auditing of the port: measured runs + AST lint.

Layer 1 (``repro_torch.analysis.dispatch``, the counterpart of the
reference's ``analysis/jaxpr``) runs a hot path once and reports its
collectives per iteration and outside the loop, memory residency, kernel
launches (plain versions on the CPU), accumulation precision and host
reads. Layer 2 (``repro_torch.analysis.lint``, ``python -m
repro_torch.analysis``) lints ``src/repro_torch`` for the port's
key-discipline, capture-hygiene and dead-kernel rules (RK001-RK003).
"""
from .dispatch import (  # noqa: F401
    COLLECTIVE_PRIMS,
    HOST_SYNC_PRIMS,
    AuditError,
    LoopReport,
    ProgramReport,
    audit,
    collective_bill,
)
from .lint import (  # noqa: F401
    Finding,
    Waiver,
    apply_waivers,
    lint_paths,
    load_waivers,
)
