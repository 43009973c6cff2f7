"""Layer 1 of the program auditor: what one run of a hot path issued. The
port's counterpart of ``repro/analysis/jaxpr.py``.

The reference traces a jaxpr and proves its invariants before anything
runs. The port has no jaxpr: eager PyTorch and the kernels' ctypes launches
leave no program to walk. So ``audit(fn, *args)`` RUNS ``fn`` once, at the
shapes and on the device its tensors give (or ``on_device=``), keeps what
``fn`` returned as ``report.output``, and records what passes through
four seams of the port: a ``TorchDispatchMode`` that sees every aten op
with its outputs' sizes and dtypes; ``kernels.ops.LAUNCHES`` (hand-kernel
launches, which only the card makes); ``kernels.ref.CALLS`` (the plain
versions, which stand in for the kernels on the CPU); and
``distributed.mesh.tally()`` (collectives and their payload bytes). The
reference's claims become measured claims at one shape: where the
reference proves that every iteration of a ``while`` body issues one psum,
the port shows that every iteration of the run it audited did, and a
path the run did not take is not covered.

* **collectives** — ``psum`` (all_reduce) and ``all_gather`` through the
  mesh's two wrappers, with their payload bytes per rank, split into
  per-iteration and outside counts. The reference splits by ``while``
  bodies; the port's loops are Python loops, so each inner loop runs in
  ``loop()`` and calls ``iteration()`` at the top of each pass (both cost
  one empty-list check when no audit is open). The report snapshots every
  counter at each tick: ``collectives_per_iteration`` is what every
  iteration issued, and two iterations that differ are a violation naming
  both, never an average. Whatever runs before the loop is entered or
  after it ends is ``outside`` (the prologue sync, the stats pass at the
  fixpoint).
* **memory** — ``largest_intermediate_bytes`` is the largest op output,
  ``peak_live_bytes`` the high-water mark of a liveness count keyed by
  storage (a ``weakref.finalize`` on each output; views count once), both
  over the storages the run allocated, so the inputs are not in them. On
  the card ``allocator_peak_bytes`` is ``torch.cuda.max_memory_allocated``
  above the entry baseline, the authority there (``check_memory`` uses
  it). **Kernel scope**: the reference never descends into a
  ``pallas_call``, whose tiles are not HBM residency. The port treats its
  five plain versions the same way: what they allocate while
  ``kernels.ref.DEPTH`` is raised (the fused mode's [rows, |L|] block on
  the CPU, which the kernel never builds) counts only where it escapes
  into an op outside the scope.
* **kernels** — ``kernel_launches`` per kernel (``ops.LAUNCHES`` deltas;
  the card) and ``plain_calls`` per plain version (``ref.CALLS`` deltas;
  the CPU). ``check_kernel`` reads the one that counts on the audited
  device. ``kernel_work`` lists each launch's (or stand-in's) work kind
  and shapes, which ``launch.hlocost.KERNEL_WORK`` prices.
* **precision** — inside kernel scope every accumulating op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``dot``, ``mv``, ``sum``, ``cumsum``)
  must output f32 or f64: ``_ACCUM_PRIMS``' rule, applied to the plain
  versions. The kernels themselves are held to it by ``launch.audit``'s
  f32-accumulation probe, since nothing inside a CUDA kernel dispatches.
* **host reads** — the aten ops that read device values to the host
  (``HOST_SYNC_PRIMS``: ``_local_scalar_dense`` for every ``.item()``,
  ``int()``, ``bool()`` of a tensor, ``nonzero``, ``masked_select``,
  ``unique*``, and any ``_to_copy`` / ``copy_`` from the card to the
  CPU). On the CPU that is the whole count, and ``.tolist()`` and
  ``.numpy()`` of a CPU tensor dispatch no op, so they are not in it;
  ``F.one_hot``'s range check, which reads two values on the CPU and none
  on the card, is kept apart as ``library_checks``. On the card the audit
  also counts the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
  (``sync_warnings``), every implicit synchronization, and restores the
  mode afterwards. ``check_host_sync(per_iteration=1)`` admits the one
  declared flag read a loop makes per iteration.
* **cost** — the flops of every aten op outside kernel scope (the
  formulas of ``torch.utils.flop_counter``'s ``flop_registry``) by the
  precision of its output, its input plus output bytes (views and bare
  allocations move none), the bytes of op outputs holding real storage
  (0 under ``FakeTensorMode``), and the run's collective totals.
  ``launch.hlocost`` prices ``kernel_work`` and adds it to these: one run
  gives both the audit and its cost terms.

Where the two differ: nothing here is static, so a count holds for the
shapes and data of the run; ``cond`` merging and ``scan`` multiplication
have no counterpart (a Python branch runs one way, a Python loop of known
length is counted as it runs). No hook stays active after ``audit``
returns: the modes, the sync debug mode, the tally and the observers are
all removed in ``finally``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
import weakref
from collections import Counter
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: collectives of the port's mesh (``distributed/mesh.py``), under the
#: reference's jaxpr names
COLLECTIVE_PRIMS = frozenset({"psum", "all_gather", "reduce_scatter",
                              "all_to_all"})

#: aten ops that read device values to the host
HOST_SYNC_PRIMS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive",
})

#: aten ops that ACCUMULATE; inside kernel scope their output dtype is the
#: accumulator's and must be f32 (or f64)
_ACCUM_PRIMS = frozenset({"mm", "addmm", "bmm", "baddbmm", "dot", "mv",
                          "addmv", "sum", "cumsum"})

#: torch functions whose CPU implementation reads values for a range check
#: that the CUDA implementation leaves to a device assert
_LIBRARY_CHECKS = frozenset({"one_hot"})

#: ops that move no data: views are skipped by ``is_view``; these are
#: bare allocation and the host read of a scalar
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided",
                         "_local_scalar_dense"})

_MESH_KEYS = {"psum": ("psum", "psum_bytes"),
              "all_gather": ("allgather", "allgather_bytes"),
              "reduce_scatter": ("reducescatter", "reducescatter_bytes"),
              "all_to_all": ("alltoall", "alltoall_bytes")}


class AuditError(AssertionError):
    """A measured program invariant does not hold."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _precision(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _storage_key(t: torch.Tensor) -> Optional[int]:
    if isinstance(t, FakeTensor):     # no storage to keep alive
        return None
    try:
        key = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):   # sparse, no storage
        return None
    return key or None


def _merge(dicts) -> dict:
    out: Counter = Counter()
    for d in dicts:
        out.update(d)
    return {k: v for k, v in out.items() if v}


@dataclasses.dataclass
class LoopReport:
    """One loop context: what each of its iterations issued (all equal, or
    ``mismatches`` say which differ)."""
    path: str
    iterations: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    host_callbacks: dict = dataclasses.field(default_factory=dict)
    sync_warnings: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    plain_calls: dict = dataclasses.field(default_factory=dict)
    # (what, message): what is "collectives", "kernels" or "host"
    mismatches: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProgramReport:
    """What one audited run issued. See the module docstring."""
    name: str
    device: str = "cpu"
    input_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0
    largest_intermediate_bytes: int = 0
    largest_intermediate_shape: str = ""
    allocator_peak_bytes: Optional[int] = None
    collectives_outside: dict = dataclasses.field(default_factory=dict)
    collective_bytes_outside: dict = dataclasses.field(default_factory=dict)
    loops: list = dataclasses.field(default_factory=list)
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    plain_calls: dict = dataclasses.field(default_factory=dict)
    kernel_work: list = dataclasses.field(default_factory=list)
    host_callbacks: dict = dataclasses.field(default_factory=dict)
    host_callbacks_in_loop: dict = dataclasses.field(default_factory=dict)
    sync_warnings: int = 0
    library_checks: int = 0
    primitive_counts: dict = dataclasses.field(default_factory=dict)
    # the op-level cost (module docstring): flops by precision, bytes
    op_flops: dict = dataclasses.field(default_factory=dict)
    op_bytes: int = 0
    allocated_bytes: int = 0
    collectives_total: dict = dataclasses.field(default_factory=dict)
    collective_bytes_total: dict = dataclasses.field(default_factory=dict)
    # (op, dtype) of accumulations inside kernel scope that are not f32
    precision_findings: list = dataclasses.field(default_factory=list)
    cost: Optional[dict] = None     # launch/audit.py --cost fills it in
    probe: Optional[dict] = None    # launch/audit.py's f32 probe
    #: what ``fn`` returned (not a field: ``to_dict`` leaves it out)
    output = None

    # -- derived views -------------------------------------------------------

    @property
    def collectives_per_iteration(self) -> dict:
        """What one iteration of the loops issued, merged over the loops:
        for the one-loop inner programs, the bill the analytic
        ``collectives_per_iteration`` functions predict."""
        return _merge(loop.collectives for loop in self.loops)

    @property
    def collective_bytes_per_iteration(self) -> dict:
        return _merge(loop.collective_bytes for loop in self.loops)

    @property
    def kernel_launches_per_iteration(self) -> dict:
        return _merge(loop.kernel_launches for loop in self.loops)

    @property
    def host_reads_per_iteration(self) -> int:
        return sum(self.host_callbacks_in_loop.values())

    def collective_totals(self, n_iter: int) -> dict:
        """Per-iteration counts x ``n_iter`` + the outside counts."""
        out = Counter({k: v * n_iter
                       for k, v in self.collectives_per_iteration.items()})
        out.update(self.collectives_outside)
        return dict(out)

    def collective_byte_totals(self, n_iter: int) -> dict:
        out = Counter({k: v * n_iter for k, v in
                       self.collective_bytes_per_iteration.items()})
        out.update(self.collective_bytes_outside)
        return dict(out)

    def _mismatches(self, what: str) -> list:
        return [f"{self.name}: {loop.path}: {msg}" for loop in self.loops
                for kind, msg in loop.mismatches if kind == what]

    # -- checks (each returns a list of violation strings) -------------------

    def check_collectives(self, expected_per_iteration: dict,
                          expected_outside: Optional[dict] = None) -> list:
        """Per-iteration counts must equal the analytic bill, and every
        iteration must have issued the same; with ``expected_outside``
        the outside counts are held to the same standard. The bills use
        the analytic vocabulary (``{"psum": n, "allgather": m}``;
        ``allgather`` means ``all_gather``, ``*_bytes`` keys are
        ignored)."""
        alias = {"allgather": "all_gather", "allreduce": "psum"}

        def compare(got: dict, expected: dict, where: str) -> list:
            out = []
            for key, want in expected.items():
                if key.endswith("_bytes"):
                    continue
                prim = alias.get(key, key)
                have = got.get(prim, 0)
                if have != want:
                    out.append(f"{self.name}: {prim} {where} is {have}, "
                               f"analytic bill says {want}")
            known = {alias.get(k, k) for k in expected
                     if not k.endswith("_bytes")}
            for prim, have in sorted(got.items()):
                if prim not in known and have:
                    out.append(f"{self.name}: unbilled collective {prim} "
                               f"x{have} {where} (analytic bill has no "
                               f"entry for it)")
            return out

        out = self._mismatches("collectives")
        out += compare(self.collectives_per_iteration,
                       expected_per_iteration, "per iteration")
        if expected_outside is not None:
            out += compare(dict(self.collectives_outside), expected_outside,
                           "outside the loop")
        return out

    def check_memory(self, budget_bytes: float, *,
                     slack: float = 3.0) -> list:
        """Peak bytes <= slack x ``budget_bytes``: the allocator's peak on
        the card, the liveness count elsewhere. Against the planner's
        price, ``slack`` absorbs the eager temporaries a fused device
        program would not hold, and with them room that a resident Gram
        block can fit in; ``launch.audit`` also holds the peak below the
        block itself (``slack=1``)."""
        peak = (self.allocator_peak_bytes
                if self.allocator_peak_bytes is not None
                else self.peak_live_bytes)
        if peak > slack * budget_bytes:
            what = ("allocator peak" if self.allocator_peak_bytes is not None
                    else "peak live bytes")
            return [f"{self.name}: {what} {peak:,} > {slack:g} x budget "
                    f"{budget_bytes:,.0f}"]
        return []

    def check_max_intermediate(self, limit_bytes: float) -> list:
        """No single intermediate may reach ``limit_bytes``: one
        materialized [rows, |L|] Gram block trips this."""
        if self.largest_intermediate_bytes >= limit_bytes:
            return [f"{self.name}: intermediate "
                    f"{self.largest_intermediate_shape} of "
                    f"{self.largest_intermediate_bytes:,} bytes >= limit "
                    f"{limit_bytes:,.0f}"]
        return []

    def check_kernel(self, expected: bool, kernel: Optional[str] = None
                     ) -> list:
        """``kernel`` (any kernel when None) ran iff ``expected``, and as
        often in every iteration. On the card that is its launches
        (``ops.LAUNCHES``); on the CPU the calls of its plain version
        (``ref.CALLS``), the only thing that runs there. The PR 5 dead-
        kernel bug is a fused mode that never reaches its kernel."""
        if self.device == "cuda":
            counts, key, what = self.kernel_launches, kernel, "launch"
        else:
            counts, what = self.plain_calls, "plain call"
            key = None if kernel is None else f"{kernel}_ref"
        n = sum(v for k, v in counts.items()
                if (k == key if key is not None
                    else k != "kernel_matrix_column"))
        name = kernel or "kernel"
        out = self._mismatches("kernels")
        if expected and n == 0:
            out.append(f"{self.name}: expected a {name} {what}, the run "
                       f"made none (dead-kernel bug)")
        if not expected and n > 0:
            out.append(f"{self.name}: unexpected {name} {what} x{n} (the "
                       f"mode promises none)")
        return out

    def check_precision(self) -> list:
        """Every accumulation inside kernel scope outputs f32 (or f64):
        tiles may be bf16, accumulators may not."""
        return [f"{self.name}: {op} inside a plain kernel version "
                f"accumulates in {dtype} x{n} (policy: tiles may be bf16, "
                f"accumulators must be f32)"
                for (op, dtype), n in sorted(
                    Counter(map(tuple, self.precision_findings)).items())]

    def check_host_sync(self, per_iteration: int = 0) -> list:
        """At most ``per_iteration`` host reads in every iteration of every
        loop (the one declared flag read: ``per_iteration=1``; the s-1
        local refinements of an s-step sync add none), and none at all in
        a loop-free program. On the card the sync debug mode's warnings
        are held to the same limits."""
        out = self._mismatches("host")
        if not self.loops:
            reads = sum(self.host_callbacks.values())
            for what, n in (("host read", reads),
                            ("synchronizing CUDA operation",
                             self.sync_warnings)):
                if n:
                    out.append(f"{self.name}: {what} x{n} in a loop-free "
                               f"program ({self.host_callbacks})")
            return out
        for loop in self.loops:
            reads = sum(loop.host_callbacks.values())
            for what, n in (("host reads", reads),
                            ("synchronizing CUDA operations",
                             loop.sync_warnings)):
                if n > per_iteration:
                    out.append(f"{self.name}: {loop.path}: {what} x{n} per "
                               f"iteration ({loop.host_callbacks}), "
                               f"{per_iteration} allowed (each serializes "
                               f"the launch queue)")
        return out

    def verify(self, *violation_lists) -> "ProgramReport":
        """Raise AuditError with every violation, or return self."""
        flat = [v for vs in violation_lists for v in vs]
        if flat:
            raise AuditError("program audit failed:\n  " + "\n  ".join(flat))
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collectives_per_iteration"] = self.collectives_per_iteration
        d["collective_bytes_per_iteration"] = \
            self.collective_bytes_per_iteration
        d["kernel_launches_per_iteration"] = \
            self.kernel_launches_per_iteration
        d["host_reads_per_iteration"] = self.host_reads_per_iteration
        return d


# ---------------------------------------------------------------------------
# the loop hooks


_OPEN: list = []                      # open audits, innermost last
_NULL = contextlib.nullcontext()


class _LoopScope:
    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        for run in _OPEN:
            run.enter_loop(self.path)
        return self

    def __exit__(self, *exc):
        for run in _OPEN:
            run.exit_loop()
        return False


def loop(path: str = "loop"):
    """Context around an inner loop; a shared null context when no audit
    is open."""
    if not _OPEN:
        return _NULL
    return _LoopScope(path)


def iteration() -> None:
    """Call at the top of each pass of a loop inside ``loop()``."""
    if _OPEN:
        for run in _OPEN:
            run.tick()


# ---------------------------------------------------------------------------
# the run


_COMPARED = {"coll": "collectives", "bytes": "collectives",
             "launch": "kernels", "plain": "kernels", "host": "host",
             "sync": "host"}


class _Run:
    """The counters of one open audit."""

    def __init__(self, report: ProgramReport, tally, ops, ref):
        from torch.utils.flop_counter import flop_registry

        self.r = report
        self.tally, self.ops, self.ref = tally, ops, ref
        self.flop_registry = flop_registry
        self.flops: Counter = Counter()
        self.launch0 = dict(ops.LAUNCHES)
        self.calls0 = dict(ref.CALLS)
        self.op_counts: Counter = Counter()
        self.host: Counter = Counter()
        self.caught: list = []          # warnings (the card's sync mode)
        self.fn = ""                    # the torch function in progress
        self.live: dict = {}            # storage key -> [bytes, {ids}]
        self.scoped: dict = {}          # storage key -> bytes, in scope
        self.cur = 0
        self.stack: list = []           # open loops: [report, last, deltas]
        self.in_loops: list = []        # iterations of the top-level loops

    # -- counters ------------------------------------------------------------

    def snapshot(self) -> dict:
        t = self.tally
        s = {}
        for prim, (count, nbytes) in _MESH_KEYS.items():
            s["coll", prim] = getattr(t, count)
            s["bytes", prim] = getattr(t, nbytes)
        for k, v in self.ops.LAUNCHES.items():
            s["launch", k] = v - self.launch0.get(k, 0)
        for k, v in self.ref.CALLS.items():
            s["plain", k] = v - self.calls0.get(k, 0)
        for k, v in self.host.items():
            s["host", k] = v
        s["sync", "warnings"] = self.sync_warnings()
        return s

    def sync_warnings(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self.caught)

    @staticmethod
    def delta(now: dict, then: dict) -> dict:
        return {k: v - then.get(k, 0) for k, v in now.items()
                if v - then.get(k, 0)}

    # -- loops ---------------------------------------------------------------

    def enter_loop(self, path: str) -> None:
        outer = "/".join(f[0].path for f in self.stack)
        loop = LoopReport(path=f"{outer}/{path}" if outer else path)
        self.r.loops.append(loop)
        self.stack.append([loop, None, []])

    def tick(self) -> None:
        if not self.stack:
            return
        frame = self.stack[-1]
        now = self.snapshot()
        if frame[1] is not None:
            frame[2].append(self.delta(now, frame[1]))
        frame[1] = now

    def exit_loop(self) -> None:
        loop, last, deltas = self.stack.pop()
        if last is not None:
            deltas.append(self.delta(self.snapshot(), last))
        loop.iterations = len(deltas)
        if deltas:
            first = deltas[0]
            for kind, field in (("coll", loop.collectives),
                                ("bytes", loop.collective_bytes),
                                ("launch", loop.kernel_launches),
                                ("plain", loop.plain_calls),
                                ("host", loop.host_callbacks)):
                field.update({k[1]: v for k, v in first.items()
                              if k[0] == kind})
            loop.sync_warnings = first.get(("sync", "warnings"), 0)
            for i, d in enumerate(deltas[1:], start=1):
                for what in sorted(set(_COMPARED.values())):
                    keys = {k for k in set(first) | set(d)
                            if _COMPARED.get(k[0]) == what}
                    a = {k[1]: first.get(k, 0) for k in sorted(keys)}
                    b = {k[1]: d.get(k, 0) for k in sorted(keys)}
                    if a != b:
                        loop.mismatches.append(
                            (what, f"iteration {i} issued {b}, iteration "
                                   f"0 issued {a}"))
        if not self.stack:       # a top-level loop: its sum is not outside
            self.in_loops += deltas

    # -- ops -----------------------------------------------------------------

    def on_op(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        self.op_counts[name] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in HOST_SYNC_PRIMS or self._to_host(name, ins, outs):
            if self.fn in _LIBRARY_CHECKS:
                self.r.library_checks += 1
            else:
                self.host[name] += 1
        self.r.allocated_bytes += sum(
            _nbytes(t) for t in outs
            if not func.is_view and not isinstance(t, FakeTensor))
        in_keys = {_storage_key(t) for t in ins}
        if self.ref.DEPTH > 0:
            if name in _ACCUM_PRIMS:
                for t in outs:
                    if (t.is_floating_point()
                            and t.dtype not in (torch.float32,
                                                torch.float64)):
                        self.r.precision_findings.append(
                            [name, str(t.dtype).replace("torch.", "")])
            for t in outs:
                key = _storage_key(t)
                if key is not None and key not in in_keys \
                        and key not in self.live:
                    self.scoped[key] = t.untyped_storage().nbytes()
                    weakref.finalize(t, self.scoped.pop, key, None)
            return
        packet = func.overloadpacket
        if packet in self.flop_registry and outs:
            self.flops[_precision(outs[0])] += self.flop_registry[packet](
                *args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.r.op_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in ins:   # a plain version's output, used outside its scope
            key = _storage_key(t)
            if key in self.scoped:
                del self.scoped[key]
                self._hold(t, key)
        for t in outs:
            key = _storage_key(t)
            if key is None:
                continue
            if key in in_keys:          # a view or an in-place result
                if key in self.live:
                    self._hold(t, key)
                continue
            self._hold(t, key)

    def _to_host(self, name, ins, outs) -> bool:
        if name == "_to_copy":
            return bool(ins and outs and ins[0].is_cuda
                        and not outs[0].is_cuda)
        if name == "copy_":
            return len(ins) >= 2 and not ins[0].is_cuda and ins[1].is_cuda
        return False

    def _hold(self, t: torch.Tensor, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            nbytes = t.untyped_storage().nbytes()
            entry = self.live[key] = [nbytes, set()]
            self.cur += nbytes
            self.r.peak_live_bytes = max(self.r.peak_live_bytes, self.cur)
            if nbytes > self.r.largest_intermediate_bytes:
                self.r.largest_intermediate_bytes = nbytes
                self.r.largest_intermediate_shape = (
                    f"{str(t.dtype).replace('torch.', '')}"
                    f"{list(t.shape)}")
        if id(t) not in entry[1]:
            entry[1].add(id(t))
            weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, ident: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1].discard(ident)
        if not entry[1]:
            del self.live[key]
            self.cur -= entry[0]

    def on_work(self, work: str, shapes: dict) -> None:
        self.r.kernel_work.append({"work": work, **shapes})

    # -- the report ----------------------------------------------------------

    def finish(self) -> None:
        r = self.r
        total = self.snapshot()
        outside = dict(total)
        for d in self.in_loops:
            for k, v in d.items():
                outside[k] = outside.get(k, 0) - v
        r.collectives_outside = {k[1]: v for k, v in outside.items()
                                 if k[0] == "coll" and v}
        r.collective_bytes_outside = {k[1]: v for k, v in outside.items()
                                      if k[0] == "bytes" and v}
        r.kernel_launches = {k[1]: v for k, v in total.items()
                             if k[0] == "launch" and v}
        r.plain_calls = {k[1]: v for k, v in total.items()
                         if k[0] == "plain" and v}
        r.host_callbacks = dict(self.host)
        r.host_callbacks_in_loop = _merge(loop.host_callbacks
                                          for loop in r.loops)
        r.sync_warnings = total["sync", "warnings"]
        r.primitive_counts = dict(self.op_counts)
        r.op_flops = {k: float(v) for k, v in self.flops.items()}
        r.collectives_total = {k[1]: v for k, v in total.items()
                               if k[0] == "coll" and v}
        r.collective_bytes_total = {k[1]: v for k, v in total.items()
                                    if k[0] == "bytes" and v}


class _DispatchSpy(TorchDispatchMode):
    def __init__(self, run: _Run):
        super().__init__()
        self.run = run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.run.on_op(func, args, kwargs, out)
        return out


class _FunctionSpy(TorchFunctionMode):
    """Names the torch function in progress (for ``_LIBRARY_CHECKS``); the
    mode is off while the function runs, so this is the outermost call."""

    def __init__(self, run: _Run):
        super().__init__()
        self.run = run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.run.fn = getattr(func, "__name__", "")
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.run.fn = ""


def _warm_cublas(device) -> None:
    """cuBLAS takes its workspace (32 MiB on Hopper) from the caching
    allocator at a stream's first matmul: the process's, not the audited
    program's, so it is made to exist before the allocator's baseline."""
    a = torch.ones(16, 16, device=device)
    torch.addmm(a, a, a)
    torch.mm(a.bfloat16(), a.bfloat16())


def audit(fn, *args, name: Optional[str] = None, on_device=None,
          **kwargs) -> ProgramReport:
    """Run ``fn(*args, **kwargs)`` once and return its ``ProgramReport``,
    with what ``fn`` returned as ``report.output``. The device is
    ``on_device``, or when that is None the card if any tensor argument
    is on it, else the CPU; a CPU audit whose run launched a kernel (a
    closure over card tensors) raises, since its counters would read the
    wrong seam. Nothing stays hooked after the call returns or raises."""
    from repro_torch.distributed import mesh
    from repro_torch.kernels import ops, ref

    given = _tensors((args, kwargs))
    cuda = (torch.device(on_device).type == "cuda" if on_device is not None
            else any(t.is_cuda for t in given))
    report = ProgramReport(name=name or getattr(fn, "__name__", "program"),
                           device="cuda" if cuda else "cpu")
    report.input_bytes = sum(_nbytes(t) for t in given)
    with contextlib.ExitStack() as stack:
        tally = stack.enter_context(mesh.tally())
        run = _Run(report, tally, ops, ref)
        _OPEN.append(run)
        stack.callback(_OPEN.remove, run)
        ops.WORK_OBSERVERS.append(run.on_work)
        stack.callback(ops.WORK_OBSERVERS.remove, run.on_work)
        if cuda:
            _warm_cublas(torch.device(on_device) if on_device is not None
                         else next(t.device for t in given if t.is_cuda))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run.caught = stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            previous = torch.cuda.get_sync_debug_mode()
            stack.callback(torch.cuda.set_sync_debug_mode, previous)
            torch.cuda.set_sync_debug_mode("warn")
        with _FunctionSpy(run), _DispatchSpy(run):
            out = fn(*args, **kwargs)
        run.finish()
        if cuda:     # the mode off first: a synchronize would warn
            torch.cuda.set_sync_debug_mode(previous)
            torch.cuda.synchronize()
            report.allocator_peak_bytes = \
                torch.cuda.max_memory_allocated() - base
    for w in run.caught:       # pass on what the sync mode did not raise
        if "synchroniz" not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    if not cuda and report.kernel_launches:
        raise AuditError(
            f"{report.name}: audited as a CPU program but launched "
            f"{report.kernel_launches}: pass its card tensors as arguments "
            f"or on_device='cuda'")
    report.output_bytes = sum(_nbytes(t) for t in _tensors(out))
    report.output = out
    return report


def collective_bill(fn, *args, name: Optional[str] = None,
                    **kwargs) -> dict:
    """The measured communication bill of one run:
    ``{"per_iteration": {prim: count}, "outside": {prim: count},
    "per_iteration_bytes": {prim: bytes}, "outside_bytes": {prim:
    bytes}}``; the flight recorder's totals are ``per_iteration x n_iter
    + outside``."""
    r = audit(fn, *args, name=name, **kwargs)
    return {
        "per_iteration": r.collectives_per_iteration,
        "outside": dict(r.collectives_outside),
        "per_iteration_bytes": r.collective_bytes_per_iteration,
        "outside_bytes": dict(r.collective_bytes_outside),
    }
