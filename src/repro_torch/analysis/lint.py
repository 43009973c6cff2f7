"""Layer 2 of the program auditor: the port's AST lint rules, the
counterpart of ``repro/analysis/lint.py`` over ``src/repro_torch``.

The rule IDs are the reference's, with the port's meaning:

* **RK001 — a global-RNG draw.** A sampling call (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, their ``_like`` forms,
  ``multinomial``, ``bernoulli``, ``normal``, ``poisson``, or a Tensor's
  ``uniform_``, ``normal_``, ``exponential_``, ``random_``, ``bernoulli_``,
  ``geometric_``, ``cauchy_``, ``log_normal_``) without ``generator=``.
  Every draw of the port comes from a ``torch.Generator`` keyed by (seed,
  batch), the counterpart of the reference's fold_in discipline; a draw
  from the global generator depends on what ran before it and breaks the
  bit-identical resume that rests on those keys. (Methods of the
  non-underscore names are left out: a numpy ``Generator`` has them too.)
* **RK002 — a host read under CUDA-graph capture.** ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()`` or ``float()`` / ``int()`` /
  ``bool()`` of a non-literal inside a ``with torch.cuda.graph(...)``
  block, or in the body of a function called there (one level down,
  resolved by name over the linted files). Under capture such a read
  raises at the worst moment, or a graph replays a value read once. A
  subscript by a string literal (``float(statics["gamma"])``) is no tensor
  element and is not flagged.
* **RK003 — a dead kernel.** An ``rt_*`` entry of ``kernels/build.py``'s
  ``SIGNATURES`` that no module but ``build.py`` names (no wrapper can
  reach it), an entry with no ``extern "C"`` definition in
  ``kernels/csrc/*.cu``, or such a definition with no entry (the library
  exports it, nothing binds it). The PR 5 fused-mode bug, a kernel written
  and never invoked, as a lint.
* **RK004** has no counterpart: the port has no ``jit`` static arguments.
  ``main`` says so once.

Findings can be waived through a checked-in JSON file (``waivers.json``,
the reference's format): ``[{"rule": "RK003", "path":
"src/repro_torch/...", "symbol": "...", "reason": "..."}]``; every waiver
needs a reason, and unused waivers are reported so the file cannot rot.
Run as ``python -m repro_torch.analysis [paths] [--waivers FILE]``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable, Optional

#: torch functions that draw from a generator
_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "bernoulli", "normal", "poisson",
})
#: Tensor methods that draw in place
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "exponential_", "random_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
})
_METHOD_READS = frozenset({"item", "tolist", "cpu", "numpy"})
_EXTERN_C = re.compile(r'extern\s+"C"\s+[\w\s*]*?\b(rt_\w+)\s*\(')

RK004_NOTE = ("RK004 (non-hashable jit static argument) has no counterpart "
              "in the port: it has no jit static arguments")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class Waiver:
    rule: str
    path: str
    symbol: str = ""
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule:
            return False
        if not f.path.endswith(self.path):
            return False
        return (not self.symbol) or self.symbol == f.symbol


def load_waivers(path: str) -> list:
    with open(path) as fh:
        raw = json.load(fh)
    out = []
    for entry in raw:
        if not entry.get("reason"):
            raise ValueError(
                f"waiver {entry} has no reason — every waiver must say why")
        out.append(Waiver(rule=entry["rule"], path=entry["path"],
                          symbol=entry.get("symbol", ""),
                          reason=entry["reason"]))
    return out


# ---------------------------------------------------------------------------
# helpers over the AST


def _dotted(node) -> str:
    """'torch.cuda.graph' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _enclosing(tree: ast.AST) -> dict:
    """node -> name of the innermost function holding it ('' at module
    level)."""
    out: dict = {}

    def visit(node, fn: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            out[child] = name
            visit(child, name)

    visit(tree, "")
    return out


# ---------------------------------------------------------------------------
# RK001 — draws from the global generator


def _check_global_draws(tree: ast.AST, path: str) -> Iterable[Finding]:
    where = _enclosing(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _has_kw(node, "generator"):
            continue
        head = _dotted(node.func)
        leaf = head.rsplit(".", 1)[-1] if head else getattr(
            node.func, "attr", "")
        if head.startswith("torch.") and leaf in _SAMPLERS:
            what = head
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _INPLACE_SAMPLERS:
            what = f".{node.func.attr}"
        else:
            continue
        yield Finding(
            "RK001", path, node.lineno, where.get(node, ""),
            f"`{what}(...)` draws from the global generator — pass "
            f"generator= (a torch.Generator keyed by seed and batch)")


# ---------------------------------------------------------------------------
# RK002 — host reads under CUDA-graph capture


def _is_capture(item: ast.withitem) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and \
        _dotted(expr.func).endswith("cuda.graph")


def _string_subscript(node) -> bool:
    return (isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str))


def _host_reads(body: list) -> Iterable[tuple]:
    """(line, description) of each host read in ``body``."""
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            head = _dotted(node.func)
            if head in ("float", "int", "bool") and node.args:
                arg = node.args[0]
                if not isinstance(arg, ast.Constant) \
                        and not _string_subscript(arg):
                    yield node.lineno, f"`{head}(...)`"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _METHOD_READS and not node.args:
                yield node.lineno, f"`.{node.func.attr}()`"


def _called_names(body: list) -> set:
    out = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    out.add(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    out.add(node.func.attr)
    return out


def _check_capture_reads(files: dict) -> Iterable[Finding]:
    defs: dict = {}
    for path, tree in files.items():
        for fn in _functions(tree):
            defs.setdefault(fn.name, []).append((path, fn))
    for path, tree in files.items():
        where = _enclosing(tree)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)) \
                    or not any(_is_capture(i) for i in node.items):
                continue
            owner = where.get(node, "")
            for line, what in _host_reads(node.body):
                yield Finding(
                    "RK002", path, line, owner,
                    f"{what} inside a torch.cuda.graph capture block — a "
                    f"host read raises under capture, or the graph replays "
                    f"a value read once")
            for callee in sorted(_called_names(node.body)):
                for cpath, fn in defs.get(callee, ()):
                    for line, what in _host_reads(fn.body):
                        yield Finding(
                            "RK002", cpath, line, fn.name,
                            f"{what} in `{fn.name}`, which the "
                            f"torch.cuda.graph capture at {path}:"
                            f"{node.lineno} calls — a host read raises "
                            f"under capture")


# ---------------------------------------------------------------------------
# RK003 — dead kernels


def _signatures(tree: ast.AST) -> dict:
    """{rt_* entry: line} of the module-level ``SIGNATURES`` dict."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                   for t in targets) and isinstance(node.value, ast.Dict):
                return {k.value: k.lineno for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
    return {}


def _names_of(tree: ast.AST) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _check_dead_kernels(files: dict) -> Iterable[Finding]:
    suffix = os.path.join("kernels", "build.py")
    for bpath, btree in files.items():
        if not bpath.endswith(suffix):
            continue
        entries = _signatures(btree)
        named = set()
        for p, t in files.items():
            if p != bpath:
                named |= _names_of(t)
        csrc = os.path.join(os.path.dirname(bpath), "csrc")
        defined: dict = {}
        if os.path.isdir(csrc):
            for fname in sorted(os.listdir(csrc)):
                if fname.endswith(".cu"):
                    cu = os.path.join(csrc, fname)
                    with open(cu, encoding="utf-8") as fh:
                        text = fh.read()
                    for m in _EXTERN_C.finditer(text):
                        defined[m.group(1)] = (
                            cu, text.count("\n", 0, m.start()) + 1)
        for entry, line in sorted(entries.items()):
            if entry not in named:
                yield Finding(
                    "RK003", bpath, line, entry,
                    f"kernel entry `{entry}` is named by no module but "
                    f"build.py — no wrapper can reach it (dead kernel)")
            if entry not in defined:
                yield Finding(
                    "RK003", bpath, line, entry,
                    f"kernel entry `{entry}` has no extern \"C\" definition "
                    f"in {csrc}")
        for entry, (cu, line) in sorted(defined.items()):
            if entry not in entries:
                yield Finding(
                    "RK003", cu, line, entry,
                    f"extern \"C\" `{entry}` has no SIGNATURES entry in "
                    f"{bpath} — the library exports it, nothing binds it")


# ---------------------------------------------------------------------------
# driver


def lint_paths(paths: Iterable[str]) -> list:
    """Lint every .py file under ``paths`` (files or directories)."""
    files: dict = {}
    for root in paths:
        if os.path.isfile(root):
            targets = [root]
        else:
            targets = sorted(
                os.path.join(dp, f)
                for dp, _dn, fns in os.walk(root) for f in fns
                if f.endswith(".py"))
        for path in targets:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            try:
                files[path] = ast.parse(src, filename=path)
            except SyntaxError as e:   # pragma: no cover
                raise SystemExit(f"{path}: cannot parse: {e}")
    findings: list = []
    for path, tree in files.items():
        findings.extend(_check_global_draws(tree, path))
    findings.extend(_check_capture_reads(files))
    findings.extend(_check_dead_kernels(files))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def apply_waivers(findings: list, waivers: list):
    """-> (active findings, waived findings, unused waivers)."""
    active, waived = [], []
    used = set()
    for f in findings:
        hit = None
        for i, w in enumerate(waivers):
            if w.matches(f):
                hit = i
                break
        if hit is None:
            active.append(f)
        else:
            used.add(hit)
            waived.append(f)
    unused = [w for i, w in enumerate(waivers) if i not in used]
    return active, waived, unused


def main(argv: Optional[list] = None) -> int:
    import argparse
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's AST lint (RK001-RK003); exit 1 on any "
                    "unwaived finding")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: src/repro_torch)")
    parser.add_argument("--waivers",
                        default=os.path.join(here, "waivers.json"),
                        help="JSON waiver file (default: the checked-in "
                             "repro_torch/analysis/waivers.json)")
    parser.add_argument("--no-waivers", action="store_true",
                        help="ignore the waiver file (show everything)")
    args = parser.parse_args(argv)

    paths = args.paths or [os.path.dirname(here)]     # .../src/repro_torch
    waivers = [] if args.no_waivers else load_waivers(args.waivers)
    findings = lint_paths(paths)
    active, waived, unused = apply_waivers(findings, waivers)

    print(RK004_NOTE)
    for f in active:
        print(f.render())
    if waived:
        print(f"[{len(waived)} finding(s) waived via "
              f"{os.path.basename(args.waivers)}]")
    for w in unused:
        print(f"warning: unused waiver {w.rule} {w.path} "
              f"{w.symbol or ''} ({w.reason})".rstrip())
    if active:
        print(f"{len(active)} unwaived finding(s)")
        return 1
    print(f"lint clean ({len(findings)} finding(s), all waived)"
          if findings else "lint clean")
    return 0
