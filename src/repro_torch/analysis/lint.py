"""Repo-specific AST lint rules (stdlib ``ast`` only — no third-party dep).

Counterpart of ``repro.analysis.lint``, over ``src/repro_torch``,
``chip_smoke.py`` and ``scripts/``. Rules:

* ``timing-outside-harness`` — bare ``time.time()`` / ``time.perf_counter()``
  (or ``monotonic`` / ``process_time``) outside ``metrics/timing.py``.
  Kernel timing goes through the harness (device sync, warmup, CUDA
  events); host wall clocks through its one helper,
  :func:`repro_torch.metrics.timing.wall_clock`, so every clock the
  repo reads is in one place.
* ``hardcoded-block`` — a literal block-shape tuple passed as ``block=`` /
  ``block_shape=`` outside the autotune machinery (``tuning/``,
  ``registry.py``), bypassing the registry's autotune cache.
* ``unguarded-uint64`` — ``torch.uint64`` outside the bus readers of
  ``core/mitchell.py`` (``to_lanes``, ``from_lanes``, ``lanes_to_float``).
  PyTorch's ``uint64`` lacks most integer operators, and the width-32 lane
  lives on the ``int64`` carrier; only the bus readers may cross between
  the two (the hazard class widthcheck's signedness rule proves against).
* ``swallowed-exception`` — a bare ``except:`` / ``except Exception`` /
  ``except BaseException`` in the serving stack (``launch/``) or the
  harness scripts (``chip_smoke.py``, ``scripts/``). Catch the specific
  exception (``GuardTripped``, ``subprocess.TimeoutExpired``, ...) or
  annotate the site with why swallowing is the contract.

Left out on purpose: the reference's ``interpret-literal`` (a literal
``interpret=True`` selects the Pallas interpreter, which the port has no
counterpart of: a CUDA kernel has no interpret mode).

Suppression: a ``# simdive-lint: allow(<rule>): <reason>`` comment on the
offending line (or the line above) suppresses that rule there. The reason
is mandatory — grandfathered sites must say why they're exempt.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .domain import Finding

__all__ = ["run_lint", "lint_file", "LINT_RULES"]

LINT_RULES = {
    "timing-outside-harness": "timing goes through metrics.timing",
    "hardcoded-block": "block shapes come from the autotune cache",
    "unguarded-uint64": "torch.uint64 only in core/mitchell.py's bus readers",
    "swallowed-exception": "serving/harness code must not blanket-catch",
}

_ALLOW_RE = re.compile(r"#\s*simdive-lint:\s*allow\(([a-z0-9-]+)\)\s*:\s*\S")

#: paths scanned relative to the repo root (directories and files)
_SCAN = ("src/repro_torch", "chip_smoke.py", "scripts")
_SKIP_PARTS = ("tests", "__pycache__")

_TIME_FUNCS = {"time", "perf_counter", "monotonic", "process_time"}
#: the functions of core/mitchell.py that may name torch.uint64
_BUS_READERS = frozenset({"to_lanes", "from_lanes", "lanes_to_float"})


def _allows(source_lines, lineno: int) -> set:
    """Rules allowed at ``lineno`` (1-based): same line or the line above."""
    out = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            for m in _ALLOW_RE.finditer(source_lines[ln - 1]):
                out.add(m.group(1))
    return out


def _is_time_call(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _TIME_FUNCS and \
            isinstance(f.value, ast.Name) and f.value.id == "time":
        return f"time.{f.attr}"
    return None


def _literal_tuple(node) -> bool:
    return isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
        isinstance(e, ast.Constant) and isinstance(e.value, int)
        for e in node.elts)


_BROAD_EXC = ("Exception", "BaseException")


def _broad_handler(node: ast.ExceptHandler) -> str | None:
    """'bare'/'Exception'/'BaseException' if the handler is a blanket
    catch, else None. Tuple clauses count if any member is broad."""
    t = node.type
    if t is None:
        return "bare except:"
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD_EXC:
            return f"except {n.id}"
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, lines, is_timing_harness: bool,
                 is_tuning: bool, is_resilient_layer: bool = False,
                 is_bus_module: bool = False):
        self.rel = rel
        self.lines = lines
        self.is_timing_harness = is_timing_harness
        self.is_tuning = is_tuning
        self.is_resilient_layer = is_resilient_layer
        self.is_bus_module = is_bus_module
        self.findings: list = []
        self._func: list = []             # enclosing function names

    def _flag(self, rule: str, lineno: int, msg: str):
        if rule in _allows(self.lines, lineno):
            return
        self.findings.append(Finding(
            rule, self.rel, msg, source=f"{self.rel}:{lineno}"))

    def _visit_func(self, node):
        self._func.append(node.name)
        self.generic_visit(node)
        self._func.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr == "uint64" and isinstance(node.value, ast.Name) and \
                node.value.id == "torch" and not (
                    self.is_bus_module and self._func
                    and self._func[0] in _BUS_READERS):
            self._flag("unguarded-uint64", node.lineno,
                       "torch.uint64 outside core/mitchell.py's bus readers "
                       "(to_lanes / from_lanes / lanes_to_float) — width-32 "
                       "lanes live on the int64 carrier")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        tf = _is_time_call(node)
        if tf and not self.is_timing_harness:
            self._flag("timing-outside-harness", node.lineno,
                       f"bare {tf}() — route timing through "
                       f"repro_torch.metrics.timing")
        for kw in node.keywords:
            if kw.arg in ("block", "block_shape") and \
                    _literal_tuple(kw.value) and not self.is_tuning:
                self._flag("hardcoded-block", node.lineno,
                           f"literal {kw.arg}= tuple bypasses the autotune "
                           f"cache — pass block=None or go through get_op")
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self.is_resilient_layer:
            broad = _broad_handler(node)
            if broad:
                self._flag(
                    "swallowed-exception", node.lineno,
                    f"{broad} in the serving/harness layer — catch the "
                    "specific exception (GuardTripped, TrajectoryError, "
                    "...) so faults fail loudly instead of being served")
        self.generic_visit(node)


def lint_file(path: Path, root: Path) -> list:
    path, root = Path(path), Path(root)
    rel = path.relative_to(root).as_posix()
    try:
        src = path.read_text()
        tree = ast.parse(src)
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return [Finding("lint-parse", rel, f"unparseable: {e}",
                        source=rel)]
    v = _Visitor(
        rel, src.splitlines(),
        is_timing_harness=rel.endswith("metrics/timing.py"),
        is_tuning=("/tuning/" in rel or rel.endswith("registry.py")),
        is_resilient_layer=("/launch/" in rel or rel.startswith("scripts/")
                            or rel == "chip_smoke.py"),
        is_bus_module=rel.endswith("core/mitchell.py"),
    )
    v.visit(tree)
    return v.findings


def run_lint(root=None) -> list:
    """Lint the port; returns sorted Findings (empty == clean)."""
    if root is None:
        root = Path(__file__).resolve().parents[3]
    root = Path(root)
    findings = []
    for entry in _SCAN:
        base = root / entry
        if base.is_file():
            paths = [base]
        elif base.is_dir():
            paths = sorted(base.rglob("*.py"))
        else:
            continue
        for path in paths:
            if any(p in _SKIP_PARTS for p in path.relative_to(root).parts):
                continue
            findings.extend(lint_file(path, root))
    findings.sort(key=Finding.sort_key)
    return findings
