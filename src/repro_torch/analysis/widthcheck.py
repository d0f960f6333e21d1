"""Bit-width / overflow verifier for the port's integer datapath, over aten
graphs.

Counterpart of ``repro.analysis.widthcheck``. Every registered op
(``registry.all_ops()``) declares trace cases: the plain PyTorch stages its
CUDA kernel mirrors, with abstract operands of the declared lane width.
Each case is traced with ``make_fx`` (fake tensors, functionalized, the
annotations of :mod:`repro_torch.core.annotations` armed) into an
aten-level graph, and the interval x possible-bits domain of
:mod:`repro_torch.analysis.domain` is propagated through it. Per (op,
width, coeff_bits, frac_out, shape) config it proves:

* **overflow** — no integer add/sub/mul/sum result can leave the case's
  *bus* (the word the kernel computes on: uint32 / int32 lanes at widths
  8 and 16, uint64 / int64 at width 32, the int32 or int64 matmul
  accumulator), even where the ``int64`` carrier would hold it,
* **shift-range** — every shift amount is statically in
  ``[0, bus bits - 1]``,
* **lane-overlap** — every integer OR is a provably disjoint bit-field
  union (the packed-lane / log-packing invariant),
* **signedness** — no conversion crosses a signedness boundary with a
  possibly-out-of-range value; and, the port's own hazard, no comparison,
  right shift, division or float conversion reads a 64-bit bus value that
  may reach 2^63 off the signed carrier (the carrier contract of
  :mod:`repro_torch.core.mitchell`), nor does ``frexp`` read a float form
  of an integer that is not exact for its interval,
* **gather-bounds** — 1-D table lookups (correction tables) are in range,
* **lane-domain** — ``require_range`` contract preconditions hold.

**Types.** An abstract value's dtype is what it means on the bus, not the
carrier's ``int64``: case operands declare it, constants are *weak* (they
take their partner's type), the carrier helpers (``wrap_bus``,
``wrap_int32``, ``wrap_signed``, ``to_lanes``, ``lanes_to_float``) trace
as ``repro_torch::carrier_cast`` nodes and are checked as the reference's
``astype`` is, and every other op types its result from its operands: a
possibly negative signed operand makes it signed, else an unsigned one
unsigned. An unsigned subtraction that may go negative defers its finding
(``pending``) until a matching ``where(a >= b, a - b, _)``, a clamp at 0 or
a cast to the signed work type settles it, as the reference's saturating
selects do.

``shift_left`` *value* overflow is deliberately not a rule, as in the
reference: the datapath's saturation selects discard exactly the lanes
that wrapped.

**Tracing.** Fake tensors, so a data-dependent branch cannot be baked in:
it raises, and the case reports the trace failure as a finding. The
correction tables are closed-over constants, read exactly. ``make_fx``
inlines every call, so there are no call primitives to recurse into; the
shape-only ops (views, expands, copies) pass pending evidence through as
the reference's call primitives do. Unknown aten ops widen to the top of
their dtype and are listed per case, never silently dropped.
"""
from __future__ import annotations

import dataclasses
import math
import operator
import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .domain import (AbsVal, CaseReport, Finding, TraceCase, bus_types,
                     from_concrete, join, np_dtype, top)

__all__ = ["check_case", "run_matrix", "render_text", "to_json",
           "MatrixResult", "verdict_for"]

_ROOT = Path(__file__).resolve().parents[3]
_TORCH_DIR = os.path.dirname(torch.__file__)
#: frames of these files are never a finding's source
_SKIP_FILES = (os.path.abspath(__file__),
               os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "core", "annotations.py"))
_I64 = np.dtype(np.int64)
_BOOL = np.dtype(np.bool_)


# ----------------------------------------------------------- source lines --
def _user_frame() -> str:
    """``file:line (fn)`` of the innermost frame outside torch and the
    analyzer: the port's (or a test's) line that emitted the node."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.startswith("<")
                or os.path.abspath(fn) in _SKIP_FILES
                or "contextlib" in fn or "functools" in fn):
            p = Path(fn).resolve()
            try:
                rel = p.relative_to(_ROOT).as_posix()
            except ValueError:
                rel = p.name
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return ""


@contextmanager
def _record_sources():
    """Tag every node ``make_fx`` creates with the user line behind it
    (``make_fx(record_stack_traces=True)`` keeps only module forwards)."""
    orig = torch.fx.Graph.create_node

    def create_node(self, *args, **kwargs):
        node = orig(self, *args, **kwargs)
        node.meta["widthcheck_src"] = _user_frame()
        return node

    torch.fx.Graph.create_node = create_node
    try:
        yield
    finally:
        torch.fx.Graph.create_node = orig


def _src_of(node) -> str:
    return node.meta.get("widthcheck_src", "") if node is not None else ""


# ------------------------------------------------------------------ helpers --
def _iinfo(dt):
    dt = np.dtype(dt)
    if dt.kind == "b":
        return 0, 1
    ii = np.iinfo(dt)
    return int(ii.min), int(ii.max)


def _corners(a, b, op):
    vals = [op(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    vals = [v for v in vals if v == v]          # drop nan (inf - inf etc.)
    if not vals:
        return -math.inf, math.inf
    return min(vals), max(vals)


def _exact(dtype, v) -> AbsVal:
    """A constant: exact, and weak (it takes its partner's type)."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return AbsVal(dt, (), float(v), float(v), None, None, True)
    v = int(v)
    return AbsVal(dt, (), v, v, v if v >= 0 else None, None, True).norm()


def _refine(val: AbsVal, lo, hi, bits=None) -> AbsVal:
    """Intersect ``val`` with a declared range (contract refinement)."""
    if not val.is_int:
        return AbsVal(val.dtype, val.shape, float(lo), float(hi))
    nb = val.bits
    if bits is not None:
        nb = bits if nb is None else (nb & bits)
    dt = val.dtype
    if val.weak or _iinfo(dt)[1] < hi:
        dt = _I64 if hi < 2 ** 63 else np.dtype(np.uint64)
    return AbsVal(dt, val.shape, max(val.lo, int(lo)), min(val.hi, int(hi)),
                  nb).norm()


# monotone float unaries: aten name -> (fn, increasing)
_FLOAT_MONO = {
    "exp": (math.exp, True),
    "exp2": (lambda x: 2.0 ** x, True),
    "log": (lambda x: math.log(x) if x > 0 else -math.inf, True),
    "log2": (lambda x: math.log2(x) if x > 0 else -math.inf, True),
    "log1p": (lambda x: math.log1p(x) if x > -1 else -math.inf, True),
    "expm1": (math.expm1, True),
    "sqrt": (lambda x: math.sqrt(x) if x >= 0 else math.nan, True),
    "floor": (math.floor, True),
    "ceil": (math.ceil, True),
    "round": (round, True),
    "trunc": (math.trunc, True),
    "rsqrt": (lambda x: 1.0 / math.sqrt(x) if x > 0 else math.inf, False),
    "tanh": (math.tanh, True),
    "sigmoid": (lambda x: 1.0 / (1.0 + math.exp(-x)), True),
}

#: shape-only ops: the value passes as it is (pendings included), as the
#: reference's call primitives pass them
_IDENTITY = frozenset({
    "expand", "expand_copy", "expand_as", "view", "view_copy", "_unsafe_view",
    "reshape", "unsqueeze", "unsqueeze_copy", "squeeze", "squeeze_copy",
    "slice", "slice_copy", "select", "select_copy", "permute",
    "permute_copy", "t", "t_copy", "transpose", "transpose_copy", "clone",
    "alias", "alias_copy", "detach", "detach_copy", "lift_fresh_copy",
    "contiguous", "flatten", "repeat", "amax", "amin", "narrow",
    "narrow_copy", "unfold", "unfold_copy", "_reshape_alias",
    "_reshape_alias_copy", "as_strided", "as_strided_copy",
})

#: ops whose result is a constant of the output's shape
_CONST = frozenset({"zeros", "zeros_like", "ones", "ones_like", "full",
                    "full_like", "scalar_tensor", "empty", "empty_like",
                    "new_zeros", "new_ones", "new_full"})

_CMP = frozenset({"lt", "le", "gt", "ge", "eq", "ne"})
_JOINS = frozenset({"stack", "cat", "concat", "concatenate",
                    "slice_scatter", "select_scatter", "index_put",
                    "diagonal_scatter", "as_strided_scatter"})


class _Interp(torch.fx.Interpreter):
    """One abstract interpretation of one trace case's aten graph."""

    def __init__(self, gm, report: CaseReport, label: str, bus):
        super().__init__(gm, garbage_collect_values=False)
        self.report = report
        self.label = label
        self.U, self.S = bus_types(bus)
        self.scopes: list = []        # (frozenset(assumed rules), what)
        self._seen: set = set()       # finding dedupe
        self._unknown: set = set()
        self._node = None

    # ----------------------------------------------------------- findings --
    def flag(self, rule: str, msg: str, ins=()):
        for assumed, _ in self.scopes:
            if rule in assumed:
                return
        src = _src_of(self._node)
        key = (rule, src, self._opname())
        if key in self._seen:
            return
        self._seen.add(key)
        self.report.findings.append(
            Finding(rule, self.label, msg, eqn=self._eqn_str(ins),
                    source=src))

    def note_unknown(self, name: str):
        if name not in self._unknown:
            self._unknown.add(name)
            self.report.unknown_prims.append(name)

    def _opname(self) -> str:
        t = self._node.target if self._node is not None else None
        if isinstance(t, torch._ops.OpOverload):
            return str(t).removeprefix("aten.")
        return getattr(t, "__name__", str(t))

    def _eqn_str(self, ins) -> str:
        parts = ", ".join(
            f"{np.dtype(v.dtype).name}{list(v.shape)}{v.describe()}"
            for v in ins if isinstance(v, AbsVal))
        out = self._meta()
        tail = (f" -> {str(out.dtype).removeprefix('torch.')}"
                f"{list(out.shape)}") if isinstance(out, torch.Tensor) else ""
        return f"{self._opname()}({parts}){tail}"

    def _meta(self, node=None):
        node = self._node if node is None else node
        return node.meta.get("val") if node is not None else None

    def _out_shape(self):
        v = self._meta()
        return tuple(v.shape) if isinstance(v, torch.Tensor) else ()

    def _out_torch_dtype(self):
        v = self._meta()
        return v.dtype if isinstance(v, torch.Tensor) else torch.int64

    # ---------------------------------------- deferred unsigned underflow --
    # ``where(a >= b, a - b, _)`` is the datapath's barrel-shifter idiom:
    # the sub underflows on lanes the select then discards. The sub defers
    # its finding as AbsVal.pending; the select with the matching
    # comparison, a clamp at 0 or a cast to the signed work type clears
    # it, any other consumption reports it.
    def _flag_raw(self, rule, msg, eqn_str, src):
        for assumed, _ in self.scopes:
            if rule in assumed:
                return
        key = (rule, src, "sub")
        if key in self._seen:
            return
        self._seen.add(key)
        self.report.findings.append(
            Finding(rule, self.label, msg, eqn=eqn_str, source=src))

    def _settle(self, v):
        if not isinstance(v, AbsVal) or v.pending is None:
            return v
        _, rule, msg, eqn_str, src = v.pending
        self._flag_raw(rule, msg, eqn_str, src)
        return top(v.dtype, v.shape)

    def _unsigned_clear(self, v: AbsVal) -> AbsVal:
        """A pending difference proven non-negative: back to the lane."""
        return AbsVal(self.U, v.shape, max(int(v.lo), 0), v.hi).norm()

    def _resolve_key(self, a, depth=0):
        """Identity of a select/compare operand, looking through shape-only
        ops so broadcast constants and views match across nodes."""
        if not isinstance(a, torch.fx.Node):
            try:
                return ("lit", float(a))
            except (TypeError, ValueError):
                return ("lit", repr(a))
        name = _name(a.target) if a.op == "call_function" else ""
        if depth < 16 and a.args and isinstance(a.args[0], torch.fx.Node) \
                and (name in _IDENTITY or name == "_to_copy"):
            return self._resolve_key(a.args[0], depth + 1)
        if name in ("zeros_like", "zeros", "new_zeros"):
            return ("lit", 0.0)
        if name in ("full_like", "full", "scalar_tensor", "new_full") \
                and len(a.args) > 1:
            return self._resolve_key(a.args[1 if name != "scalar_tensor"
                                            else 0], depth + 1)
        return ("var", a.name)

    def _def_of(self, a, depth=0):
        """Defining node of ``a``, looking through shape-only wrappers."""
        if not isinstance(a, torch.fx.Node) or a.op != "call_function":
            return None
        if depth < 16 and _name(a.target) in _IDENTITY and a.args and \
                isinstance(a.args[0], torch.fx.Node):
            return self._def_of(a.args[0], depth + 1) or a
        return a

    def _select_clear(self, node, ins):
        """Clear pendings proven dead by this where's predicate."""
        pred = node.args[0]
        cmp = kx = ky = None
        d = self._def_of(pred)
        if d is not None and _name(d.target) in ("ge", "gt", "lt", "le"):
            cmp = _name(d.target)
            kx = self._resolve_key(d.args[0])
            ky = self._resolve_key(d.args[1])
        out = [ins[0]]
        # where(cond, x, y): x (position 1) is the pred-true branch
        for pos, v in ((1, ins[1]), (2, ins[2])):
            if not isinstance(v, AbsVal) or v.pending is None:
                out.append(v)
                continue
            ka, kb = v.pending[0]
            if cmp in ("ge", "gt"):          # true <=> x >= y / x > y
                ok = (pos == 1 and (ka, kb) == (kx, ky)) or \
                     (pos == 2 and (ka, kb) == (ky, kx))
            elif cmp in ("lt", "le"):        # true <=> x < y / x <= y
                ok = (pos == 1 and (ka, kb) == (ky, kx)) or \
                     (pos == 2 and (ka, kb) == (kx, ky))
            else:
                ok = False
            out.append(self._unsigned_clear(v) if ok else self._settle(v))
        return out

    # --------------------------------------------------------- evaluation --
    def run_node(self, n):
        self._node = n
        return super().run_node(n)

    def get_attr(self, target, args, kwargs):
        t = super().get_attr(target, args, kwargs)
        if not isinstance(t, torch.Tensor):
            return t
        v = from_concrete(t)
        if v.is_int and np_dtype(t.dtype) == _I64:
            # a table: signed coefficients are the signed work type, a
            # non-negative constant takes its partner's type
            if v.lo < 0:
                return dataclasses.replace(v, dtype=self.S).norm()
            return dataclasses.replace(v, weak=True)
        return dataclasses.replace(v, weak=True)

    def call_function(self, target, args, kwargs):
        if target is operator.getitem:
            return args[0][args[1]]
        name = _name(target)
        if name == "where":
            return self._where(args)
        if name == "clamp" or name in ("clamp_min", "clamp_max"):
            return self._clamp(name, args, kwargs)
        if name == "range_contract":
            return self._contract(args)
        if name == "carrier_cast":
            return self._cast_helper(args[0], args[1])
        if name in _IDENTITY:
            a = args[0]
            if not isinstance(a, AbsVal):
                return self._top()
            shape = self._out_shape()
            return dataclasses.replace(a.with_shape(shape)) if a.is_int \
                else AbsVal(a.dtype, shape, a.lo, a.hi, None, None, a.weak)
        # any other consumption of a deferred underflow reports it
        args = [self._settle(a) if isinstance(a, AbsVal) else
                ([self._settle(x) for x in a] if isinstance(a, list) else a)
                for a in args]
        ins = [a for a in args if isinstance(a, AbsVal)]
        if name in _CONST:
            return self._const(name, args, kwargs)
        if name == "arange":
            return self._arange(args, kwargs)
        if name in _CMP:
            return self._compare(name, args)
        if name in ("add", "sub", "rsub", "mul"):
            return self._arith(name, args, kwargs)
        if name in ("bitwise_and", "__and__", "bitwise_or", "__or__",
                    "bitwise_xor", "__xor__"):
            return self._bitwise(name.strip("_").replace("bitwise_", ""),
                                 args)
        if name in ("bitwise_not", "logical_not"):
            return self._not(args[0])
        if name in ("logical_and", "logical_or", "logical_xor"):
            return self._bool()
        if name in ("__lshift__", "bitwise_left_shift"):
            return self._shift("left", args)
        if name in ("__rshift__", "bitwise_right_shift"):
            return self._shift("right", args)
        if name in ("_to_copy", "to", "_to_dtype"):
            return self._convert(args[0], self._out_torch_dtype())
        if name == "copy":
            return self._convert(args[1], self._out_torch_dtype())
        if name in ("maximum", "minimum", "max", "min") and len(ins) == 2:
            return self._minmax(name, args)
        if name in ("max", "min") and len(args) == 1:
            return self._ident(args[0])
        if name in ("max", "min"):           # (values, indices) reductions
            n = int(np.prod(args[0].shape) // max(int(np.prod(
                self._out_shape() or (1,))), 1))
            return (self._ident(args[0]),
                    AbsVal(_I64, self._out_shape(), 0, max(n - 1, 0)).norm())
        if name in ("sum", "cumsum"):
            return self._reduce_sum(args)
        if name in ("mm", "bmm", "matmul", "dot"):
            return self._dot(args)
        if name in ("div", "floor_divide", "true_divide"):
            return self._div(args)
        if name in ("remainder", "fmod"):
            return self._rem(args)
        if name == "neg":
            a = args[0]
            if a.is_int:
                return self._mk(-a.hi, -a.lo, self._signed_of(a), ins=ins,
                                what="negation")
            return self._float(-a.hi, -a.lo)
        if name == "abs":
            a = args[0]
            lo = 0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
            if a.is_int:
                return self._mk(lo, max(abs(a.lo), abs(a.hi)),
                                self._signed_of(a), ins=ins, what="abs")
            return self._float(lo, max(abs(a.lo), abs(a.hi)))
        if name == "sign":
            a = args[0]
            return self._float(-1.0 if a.lo < 0 else 0.0,
                               1.0 if a.hi > 0 else 0.0) \
                if not a.is_int else self._mk(
                    -1 if a.lo < 0 else 0, 1 if a.hi > 0 else 0, a.dtype,
                    check=False)
        if name == "index":
            return self._gather(args)
        if name == "frexp":
            return self._frexp(args[0])
        if name == "ldexp":
            return self._ldexp(args[0], args[1])
        if name in _FLOAT_MONO:
            f, inc = _FLOAT_MONO[name]
            a = args[0]
            if a.is_int:
                return self._ident(a)
            try:
                v0, v1 = f(float(a.lo)), f(float(a.hi))
            except (OverflowError, ValueError):
                return self._top()
            lo, hi = (v0, v1) if inc else (v1, v0)
            return self._float(min(lo, hi), max(lo, hi))
        if name in ("sin", "cos", "erf"):
            return self._float(-1.0, 1.0)
        if name in _JOINS:
            vals = [v for v in _flat(args) if isinstance(v, AbsVal)]
            return self._join_all(vals, self._out_shape())
        self.note_unknown(self._opname())
        return self._top()

    # ------------------------------------------------------------ typing --
    def _signed_of(self, v: AbsVal):
        """Signed type a value of ``v``'s kind negates/abs-es into."""
        if v.weak or v.kind == "u" or v.kind == "b":
            return self.S if np.dtype(v.dtype).itemsize <= \
                np.dtype(self.S).itemsize else _I64
        return v.dtype

    def _carrier_out(self) -> bool:
        return self._out_torch_dtype() == torch.int64

    def _unify(self, vals):
        """Result logical dtype of an op on ``vals`` with an int64 carrier
        output, plus the operands converted to it; None = all weak."""
        ints = [v for v in vals if isinstance(v, AbsVal) and v.is_int]
        strong = [v for v in ints if not v.weak]
        if not strong:
            return None, vals
        neg_s = [v for v in strong if v.kind == "i" and v.lo < 0]
        uns = [v for v in strong if v.kind in ("u", "b")]
        if neg_s or (not uns):
            # the widest signed type among the operands
            res = max((v.dtype for v in strong if v.kind == "i"),
                      key=lambda d: np.dtype(d).itemsize)
            if np.dtype(res).itemsize < np.dtype(self.S).itemsize and \
                    self._carrier_out():
                res = self.S
            for v in uns:
                if v.hi > _iinfo(res)[1]:
                    self.flag("signedness",
                              f"unsigned operand {v.describe()} read as "
                              f"{np.dtype(res).name} can change the value",
                              ints)
        else:
            res = max((v.dtype for v in uns),
                      key=lambda d: np.dtype(d).itemsize)
            if np.dtype(res).kind == "b" or (
                    np.dtype(res).itemsize < np.dtype(self.U).itemsize
                    and self._carrier_out()):
                res = self.U
        out = []
        for v in vals:
            if isinstance(v, AbsVal) and v.is_int and v.weak and \
                    np.dtype(res).kind == "u" and v.lo < 0 and v.lo == v.hi:
                # an all-ones constant (-1 on the carrier) on an unsigned
                # bus is the bus maximum
                m = int(v.lo) % (1 << (8 * np.dtype(res).itemsize))
                v = AbsVal(np.dtype(res), v.shape, m, m, m).norm()
            out.append(v)
        return np.dtype(res), out

    def _val(self, x, like=None) -> AbsVal:
        """An operand as an AbsVal (Python scalars are weak constants)."""
        if isinstance(x, AbsVal):
            return x
        if isinstance(x, bool):
            return _exact(_BOOL, int(x))
        if isinstance(x, int):
            return _exact(_I64, x)
        if isinstance(x, float):
            dt = like.dtype if like is not None and not like.is_int \
                else np.dtype(np.float64)
            return _exact(dt, float(np.dtype(dt).type(x)))
        return self._top()

    # ------------------------------------------------------------ builders --
    def _top(self):
        v = self._meta()
        if isinstance(v, (tuple, list)):
            return tuple(top(np_dtype(t.dtype), t.shape) for t in v)
        dt = np_dtype(v.dtype) if isinstance(v, torch.Tensor) else _I64
        return top(dt, self._out_shape())

    def _bool(self, lo=0, hi=1):
        return AbsVal(_BOOL, self._out_shape(), lo, hi, hi)

    def _float(self, lo, hi):
        dt = np_dtype(self._out_torch_dtype())
        if dt.kind != "f":
            dt = np.dtype(np.float32)
        if lo != lo:
            lo = -math.inf
        if hi != hi:
            hi = math.inf
        return AbsVal(dt, self._out_shape(), float(lo), float(hi))

    def _mk(self, lo, hi, dtype, bits=None, check=True, ins=(),
            what="result", weak=False):
        """Build the output value of logical ``dtype``; flag overflow if
        the interval leaves it."""
        dt = np.dtype(dtype)
        shape = self._out_shape()
        if dt.kind == "f":
            return AbsVal(dt, shape, float(lo), float(hi), None, None, weak)
        lo, hi = int(lo), int(hi)
        dlo, dhi = _iinfo(dt)
        if check and (lo < dlo or hi > dhi):
            self.flag("overflow", f"{what} [{lo}, {hi}] exceeds {dt.name} "
                                  f"[{dlo}, {dhi}]", ins)
            return top(dt, shape)
        return AbsVal(dt, shape, lo, hi, bits, None, weak).norm()

    def _ident(self, a):
        shape = self._out_shape()
        if a.is_int:
            return a.with_shape(shape).norm()
        return AbsVal(a.dtype, shape, a.lo, a.hi, None, None, a.weak)

    def _join_all(self, vals, shape):
        res, vals = self._unify(vals)
        out = None
        for v in (self._settle(v) for v in vals):
            if res is not None and v.is_int:
                lo, hi = _iinfo(res)
                v = AbsVal(res, v.shape, v.lo, v.hi, v.bits).norm() \
                    if lo <= v.lo and v.hi <= hi else top(res, v.shape)
            out = v if out is None else join(out, v.with_shape(out.shape))
        if out is None:
            return self._top()
        return out.with_shape(shape)

    def _const(self, name, args, kwargs):
        tdt = self._out_torch_dtype()
        dt = np_dtype(tdt)
        if name in ("zeros", "zeros_like", "new_zeros"):
            v = 0
        elif name in ("ones", "ones_like", "new_ones"):
            v = 1
        elif name in ("full", "full_like", "new_full"):
            v = args[1] if len(args) > 1 else kwargs.get("fill_value")
        elif name == "scalar_tensor":
            v = args[0]
        else:                                # empty: anything
            return self._top()
        if isinstance(v, AbsVal):
            return self._top()
        c = _exact(dt if dt.kind != "b" else _BOOL, v)
        return c.with_shape(self._out_shape())

    def _arange(self, args, kwargs):
        nums = [a for a in args if isinstance(a, (int, float))]
        if len(nums) == 1:
            lo, hi = 0, nums[0]
        elif len(nums) >= 2:
            lo, hi = nums[0], nums[1]
        else:
            return self._top()
        dt = np_dtype(self._out_torch_dtype())
        if dt.kind == "f":
            return self._float(lo, hi)
        return self._mk(lo, max(int(hi) - 1, int(lo)), dt, check=False,
                        weak=True)

    # ------------------------------------------------------- select family --
    def _where(self, args):
        c = self._val(args[0])
        x = self._val(args[1], args[2] if isinstance(args[2], AbsVal)
                      else None)
        y = self._val(args[2], x)
        if c.is_int and c.lo == c.hi:
            # statically decided select: only the live branch matters
            v = x if c.lo else y
            return self._ident(v) if not v.pending else \
                v.with_shape(self._out_shape())
        _, x, y = self._select_clear(self._node, [c, x, y])
        if not x.is_int or not y.is_int:
            if x.is_int or y.is_int:
                return self._top()
            return AbsVal(x.dtype if not x.weak else y.dtype,
                          self._out_shape(), min(x.lo, y.lo),
                          max(x.hi, y.hi), None, None, x.weak and y.weak)
        return self._join_all([x, y], self._out_shape())

    def _clamp(self, name, args, kwargs):
        x = args[0]
        mn = kwargs.get("min", args[1] if len(args) > 1 else None)
        mx = kwargs.get("max", args[2] if len(args) > 2 else None)
        if name == "clamp_max":
            mn, mx = None, mn
        if isinstance(mn, AbsVal) or isinstance(mx, AbsVal):
            x = self._settle(x)
            mnv = mn.lo if isinstance(mn, AbsVal) else mn
            mxv = mx.hi if isinstance(mx, AbsVal) else mx
        else:
            mnv, mxv = mn, mx
        if x.is_int:
            saturated = x.pending is not None and mnv is not None \
                and mnv >= 0
            if x.pending is not None and not saturated:
                x = self._settle(x)
            lo, hi = x.lo, x.hi
            if mnv is not None:
                lo, hi = max(lo, int(math.ceil(mnv))), max(hi, int(
                    math.ceil(mnv)))
            if mxv is not None:
                lo, hi = min(lo, int(math.floor(mxv))), min(hi, int(
                    math.floor(mxv)))
            if saturated:
                return AbsVal(self.U, self._out_shape(), lo, hi).norm()
            return AbsVal(x.dtype, self._out_shape(), lo, hi,
                          x.bits if lo >= 0 else None, None, x.weak).norm()
        # float clamp: the bounds are rounded to the tensor's dtype first
        ft = np.dtype(x.dtype).type
        lo, hi = x.lo, x.hi
        if mnv is not None:
            m = float(ft(mnv))
            lo, hi = max(lo, m), max(hi, m)
        if mxv is not None:
            m = float(ft(mxv))
            lo, hi = min(lo, m), min(hi, m)
        return AbsVal(x.dtype, self._out_shape(), lo, hi, None, None,
                      x.weak)

    def _minmax(self, name, args):
        a, b = self._val(args[0]), self._val(args[1])
        f = max if name in ("maximum", "max") else min
        if a.is_int and b.is_int:
            res, (a, b) = self._unify([a, b])
            dt = res if res is not None else _I64
            return self._mk(f(a.lo, b.lo), f(a.hi, b.hi), dt, check=False,
                            weak=res is None)
        return self._float(f(a.lo, b.lo), f(a.hi, b.hi))

    # ------------------------------------------------------- arith family --
    def _arith(self, name, args, kwargs):
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        a, b = self._val(args[0]), self._val(args[1], self._val(args[0]))
        if name == "rsub":                   # rsub(x, c) = c - alpha * x
            a, b = b, a
            name = "sub"
        if alpha != 1 and isinstance(alpha, (int, float)):
            b = dataclasses.replace(
                b, lo=min(b.lo * alpha, b.hi * alpha),
                hi=max(b.lo * alpha, b.hi * alpha))
        ins = [a, b]
        if not a.is_int or not b.is_int or \
                np.dtype(np_dtype(self._out_torch_dtype())).kind == "f":
            op = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
                  "mul": lambda x, y: x * y}[name]
            lo, hi = _corners(a, b, op)
            return self._float(lo, hi)
        if self._carrier_out():
            res, (a, b) = self._unify([a, b])
        else:
            res = np_dtype(self._out_torch_dtype())
        weak = res is None
        dt = _I64 if weak else res
        if name == "add":
            lo, hi = a.lo + b.lo, a.hi + b.hi
            what = "integer sum"
        elif name == "sub":
            lo, hi = a.lo - b.hi, a.hi - b.lo
            what = "integer difference"
            if np.dtype(dt).kind == "u" and lo < 0:
                msg = (f"possible unsigned underflow: {a.describe()} - "
                       f"{b.describe()} reaches {lo}")
                if hi < 0:       # certain underflow — no guard saves this
                    self.flag("overflow", msg, ins)
                    return top(dt, self._out_shape())
                pend = ((self._resolve_key(self._arg_node(0)),
                         self._resolve_key(self._arg_node(1))),
                        "overflow", msg, self._eqn_str(ins),
                        _src_of(self._node))
                return AbsVal(self.S if np.dtype(dt).itemsize <= np.dtype(
                    self.S).itemsize else _I64, self._out_shape(), lo,
                    min(hi, _iinfo(dt)[1]), None, pend)
        else:
            lo, hi = _corners(a, b, lambda x, y: x * y)
            what = "integer product"
        return self._mk(lo, hi, dt, ins=ins, what=what, check=not weak,
                        weak=weak)

    def _arg_node(self, i):
        """The graph argument behind operand ``i`` (rsub swaps them)."""
        n = self._node
        if _name(n.target) == "rsub":
            i = 1 - i
        return n.args[i] if i < len(n.args) else None

    def _bitwise(self, name, args):
        a, b = self._val(args[0]), self._val(args[1])
        ins = [a, b]
        if np_dtype(self._out_torch_dtype()).kind == "b":
            return self._bool()
        if self._carrier_out():
            if name == "and" and any(v.lo >= 0 for v in (a, b)):
                # an AND with a non-negative operand is an unsigned bit
                # field of it, whatever the other operand's sign
                field_hi = min(v.hi for v in (a, b) if v.lo >= 0)
                res = None if a.weak and b.weak else (
                    self.U if field_hi <= _iinfo(self.U)[1]
                    else np.dtype(np.uint64))
            else:
                res, (a, b) = self._unify([a, b])
        else:
            res = np_dtype(self._out_torch_dtype())
        weak = res is None
        dt = _I64 if weak else res
        if name == "and":
            if a.lo >= 0 and b.lo >= 0:
                bits = None
                if a.bits is not None and b.bits is not None:
                    bits = a.bits & b.bits
                elif a.bits is not None:
                    bits = a.bits
                elif b.bits is not None:
                    bits = b.bits
                hi = min(a.hi, b.hi)
                if bits is not None:
                    hi = min(hi, bits)
                return self._mk(0, hi, dt, bits, check=False, weak=weak)
            # x & m with m >= 0 clears the sign bit too: result in [0, m]
            for m in (a, b):
                if m.lo >= 0:
                    bits = m.bits if m.bits is not None else \
                        (1 << int(m.hi).bit_length()) - 1
                    return self._mk(0, min(m.hi, bits), dt, bits,
                                    check=False, weak=weak)
            return top(dt, self._out_shape())
        if name == "xor":
            if a.lo >= 0 and b.lo >= 0 and a.bits is not None \
                    and b.bits is not None:
                bits = a.bits | b.bits
                return self._mk(0, bits, dt, bits, check=False, weak=weak)
            return top(dt, self._out_shape())
        # name == "or": the repo invariant — every integer OR is a disjoint
        # bit-field union (lane packing, log packing, region indices)
        disjoint = (a.lo >= 0 and b.lo >= 0 and a.bits is not None
                    and b.bits is not None and (a.bits & b.bits) == 0)
        if not disjoint:
            self.flag("lane-overlap",
                      f"integer OR operands not provably disjoint: "
                      f"{a.describe()} | {b.describe()}", ins)
            return top(dt if not weak else self.U, self._out_shape())
        bits = a.bits | b.bits
        return self._mk(max(a.lo, b.lo), min(a.hi + b.hi, bits), dt, bits,
                        check=False, weak=weak)

    def _not(self, a):
        if a.kind == "b" or np_dtype(self._out_torch_dtype()).kind == "b":
            return self._bool(0 if a.hi else 1, 1 if not a.lo else 0) \
                if a.lo == a.hi else self._bool()
        if a.lo >= 0 and a.kind == "u":
            m = _iinfo(a.dtype)[1]
            return self._mk(m - a.hi, m - a.lo, a.dtype, check=False)
        return self._top()

    def _bus_bits(self, v: AbsVal) -> int:
        if v.weak or np.dtype(v.dtype) == _I64 and not self._is_bus_i64():
            return 8 * np.dtype(self.U).itemsize
        return v.nbits

    def _is_bus_i64(self) -> bool:
        return np.dtype(self.S) == _I64

    def _wide_unsigned(self, v: AbsVal) -> bool:
        """A 64-bit unsigned bus value that may reach 2^63: on the int64
        carrier it reads negative."""
        return v.is_int and v.kind == "u" and v.nbits == 64 and \
            v.hi >= (1 << 63)

    def _shift(self, direction, args):
        a, amt = self._val(args[0]), self._val(args[1])
        ins = [a, amt]
        nbits = self._bus_bits(a)
        if not (amt.is_int and amt.lo >= 0 and amt.hi <= nbits - 1):
            self.flag("shift-range",
                      f"shift amount {amt.describe()} not provably in "
                      f"[0, {nbits - 1}]", ins)
            return top(a.dtype if not a.weak else self.U, self._out_shape())
        weak = a.weak and amt.weak
        dt = a.dtype if not a.weak else (self.U if a.lo >= 0 else self.S)
        if a.weak and not amt.weak and a.lo >= 0:
            weak = True           # `1 << k`: a constant shifted stays weak
            dt = _I64
        if direction == "right" and self._wide_unsigned(a):
            self.flag("signedness",
                      f"right shift of a 64-bit bus value {a.describe()} "
                      f"that may reach 2^63 (the int64 carrier shifts "
                      f"arithmetically)", ins)
            return top(a.dtype, self._out_shape())
        if a.lo < 0:
            if direction == "right":
                c = [x >> s for x in (int(a.lo), int(a.hi))
                     for s in (int(amt.lo), int(amt.hi))]
                return self._mk(min(c), max(c), dt, check=False, weak=weak)
            c = [x << s for x in (int(a.lo), int(a.hi))
                 for s in (int(amt.lo), int(amt.hi))]
            dlo, dhi = _iinfo(dt)
            if min(c) >= dlo and max(c) <= dhi:
                return self._mk(min(c), max(c), dt, check=False, weak=weak)
            return top(dt, self._out_shape())
        span = int(amt.hi) - int(amt.lo)
        dhi = _iinfo(dt)[1] if not weak else (1 << 63) - 1
        mask = (1 << (8 * np.dtype(dt).itemsize)) - 1 \
            if np.dtype(dt).kind == "u" else dhi
        if direction == "left":
            bits = None
            if a.bits is not None and span <= 64:
                bits = 0
                for s in range(int(amt.lo), int(amt.hi) + 1):
                    bits |= (a.bits << s) & mask
            hi = a.hi << int(amt.hi)
            if hi <= dhi:
                return self._mk(a.lo << int(amt.lo), hi, dt, bits,
                                check=False, weak=weak)
            # modular wrap is defined; saturation selects downstream decide
            return self._mk(0, mask, dt, bits, check=False, weak=weak)
        bits = None
        if a.bits is not None and span <= 64:
            bits = 0
            for s in range(int(amt.lo), int(amt.hi) + 1):
                bits |= a.bits >> s
        return self._mk(a.lo >> int(amt.hi), a.hi >> int(amt.lo), dt, bits,
                        check=False, weak=weak)

    def _compare(self, name, args):
        a, b = self._val(args[0]), self._val(args[1], self._val(args[0]))
        if name not in ("eq", "ne"):
            for v in (a, b):
                if self._wide_unsigned(v):
                    self.flag("signedness",
                              f"comparison reads a 64-bit bus value "
                              f"{v.describe()} that may reach 2^63 off the "
                              f"signed int64 carrier", [a, b])
        lo, hi = 0, 1
        if all(math.isfinite(v.lo) and math.isfinite(v.hi) for v in (a, b)):
            # interval-decidable comparisons collapse to a constant
            if name in ("lt", "le"):
                strict = name == "lt"
                if a.hi < b.lo or (not strict and a.hi <= b.lo):
                    lo = hi = 1
                elif a.lo > b.hi or (strict and a.lo >= b.hi):
                    lo = hi = 0
            elif name in ("gt", "ge"):
                strict = name == "gt"
                if a.lo > b.hi or (not strict and a.lo >= b.hi):
                    lo = hi = 1
                elif a.hi < b.lo or (strict and a.hi <= b.lo):
                    lo = hi = 0
            elif name == "eq":
                if a.lo == a.hi == b.lo == b.hi:
                    lo = hi = 1
                elif a.hi < b.lo or a.lo > b.hi:
                    lo = hi = 0
            elif name == "ne":
                if a.lo == a.hi == b.lo == b.hi:
                    lo = hi = 0
                elif a.hi < b.lo or a.lo > b.hi:
                    lo = hi = 1
        return self._bool(lo, hi)

    # ------------------------------------------------------- conversions --
    def _convert(self, a, tdt):
        a = self._val(a)
        odt = np_dtype(tdt)
        shape = self._out_shape()
        if odt.kind == "b":
            return AbsVal(odt, shape, 0, 1, 1)
        if odt.kind == "f":
            if self._wide_unsigned(a):
                self.flag("signedness",
                          f"float conversion reads a 64-bit bus value "
                          f"{a.describe()} that may reach 2^63 off the "
                          f"signed int64 carrier", [a])
                return AbsVal(odt, shape, -math.inf, math.inf)
            return AbsVal(odt, shape, float(a.lo), float(a.hi), None, None,
                          a.weak)
        # integer destination
        if not a.is_int:  # float -> int truncates toward zero
            if not (math.isfinite(a.lo) and math.isfinite(a.hi)):
                self.flag("overflow", f"unbounded float {a.describe()} "
                                      f"converted to {odt.name}", [a])
                return top(odt, shape)
            lo, hi = int(a.lo), int(a.hi)
            if odt == _I64:
                odt = self.U if lo >= 0 else self.S
                if hi > _iinfo(odt)[1] and lo >= 0:
                    odt = np.dtype(np.uint64)
            bits = None
            src_kind = "f"
        else:
            lo, hi = a.lo, a.hi
            bits = a.bits
            src_kind = a.kind
            if a.weak:
                return AbsVal(odt, shape, lo, hi, bits, None, True).norm()
            if odt == _I64:                  # onto the carrier
                if a.kind == "i":
                    odt = a.dtype if a.nbits >= np.dtype(self.S).itemsize * 8 \
                        else self.S
                else:
                    odt = a.dtype if a.nbits >= np.dtype(self.U).itemsize * 8 \
                        else self.U
        dlo, dhi = _iinfo(odt)
        if lo < dlo or hi > dhi:
            crossing = (odt.kind == "u" and lo < 0) or \
                       (odt.kind == "i" and src_kind == "u" and hi > dhi)
            self.flag("signedness" if crossing else "overflow",
                      f"conversion of [{lo}, {hi}] to {odt.name} "
                      f"[{dlo}, {dhi}] can change the value", [a])
            return top(odt, shape)
        return AbsVal(odt, shape, lo, hi, bits).norm()

    def _cast_helper(self, a, to):
        """A carrier helper (``repro_torch::carrier_cast``): the reference's
        ``astype`` to the bus's unsigned type, to the signed work type, to
        public lanes or, for a bus reader, to float."""
        shape = self._out_shape()
        if to.startswith("float") or to in ("bfloat16", "float16"):
            # lanes_to_float reads the carrier unsigned: exact by design
            a = self._settle(a)
            hi = a.hi if a.lo >= 0 else (1 << (8 * np.dtype(self.U)
                                               .itemsize)) - 1
            dt = np_dtype(getattr(torch, to))
            return AbsVal(dt, shape, float(max(a.lo, 0)), float(hi))
        target = {"uint32": np.uint32, "uint64": np.uint64,
                  "int32": np.int32, "int64": np.int64,
                  "lanes32": np.uint32, "lanes64": np.uint64}[to]
        odt = np.dtype(target)
        dlo, dhi = _iinfo(odt)
        if odt.kind == "i" and a.pending is not None:
            # the signed reading of a wrapped difference is the signed
            # subtraction the reference makes (astype first, then sub)
            a = dataclasses.replace(a, pending=None)
        a = self._settle(a)
        if a.weak:
            v = a
            if odt.kind == "u" and a.lo < 0 and a.lo == a.hi:
                m = int(a.lo) % (dhi + 1)
                v = AbsVal(odt, a.shape, m, m, m)
            return AbsVal(odt, shape, max(v.lo, dlo), min(v.hi, dhi), v.bits
                          ).norm()
        lo, hi = a.lo, a.hi
        if lo < dlo or hi > dhi:
            if to.startswith("uint") and a.kind == "u" and lo >= 0:
                # wrap_bus: the bus's own modular arithmetic; an add/mul
                # that got here was already checked
                return top(odt, shape)
            crossing = (odt.kind == "u" and lo < 0) or \
                       (odt.kind == "i" and a.kind == "u" and hi > dhi)
            self.flag("signedness" if crossing else "overflow",
                      f"{_CAST_NAMES[to]} of [{lo}, {hi}] to {odt.name} "
                      f"[{dlo}, {dhi}] can change the value", [a])
            return top(odt, shape)
        return AbsVal(odt, shape, lo, hi, a.bits if lo >= 0 else None).norm()

    def _frexp(self, a):
        shape = self._out_shape()
        d = self._def_of(self._node.args[0])
        integral = False
        if d is not None and _name(d.target) in ("_to_copy", "to") and \
                isinstance(d.args[0], torch.fx.Node):
            src = self.env.get(d.args[0])
            if isinstance(src, AbsVal) and src.is_int:
                integral = True
                exact = 1 << (np.finfo(a.dtype).nmant + 1)
                if max(abs(int(src.lo)), abs(int(src.hi))) > exact:
                    self.flag("signedness",
                              f"frexp of the {np.dtype(a.dtype).name} form "
                              f"of {src.describe()}, which is not exact "
                              f"above 2^{np.finfo(a.dtype).nmant + 1}",
                              [src])
        mant = AbsVal(a.dtype, shape, -1.0, 1.0)
        i32 = np.dtype(np.int32)
        if not (math.isfinite(a.lo) and math.isfinite(a.hi)):
            return mant, top(i32, shape)
        big = max(abs(a.lo), abs(a.hi))
        e_hi = math.frexp(big)[1]
        small = 0.0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
        if integral or small >= 1.0:
            e_lo = 0 if small < 1.0 else math.frexp(small)[1]
        elif small > 0:
            e_lo = math.frexp(small)[1]
        else:
            e_lo = np.finfo(a.dtype).minexp - np.finfo(a.dtype).nmant
        return mant, AbsVal(i32, shape, min(e_lo, 0) if small == 0 else e_lo,
                            max(e_hi, 0)).norm()

    def _ldexp(self, a, e):
        a, e = self._val(a), self._val(e)
        try:
            c = [math.ldexp(float(x), int(max(min(s, 4096), -4096)))
                 for x in (a.lo, a.hi) for s in (e.lo, e.hi)]
        except (OverflowError, ValueError):
            return self._float(-math.inf, math.inf)
        return self._float(min(c), max(c))

    # ---------------------------------------------------------- reductions --
    def _reduce_sum(self, args):
        a = args[0]
        n = int(np.prod(a.shape) // max(int(np.prod(self._out_shape())), 1))
        n = max(n, 1)
        if not a.is_int:
            return self._float(min(a.lo * n, a.lo), max(a.hi * n, a.hi))
        tdt = self._out_torch_dtype()
        src = self._meta(self._node.args[0])
        if tdt == torch.int64 and isinstance(src, torch.Tensor) and \
                src.dtype != torch.int64 and a.kind == "i":
            # a narrower signed tensor summed into int64 (torch promotes
            # integer sums): the code left the bus for a true int64 sum
            dt = _I64
        elif tdt == torch.int64:
            dt = a.dtype
            if a.weak:
                dt = self.U if a.lo >= 0 else self.S
            elif a.kind == "i" and a.nbits < 64 and a.dtype != self.S:
                dt = self.S
            elif a.kind != "i" and a.nbits < np.dtype(self.U).itemsize * 8:
                dt = self.U
        else:
            dt = np_dtype(tdt)
        return self._mk(a.lo * n, a.hi * n, dt, ins=[a],
                        what=f"sum of {n} elements")

    def _dot(self, args):
        a, b = args[0], args[1]
        k = max(int(a.shape[-1]) if a.shape else 1, 1)
        plo, phi = _corners(a, b, lambda x, y: x * y)
        if not a.is_int or not b.is_int:
            return self._float(plo * k if math.isfinite(plo) else plo,
                               phi * k if math.isfinite(phi) else phi)
        dt = np_dtype(self._out_torch_dtype())
        if dt == _I64:
            dt = self.S
        return self._mk(plo * k, phi * k, dt, ins=[a, b],
                        what=f"contraction over {k}")

    def _div(self, args):
        a, b = self._val(args[0]), self._val(args[1])
        for v in (a, b):
            if self._wide_unsigned(v):
                self.flag("signedness",
                          f"division reads a 64-bit bus value "
                          f"{v.describe()} that may reach 2^63 off the "
                          f"signed int64 carrier", [a, b])
                return self._top()
        odt = np_dtype(self._out_torch_dtype())
        if odt.kind == "f":
            if b.lo > 0 or b.hi < 0:
                lo, hi = _corners(a, b,
                                  lambda x, y: x / y if y else math.inf)
                return self._float(lo, hi)
            return self._top()
        if a.is_int and b.is_int and a.lo >= 0 and b.lo >= 1:
            return self._mk(a.lo // b.hi, a.hi // b.lo,
                            a.dtype if not a.weak else self.U, check=False)
        return self._top()

    def _rem(self, args):
        a, b = self._val(args[0]), self._val(args[1])
        if self._wide_unsigned(a):
            self.flag("signedness",
                      f"remainder reads a 64-bit bus value {a.describe()} "
                      f"that may reach 2^63 off the signed int64 carrier",
                      [a, b])
            return self._top()
        if a.is_int and a.lo >= 0 and b.lo >= 1:
            return self._mk(0, min(a.hi, b.hi - 1), a.dtype, check=False)
        return self._top()

    def _gather(self, args):
        operand, idxs = args[0], args[1]
        idx = [i for i in idxs if isinstance(i, AbsVal)]
        if len(operand.shape) == 1 and len(idx) == 1 and idx[0].is_int:
            t = int(operand.shape[0])
            i = idx[0]
            if not (i.lo >= 0 and i.hi <= t - 1):
                self.flag("gather-bounds",
                          f"table index {i.describe()} not provably in "
                          f"[0, {t - 1}]", [operand, i])
        return dataclasses.replace(operand.with_shape(self._out_shape()))

    # ----------------------------------------------------------- contracts --
    def _contract(self, args):
        val, phase, lo, hi, bits, what, assume = args
        lo, hi = int(lo or 0), int(hi)
        bits = int(bits) if bits else None
        assume = tuple(a for a in assume.split(",") if a)
        val = self._settle(val)
        if phase == "require":
            ok = (val.is_int and val.lo >= lo and val.hi <= hi)
            if not ok:
                self.flag("lane-domain",
                          f"{what}: operand {val.describe()} not "
                          f"provably within [{lo}, {hi}]", [val])
            if assume:
                self.scopes.append((frozenset(assume), what))
            return _refine(val, lo, hi)
        # ensure: closes the innermost assume scope, refines to declared
        if self.scopes:
            _, swhat = self.scopes.pop()
            tag = f"{swhat} -> {what}" if what else swhat
        else:
            tag = what
        if tag and tag not in self.report.assumed:
            self.report.assumed.append(tag)
        return _refine(val, lo, hi, bits)


_CAST_NAMES = {"uint32": "wrap_bus", "uint64": "wrap_bus",
               "int32": "wrap_int32", "int64": "wrap_signed",
               "lanes32": "to_lanes", "lanes64": "to_lanes"}


def _name(target) -> str:
    """aten op name without overload (``aten.add.Tensor`` -> ``add``)."""
    if isinstance(target, torch._ops.OpOverload):
        return target.overloadpacket.__name__
    if isinstance(target, torch._ops.OpOverloadPacket):
        return target.__name__
    return getattr(target, "__name__", str(target))


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


# ========================================================= cases to reports ==
def _trace(case: TraceCase):
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    from repro_torch.core.annotations import analysis_tracing

    def entry(*xs):
        return case.fn(*xs)

    # distinct inputs (make_fx shares a fake tensor between equal objects)
    args = [torch.empty(tuple(a.shape), dtype=a.dtype) for a in case.args]
    with analysis_tracing(), _record_sources():
        return make_fx(functionalize(entry, remove="mutations_and_views"),
                       tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)


def check_case(case: TraceCase) -> CaseReport:
    """Trace one case and interpret it abstractly."""
    report = CaseReport(label=case.label, requires_x64=case.requires_x64,
                        note=case.note,
                        bus=str(case.bus).removeprefix("torch."))
    try:
        gm = _trace(case)
    except Exception as e:  # trace failure (a data-dependent branch...)
        report.findings.append(Finding(
            "overflow", case.label,
            f"trace failed: {type(e).__name__}: {str(e).splitlines()[0]}"))
        return report
    interp = _Interp(gm, report, case.label, case.bus)
    outs = interp.run(*[a.absval(case.bus) for a in case.args],
                      enable_io_processing=False)
    for o in _flat([outs]):             # escaped deferred findings report here
        interp._node = None
        interp._settle(o)
    report.findings.sort(key=Finding.sort_key)
    report.assumed.sort()
    report.unknown_prims.sort()
    if interp.scopes:
        report.findings.append(Finding(
            "lane-domain", case.label,
            f"{len(interp.scopes)} require_range scope(s) never closed by "
            f"ensure_range"))
    return report


@dataclass
class MatrixResult:
    """Everything one full ops x widths analyzer run produced."""
    reports: list = field(default_factory=list)       # CaseReport
    skips: list = field(default_factory=list)         # (op, width, reason)
    gaps: list = field(default_factory=list)          # ops missing metadata

    @property
    def findings(self):
        return [f for r in self.reports for f in r.findings]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.gaps


def run_matrix(ops=None, widths=None) -> MatrixResult:
    """Run the analyzer over registered ops x SUPPORTED_WIDTHS."""
    from repro_torch.core.mitchell import SUPPORTED_WIDTHS
    from repro_torch.kernels import registry

    widths = tuple(widths) if widths else tuple(sorted(SUPPORTED_WIDTHS))
    result = MatrixResult()
    for impl in registry.all_ops():
        if ops and impl.name not in ops:
            continue
        if impl.analysis is None:
            result.gaps.append(impl.name)
            continue
        for w in widths:
            cases = impl.analysis(w)
            if cases is None:
                result.skips.append((impl.name, w, "width not supported"))
                continue
            if isinstance(cases, str):
                result.skips.append((impl.name, w, cases))
                continue
            for case in cases:
                result.reports.append(check_case(case))
    result.reports.sort(key=lambda r: r.label)
    result.skips.sort()
    result.gaps.sort()
    return result


def verdict_for(op_name: str, width: int) -> str:
    """One-line analyzer verdict for (op, width)."""
    res = run_matrix(ops=[op_name], widths=[width])
    if op_name in res.gaps:
        return "no-analysis-metadata"
    if not res.reports and res.skips:
        return f"skipped: {res.skips[0][2]}"
    n = len(res.findings)
    if n:
        return (f"UNSAFE: {n} finding(s) — run "
                f"`python -m repro_torch.analysis`")
    skipped = sum(1 for r in res.reports if "skipped" in r.note)
    proved = len(res.reports) - skipped
    return f"proved safe ({proved} case(s), {skipped} skipped)"


def to_json(result: MatrixResult, lint_findings=()) -> dict:
    return {
        "cases": [{
            "label": r.label,
            "ok": r.ok,
            "note": r.note,
            "requires_x64": r.requires_x64,
            "bus": r.bus,
            "findings": [{
                "rule": f.rule, "message": f.message,
                "eqn": f.eqn, "source": f.source,
            } for f in r.findings],
            "assumed": list(r.assumed),
            "unknown_primitives": list(r.unknown_prims),
        } for r in result.reports],
        "skips": [{"op": o, "width": w, "reason": why}
                  for o, w, why in result.skips],
        "coverage_gaps": list(result.gaps),
        "lint": [{
            "rule": f.rule, "ctx": f.ctx, "message": f.message,
            "source": f.source,
        } for f in lint_findings],
    }


def render_text(result: MatrixResult, lint_findings=()) -> str:
    lines = ["simdive widthcheck report (repro_torch)", "=" * 39, ""]
    n_ok = sum(1 for r in result.reports if r.ok and "skipped" not in r.note)
    n_skip = sum(1 for r in result.reports if "skipped" in r.note)
    n_bad = sum(1 for r in result.reports if not r.ok)
    lines.append(f"cases: {len(result.reports)}  proved: {n_ok}  "
                 f"skipped: {n_skip + len(result.skips)}  "
                 f"unsafe: {n_bad}  lint: {len(lint_findings)}")
    lines.append("")
    for r in result.reports:
        mark = "FAIL" if not r.ok else (
            "skip" if "skipped" in r.note else "  ok")
        note = f"  ({r.note})" if r.note else ""
        lines.append(f"[{mark}] {r.label}  bus={r.bus}{note}")
        for f in r.findings:
            lines.append(f"    {f.render()}")
        for a in r.assumed:
            lines.append(f"    assumed contract: {a}")
        for u in r.unknown_prims:
            lines.append(f"    widened: {u}")
    if result.skips:
        lines.append("")
        lines.append("declared skips:")
        for o, w, why in result.skips:
            lines.append(f"  {o} w{w}: {why}")
    if result.gaps:
        lines.append("")
        lines.append("coverage gaps (registered ops without analysis "
                     "metadata):")
        for g in result.gaps:
            lines.append(f"  {g}")
    if lint_findings:
        lines.append("")
        lines.append("lint:")
        for f in lint_findings:
            lines.append(f"  {f.render()}")
    lines.append("")
    return "\n".join(lines)
