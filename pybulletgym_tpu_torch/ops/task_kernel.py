"""The env-step kernel of any task: its hooks translated into CUDA C++.

Counterpart of the JAX package's `ops/pallas_engine.py ·
make_pallas_env_step` for a task that `env_step_kernel` does not implement
(a user's `Task`, a subclass of a shipped one): Pallas traces the task's
scalar hooks into the kernel body, and so does this module. It runs each
hook once on the CPU at a small batch under a `TorchDispatchMode` that
records every aten op, checks that every value is per env (a tensor of a
small static leading shape and the batch last, elementwise in the batch)
or a constant, and writes the ops out as C++ statements (`trace_hooks`):
one function per hook, in namespace `hooks`.
`csrc/task_step.cu` compiles them with engine_core.h's substeps into
`task_step_kernel` (`csrc/task_core.h · task_step_one`), built with nvcc
per task into `_build/` (keyed by the content hash) and launched once per
env step by `CudaTaskStep`. A model over the default tables' caps takes
the large class's build (`-DENG_BIG_TABLES`: the tables in global memory,
`ops.cuda_engine`), one over the large caps or whose scratch outgrows a
block's shared memory the huge class's (`-DENG_HUGE_TABLES`), and any
larger one a class sized to it (`-DENG_SIZED_TABLES` with the model's caps):
the three run the default class's substep over root paths, the scratch in
a device buffer.

What the translation keeps from torch: each op's dtype and type promotion
(`torch.result_type` of the traced arguments) in float32, float64 and the
integer types of `_CTYPE`; each op's formula as torch's CUDA kernel
computes it, every operation rounded on its own (no FMA contraction,
`csrc/task_ops.h`) but where that kernel fuses one (addcmul, lerp, gelu's
tanh form); the division by a Python scalar as a product with its
reciprocal; wrapping integer arithmetic; NaN-propagating clamp, maximum,
minimum and reductions. The ops: arithmetic, comparisons, bitwise and
logical ops, shifts, where and masked_fill, casts; the math functions of
`_UNARY_F`; the activations (relu, sigmoid, softplus, logsigmoid, silu,
elu, leaky_relu, hardtanh, gelu, mish, logit, logaddexp); div with a
rounding mode, floor_divide, fmod, remainder, round (and decimals), frac,
copysign, signbit, sign and sgn; pow of any operands; hypot, lerp,
addcmul, addcdiv, xlogy, deg2rad, rad2deg, sinc; erfc, erfinv, asinh,
acosh, atanh; isnan, isinf, isposinf, isneginf, isfinite, nan_to_num,
fmax, fmin, heaviside. A per-env value may hold up to `_MAX_ELEMENTS`
elements before its batch axis (`torch.stack([x, y, z])` is (3, B)): each
element is a C expression, ops broadcast over them, stack, cat,
unsqueeze, squeeze, select, slice, unbind, split, flip, permute and
indexing with constant indices move them, and sum, prod, mean, amax,
amin, max/min over a dim, all, any, linalg.vector_norm, logsumexp, cumsum
and cumprod over a leading axis are written out in index order. Values
that do not depend on the env (the task's constants, factories such as
`zeros_like`) are folded at trace time, by torch itself.

Refused, with the hook and the op named (NotImplementedError, so that
`BatchedEnv`'s default "fused" backend raises at construction and
"composed" is taken only when asked for): a reduction, scan, stack or
index over the batch axis (it couples the envs); torch's random draws
(hooks draw with `ops/rand.py`'s Threefry); matrix products (write a sum
of products); a gather or index with a per-env index; a Python branch on
a value (`.item()`, `bool(t)`, `torch.equal`); a write into a view; a
dtype outside `_CTYPE`; a per-env value of more than `_MAX_ELEMENTS`
elements; any other op (lgamma, digamma, the Bessel functions, ...).

`HostTaskTwin` builds the same source with g++ for the CPU tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pybulletgym_tpu_torch.ops import cuda_engine as ce

_TRACE_B = 5  # the trace's batch: >1, so that a value that varies over envs shows
_MAX_ELEMENTS = 64  # the most elements of a per-env value (its leading shape's size)

_CTYPE = {torch.float32: "float", torch.float64: "double", torch.int64: "int64_t",
          torch.int32: "int32_t", torch.uint32: "uint32_t", torch.bool: "bool"}
_FLOAT = (torch.float32, torch.float64)

# ops whose output depends on their inputs' shape and dtype only
_FACTORIES = {"zeros_like", "ones_like", "full_like", "zeros", "ones", "full",
              "scalar_tensor", "new_zeros", "new_ones", "new_full", "fill", "zero"}
# ops that return their input
_IDENTITY = {"clone", "alias", "detach", "lift_fresh", "lift_fresh_copy", "contiguous",
             "positive"}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
_BITWISE = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^"}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_ARITH = {"add": "tk::add", "sub": "tk::sub", "mul": "tk::mul"}
_SHIFT = {"__lshift__": "tk::shl", "__rshift__": "tk::shr", "bitwise_left_shift": "tk::shl",
          "bitwise_right_shift": "tk::shr"}
# the float32 C function of each unary op; float64's drops the "f"
_UNARY_F = {"sin": "sinf", "cos": "cosf", "tan": "tanf", "exp": "expf", "log": "logf",
            "tanh": "tanhf", "asin": "asinf", "acos": "acosf", "atan": "atanf",
            "sinh": "sinhf", "cosh": "coshf", "expm1": "expm1f", "log1p": "log1pf",
            "log2": "log2f", "log10": "log10f", "floor": "floorf", "ceil": "ceilf",
            "trunc": "truncf", "sqrt": "sqrtf", "erf": "erff", "exp2": "exp2f",
            "erfc": "erfcf", "asinh": "asinhf", "acosh": "acoshf", "atanh": "atanhf"}
# unary ops computed by the tk:: function of the same name (csrc/task_ops.h),
# with their float operations (a math function counts one)
_UNARY_TK = {"sigmoid": 3, "silu": 3, "mish": 4, "sinc": 3, "frac": 2, "erfinv": 1,
             "log_sigmoid_forward": 4}
# binary float ops computed by a tk:: function, with their float operations
_BINARY_TK = {"hypot": ("tk::hypot_", 1), "logaddexp": ("tk::logaddexp", 6),
              "copysign": ("tk::copysign_", 0), "heaviside": ("tk::heaviside", 0),
              "fmax": ("tk::fmax_", 0), "fmin": ("tk::fmin_", 0), "fmod": ("tk::fmod_", 1),
              "xlogy": ("tk::xlogy", 2)}
# reductions and scans over the leading axes (each written out in index order)
_REDUCE = {"sum", "prod", "mean", "amax", "amin", "max", "min", "all", "any",
           "linalg_vector_norm", "logsumexp"}
_SCAN = {"cumsum", "cumprod"}
# ops that only move elements around
_SHAPE = {"expand", "view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "select",
          "slice", "permute", "transpose", "t", "stack", "cat", "unbind", "split",
          "split_with_sizes", "index", "index_select", "flip"}
# what stays refused, by name
_DRAWS = {"rand", "randn", "rand_like", "randn_like", "randint", "randint_like", "randperm",
          "uniform", "normal", "bernoulli", "multinomial", "exponential", "geometric",
          "log_normal", "cauchy", "random", "poisson"}
_PRODUCTS = {"mm", "mv", "bmm", "matmul", "dot", "vdot", "addmm", "addmv", "addbmm",
             "baddbmm", "outer", "ger", "inner", "tensordot", "einsum", "linear"}
_GATHERS = {"gather", "take", "take_along_dim", "index_select", "index"}


class _Val:
    """A traced value of one element: a C expression of one env (a name or
    a literal) and its dtype; `const` is the Python value of a constant,
    else None."""

    __slots__ = ("expr", "dtype", "const")

    def __init__(self, expr, dtype, const=None):
        self.expr, self.dtype, self.const = expr, dtype, const


class _Arr:
    """A per-env tensor: a `_Val` for each element of its leading shape
    (`els`, a numpy object array); the batch axis trails, as in the JAX
    package's (rows, B)."""

    __slots__ = ("els", "dtype")

    def __init__(self, els, dtype):
        self.els, self.dtype = els, dtype


def _one(v: _Val) -> _Arr:
    return _Arr(_nd(v), v.dtype)


def _nd(x) -> np.ndarray:
    """numpy's result of indexing an object array: an array, or (all the
    axes indexed) the element itself, made a 0-d array."""
    if isinstance(x, np.ndarray):
        return x
    els = np.empty((), object)
    els[()] = x
    return els


def _literal(value, dtype) -> str:
    if dtype in _FLOAT:
        x = float(np.float32(value)) if dtype == torch.float32 else float(value)
        suffix = "f" if dtype == torch.float32 else ""
        if math.isnan(x):
            return "(float)NAN" if suffix else "(double)NAN"
        if math.isinf(x):
            return f"({'-' if x < 0 else ''}(float)INFINITY)"
        return f"({x.hex()}{suffix})"
    if dtype == torch.bool:
        return "true" if bool(value) else "false"
    v = int(value)
    if dtype == torch.int64:
        return f"((int64_t){v}LL)" if v != -(2 ** 63) else "((int64_t)INT64_MIN)"
    if dtype == torch.int32:
        return f"((int32_t){v})"
    if dtype == torch.uint32:
        return f"{v & 0xFFFFFFFF}u"
    raise NotImplementedError(f"no literal of dtype {dtype}")


def _scalar_dtype(x):
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int64
    return torch.float64


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


def _params(args, kwargs, names, defaults):
    """An op's parameters after its first argument: positional, else by
    keyword, else the default."""
    got = list(args[1:1 + len(names)])
    return [got[i] if i < len(got) else kwargs.get(n, d)
            for i, (n, d) in enumerate(zip(names, defaults))]


def _in_dtype(x, dtype):
    """The Python number `x` rounded as a value of `dtype` (a float32 op's
    parameter, for example), as a float."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


class _Recorder(TorchDispatchMode):
    """Records the aten ops of one hook as C statements over per-env values."""

    def __init__(self, where: str):
        super().__init__()
        self.where = where
        self.vals: Dict[int, _Arr] = {}
        self.keep: List[torch.Tensor] = []  # every traced tensor stays alive: ids stay unique
        self.viewed = set()  # ids of views and of the tensors they view
        # (name, statement, deps, float operations)
        self.lines: List[Tuple[str, str, Tuple[str, ...], int]] = []
        self.n = 0

    # -- values --------------------------------------------------------------
    def bind(self, t: torch.Tensor, arr: _Arr, func=None):
        if tuple(t.shape) != arr.els.shape + (_TRACE_B,):
            raise NotImplementedError(f"{self.where}: {func} gives shape {tuple(t.shape)} "
                                      "from per-env values: the hooks must be elementwise in "
                                      "the batch, which stays the last axis")
        if arr.els.size > _MAX_ELEMENTS:
            raise NotImplementedError(
                f"{self.where}: {func} gives a per-env value of {arr.els.size} elements "
                f"(leading shape {arr.els.shape}): the kernel takes at most {_MAX_ELEMENTS}")
        self.keep.append(t)
        self.vals[id(t)] = arr

    def live(self, x) -> bool:
        return isinstance(x, torch.Tensor) and id(x) in self.vals

    def const_els(self, t: torch.Tensor, what: str) -> np.ndarray:
        """The elements of a constant tensor over its leading shape: its last
        axis lines up with the batch, so it is 1 or B long and the same in
        every env."""
        if t.dtype not in _CTYPE:
            raise NotImplementedError(f"{self.where}: {what} of dtype {t.dtype}")
        a = t.detach()
        if a.dim() >= 1:
            if a.shape[-1] not in (1, _TRACE_B):
                raise NotImplementedError(f"{self.where}: {what} of shape {tuple(t.shape)}: "
                                          "its last axis lines up with the batch")
            first = a[..., :1]
            if not bool(((a == first) | ((a != a) & (first != first))).all()):
                raise NotImplementedError(f"{self.where}: {what} differs between envs")
            a = a[..., 0]
        els = np.empty(tuple(a.shape), object)
        for idx, x in zip(np.ndindex(els.shape), a.reshape(-1).tolist()):
            els[idx] = _Val(None, t.dtype, x)
        return els

    def arr(self, x) -> _Arr:
        if isinstance(x, torch.Tensor):
            a = self.vals.get(id(x))
            return a if a is not None else _Arr(
                self.const_els(x, "a tensor from outside the hook"), x.dtype)
        if isinstance(x, (bool, int, float)):
            return _one(_Val(None, _scalar_dtype(x), x))
        raise NotImplementedError(f"{self.where}: an argument of type {type(x).__name__}")

    def expr(self, v: _Val, dtype) -> str:
        """`v` as a C expression of `dtype` (torch's casts)."""
        if v.const is not None:
            return _literal(v.const, dtype)
        if v.dtype == dtype:
            return v.expr
        if dtype == torch.bool:
            return f"({v.expr} != 0)"
        return f"(({_CTYPE[dtype]}){v.expr})"

    def emit(self, dtype, statement: str, deps, flops: int = 0) -> _Val:
        if dtype not in _CTYPE:
            raise NotImplementedError(f"{self.where}: a result of dtype {dtype}")
        name = f"t{self.n}"
        self.n += 1
        self.lines.append((name, f"const {_CTYPE[dtype]} {name} = {statement};",
                           tuple(d.expr for d in deps if d.const is None), flops))
        return _Val(name, dtype)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        base = func.overloadpacket.__name__
        inplace = base.endswith("_") and not base.endswith("__") and not base.startswith("_")
        if base in ("_local_scalar_dense", "is_nonzero", "equal"):
            raise NotImplementedError(
                f"{self.where}: a Python value of a tensor ({func}): the kernel cannot branch "
                "on a value at trace time; write the branch with torch.where")
        if inplace:
            base = base[:-1]
        if base in _DRAWS:
            raise NotImplementedError(
                f"{self.where}: {func} draws from torch's generator: a hook draws with "
                "ops/rand.py's Threefry (rand.uniform(seed, stream, env_id, epoch, lo, hi))")
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o._is_view():
                self.keep += [o, o._base]  # alive, so that their ids stay theirs
                self.viewed.update((id(o), id(o._base)))
        live = any(self.live(t) for t in _flat(list(args) + list(kwargs.values())))
        if not live:  # nothing per env: a constant (a factory, the task's constants)
            return out
        if (inplace or base == "copy") and (args[0]._is_view() or id(args[0]) in self.viewed):
            raise NotImplementedError(
                f"{self.where}: {func} writes into a view of a tensor (indexed, sliced or "
                "reshaped): build the value with torch.stack, torch.cat or torch.where")
        if base == "copy":
            dst, src = args[0], args[1]
            if not self.live(src):  # a constant written over dst
                self.vals.pop(id(dst), None)
                return out
            if dst.dim() == 0:
                raise NotImplementedError(f"{self.where}: {func} into a tensor of shape ()")
            els = self._broadcast(func, self.arr(src), tuple(dst.shape[:-1]))
            new = np.empty(els.shape, object)
            for idx in np.ndindex(els.shape):
                v = els[idx]
                new[idx] = (_Val(None, dst.dtype, v.const) if v.const is not None else
                            v if v.dtype == dst.dtype else
                            self.emit(dst.dtype, self.expr(v, dst.dtype), [v]))
            self.bind(dst, _Arr(new, dst.dtype), func)
            return out
        if base in _FACTORIES:  # zeros_like(x), x.zero_(): a constant
            if inplace:
                self.vals.pop(id(args[0]), None)
            return out
        if base in _PRODUCTS:
            raise NotImplementedError(
                f"{self.where}: {func} is a matrix product, which the kernel does not "
                "take: write it as a sum of products, (u * w).sum(0) over a leading axis")
        if base in _GATHERS and any(self.live(t) for t in _flat(args[1:])):
            raise NotImplementedError(
                f"{self.where}: {func} gathers or indexes with a per-env index, which the "
                "kernel does not take: select with torch.where")
        if base in _SHAPE:
            new = self._shape(func, base, args, out)
        elif base in _REDUCE and func._overloadname != "other":
            new = self._reduce(func, base, args, kwargs, outs)
        elif base in _SCAN:
            new = [self._scan(func, base, args, out)]
        elif base == "log_sigmoid_forward":  # (output, a buffer for the backward pass)
            new = [self._elementwise(func, base, args, kwargs, outs[0])]
            outs = outs[:1]
        else:
            if not isinstance(out, torch.Tensor):
                raise NotImplementedError(f"{self.where}: {func} returns {type(out).__name__}")
            new = [self._elementwise(func, base, args, kwargs, out)]
        for o, a in zip(outs, new):
            self.bind(o, a, func)
        return out

    def _batch_refused(self, func, what="reduces or scans over"):
        return NotImplementedError(
            f"{self.where}: {func} {what} the batch axis, which couples the envs: no CUDA "
            "translation; the hooks must be elementwise in the batch")

    def _broadcast(self, func, a: _Arr, shape) -> np.ndarray:
        try:
            return np.broadcast_to(a.els, shape)
        except ValueError:
            raise NotImplementedError(
                f"{self.where}: {func} broadcasts a per-env value of leading shape "
                f"{a.els.shape} to {shape}: the hooks must be elementwise in the batch, "
                "which stays the last axis") from None

    def _elementwise(self, func, base, args, kwargs, out) -> _Arr:
        if out.dim() == 0 or out.shape[-1] != _TRACE_B:
            raise NotImplementedError(f"{self.where}: {func} gives shape {tuple(out.shape)} "
                                      "from per-env values: the hooks must be elementwise "
                                      "in the batch")
        if out.dtype not in _CTYPE:
            raise NotImplementedError(f"{self.where}: {func} gives a result of dtype {out.dtype}")
        S = tuple(out.shape[:-1])
        if math.prod(S) > _MAX_ELEMENTS:
            raise NotImplementedError(
                f"{self.where}: {func} gives a per-env value of {math.prod(S)} elements "
                f"(leading shape {S}): the kernel takes at most {_MAX_ELEMENTS}")
        value = (torch.Tensor, bool, int, float)

        def spread(x):
            a = self.arr(x)
            return a.els if a.els.shape == S else self._broadcast(func, a, S)

        pos = [spread(a) if isinstance(a, value) else None for a in args]
        kw = {k: spread(a) for k, a in kwargs.items() if isinstance(a, value)}
        tensors = ([i for i, a in enumerate(args) if isinstance(a, torch.Tensor)],
                   [k for k, a in kwargs.items() if isinstance(a, torch.Tensor)])
        els = np.empty(S, object)
        for idx in np.ndindex(S) if S else [()]:
            vals = [None if p is None else p[idx] for p in pos]
            kws = {k: p[idx] for k, p in kw.items()}
            if all(vals[i].const is not None for i in tensors[0]) and \
                    all(kws[k].const is not None for k in tensors[1]):
                els[idx] = _Val(None, out.dtype, out[idx + (0,)].item())  # folded by torch
            else:
                els[idx] = self._translate(func, base, args, kwargs, out.dtype, vals, kws)
        return _Arr(els, out.dtype)

    def _translate(self, func, base, args, kwargs, R, vals, kws) -> _Val:
        """One element of an elementwise op: `vals` and `kws` are the
        elements of its positional and keyword arguments."""
        x = vals[0]
        F = R in _FLOAT

        def binary():
            C = torch.result_type(args[0], args[1])
            return C, self.expr(vals[0], C), self.expr(vals[1], C)

        def lit(v, dtype=R):
            return _literal(v, dtype)

        if base in _IDENTITY:
            return x
        if base == "_to_copy":
            return self.emit(R, self.expr(x, R), [x])
        if base in _ARITH or base == "rsub":
            C, a, b = binary()
            alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            if base == "rsub":
                a, b = b, a
            if alpha != 1:
                b = f"tk::mul({_literal(alpha, C)}, {b})"
            op = "tk::sub" if base == "rsub" else _ARITH[base]
            return self.emit(R, self._cast(f"{op}({a}, {b})", C, R), vals[:2],
                             int(C in _FLOAT) * (1 + (alpha != 1)))
        if base == "div" and kwargs.get("rounding_mode") is None:
            C = torch.result_type(args[0], args[1])
            if C not in _FLOAT:
                C = R
            y = vals[1]
            if y.const is not None and C == torch.float32:
                # torch's CUDA division by a scalar: the product with its reciprocal
                inv = np.float32(1.0) / np.float32(y.const)
                return self.emit(R, f"tk::mul({self.expr(x, C)}, {_literal(inv, C)})", [x], 1)
            return self.emit(R, f"tk::div({self.expr(x, C)}, {self.expr(y, C)})", vals[:2], 1)
        if base in ("div", "floor_divide"):
            return self._div(args, R, vals, kwargs.get("rounding_mode", "floor"))
        if base in _COMPARE:
            C, a, b = binary()
            return self.emit(R, f"({a} {_COMPARE[base]} {b})", vals[:2])
        if base in _BITWISE:
            C, a, b = binary()
            return self.emit(R, self._cast(f"({a} {_BITWISE[base]} {b})", C, R,
                                           force=True), vals[:2])
        if base in _LOGICAL:
            a, b = self.expr(vals[0], torch.bool), self.expr(vals[1], torch.bool)
            return self.emit(R, f"({a} {_LOGICAL[base]} {b})", vals[:2])
        if base == "logical_not":
            return self.emit(R, f"(!{self.expr(x, torch.bool)})", [x])
        if base == "bitwise_not":
            if R == torch.bool:
                return self.emit(R, f"(!{self.expr(x, R)})", [x])
            return self.emit(R, f"(({_CTYPE[R]})~{self.expr(x, R)})", [x])
        if base in _SHIFT:
            C = torch.result_type(args[0], args[1])
            return self.emit(R, self._cast(
                f"{_SHIFT[base]}({self.expr(vals[0], C)}, {self.expr(vals[1], C)})", C, R),
                vals[:2])
        if base == "remainder":
            C, a, b = binary()
            return self.emit(R, self._cast(f"tk::rem({a}, {b})", C, R), vals[:2])
        if base in ("maximum", "minimum", "atan2", "max", "min"):
            C, a, b = binary()
            fn = {"atan2": "atan2f" if C != torch.float64 else "atan2",
                  "max": "tk::maximum", "min": "tk::minimum"}.get(base, f"tk::{base}")
            return self.emit(R, self._cast(f"{fn}({a}, {b})", C, R), vals[:2])
        if base == "where":
            c = self.expr(vals[0], torch.bool)
            return self.emit(R, f"({c} ? {self.expr(vals[1], R)} : {self.expr(vals[2], R)})",
                             vals[:3])
        if base == "masked_fill":
            c = self.expr(vals[1], torch.bool)
            return self.emit(R, f"({c} ? {self.expr(vals[2], R)} : {self.expr(x, R)})",
                             vals[:3])
        if base in ("clamp", "clamp_min", "clamp_max", "hardtanh"):
            lo = kws.get("min", vals[1] if len(args) > 1 and base != "clamp_max" else None)
            hi = kws.get("max", vals[2] if len(args) > 2 else
                         (vals[1] if base == "clamp_max" else None))
            if base == "hardtanh":
                lo, hi = (_Val(None, R, a) for a in _params(args, kwargs, ("min_val", "max_val"),
                                                            (-1.0, 1.0)))
            deps = [x] + [b for b in (lo, hi) if b is not None]
            s = self.expr(x, R)
            if lo is not None and hi is not None:
                e = f"tk::clamp({s}, {self.expr(lo, R)}, {self.expr(hi, R)})"
            elif lo is not None:
                e = f"tk::clamp_min({s}, {self.expr(lo, R)})"
            elif hi is not None:
                e = f"tk::clamp_max({s}, {self.expr(hi, R)})"
            else:
                return x
            return self.emit(R, e, deps)
        if base == "relu":
            fn = "tk::relu" if F else "tk::clamp_min"
            return self.emit(R, f"{fn}({self.expr(x, R)}{'' if F else ', ' + lit(0)})", [x])
        if base == "neg":
            return self.emit(R, f"(({_CTYPE[R]})(-{self.expr(x, R)}))", [x])
        if base == "abs":
            fn = "fabsf" if R == torch.float32 else ("fabs" if R == torch.float64 else "llabs")
            return self.emit(R, self._cast(f"{fn}({self.expr(x, R)})", R, R), [x])
        if base in ("sign", "sgn"):
            return x if R == torch.bool else self.emit(R, f"tk::sign({self.expr(x, R)})", [x])
        if base == "reciprocal" and F:
            one = "1.f" if R == torch.float32 else lit(1)
            return self.emit(R, f"tk::div({one}, {self.expr(x, R)})", [x], 1)
        if base == "rsqrt" and F:
            return self.emit(R, f"tk::rsqrt({self.expr(x, R)})", [x], 1)
        if base == "pow":
            return self._pow_op(func, args, R, vals)
        if base in _UNARY_F and F:
            fn = _UNARY_F[base] if R == torch.float32 else _UNARY_F[base][:-1]
            return self.emit(R, f"{fn}({self.expr(x, R)})", [x], 1)
        if base in _UNARY_TK and F:
            fn = "log_sigmoid" if base == "log_sigmoid_forward" else base
            return self.emit(R, f"tk::{fn}({self.expr(x, R)})", [x], _UNARY_TK[base])
        if base in _BINARY_TK:
            C = R if F else torch.result_type(args[0], args[1])
            fn, n = _BINARY_TK[base]
            if C not in _FLOAT and base in ("fmax", "fmin"):
                fn = "tk::maximum" if base == "fmax" else "tk::minimum"
            elif C not in _FLOAT and base not in ("fmod", "heaviside"):
                fn = None
            if fn is not None:
                return self.emit(R, self._cast(
                    f"{fn}({self.expr(vals[0], C)}, {self.expr(vals[1], C)})", C, R),
                    vals[:2], n if C in _FLOAT else 0)
        if base == "round" and R != torch.bool:
            d = int(kwargs.get("decimals", 0))
            if not F:
                return x
            if d == 0:
                return self.emit(R, f"tk::round_({self.expr(x, R)})", [x], 1)
            # torch: nearbyint(x * 10^d) / 10^d, or for d < 0 nearbyint(x / 10^-d) * 10^-d
            p = _in_dtype(10.0 ** abs(d), R)
            return self.emit(R, f"tk::round_dec({self.expr(x, R)}, {lit(p)}, {str(d < 0).lower()})",
                             [x], 3)
        if base == "signbit":
            T = args[0].dtype
            if T in _FLOAT:
                return self.emit(R, f"(signbit({self.expr(x, T)}) != 0)", [x])
            return self.emit(R, f"({self.expr(x, T)} < 0)" if T != torch.bool else "false", [x])
        if base in ("isnan", "isinf", "isposinf", "isneginf", "isfinite"):
            T = args[0].dtype
            if T not in _FLOAT:
                return self.emit(R, "true" if base == "isfinite" else "false", [])
            return self.emit(R, f"tk::{base}_({self.expr(x, T)})", [x])
        if base == "nan_to_num":
            if not F:
                return x
            fin = torch.finfo(R)
            rep = [d if v is None else v for v, d in zip(
                _params(args, kwargs, ("nan", "posinf", "neginf"), (None,) * 3),
                (0.0, fin.max, fin.min))]
            return self.emit(R, f"tk::nan_to_num({self.expr(x, R)}, "
                             f"{', '.join(lit(v) for v in rep)})", [x])
        if base in ("deg2rad", "rad2deg") and F:
            k = math.pi / 180.0 if base == "deg2rad" else 180.0 / math.pi
            return self.emit(R, f"tk::mul({self.expr(x, R)}, {lit(k)})", [x], 1)
        if base == "softplus" and F:
            beta, thr = _params(args, kwargs, ("beta", "threshold"), (1.0, 20.0))
            return self.emit(R, f"tk::softplus({self.expr(x, R)}, {lit(beta)}, {lit(thr)})",
                             [x], 4)
        if base == "elu" and F:
            alpha, scale, iscale = _params(args, kwargs, ("alpha", "scale", "input_scale"),
                                           (1.0, 1.0, 1.0))
            neg = _in_dtype(_in_dtype(alpha, R) * _in_dtype(scale, R), R)
            return self.emit(R, f"tk::elu({self.expr(x, R)}, {lit(neg)}, {lit(scale)}, "
                             f"{lit(iscale)})", [x], 3)
        if base == "leaky_relu" and F:
            slope, = _params(args, kwargs, ("negative_slope",), (0.01,))
            return self.emit(R, f"tk::leaky_relu({self.expr(x, R)}, {lit(slope)})", [x], 1)
        if base == "gelu" and F:
            fn = "tk::gelu_tanh" if kwargs.get("approximate", "none") == "tanh" else "tk::gelu"
            return self.emit(R, f"{fn}({self.expr(x, R)})", [x], 5)
        if base == "logit" and F:
            eps, = _params(args, kwargs, ("eps",), (None,))
            if eps is None:
                return self.emit(R, f"tk::logit({self.expr(x, R)})", [x], 3)
            lo = _in_dtype(eps, R)
            hi = _in_dtype(1.0 - lo, R) if R == torch.float64 else float(
                np.float32(1.0) - np.float32(lo))
            return self.emit(R, f"tk::logit_eps({self.expr(x, R)}, {lit(lo)}, {lit(hi)})",
                             [x], 3)
        if base == "lerp" and F:
            w = vals[2]
            return self.emit(R, f"tk::lerp({self.expr(x, R)}, {self.expr(vals[1], R)}, "
                             f"{self.expr(w, R)})", vals[:3], 3)
        if base in ("addcmul", "addcdiv"):
            value = kwargs.get("value", args[3] if len(args) > 3 else 1)
            a, b, c = (self.expr(v, R) for v in vals[:3])
            op = f"tk::mul({b}, {c})" if base == "addcmul" else f"tk::div({b}, {c})"
            if F and value == 1:
                e = f"tk::fma_({b}, {c}, {a})" if base == "addcmul" else f"tk::add({a}, {op})"
            elif F:  # torch: one fma with the value
                e = f"tk::fma_({lit(value)}, {op}, {a})"
            else:  # addcmul of integers (torch refuses addcdiv's)
                e = f"tk::add({a}, tk::mul({lit(value)}, {op}))"
            return self.emit(R, e, vals[:3], 2 if F else 0)
        raise NotImplementedError(f"{self.where}: {func} has no CUDA translation")

    def _div(self, args, R, vals, mode) -> _Val:
        """div with a rounding mode, and floor_divide, as torch's CUDA kernels
        compute them: by a Python scalar, a product with its reciprocal."""
        if mode not in ("floor", "trunc"):
            raise NotImplementedError(f"{self.where}: div with rounding mode {mode!r}")
        C = torch.result_type(args[0], args[1])
        a, b = self.expr(vals[0], C), self.expr(vals[1], C)
        if C in _FLOAT and not isinstance(args[1], torch.Tensor):
            y = _in_dtype(args[1], C)
            if y == 0:  # torch: the true division
                return self.emit(R, self._cast(f"tk::div({a}, {b})", C, R), vals[:1], 1)
            inv = (float(np.float32(1.0) / np.float32(y)) if C == torch.float32 else 1.0 / y)
            e = (f"tk::div_floor_inv({a}, {b}, {_literal(inv, C)})" if mode == "floor" else
                 f"tk::trunc_(tk::mul({a}, {_literal(inv, C)}))")
            return self.emit(R, self._cast(e, C, R), vals[:1], 5 if mode == "floor" else 2)
        fn = "tk::div_floor" if mode == "floor" else "tk::div_trunc"
        return self.emit(R, self._cast(f"{fn}({a}, {b})", C, R), vals[:2],
                         (5 if mode == "floor" else 2) if C in _FLOAT else 0)

    def _pow_op(self, func, args, R, vals) -> _Val:
        """pow of any operands: by a float scalar exponent torch's special
        forms (`_pow`), else powf/pow, or integer powers by squaring."""
        if func._overloadname == "Tensor_Scalar" and R in _FLOAT:
            return self._pow(R, vals[0], float(args[1]))
        a, b = self.expr(vals[0], R), self.expr(vals[1], R)
        if R in _FLOAT:
            return self.emit(R, f"tk::pow_({a}, {b})", vals[:2], 1)
        return self.emit(R, f"tk::powi({a}, {b})", vals[:2])

    def _pow(self, R, x, e: float) -> _Val:
        s = self.expr(x, R)
        one = _literal(1, R) if R == torch.float64 else "1.f"
        # torch's pow by a scalar exponent special-cases these (pow_tensor_scalar)
        forms = {2.0: f"tk::mul({s}, {s})", 3.0: f"tk::mul(tk::mul({s}, {s}), {s})",
                 0.5: f"{'sqrtf' if R == torch.float32 else 'sqrt'}({s})",
                 -0.5: f"tk::rsqrt({s})", -1.0: f"tk::div({one}, {s})",
                 -2.0: f"tk::div({one}, tk::mul({s}, {s}))", 1.0: s}
        default = (f"powf({s}, {_literal(e, R)})" if R == torch.float32 else
                   f"tk::pow_({s}, {_literal(e, R)})")
        return self.emit(R, forms.get(e, default), [x],
                         {2.0: 1, 3.0: 2, -2.0: 2, 1.0: 0}.get(e, 1))

    @staticmethod
    def _cast(e: str, C, R, force=False) -> str:
        return e if C == R and not force else f"(({_CTYPE[R]}){e})"

    # -- per-env vectors -----------------------------------------------------
    def _axis(self, func, d: int, rank: int, what="indexes") -> int:
        """`d` as an axis of a tensor of `rank` (the batch's is rank - 1),
        refused where it is the batch's."""
        d = d % rank
        if d == rank - 1:
            raise self._batch_refused(func, what)
        return d

    def _shape(self, func, base, args, out) -> List[_Arr]:
        """Ops that move elements (stack, cat, indexing, views): the batch
        axis stays the last."""
        if base in ("stack", "cat"):
            xs = [t for t in args[0] if not (base == "cat" and tuple(t.shape) == (0,))]
            els = [self.arr(t).els if self.live(t) else
                   self.const_els(t, f"a constant in {func}") for t in xs]
            rank = max(e.ndim for e in els) + 1 + (base == "stack")
            d = self._axis(func, args[1] if len(args) > 1 else 0, rank, "stacks or joins along")
            new = np.stack(els, d) if base == "stack" else np.concatenate(els, d)
            return [_Arr(new, out.dtype)]
        a = self.arr(args[0])
        rank = a.els.ndim + 1
        if base in ("expand", "view", "reshape", "_unsafe_view", "squeeze"):
            if out.dim() == 0 or out.shape[-1] != _TRACE_B or \
                    (base == "expand" and out.dim() < rank):
                raise NotImplementedError(f"{self.where}: {func} changes the shape across "
                                          "the batch axis, which stays the last")
            lead = tuple(out.shape[:-1])
            return [_Arr(np.broadcast_to(a.els, lead) if base == "expand" else
                         a.els.reshape(lead), out.dtype)]
        if base == "unsqueeze":
            d = args[1] % (rank + 1)
            if d == rank:
                raise self._batch_refused(func, "puts an axis after")
            return [_Arr(np.expand_dims(a.els, d), out.dtype)]
        if base == "select":
            d = self._axis(func, args[1], rank)
            return [_Arr(_nd(np.take(a.els, args[2], axis=d)), out.dtype)]
        if base == "slice":
            d = args[1] % rank if len(args) > 1 else 0
            if d == rank - 1:
                if tuple(out.shape) != tuple(args[0].shape):
                    raise self._batch_refused(func, "slices")
                return [a]
            sl = slice(*(list(args[2:5]) + [None] * 3)[:3])
            return [_Arr(a.els[(slice(None),) * d + (sl,)], out.dtype)]
        if base in ("permute", "transpose", "t"):
            if base == "t":
                order = list(range(rank))[::-1]
            elif base == "transpose":
                order = list(range(rank))
                i, j = args[1] % rank, args[2] % rank
                order[i], order[j] = order[j], order[i]
            else:
                order = [d % rank for d in args[1]]
            if order[-1] != rank - 1:
                raise self._batch_refused(func, "moves")
            return [_Arr(np.transpose(a.els, order[:-1]), out.dtype)]
        if base in ("unbind", "split", "split_with_sizes"):
            d = self._axis(func, args[2] if base != "unbind" and len(args) > 2 else
                           (args[1] if base == "unbind" and len(args) > 1 else 0), rank)
            if base == "unbind":
                return [_Arr(_nd(np.take(a.els, k, axis=d)), out[0].dtype)
                        for k in range(a.els.shape[d])]
            parts, lo = [], 0
            for o in out:
                n = o.shape[d]
                parts.append(_Arr(np.take(a.els, range(lo, lo + n), axis=d), o.dtype))
                lo += n
            return parts
        if base == "flip":
            dims = [self._axis(func, d, rank, "flips") for d in args[1]]
            return [_Arr(np.flip(a.els, dims), out.dtype)]
        if base == "index_select":
            d = self._axis(func, args[1], rank)
            return [_Arr(np.take(a.els, args[2].tolist(), axis=d), out.dtype)]
        # index.Tensor: constant indices over the leading axes
        idx = list(args[1])
        if len(idx) >= rank and idx[rank - 1] is not None:
            raise self._batch_refused(func, "indexes")
        key = tuple(slice(None) if i is None else i.numpy() for i in idx)
        return [_Arr(_nd(a.els[key]), out.dtype)]

    def _reduce(self, func, base, args, kwargs, outs) -> List[_Arr]:
        """Reductions over leading axes, in index order (sums from 0, as
        torch's kernels start them)."""
        a = self.arr(args[0])
        rank = a.els.ndim + 1
        if base == "linalg_vector_norm":
            dims, keep = _params(args[1:], kwargs, ("dim", "keepdim"), (None, False))
        else:
            dims, keep = _params(args, kwargs, ("dim", "keepdim"), (None, False))
            if func._overloadname == "default" and base not in ("amax", "amin", "logsumexp"):
                dims = None  # sum(), mean(), max(), all(): every axis
        if isinstance(dims, int):
            dims = [dims]
        if not dims:  # over every axis, the batch's too
            raise self._batch_refused(func)
        dims = sorted({self._axis(func, d, rank, "reduces over") for d in dims})
        rest = [d for d in range(rank - 1) if d not in dims]
        moved = np.transpose(a.els, rest + dims)
        lead = moved.shape[:len(rest)]
        shape = tuple(1 if d in dims else a.els.shape[d] for d in range(rank - 1)) if keep \
            else lead
        out = outs[0]
        R = out.dtype
        vals = np.empty(lead, object)
        idxs = np.empty(lead, object)
        for k in np.ndindex(lead):
            xs = list(moved[k].reshape(-1))
            at = k if not keep else tuple(
                0 if d in dims else k[rest.index(d)] for d in range(rank - 1))
            if all(v.const is not None for v in xs):
                vals[k] = _Val(None, R, out[at + (0,)].item())
                if len(outs) > 1:
                    idxs[k] = _Val(None, outs[1].dtype, outs[1][at + (0,)].item())
                continue
            if base in ("max", "min"):
                vals[k], idxs[k] = self._arg_extreme(base, R, xs)
            else:
                vals[k] = self._fold(base, args, kwargs, R, xs)
        res = [_Arr(vals.reshape(shape), R)]
        if len(outs) > 1:
            res.append(_Arr(idxs.reshape(shape), outs[1].dtype))
        return res

    def _fold(self, base, args, kwargs, R, xs) -> _Val:
        """One output element of a reduction over the elements `xs`."""
        e = [self.expr(v, R) for v in xs]
        n = len(e)
        T = "float" if R == torch.float32 else "double"
        if base in ("all", "any"):
            op = " && " if base == "all" else " || "
            return self.emit(R, "(" + op.join(self.expr(v, torch.bool) for v in xs) + ")", xs)
        if base in ("amax", "amin"):
            fn = "tk::reduce_max" if base == "amax" else "tk::reduce_min"
            return self.emit(R, functools.reduce(lambda s, y: f"{fn}({s}, {y})", e), xs)
        if base == "prod":
            return self.emit(R, functools.reduce(lambda s, y: f"tk::mul({s}, {y})", e), xs,
                             (n - 1) * (R in _FLOAT))
        if base == "logsumexp":
            m = self.emit(R, functools.reduce(lambda s, y: f"tk::reduce_max({s}, {y})", e), xs)
            # torch: the maximum, 0 where it is infinite, taken out of the exponentials
            mm = self.emit(R, f"(tk::isinf_({m.expr}) ? {_literal(0, R)} : {m.expr})", [m])
            fn = "expf" if T == "float" else "exp"
            s = functools.reduce(lambda s, y: f"tk::add({s}, {fn}(tk::sub({y}, {mm.expr})))",
                                 e, _literal(0, R))
            log = "logf" if T == "float" else "log"
            return self.emit(R, f"tk::add({log}({s}), {mm.expr})", xs + [mm], 3 * n + 2)
        if base == "linalg_vector_norm":
            p = float(kwargs.get("ord", args[1] if len(args) > 1 else 2))
            ab = [f"{'fabsf' if T == 'float' else 'fabs'}({y})" for y in e]
            if p == math.inf or p == -math.inf:
                fn = "tk::reduce_max" if p > 0 else "tk::reduce_min"
                return self.emit(R, functools.reduce(lambda s, y: f"{fn}({s}, {y})", ab), xs)
            zero = _literal(0, R)
            if p == 0:
                terms = [f"(({T})({y} != {zero}))" for y in e]
            elif p == 1:
                terms = ab
            elif p == 2:
                terms = [f"tk::mul({y}, {y})" for y in e]
            else:
                terms = [f"tk::pow_({y}, {_literal(p, R)})" for y in ab]
            s = functools.reduce(lambda s, y: f"tk::add({s}, {y})", terms, zero)
            if p == 2:
                s = f"{'sqrtf' if T == 'float' else 'sqrt'}({s})"
            elif p not in (0, 1):
                s = f"tk::pow_({s}, {_literal(_in_dtype(1.0 / _in_dtype(p, R), R), R)})"
            return self.emit(R, s, xs, 2 * n + 1)
        # sum and mean: from 0 in index order; mean times the float reciprocal
        # of the count (torch's CUDA MeanOps)
        s = functools.reduce(lambda s, y: f"tk::add({s}, {y})", e, _literal(0, R))
        if base == "mean":
            s = f"tk::mul({s}, {_literal(_in_dtype(1.0 / n, R), R)})"
        return self.emit(R, s, xs, (n + (base == "mean")) * (R in _FLOAT))

    def _arg_extreme(self, base, R, xs) -> Tuple[_Val, _Val]:
        """max.dim and min.dim: the value and the index torch's CPU kernel
        takes (the first extreme, or the first NaN)."""
        keep = "<=" if base == "max" else ">="
        m, i = xs[0], _Val(None, torch.int64, 0)
        for k, v in enumerate(xs[1:], 1):
            y, M = self.expr(v, R), self.expr(m, R)
            c = self.emit(torch.bool, f"(({M} == {M}) && !({y} {keep} {M}))", [m, v])
            m = self.emit(R, f"({c.expr} ? {y} : {M})", [c, v, m])
            i = self.emit(torch.int64, f"({c.expr} ? {_literal(k, torch.int64)} : "
                          f"{self.expr(i, torch.int64)})", [c, i])
        return m, i

    def _scan(self, func, base, args, out) -> _Arr:
        """cumsum and cumprod over a leading axis, in order (cumsum from 0)."""
        a = self.arr(args[0])
        rank = a.els.ndim + 1
        d = self._axis(func, args[1], rank, "scans over")
        R = out.dtype
        moved = np.moveaxis(a.els, d, -1)
        new = np.empty(moved.shape, object)
        for k in np.ndindex(moved.shape[:-1]):
            acc = None
            for j, v in enumerate(moved[k]):
                if acc is None:
                    acc = (self.emit(R, f"tk::add({_literal(0, R)}, {self.expr(v, R)})", [v],
                                     int(R in _FLOAT)) if base == "cumsum" else
                           v if v.dtype == R else self.emit(R, self.expr(v, R), [v]))
                else:
                    op = "tk::add" if base == "cumsum" else "tk::mul"
                    acc = self.emit(R, f"{op}({self.expr(acc, R)}, {self.expr(v, R)})",
                                    [acc, v], int(R in _FLOAT))
                new[k + (j,)] = acc
        return _Arr(np.moveaxis(new, -1, d), R)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HookProgram:
    """A task's hooks as C++ (`source`), with its aux and reward keys in
    sorted order, the statements each hook keeps (`ops`) and the float
    operations among them (`flops`: a sum, product, quotient or math
    function counts one)."""

    source: str
    aux_keys: Tuple[str, ...]
    comp_keys: Tuple[str, ...]
    ops: Dict[str, int]
    flops: Dict[str, int]


def _trace(where: str, fn, inputs: List[Tuple[str, torch.Tensor]]):
    """Run fn(*tensors) under a recorder; inputs are (C expression, tensor).
    Returns (recorder, fn's result)."""
    rec = _Recorder(where)
    for expr, t in inputs:
        rec.bind(t, _one(_Val(expr, t.dtype)))
    with rec:
        res = fn(*[t for _, t in inputs])
    return rec, res


def _out(rec: _Recorder, x, dtype, what: str) -> _Val:
    """An output of a hook as a value of `dtype` (floats as torch would
    stack them)."""
    if isinstance(x, torch.Tensor):
        a = rec.vals.get(id(x))
        if tuple(x.shape) not in ((_TRACE_B,), ()) or (a is not None and a.els.shape != ()):
            raise NotImplementedError(f"{rec.where}: {what} has shape {tuple(x.shape)}, "
                                      f"expected ({_TRACE_B},)")
        return a.els[()] if a is not None else rec.const_els(x, what)[()]
    if isinstance(x, (bool, int, float)):
        return _Val(None, _scalar_dtype(x), x)
    raise NotImplementedError(f"{rec.where}: {what} is a {type(x).__name__}")


def _function(rec: _Recorder, signature: str, loads: List[str],
              stores: List[Tuple[str, _Val, torch.dtype]]) -> Tuple[str, int, int]:
    """The C++ function of one traced hook: the statements that the stores
    need (dead ones dropped), in trace order. Returns (text, statements,
    float operations)."""
    need = {v.expr for _, v, _ in stores if v.const is None}
    keep, flops = [], 0
    for name, stmt, deps, n in reversed(rec.lines):
        if name in need:
            keep.append(stmt)
            flops += n
            need.update(deps)
    keep.reverse()
    body = [f"  {x}" for x in loads if x.split(" = ")[0].split()[-1] in need]
    body += [f"  {x}" for x in keep]
    body += [f"  {dst} = {rec.expr(v, dt)};" for dst, v, dt in stores]
    return f"ENG_HD void {signature} {{\n" + "\n".join(body) + "\n}\n", len(keep), flops


def _ids_inputs(B=_TRACE_B):
    return [("seed", (torch.arange(B, dtype=torch.int64) + 7).to(torch.uint32)),
            ("env_id", torch.arange(B, dtype=torch.int32)),
            ("epoch", torch.full((B,), 3, dtype=torch.int64).to(torch.uint32))]


def trace_hooks(task) -> HookProgram:
    """Translate `task`'s four scalar hooks into the C++ of namespace
    `hooks` (see csrc/task_core.h). Raises NotImplementedError, naming the
    hook and the op, for a hook the kernel cannot run."""
    from pybulletgym_tpu_torch.envs.base import Task, _n_rows

    name = type(task).__name__
    m, act, n_rows = task.model, task.act_dim, _n_rows(task)
    f32 = torch.float32
    fns, ops, flops = [], {}, {}

    # initial_state(seed, env_id, epoch, q, v, aux)
    ids = _ids_inputs()
    rec, (q0, v0, aux0) = _trace(f"{name}.initial_state_scalar",
                                 lambda *i: task.initial_state_scalar(*i), ids)
    aux_keys = tuple(sorted(aux0))
    if len(q0) != m.nq or len(v0) != m.nv:
        raise NotImplementedError(f"{name}: initial_state_scalar gives {len(q0)} q and "
                                  f"{len(v0)} v entries, the model has {m.nq} and {m.nv}")
    stores = ([(f"q[{k}]", _out(rec, x, f32, f"q[{k}]"), f32) for k, x in enumerate(q0)]
              + [(f"v[{k}]", _out(rec, x, f32, f"v[{k}]"), f32) for k, x in enumerate(v0)]
              + [(f"aux[{j}]", _out(rec, aux0[k], f32, f"aux[{k!r}]"), f32)
                 for j, k in enumerate(aux_keys)])
    text, ops["initial_state"], flops["initial_state"] = _function(
        rec, "initial_state(uint32_t seed, int32_t env_id, uint32_t epoch, float* q, float* v, "
        "float* aux)", [], stores)
    fns.append(text)

    # concrete per-env values for the other hooks' traces
    def full(x):
        return x if isinstance(x, torch.Tensor) and x.dim() == 1 else \
            torch.full((_TRACE_B,), float(x), dtype=f32)

    qv = [full(x).to(f32) for x in q0]
    vv = [full(x).to(f32) for x in v0]
    auxv = [full(aux0[k]).to(f32) for k in aux_keys]

    def named(prefix, xs):
        return [(f"{prefix}{k}", x.clone()) for k, x in enumerate(xs)]

    def loads(prefix, array, n):
        return [f"const float {prefix}{k} = {array}[{k}];" for k in range(n)]

    id_loads = []  # the ids are the function's parameters

    # pre_physics(q, v, aux, seed, env_id, epoch)
    sig = ("pre_physics(float* q, float* v, float* aux, uint32_t seed, int32_t env_id, "
           "uint32_t epoch)")
    if type(task).pre_physics_scalar is Task.pre_physics_scalar:
        fns.append(f"ENG_HD void {sig} {{}}\n")
        ops["pre_physics"] = flops["pre_physics"] = 0
    else:
        ins = named("q_", qv) + named("v_", vv) + named("a_", auxv) + _ids_inputs()

        def pre(*xs):
            q, v = list(xs[:m.nq]), list(xs[m.nq:m.nq + m.nv])
            aux = dict(zip(aux_keys, xs[m.nq + m.nv:m.nq + m.nv + len(aux_keys)]))
            return task.pre_physics_scalar(q, v, aux, tuple(xs[-3:]))

        rec, (q1, v1, aux1) = _trace(f"{name}.pre_physics_scalar", pre, ins)
        if tuple(sorted(aux1)) != aux_keys:
            raise NotImplementedError(f"{name}: pre_physics_scalar's aux keys "
                                      f"{sorted(aux1)} differ from the reset's {aux_keys}")
        stores = ([(f"q[{k}]", _out(rec, x, f32, f"q[{k}]"), f32) for k, x in enumerate(q1)]
                  + [(f"v[{k}]", _out(rec, x, f32, f"v[{k}]"), f32) for k, x in enumerate(v1)]
                  + [(f"aux[{j}]", _out(rec, aux1[k], f32, f"aux[{k!r}]"), f32)
                     for j, k in enumerate(aux_keys)])
        text, ops["pre_physics"], flops["pre_physics"] = _function(
            rec, sig, loads("q_", "q", m.nq) + loads("v_", "v", m.nv)
            + loads("a_", "aux", len(aux_keys)) + id_loads, stores)
        fns.append(text)

    # action_tau(act, tau)
    av = [torch.linspace(-0.9, 0.8, _TRACE_B) * (1 + 0.1 * k) for k in range(act)]
    rec, tau = _trace(f"{name}.action_tau_scalar",
                      lambda *a: task.action_tau_scalar(list(a)), named("act_", av))
    tau = list(tau)
    if len(tau) != m.nv:
        raise NotImplementedError(f"{name}: action_tau_scalar gives {len(tau)} torques, the "
                                  f"model has {m.nv} dofs")
    stores = [(f"tau[{k}]", _out(rec, x, f32, f"tau[{k}]"), f32) for k, x in enumerate(tau)]
    text, ops["action_tau"], flops["action_tau"] = _function(rec, "action_tau(const float* act, float* tau)",
                                        loads("act_", "act", act), stores)
    fns.append(text)

    # output(q, v, depth, act, aux, seed, env_id, epoch, obs, reward, term, aux2, comps)
    dv = [torch.linspace(-0.01, 0.02, _TRACE_B) for _ in range(n_rows)]
    ins = (named("q_", qv) + named("v_", vv) + named("d_", dv) + named("act_", av)
           + named("a_", auxv) + _ids_inputs())

    def output(*xs):
        o = 0
        parts = []
        for n in (m.nq, m.nv, n_rows, act, len(aux_keys)):
            parts.append(list(xs[o:o + n]))
            o += n
        q, v, d, a, ax = parts
        return task.output_scalar(q, v, d, a, dict(zip(aux_keys, ax)), tuple(xs[o:o + 3]))

    rec, (obs, reward, term, aux2, comps) = _trace(f"{name}.output_scalar", output, ins)
    obs = list(obs)
    if len(obs) != task.obs_dim:
        raise NotImplementedError(f"{name}: output_scalar gives {len(obs)} obs entries, "
                                  f"obs_dim is {task.obs_dim}")
    if tuple(sorted(aux2)) != aux_keys:
        raise NotImplementedError(f"{name}: output_scalar's aux keys {sorted(aux2)} differ "
                                  f"from the reset's {aux_keys}")
    comp_keys = tuple(sorted(comps))
    stores = ([(f"obs[{k}]", _out(rec, x, f32, f"obs[{k}]"), f32) for k, x in enumerate(obs)]
              + [("reward", _out(rec, reward, f32, "reward"), f32),
                 ("term", _out(rec, term, torch.bool, "term"), torch.bool)]
              + [(f"aux2[{j}]", _out(rec, aux2[k], f32, f"aux[{k!r}]"), f32)
                 for j, k in enumerate(aux_keys)]
              + [(f"comps[{j}]", _out(rec, comps[k], f32, f"rewards[{k!r}]"), f32)
                 for j, k in enumerate(comp_keys)])
    text, ops["output"], flops["output"] = _function(
        rec, "output(const float* q, const float* v, const float* depth, const float* act, "
        "const float* aux, uint32_t seed, int32_t env_id, uint32_t epoch, float* obs, "
        "float& reward, bool& term, float* aux2, float* comps)",
        loads("q_", "q", m.nq) + loads("v_", "v", m.nv) + loads("d_", "depth", n_rows)
        + loads("act_", "act", act) + loads("a_", "aux", len(aux_keys)), stores)
    fns.append(text)

    head = (f"// {name}'s hooks, translated by ops/task_kernel.py · trace_hooks: do not edit.\n"
            "#pragma once\n#include \"engine_core.h\"\n#include \"task_ops.h\"\n\n"
            "namespace hooks {\n\n"
            f"constexpr int NAUX = {len(aux_keys)};\n"
            f"constexpr int NCOMP = {len(comp_keys)};\n"
            f"constexpr int NOBS = {len(obs)};\n\n"
            "#pragma GCC diagnostic push\n"
            "#pragma GCC diagnostic ignored \"-Wunused-parameter\"\n"
            "#pragma GCC diagnostic ignored \"-Wunused-variable\"\n\n")
    src = head + "\n".join(fns) + "\n#pragma GCC diagnostic pop\n\n}  // namespace hooks\n"
    return HookProgram(src, aux_keys, comp_keys, ops, flops)


def task_tables(task, program: HookProgram, frame_skip: Optional[int] = None):
    """The physics tables of `task`, with its obs, aux and reward sizes and
    its horizon (which the kernel freezes, as the JAX package's does)."""
    t = ce.pack_physics(task.model, task.physics, frame_skip, act=task.act_dim,
                        naux=len(program.aux_keys), obs_dim=task.obs_dim)
    t.naux, t.ncomp = len(program.aux_keys), len(program.comp_keys)
    t.obs_dim = t.obs_live = task.obs_dim
    t.max_steps = int(task.max_episode_steps)
    ce.scratch_layout(t)
    return t


def work_per_task_step(t, program: HookProgram, reset_share: float,
                       dense: bool = False) -> Tuple[float, int]:
    """(float operations, bytes) that one env of one `task_step_kernel`
    launch needs, for the tables `t` and the hooks `program`: the substeps
    (`dense`: their count before the root paths, `ce.substep_flops`), the
    hooks, and the reset's share of envs (`reset_share`) times the reset's
    operations. Bytes count each input read once and each output written
    once; the tables once per launch are left to the caller."""
    f = program.flops
    n = (t.frame_skip * ce.substep_flops(t, dense) + f["pre_physics"] + f["action_tau"]
         + f["output"] + reset_share * f["initial_state"])
    ins = 4 * (t.nq + t.nv + t.act + t.naux) + 2 + 4 * 4  # term, trunc, step, epoch, seed, id
    outs = 4 * (t.nq + t.nv + t.obs_dim + 1 + t.naux + t.ncomp) + 2 + 4 * 2
    return n, ins + outs


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_CORE = ["engine_core.h", "task_ops.h", "task_core.h"]


def _write_header(source: str, tag: str) -> str:
    """The generated header in `_build/`, named by its content."""
    os.makedirs(ce.BUILD_DIR, exist_ok=True)
    path = os.path.join(ce.BUILD_DIR, f"hooks_{tag}.h")
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".h", dir=ce.BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(source)
        os.replace(tmp, path)
    return path


def _tag(source: str, names, flags) -> str:
    h = ce._sources(names)
    h.update(source.encode())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _cuda_job(source: str, lanes: int, size: int = ce.DEFAULT,
              caps: Optional[Tuple[int, ...]] = None):
    """The nvcc job of task_step.cu with the hooks `source` for group width
    `lanes` and the tables' size class `size` (and the sized class's `caps`;
    the generated header written), and its library's name."""
    flags = ce.NVCC_FLAGS + (f"-DENG_LANES={lanes}",) + ce.class_flags(size, caps)
    tag = _tag(source, _CORE + ["task_step.cu"], flags)
    header = _write_header(source, tag)
    name = f"libtask_cuda{ce._LIB_SUFFIX[size]}_g{lanes}_{tag}.so"
    return ([ce.nvcc_path()], "task_step.cu", name, flags + ("-include", header)), name


def build_task_libraries(steps) -> Dict[str, str]:
    """Build the libraries of several `CudaTaskStep`s at once (one nvcc
    each, all started together). Returns {library path: nvcc log}."""
    jobs = []
    for st in steps:
        st.prepare()
        jobs.append(st.cuda_job()[0])
    return ce._compile(jobs)


def load_task_library(source: str, lanes: int, size: int = ce.DEFAULT,
                      caps: Optional[Tuple[int, ...]] = None):
    """Build (once per content hash) and load task_step.cu with the hooks
    `source` for group width `lanes` and the tables' size class `size` (and
    the sized class's `caps`). Returns (ctypes library, nvcc log)."""
    return _load_task_library(source, int(lanes), int(size),
                              None if caps is None else tuple(caps))


@functools.lru_cache(maxsize=None)
def _load_task_library(source: str, lanes: int, size: int, caps: Optional[Tuple[int, ...]]):
    job, name = _cuda_job(source, lanes, size, caps)
    built = ce._compile([job])
    lib = ctypes.CDLL(os.path.join(ce.BUILD_DIR, name))
    ce._check_layout(lib, size, caps)
    lib.task_launch_config.argtypes = [ctypes.c_int, ce._P]
    lib.task_launch_config.restype = ctypes.c_int
    # the large, huge and sized builds take the tables' device copy and
    # their buffer after the host copy
    lib.launch_task_step.argtypes = ([ce._P] * ce._extra_args(size) + ce._ENV_ARGS
                                     + [ctypes.c_int, ce._P])
    lib.launch_task_step.restype = ctypes.c_int
    return lib, built[os.path.join(ce.BUILD_DIR, name)]


@functools.lru_cache(maxsize=None)
def _task_launch_config(lib, stride: int, device: int) -> Dict[str, int]:
    out = (ctypes.c_int32 * 5)()
    with torch.cuda.device(device):
        rc = lib.task_launch_config(stride, ce._P(ctypes.addressof(out)))
    if rc != 0:
        raise RuntimeError(f"task_step_kernel: no launch configuration for a {stride * 4}-byte "
                           f"env scratch (CUDA error {rc})")
    E, per_sm, smem, regs, local = list(out)
    return {"E": E, "threads": 0, "blocks_per_sm": per_sm, "envs_per_sm": per_sm * E,
            "shared_bytes": smem, "env_scratch_bytes": stride * 4, "registers": regs,
            "local_bytes": local}


class CudaTaskStep:
    """step(state: EnvState, action (act, B)) -> EnvState for any task, one
    launch of `task_step_kernel` an env step on CUDA tensors (its hooks
    translated at the first CUDA call, or by `prepare`); CPU tensors run
    `envs.base.env_step_plain`. The task's horizon and constants are
    frozen into the kernel: after changing one, build a new step.
    `launches` counts kernel launches (none while a CUDA graph is
    captured). The large, huge and sized classes' scratch buffer is
    allocated once for each batch size (by `prepare(device, B)` or the first
    step), so one step at a time."""

    backend = "fused"
    kernel = "task_step_kernel"

    def __init__(self, task, frame_skip: Optional[int] = None):
        self.task, self.frame_skip = task, frame_skip
        self.program = None
        self.tables = None
        self.size, self.caps = ce.DEFAULT, None
        self.device_tables: Dict[int, torch.Tensor] = {}
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.launches = 0

    def prepare(self, device: Optional[torch.device] = None, B: Optional[int] = None):
        """Translate the hooks and pack the tables; with a CUDA `device`,
        also build the library, pick the launch configuration, upload the
        large, huge and sized classes' tables and, for a batch of B envs,
        allocate their scratch buffer."""
        if self.program is None:
            self.program = trace_hooks(self.task)
            self.tables = task_tables(self.task, self.program, self.frame_skip)
            self.size, self.caps = ce.tables_class(self.tables), ce.tables_caps(self.tables)
            self.kernel = "task_step_kernel" + ce.KERNEL_SUFFIX[self.size]
        if device is not None and torch.device(device).type == "cuda":
            device = torch.device(device)
            cfg = self.launch_config(device)
            ce._tables_args(self.tables, self.device_tables, device)
            if B is not None:
                ce._buffer_args(self.tables, self.buffers, device, B)
            return cfg
        return None

    def cuda_job(self):
        """The nvcc job of this task's library, and the library's name."""
        return _cuda_job(self.program.source, self.tables.lanes, self.size, self.caps)

    def library(self):
        return load_task_library(self.program.source, self.tables.lanes, self.size, self.caps)

    def launch_config(self, device: torch.device, B: Optional[int] = None) -> Dict[str, int]:
        self.prepare()
        lanes = ce.lane_nv(self.tables.lanes, self.size, self.caps)
        if self.tables.nv > lanes:
            raise ValueError(f"{self.tables.nv} dofs exceed the {lanes} "
                             f"that G={self.tables.lanes} lanes hold")
        cfg = dict(_task_launch_config(self.library()[0], self.tables.sc_stride,
                                       device.index or 0))
        cfg["G"], cfg["threads"] = self.tables.lanes, cfg["E"] * self.tables.lanes
        cfg["buffer_bytes"] = 4 * ce.buffer_floats(self.tables)
        if B is not None:
            cfg["blocks"] = -(-B // cfg["E"])
        return cfg

    def __call__(self, state, action):
        from pybulletgym_tpu_torch.envs.base import env_step_plain

        dev = state.q.device
        if dev.type == "cpu":
            return env_step_plain(self.task, state, action, self.frame_skip)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        E = self.launch_config(dev)["E"]
        ins, outs = ce._env_tensors(self.task, self.tables, state, action)
        B = state.q.shape[-1]
        with torch.cuda.device(dev):
            rc = self.library()[0].launch_task_step(
                *ce._tables_args(self.tables, self.device_tables, dev),
                *ce._buffer_args(self.tables, self.buffers, dev, B), *ce._ptrs(ins + outs),
                B, E, ce._P(torch.cuda.current_stream(dev).cuda_stream))
        ce._launch_checked(rc, self.kernel)
        ce.count_launch(self.kernel, self)
        return ce._env_state(state, outs)


def host_task_job(program, tables):
    """The g++ job of a task's host twin (`HostTaskTwin`) for its traced
    hooks `program` and its tables' class, and its library's name: started
    beside other builds (`ce.Builds`), it leaves the library that
    HostTaskTwin then loads."""
    size, caps = ce.tables_class(tables), ce.tables_caps(tables)
    flags = HostTaskTwin.FLAGS + ce.class_flags(size, caps)
    tag = _tag(program.source, _CORE + ["task_step_host.cpp"], flags)
    header = _write_header(program.source, tag)
    name = f"libtask_host_{tag}.so"
    return ([ce.gxx_path()], "task_step_host.cpp", name, flags + ("-include", header)), name


class HostTaskTwin:
    """task_step.cu's body built with g++ for the host, for the CPU tests
    and for holding the card to it: the kernel's own C++, the task's
    translated hooks included, on CPU tensors. `program`: the task's traced
    hooks, if at hand (a CudaTaskStep's). No wrapper routes here."""

    FLAGS = ("-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

    def __init__(self, task, frame_skip: Optional[int] = None, program=None):
        self.task = task
        self.program = program or trace_hooks(task)
        self.tables = task_tables(task, self.program, frame_skip)
        job, name = host_task_job(self.program, self.tables)
        ce._compile([job])
        self.lib = ctypes.CDLL(os.path.join(ce.BUILD_DIR, name))
        ce._check_layout(self.lib, ce.tables_class(self.tables), ce.tables_caps(self.tables))
        self.lib.host_task_step.argtypes = ce._ENV_ARGS
        self.lib.host_task_step.restype = ctypes.c_int

    def __call__(self, state, action):
        ins, outs = ce._env_tensors(self.task, self.tables, state, action)
        rc = self.lib.host_task_step(ctypes.addressof(self.tables), *ce._ptrs(ins + outs),
                                     state.q.shape[-1])
        ce._launch_checked(rc, "host task step")
        return ce._env_state(state, outs)
