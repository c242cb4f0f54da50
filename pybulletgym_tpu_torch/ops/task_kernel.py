"""The env-step kernel of any task: its hooks translated into CUDA C++.

Counterpart of the JAX package's `ops/pallas_engine.py ·
make_pallas_env_step` for a task that `env_step_kernel` does not implement
(a user's `Task`, a subclass of a shipped one): Pallas traces the task's
scalar hooks into the kernel body, and so does this module. It runs each
hook once on the CPU at a small batch under a `TorchDispatchMode` that
records every aten op, checks that every value is per env (a (B,) tensor,
elementwise in the batch) or a constant, and writes the ops out as C++
statements (`trace_hooks`): one function per hook, in namespace `hooks`.
`csrc/task_step.cu` compiles them with engine_core.h's substeps into
`task_step_kernel` (`csrc/task_core.h · task_step_one`), built with nvcc
per task into `_build/` (keyed by the content hash) and launched once per
env step by `CudaTaskStep`. A model over the default tables' caps takes
the large class's build (`-DENG_BIG_TABLES`: the tables in global memory,
`ops.cuda_engine`), one over the large caps or whose scratch outgrows a
block's shared memory the huge class's (`-DENG_HUGE_TABLES`: Y in a device
buffer too).

What the translation keeps from torch: each op's dtype and type promotion
(`torch.result_type` of the traced arguments), one rounding per float op
(no FMA contraction, `csrc/task_ops.h`), the division by a scalar as a
product with its float32 reciprocal (what torch's CUDA kernel computes),
wrapping integer arithmetic, NaN-propagating clamp, maximum and minimum.
Values that do not depend on the env (the task's constants, factories such
as `zeros_like`) are folded at trace time. A hook that branches in Python
on a tensor's value (`.item()`, `bool(t)`), reduces over the batch or uses
an op without a translation is refused with the op named.

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

_CTYPE = {torch.float32: "float", torch.float64: "double", torch.int64: "int64_t",
          torch.int32: "int32_t", torch.uint32: "uint32_t", torch.bool: "bool"}
_FLOAT = (torch.float32, torch.float64)

# ops whose output depends on their inputs' shape and dtype only
_FACTORIES = {"zeros_like", "ones_like", "full_like", "zeros", "ones", "full",
              "scalar_tensor", "new_zeros", "new_ones", "new_full"}
# ops that return their input
_IDENTITY = {"clone", "alias", "detach", "lift_fresh", "lift_fresh_copy", "contiguous",
             "expand", "view", "reshape", "_unsafe_view", "positive"}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
_BITWISE = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^"}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_ARITH = {"add": "tk::add", "sub": "tk::sub", "mul": "tk::mul"}
_SHIFT = {"__lshift__": "tk::shl", "__rshift__": "tk::shr", "bitwise_left_shift": "tk::shl",
          "bitwise_right_shift": "tk::shr"}
_UNARY_F = {"sin": "sinf", "cos": "cosf", "tan": "tanf", "exp": "expf", "log": "logf",
            "tanh": "tanhf", "asin": "asinf", "acos": "acosf", "atan": "atanf",
            "sinh": "sinhf", "cosh": "coshf", "expm1": "expm1f", "log1p": "log1pf",
            "log2": "log2f", "log10": "log10f", "floor": "floorf", "ceil": "ceilf",
            "trunc": "truncf", "sqrt": "sqrtf", "erf": "erff", "exp2": "exp2f"}


class _Val:
    """A traced value: a C expression of one env (a name or a literal) and
    its dtype; `const` is the Python value of a constant, else None."""

    __slots__ = ("expr", "dtype", "const")

    def __init__(self, expr, dtype, const=None):
        self.expr, self.dtype, self.const = expr, dtype, const


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


class _Recorder(TorchDispatchMode):
    """Records the aten ops of one hook as C statements over per-env values."""

    def __init__(self, where: str):
        super().__init__()
        self.where = where
        self.vals: Dict[int, _Val] = {}
        self.keep: List[torch.Tensor] = []  # every traced tensor stays alive: ids stay unique
        # (name, statement, deps, float operations)
        self.lines: List[Tuple[str, str, Tuple[str, ...], int]] = []
        self.n = 0

    # -- values --------------------------------------------------------------
    def bind(self, t: torch.Tensor, val: _Val):
        self.keep.append(t)
        self.vals[id(t)] = val

    def val(self, x) -> _Val:
        if isinstance(x, torch.Tensor):
            v = self.vals.get(id(x))
            if v is not None:
                return v
            return self._const_tensor(x, "a tensor from outside the hook")
        if isinstance(x, (bool, int, float)):
            return _Val(None, _scalar_dtype(x), x)
        raise NotImplementedError(f"{self.where}: an argument of type {type(x).__name__}")

    def _const_tensor(self, t: torch.Tensor, what: str) -> _Val:
        if t.dtype not in _CTYPE:
            raise NotImplementedError(f"{self.where}: {what} of dtype {t.dtype}")
        if t.dim() > 1 or (t.dim() == 1 and t.shape[0] != _TRACE_B):
            raise NotImplementedError(f"{self.where}: {what} of shape {tuple(t.shape)}: the "
                                      "hooks work on (B,) tensors")
        xs = t.detach().reshape(-1).tolist()
        if any(x != xs[0] and not (x != x and xs[0] != xs[0]) for x in xs):
            raise NotImplementedError(f"{self.where}: {what} differs between envs")
        v = _Val(None, t.dtype, xs[0])
        self.keep.append(t)
        self.vals[id(t)] = v
        return v

    def expr(self, v: _Val, dtype) -> str:
        """`v` as a C expression of `dtype` (torch's casts)."""
        if v.const is not None:
            return _literal(v.const, dtype)
        if v.dtype == dtype:
            return v.expr
        if dtype == torch.bool:
            return f"({v.expr} != 0)"
        return f"(({_CTYPE[dtype]}){v.expr})"

    def emit(self, out: torch.Tensor, statement: str, deps, flops: int = 0) -> _Val:
        if out.dtype not in _CTYPE:
            raise NotImplementedError(f"{self.where}: a result of dtype {out.dtype}")
        name = f"t{self.n}"
        self.n += 1
        c = _CTYPE[out.dtype]
        self.lines.append((name, f"const {c} {name} = {statement};",
                           tuple(d.expr for d in deps if d.const is None), flops))
        return _Val(name, out.dtype)

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
        if base == "copy":
            dst, src = args[0], args[1]
            v = self.val(src)
            if v.const is not None:
                self.bind(dst, _Val(None, dst.dtype, v.const))
            else:
                self.bind(dst, v if v.dtype == dst.dtype else
                          self.emit(dst, self.expr(v, dst.dtype), [v]))
            return out
        if not isinstance(out, torch.Tensor):
            raise NotImplementedError(f"{self.where}: {func} returns {type(out).__name__}")
        if base in _FACTORIES:
            self._const_tensor(out, str(func))
            return out
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        vals = [self.val(a) for a in tensors]
        if all(v.const is not None for v in vals):  # nothing per env: fold it
            self._const_tensor(out, f"the constant result of {func}")
            return out
        if tuple(out.shape) != (_TRACE_B,):
            raise NotImplementedError(f"{self.where}: {func} gives shape {tuple(out.shape)} "
                                      "from per-env (B,) values: the hooks must be elementwise "
                                      "in the batch")
        self.bind(out, self._translate(func, base, args, kwargs, out))
        return out

    def _translate(self, func, base, args, kwargs, out) -> _Val:
        R = out.dtype
        vals = [self.val(a) if isinstance(a, (torch.Tensor, bool, int, float)) else None
                for a in args]
        x = vals[0]

        def binary():
            C = torch.result_type(args[0], args[1])
            return C, self.expr(vals[0], C), self.expr(vals[1], C)

        if base in _IDENTITY:
            if base in ("expand", "view", "reshape", "_unsafe_view") and \
                    tuple(out.shape) != tuple(args[0].shape):
                raise NotImplementedError(f"{self.where}: {func} changes the shape")
            return x
        if base == "_to_copy":
            return self.emit(out, self.expr(x, R), [x])
        if base in _ARITH or base == "rsub":
            C, a, b = binary()
            alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            if base == "rsub":
                a, b = b, a
            if alpha != 1:
                b = f"tk::mul({_literal(alpha, C)}, {b})"
            op = "tk::sub" if base == "rsub" else _ARITH[base]
            return self.emit(out, self._cast(f"{op}({a}, {b})", C, R), vals[:2],
                             int(C in _FLOAT) * (1 + (alpha != 1)))
        if base == "div":
            if kwargs.get("rounding_mode") is not None:
                raise NotImplementedError(f"{self.where}: {func} with a rounding mode")
            C = torch.result_type(args[0], args[1])
            if C not in _FLOAT:
                C = R
            y = vals[1]
            if y.const is not None and C == torch.float32:
                # torch's CUDA division by a scalar: the product with its reciprocal
                inv = np.float32(1.0) / np.float32(y.const)
                return self.emit(out, f"tk::mul({self.expr(x, C)}, {_literal(inv, C)})", [x], 1)
            return self.emit(out, f"tk::div({self.expr(x, C)}, {self.expr(y, C)})", vals[:2], 1)
        if base in _COMPARE:
            C, a, b = binary()
            return self.emit(out, f"({a} {_COMPARE[base]} {b})", vals[:2])
        if base in _BITWISE:
            C, a, b = binary()
            return self.emit(out, self._cast(f"({a} {_BITWISE[base]} {b})", C, R,
                                             force=True), vals[:2])
        if base in _LOGICAL:
            a, b = self.expr(vals[0], torch.bool), self.expr(vals[1], torch.bool)
            return self.emit(out, f"({a} {_LOGICAL[base]} {b})", vals[:2])
        if base == "logical_not":
            return self.emit(out, f"(!{self.expr(x, torch.bool)})", [x])
        if base == "bitwise_not":
            if R == torch.bool:
                return self.emit(out, f"(!{self.expr(x, R)})", [x])
            return self.emit(out, f"(({_CTYPE[R]})~{self.expr(x, R)})", [x])
        if base in _SHIFT:
            C = torch.result_type(args[0], args[1])
            return self.emit(out, self._cast(
                f"{_SHIFT[base]}({self.expr(vals[0], C)}, {self.expr(vals[1], C)})", C, R),
                vals[:2])
        if base == "remainder":
            C, a, b = binary()
            return self.emit(out, self._cast(f"tk::rem({a}, {b})", C, R), vals[:2])
        if base in ("maximum", "minimum", "atan2"):
            C, a, b = binary()
            fn = f"tk::{base}" if base != "atan2" else "atan2f"
            return self.emit(out, self._cast(f"{fn}({a}, {b})", C, R), vals[:2])
        if base == "where":
            c = self.expr(vals[0], torch.bool)
            return self.emit(out, f"({c} ? {self.expr(vals[1], R)} : {self.expr(vals[2], R)})",
                             vals[:3])
        if base in ("clamp", "clamp_min", "clamp_max"):
            lo = kwargs.get("min", args[1] if len(args) > 1 and base != "clamp_max" else None)
            hi = kwargs.get("max", args[2] if len(args) > 2 else
                            (args[1] if base == "clamp_max" else None))
            deps = [x] + [self.val(b) for b in (lo, hi) if b is not None]
            s = self.expr(x, R)
            if lo is not None and hi is not None:
                e = f"tk::clamp({s}, {self.expr(self.val(lo), R)}, {self.expr(self.val(hi), R)})"
            elif lo is not None:
                e = f"tk::clamp_min({s}, {self.expr(self.val(lo), R)})"
            elif hi is not None:
                e = f"tk::clamp_max({s}, {self.expr(self.val(hi), R)})"
            else:
                return x
            return self.emit(out, e, deps)
        if base == "neg":
            return self.emit(out, f"(({_CTYPE[R]})(-{self.expr(x, R)}))", [x])
        if base == "abs":
            fn = "fabsf" if R == torch.float32 else ("fabs" if R == torch.float64 else "llabs")
            return self.emit(out, self._cast(f"{fn}({self.expr(x, R)})", R, R), [x])
        if base == "sign" and R in (torch.float32, torch.int64):
            return self.emit(out, f"tk::sign({self.expr(x, R)})", [x])
        if base == "reciprocal" and R == torch.float32:
            return self.emit(out, f"tk::div(1.f, {self.expr(x, R)})", [x], 1)
        if base == "rsqrt" and R == torch.float32:
            return self.emit(out, f"tk::rsqrt({self.expr(x, R)})", [x], 1)
        if base == "pow" and R == torch.float32 and not isinstance(args[1], torch.Tensor):
            return self._pow(out, x, float(args[1]))
        if base in _UNARY_F and R == torch.float32:
            return self.emit(out, f"{_UNARY_F[base]}({self.expr(x, R)})", [x], 1)
        raise NotImplementedError(f"{self.where}: {func} has no CUDA translation")

    def _pow(self, out, x, e: float) -> _Val:
        s = self.expr(x, torch.float32)
        # torch's pow by a scalar exponent special-cases these (pow_tensor_scalar)
        forms = {2.0: f"tk::mul({s}, {s})", 3.0: f"tk::mul(tk::mul({s}, {s}), {s})",
                 0.5: f"sqrtf({s})", -0.5: f"tk::rsqrt({s})", -1.0: f"tk::div(1.f, {s})",
                 -2.0: f"tk::div(1.f, tk::mul({s}, {s}))", 1.0: s}
        return self.emit(out, forms.get(e, f"powf({s}, {_literal(e, torch.float32)})"), [x],
                         {2.0: 1, 3.0: 2, -2.0: 2, 1.0: 0}.get(e, 1))

    @staticmethod
    def _cast(e: str, C, R, force=False) -> str:
        return e if C == R and not force else f"(({_CTYPE[R]}){e})"


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
        rec.bind(t, _Val(expr, t.dtype))
    with rec:
        res = fn(*[t for _, t in inputs])
    return rec, res


def _out(rec: _Recorder, x, dtype, what: str) -> _Val:
    """An output of a hook as a value of `dtype` (floats as torch would
    stack them)."""
    if isinstance(x, torch.Tensor):
        if tuple(x.shape) not in ((_TRACE_B,), ()):
            raise NotImplementedError(f"{rec.where}: {what} has shape {tuple(x.shape)}, "
                                      f"expected ({_TRACE_B},)")
        return rec.val(x)
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


def work_per_task_step(t, program: HookProgram, reset_share: float) -> Tuple[float, int]:
    """(float operations, bytes) that one env of one `task_step_kernel`
    launch needs, for the tables `t` and the hooks `program`: the substeps,
    the hooks, and the reset's share of envs (`reset_share`) times the
    reset's operations. Bytes count each input read once and each output
    written once; the tables once per launch are left to the caller."""
    f = program.flops
    n = (t.frame_skip * ce.substep_flops(t) + f["pre_physics"] + f["action_tau"] + f["output"]
         + reset_share * f["initial_state"])
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


def _cuda_job(source: str, lanes: int, size: int = ce.DEFAULT):
    """The nvcc job of task_step.cu with the hooks `source` for group width
    `lanes` and the tables' size class `size` (the generated header
    written), and its library's name."""
    flags = ce.NVCC_FLAGS + (f"-DENG_LANES={lanes}",) + ce.CLASS_FLAGS[size]
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


def load_task_library(source: str, lanes: int, size: int = ce.DEFAULT):
    """Build (once per content hash) and load task_step.cu with the hooks
    `source` for group width `lanes` and the tables' size class `size`.
    Returns (ctypes library, nvcc log)."""
    return _load_task_library(source, int(lanes), int(size))


@functools.lru_cache(maxsize=None)
def _load_task_library(source: str, lanes: int, size: int):
    job, name = _cuda_job(source, lanes, size)
    built = ce._compile([job])
    lib = ctypes.CDLL(os.path.join(ce.BUILD_DIR, name))
    ce._check_layout(lib, size)
    lib.task_launch_config.argtypes = [ctypes.c_int, ce._P]
    lib.task_launch_config.restype = ctypes.c_int
    # the large and huge builds take the tables' device copy after the host
    # copy, the huge one then the Y buffer
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
    captured). The huge class's Y buffer is allocated once for each batch
    size (by `prepare(device, B)` or the first step), so one step at a time."""

    backend = "fused"
    kernel = "task_step_kernel"

    def __init__(self, task, frame_skip: Optional[int] = None):
        self.task, self.frame_skip = task, frame_skip
        self.program = None
        self.tables = None
        self.size = ce.DEFAULT
        self.device_tables: Dict[int, torch.Tensor] = {}
        self.y_buffers: Dict[tuple, torch.Tensor] = {}
        self.launches = 0

    def prepare(self, device: Optional[torch.device] = None, B: Optional[int] = None):
        """Translate the hooks and pack the tables; with a CUDA `device`,
        also build the library, pick the launch configuration, upload the
        large and huge classes' tables and, for a batch of B envs, allocate
        the huge class's Y buffer."""
        if self.program is None:
            self.program = trace_hooks(self.task)
            self.tables = task_tables(self.task, self.program, self.frame_skip)
            self.size = ce.tables_class(self.tables)
            self.kernel = "task_step_kernel" + ce.KERNEL_SUFFIX[self.size]
        if device is not None and torch.device(device).type == "cuda":
            device = torch.device(device)
            cfg = self.launch_config(device)
            ce._tables_args(self.tables, self.device_tables, device)
            if B is not None:
                ce._y_args(self.tables, self.y_buffers, device, B)
            return cfg
        return None

    def cuda_job(self):
        """The nvcc job of this task's library, and the library's name."""
        return _cuda_job(self.program.source, self.tables.lanes, self.size)

    def library(self):
        return load_task_library(self.program.source, self.tables.lanes, self.size)

    def launch_config(self, device: torch.device, B: Optional[int] = None) -> Dict[str, int]:
        self.prepare()
        lanes = ce.lane_nv(self.tables.lanes, self.size)
        if self.tables.nv > lanes:
            raise ValueError(f"{self.tables.nv} dofs exceed the {lanes} "
                             f"that G={self.tables.lanes} lanes hold")
        cfg = dict(_task_launch_config(self.library()[0], self.tables.sc_stride,
                                       device.index or 0))
        cfg["G"], cfg["threads"] = self.tables.lanes, cfg["E"] * self.tables.lanes
        cfg["y_bytes"] = 4 * ce.y_stride(self.tables)
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
                *ce._y_args(self.tables, self.y_buffers, dev, B), *ce._ptrs(ins + outs),
                B, E, ce._P(torch.cuda.current_stream(dev).cuda_stream))
        ce._launch_checked(rc, self.kernel)
        ce.count_launch(self.kernel, self)
        return ce._env_state(state, outs)


class HostTaskTwin:
    """task_step.cu's body built with g++ for the host, for the CPU tests:
    the kernel's own C++, the task's translated hooks included, on CPU
    tensors (the huge class's Y in a second heap buffer). No wrapper routes
    here."""

    FLAGS = ("-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

    def __init__(self, task, frame_skip: Optional[int] = None):
        gxx = ce.gxx_path()
        self.task = task
        self.program = trace_hooks(task)
        self.tables = task_tables(task, self.program, frame_skip)
        size = ce.tables_class(self.tables)
        flags = self.FLAGS + ce.CLASS_FLAGS[size]
        tag = _tag(self.program.source, _CORE + ["task_step_host.cpp"], flags)
        header = _write_header(self.program.source, tag)
        name = f"libtask_host_{tag}.so"
        ce._compile([([gxx], "task_step_host.cpp", name, flags + ("-include", header))])
        self.lib = ctypes.CDLL(os.path.join(ce.BUILD_DIR, name))
        ce._check_layout(self.lib, size)
        self.lib.host_task_step.argtypes = ce._ENV_ARGS
        self.lib.host_task_step.restype = ctypes.c_int

    def __call__(self, state, action):
        ins, outs = ce._env_tensors(self.task, self.tables, state, action)
        rc = self.lib.host_task_step(ctypes.addressof(self.tables), *ce._ptrs(ins + outs),
                                     state.q.shape[-1])
        ce._launch_checked(rc, "host task step")
        return ce._env_state(state, outs)
