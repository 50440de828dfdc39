"""A user's sag (or mask) as a straight-line program of elementwise f32
operations: what ``csrc/generic_hit.cu`` runs in registers.

A function or data surface's sag is the surface object's Python code over
tensors, so no fixed kernel holds it. :func:`record` runs it once on a few
CPU rays under a ``TorchFunctionMode`` that sees every torch operation,
and keeps each as an entry of a :class:`Program`: an op code, the
registers of its operands and its result, and its constants (Python
numbers and 0-d tensors). ``x`` and ``y`` are registers 0 and 1, the
constants follow, then the temporaries (a register is reused once its
value is dead). Anything outside the op set below, or that is not
elementwise in (x, y), ends the recording, and the surface keeps its eager
closures: an index or gather (a data surface's spline), ``.item()``, numpy,
a branch on a tensor (``bool()``), a reduction, a tensor from outside the
call on the card or with a derivative, a result that is not f32 or bool.

Each operation is recorded as PyTorch's CUDA kernel computes it, so that
the program gives the eager route's bits on the card:

- a Python number taking part in an f32 operation is rounded to f32 first;
- the division by a Python number is the product with its reciprocal taken
  in f64 and rounded once (the division by a 0-d tensor is not recorded:
  whether the card divides or multiplies then depends on where the tensor
  lives);
- ``x ** e`` takes PyTorch's special cases: 0 a fill of ones, 1 a copy,
  0.5 ``sqrt``, -0.5 ``rsqrt``, -1 ``reciprocal``, 2 ``x * x``, 3
  ``x * x * x``, -2 ``1 / (x * x)`` in f64 rounded once, else ``powf``;
- ``c / x`` for a Python number c is ``reciprocal(x) * c``, as
  ``Tensor.__rtruediv__`` computes it.

A :class:`Program` runs in plain torch two ways: :meth:`Program.replay`
makes the recorded torch calls again (the eager route's bits on any
device), and :func:`evaluate` runs the op codes as the kernel does, with
the value's two partials by forward mode where asked (:func:`normals`).
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
import torch.autograd.forward_ad as fwAD

# op codes: the order is the kernel's enum (csrc/generic_hit.cu)
OPS = ("add", "sub", "mul", "div", "neg", "sqr", "cube", "invsqr", "recip", "sqrt", "rsqrt",
       "pow", "exp", "log", "sin", "cos", "tan", "abs", "where", "gt", "ge", "lt", "le", "eq",
       "ne", "and", "or", "xor", "not", "one", "copy")
OP = {name: i for i, name in enumerate(OPS)}
_UNARY = ("neg", "sqr", "cube", "invsqr", "recip", "sqrt", "rsqrt", "exp", "log", "sin", "cos",
          "tan", "abs", "not", "one", "copy")
_BOOL_OUT = ("gt", "ge", "lt", "le", "eq", "ne", "and", "or", "xor", "not")

MAX_REGS = 64       # the kernel's register file a thread (6 bits an operand)
MAX_OPS = 256       # the kernel's program length (shared memory)


def encode(op: int, dst: int, a: int = 0, b: int = 0, c: int = 0) -> int:
    """One program word: op code in bits 0–4, then the result and three
    operand registers in 6 bits each."""
    return op | dst << 5 | a << 11 | b << 17 | c << 23


def decode(word: int) -> tuple:
    return word & 31, word >> 5 & 63, word >> 11 & 63, word >> 17 & 63, word >> 23 & 63


class Program(NamedTuple):
    """A recorded elementwise function of (x, y).

    ``code``: the words of the kernel's program; ``consts``: the values of
    registers 2, 3, … (f32 numbers); ``out``: the result's register;
    ``n_regs``: registers used; ``calls``: the recorded torch calls,
    ``(func, args, kwargs, slot)``, their tensors replaced by slot numbers
    (:class:`_Slot`), for :meth:`replay`; ``out_slot``: the result's slot."""
    code: tuple
    consts: tuple
    out: int
    n_regs: int
    calls: tuple
    out_slot: int

    def replay(self, x, y):
        """The recorded torch calls again, on ``x`` and ``y`` of any device
        and shape: the eager function's bits."""
        vals = {0: x, 1: y}

        def sub(v):
            if isinstance(v, _Slot):
                return vals[v.k]
            if isinstance(v, (tuple, list)):
                return type(v)(sub(u) for u in v)
            return v
        for func, args, kwargs, slot in self.calls:
            vals[slot] = func(*sub(args), **{k: sub(v) for k, v in kwargs.items()})
        return vals[self.out_slot]


class _Slot(NamedTuple):
    k: int


class _Unrecordable(Exception):
    """Raised inside the recorded call: the function leaves the op set."""


def _fns(*names) -> list:
    roots = {"torch": torch, "Tensor": torch.Tensor, "TensorBase": torch._C.TensorBase}
    out = []
    for n in names:
        root, attr = n.split(".")
        f = getattr(roots[root], attr, None)
        if f is not None:
            out.append(f)
    return out


def _both(*attrs) -> list:
    return _fns(*(f"{r}.{a}" for a in attrs for r in ("torch", "Tensor", "TensorBase")))


_GROUPS = {
    "add": _both("add", "__add__", "__radd__"),
    "sub": _both("sub", "subtract", "__sub__"),
    "rsub": _both("rsub", "__rsub__"),
    "mul": _both("mul", "multiply", "__mul__", "__rmul__"),
    "div": _both("div", "divide", "true_divide", "__truediv__", "__div__"),
    "rdiv": _both("__rtruediv__", "__rdiv__"),
    "neg": _both("neg", "negative", "__neg__"),
    "pow": _both("pow", "__pow__"),
    "square": _both("square"),
    "sqrt": _both("sqrt"), "rsqrt": _both("rsqrt"), "exp": _both("exp"), "log": _both("log"),
    "sin": _both("sin"), "cos": _both("cos"), "tan": _both("tan"),
    "abs": _both("abs", "absolute", "__abs__"), "recip": _both("reciprocal"),
    "where": _both("where"),
    "gt": _both("gt", "greater", "__gt__"), "ge": _both("ge", "greater_equal", "__ge__"),
    "lt": _both("lt", "less", "__lt__"), "le": _both("le", "less_equal", "__le__"),
    "eq": _both("eq", "__eq__"), "ne": _both("ne", "not_equal", "__ne__"),
    "and": _both("logical_and", "__and__", "__rand__"), "or": _both("logical_or", "__or__", "__ror__"),
    "xor": _both("logical_xor", "__xor__", "__rxor__"), "not": _both("logical_not", "__invert__"),
    "to": _both("to"), "float": _both("float"), "same": _both("clone", "contiguous"),
    "as_tensor": _fns("torch.as_tensor"), "full": _fns("torch.full", "torch.tensor", "torch.scalar_tensor"),
}
_TABLE = {f: g for g, fs in _GROUPS.items() for f in fs}
# what a function may ask of a tensor without computing anything
_GETTERS = {torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__, torch.Tensor.device.__get__,
            torch.Tensor.ndim.__get__, torch.Tensor.is_cuda.__get__, torch.Tensor.layout.__get__,
            torch.Tensor.requires_grad.__get__, *_both("dim", "size", "numel", "is_floating_point")}
_NUMBERS = (bool, int, float, np.number, np.bool_)


class _Recorder(TorchFunctionMode):
    """Records the torch calls of one call of a function of (x, y)."""

    def __init__(self, x, y):
        super().__init__()
        self.shape = x.shape
        self.slot = {id(x): 0, id(y): 1}    # tensor id -> slot
        self.kind = {0: "f", 1: "f"}        # slot -> "f" or "b"
        self.const = {}                     # id of a 0-d tensor made inside the call -> value
        self.keep = [x, y]                  # every tensor seen stays alive: ids stay unique
        self.ops = []                       # (op, dst slot, operands): ("s", slot) or ("c", f32 value)
        self.calls = []

    # operands
    def operand(self, v):
        if isinstance(v, torch.Tensor):
            if id(v) in self.slot:
                return "s", self.slot[id(v)]
            if id(v) in self.const:
                return "t", self.const[id(v)]
            # a tensor from outside the call: a number on the CPU only (a
            # tensor on the card may change after the recording; one with a
            # derivative belongs to the eager route)
            if (v.dim() != 0 or v.device.type != "cpu" or v.requires_grad or v.is_complex()
                    or fwAD.unpack_dual(v).tangent is not None):
                raise _Unrecordable(f"a tensor of shape {tuple(v.shape)} on {v.device}")
            self.keep.append(v)
            return "t", float(v.item())
        if isinstance(v, _NUMBERS):
            return "p", float(v)
        raise _Unrecordable(f"an operand of type {type(v).__name__}")

    @staticmethod
    def f32(x: float) -> float:
        with np.errstate(over="ignore"):
            return float(np.float32(x))

    def arg(self, o):
        """An operand in the program: a slot, or a constant rounded to f32."""
        return ("s", o[1]) if o[0] == "s" else ("c", self.f32(o[1]))

    def emit(self, op, operands, out, func, args, kwargs):
        """Registers ``out`` (the real result) as a new slot of ``op``."""
        kind = "b" if op in _BOOL_OUT else "f"
        if op == "where":
            kind = self.kind_of(operands[1])
            if self.kind_of(operands[2]) != kind:
                kind = "f"
        want = torch.bool if kind == "b" else torch.float32
        if not isinstance(out, torch.Tensor) or out.shape != self.shape or out.dtype != want:
            raise _Unrecordable(f"{op} gave {getattr(out, 'dtype', type(out))} "
                                f"{tuple(getattr(out, 'shape', ()))}")
        k = len(self.kind)
        self.slot[id(out)] = k
        self.kind[k] = kind
        self.keep.append(out)
        self.ops.append((OP[op], k, tuple(self.arg(o) for o in operands)))
        if func is not None:
            self.calls.append((func, self.template(args), {n: self.template(v) for n, v in kwargs.items()},
                               k))
        return out

    def kind_of(self, o):
        return self.kind[o[1]] if o[0] == "s" else "f"

    def template(self, v):
        if isinstance(v, torch.Tensor):
            o = self.operand(v)
            return _Slot(o[1]) if o[0] == "s" else o[1]
        if isinstance(v, (tuple, list)):
            return type(v)(self.template(u) for u in v)
        return v

    def alias(self, out, src):
        self.slot[id(out)] = src
        self.keep.append(out)
        return out

    # the mode
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _GETTERS:
            return func(*args, **kwargs)
        group = _TABLE.get(func)
        if group is None or "out" in kwargs:
            raise _Unrecordable(f"{getattr(func, '__name__', func)} is outside the op set")
        if group == "full":
            return self.full(func, args, kwargs)
        ops = [self.operand(a) for a in args if not isinstance(a, (torch.dtype, torch.device))]
        if not any(o[0] == "s" for o in ops):
            raise _Unrecordable(f"{group} of constants alone")
        out = func(*args, **kwargs)
        handler = getattr(self, "g_" + group, None)
        if handler is None:
            return self.plain(group, func, args, kwargs, ops, out)
        return handler(func, args, kwargs, ops, out)

    def full(self, func, args, kwargs):
        if func is torch.full:
            size, value = args[0], args[1]
            if tuple(size) != ():
                raise _Unrecordable("torch.full of a shape")
        else:
            value = args[0]
        if not isinstance(value, _NUMBERS) or isinstance(value, (complex, np.complexfloating)):
            raise _Unrecordable("a factory of something other than a number")
        out = func(*args, **kwargs)
        if out.dim() != 0 or out.is_complex():
            raise _Unrecordable("a factory of a tensor")
        self.const[id(out)] = float(out.item())
        self.keep.append(out)
        return out

    def plain(self, group, func, args, kwargs, ops, out):
        if group in ("add", "sub", "rsub") and kwargs.get("alpha", 1) != 1:
            raise _Unrecordable("add/sub with an alpha")
        if set(kwargs) - {"alpha"}:
            raise _Unrecordable(f"{group} with {sorted(kwargs)}")
        op = {"square": "sqr", "rsub": "sub"}.get(group, group)
        if group == "rsub":
            ops = ops[::-1]
        if op in _UNARY:
            if len(ops) != 1:
                raise _Unrecordable(f"{group} of {len(ops)} operands")
        elif len(ops) != 2:
            raise _Unrecordable(f"{group} of {len(ops)} operands")
        if op in ("and", "or", "xor", "not") and any(self.kind_of(o) != "b" for o in ops):
            raise _Unrecordable(f"{group} of a float")
        return self.emit(op, ops, out, func, args, kwargs)

    def g_div(self, func, args, kwargs, ops, out):
        if kwargs.get("rounding_mode") is not None or set(kwargs) - {"rounding_mode"} or len(ops) != 2:
            raise _Unrecordable("div with a rounding mode")
        a, b = ops
        if b[0] == "s":
            return self.emit("div", ops, out, func, args, kwargs)
        if b[0] != "p":
            raise _Unrecordable("a division by a 0-d tensor")
        # the product with the reciprocal taken in f64 and rounded once
        with np.errstate(divide="ignore"):
            inv = float(np.float64(1.0) / np.float64(b[1]))
        return self.emit("mul", (a, ("p", inv)), out, func, args, kwargs)

    def g_rdiv(self, func, args, kwargs, ops, out):
        # Tensor.__rtruediv__: self.reciprocal() * other
        if kwargs or len(ops) != 2 or ops[0][0] != "s" or ops[1][0] != "p":
            raise _Unrecordable("a reversed division")
        k = len(self.kind)
        self.kind[k] = "f"
        self.ops.append((OP["recip"], k, (("s", ops[0][1]),)))
        self.emit("mul", (("s", k), ops[1]), out, None, (), {})
        # the torch call as it was: reciprocal and product in one
        self.calls.append((func, self.template(args), {}, self.slot[id(out)]))
        return out

    def g_pow(self, func, args, kwargs, ops, out):
        if kwargs or len(ops) != 2 or ops[0][0] != "s" or ops[1][0] != "p":
            raise _Unrecordable("pow of a tensor exponent or a number base")
        e = ops[1][1]
        ef = self.f32(e)
        a = ops[:1]
        if e == 0:
            return self.emit("one", a, out, func, args, kwargs)
        if e == 1:
            return self.emit("copy", a, out, func, args, kwargs)
        special = {0.5: "sqrt", -0.5: "rsqrt", -1.0: "recip"}.get(e) or {2.0: "sqr", 3.0: "cube",
                                                                         -2.0: "invsqr"}.get(ef)
        if special:
            return self.emit(special, a, out, func, args, kwargs)
        return self.emit("pow", (ops[0], ("p", ef)), out, func, args, kwargs)

    def g_where(self, func, args, kwargs, ops, out):
        if kwargs or len(ops) != 3:
            raise _Unrecordable("where of other than three operands")
        if func is torch.where:
            cond, a, b = ops
        else:                                   # Tensor.where(self, condition, other)
            a, cond, b = ops
        if cond[0] != "s" or self.kind_of(cond) != "b":
            raise _Unrecordable("where on a condition that is not a bool tensor")
        return self.emit("where", (cond, a, b), out, func, args, kwargs)

    def _convert(self, arg, dtype, out):
        """``out``, the tensor ``arg`` converted to ``dtype``: the same slot
        where the type stays, else a copy of the 0/1 a bool holds or the
        test v != 0 of a float, replayed as ``Tensor.to``."""
        src = self.slot[id(arg)]
        kind = self.kind[src]
        if dtype is None or dtype == (torch.bool if kind == "b" else torch.float32):
            return self.alias(out, src)
        if dtype not in (torch.float32, torch.bool):
            raise _Unrecordable(f"a conversion to {dtype}")
        operands = (("s", src),) if dtype == torch.float32 else (("s", src), ("p", 0.0))
        return self.emit("copy" if dtype == torch.float32 else "ne", operands, out, torch.Tensor.to,
                         (arg, dtype), {})

    def g_to(self, func, args, kwargs, ops, out):
        dtype = kwargs.get("dtype")
        rest = [a for a in args[1:] if not isinstance(a, torch.dtype)]
        dtypes = [a for a in args[1:] if isinstance(a, torch.dtype)]
        if rest or set(kwargs) - {"dtype"} or len(dtypes) > 1 or ops[0][0] != "s" or len(ops) != 1:
            raise _Unrecordable("to() with more than a dtype")
        return self._convert(args[0], dtypes[0] if dtypes else dtype, out)

    def g_float(self, func, args, kwargs, ops, out):
        if kwargs or len(ops) != 1:
            raise _Unrecordable("float() with arguments")
        return self._convert(args[0], torch.float32, out)

    def g_same(self, func, args, kwargs, ops, out):
        if len(ops) != 1 or (kwargs and set(kwargs) != {"memory_format"}):
            raise _Unrecordable("clone/contiguous with arguments")
        return self.alias(out, ops[0][1])

    def g_as_tensor(self, func, args, kwargs, ops, out):
        if len(args) != 1 or set(kwargs) - {"dtype", "device"} or ops[0][0] != "s":
            raise _Unrecordable("as_tensor with more than a dtype and a device")
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev) != args[0].device:
            raise _Unrecordable("as_tensor to another device")
        return self._convert(args[0], kwargs.get("dtype"), out)


def _assemble(rec: _Recorder, out_slot: int) -> Optional[Program]:
    """Registers for the recorded slots: x, y, the constants (deduplicated
    by their f32 bits), then the temporaries, each freed after its last
    use."""
    consts = {}
    for _, _, operands in rec.ops:
        for o in operands:
            if o[0] == "c":
                key = np.float32(o[1]).view(np.uint32).item()
                consts.setdefault(key, len(consts))
    base = 2 + len(consts)
    last = {}
    for i, (_, _, operands) in enumerate(rec.ops):
        for o in operands:
            if o[0] == "s":
                last[o[1]] = i
    reg = {0: 0, 1: 1}
    free, top, code = [], base, []
    for i, (op, dst, operands) in enumerate(rec.ops):
        regs = []
        for o in operands:
            if o[0] == "s":
                regs.append(reg[o[1]])
            else:
                regs.append(2 + consts[np.float32(o[1]).view(np.uint32).item()])
        for o in operands:
            if o[0] == "s" and o[1] > 1 and last.get(o[1]) == i and o[1] != out_slot and o[1] in reg:
                free.append(reg.pop(o[1]))
        if free:
            r = free.pop()
        else:
            r, top = top, top + 1
        reg[dst] = r
        if dst not in last and dst != out_slot:     # never read: free at once
            free.append(reg.pop(dst))
        code.append(encode(op, r, *regs))
    if top > MAX_REGS or len(code) > MAX_OPS or out_slot not in reg:
        return None
    values = [0.0] * len(consts)
    for key, i in consts.items():
        values[i] = float(np.uint32(key).view(np.float32))
    return Program(tuple(code), tuple(values), reg[out_slot], top, tuple(rec.calls), out_slot)


def record(fn: Callable, kind: str = "f") -> Optional[Program]:
    """``fn(x, y)`` as a :class:`Program` whose result is of ``kind``
    (``"f"``: f32, ``"b"``: bool), or None where the function leaves the
    op set or fails on the CPU. Runs ``fn`` once on four CPU rays."""
    x = torch.tensor([0.3125, -0.7, 0.1, 1.2], dtype=torch.float32)
    y = torch.tensor([-0.4, 0.2, 0.9, -1.1], dtype=torch.float32)
    rec = _Recorder(x, y)
    try:
        with torch.no_grad(), rec:
            res = fn(x, y)
    except Exception:      # outside the op set, or a function that runs on the card only
        return None
    if not isinstance(res, torch.Tensor) or id(res) not in rec.slot:
        return None
    out_slot = rec.slot[id(res)]
    if rec.kind[out_slot] != kind:
        return None
    return _assemble(rec, out_slot)


# ----------------------------------------------------------------------
# the op codes in plain torch: the kernel's arithmetic, with forward mode

def _apply(op: int, a, b, c):
    name = OPS[op]
    if name == "add":
        return a + b
    if name == "sub":
        return a - b
    if name == "mul":
        return a * b
    if name == "div":
        return a / b
    if name == "neg":
        return -a
    if name == "sqr":
        return a * a
    if name == "cube":
        return a * a * a
    if name == "invsqr":
        return (1.0 / (a * a).double()).float()
    if name == "recip":
        return torch.reciprocal(a)
    if name in ("sqrt", "rsqrt", "exp", "log", "sin", "cos", "tan", "abs"):
        return getattr(torch, name)(a)
    if name == "pow":
        return torch.pow(a, b)
    if name == "where":
        return torch.where(a != 0, b, c)
    if name in ("gt", "ge", "lt", "le", "eq", "ne"):
        return getattr(torch, name)(a, b).float()
    if name == "and":
        return ((a != 0) & (b != 0)).float()
    if name == "or":
        return ((a != 0) | (b != 0)).float()
    if name == "xor":
        return ((a != 0) ^ (b != 0)).float()
    if name == "not":
        return (a == 0).float()
    if name == "one":
        return torch.ones_like(a)
    return a.clone()     # copy


def _tangent(op: int, v, a, b, c, ta, tb, tc):
    """The tangent of the result ``v`` of ``op`` from its operands' values
    and tangents, in the kernel's order of operations."""
    name = OPS[op]
    if name == "add":
        return ta + tb
    if name == "sub":
        return ta - tb
    if name == "mul":
        return ta * b + a * tb
    if name == "div":
        return (ta - v * tb) / b
    if name == "neg":
        return -ta
    if name == "sqr":
        return (2.0 * a) * ta
    if name == "cube":
        return (3.0 * (a * a)) * ta
    if name == "invsqr":
        return (-2.0 * v / a) * ta
    if name == "recip":
        return (-(v * v)) * ta
    if name == "sqrt":
        return ta / (v + v)
    if name == "rsqrt":
        return (-0.5 * v * v * v) * ta
    if name == "pow":
        return (b * torch.pow(a, b - 1.0)) * ta
    if name == "exp":
        return v * ta
    if name == "log":
        return ta / a
    if name == "sin":
        return torch.cos(a) * ta
    if name == "cos":
        return (-torch.sin(a)) * ta
    if name == "tan":
        return (1.0 + v * v) * ta
    if name == "abs":
        return torch.sign(a) * ta
    if name == "where":
        return torch.where(a != 0, tb, tc)
    if name == "copy":
        return ta
    return torch.zeros_like(v)


def evaluate(prog: Program, x, y, tangents: bool = False):
    """``prog`` at (x, y) by its op codes, the constants as full tensors of
    f32 (the kernel's registers): the value, and with ``tangents`` its
    partials along x and y by forward mode, ``(v, dv/dx, dv/dy)``."""
    regs = [x, y] + [torch.full_like(x, c) for c in prog.consts]
    regs += [None] * (prog.n_regs - len(regs))
    if tangents:
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        tu = [one, zero] + [zero] * (prog.n_regs - 2)
        tw = [zero, one] + [zero] * (prog.n_regs - 2)
    for word in prog.code:
        op, d, a, b, c = decode(word)
        va, vb, vc = regs[a], regs[b], regs[c]
        v = _apply(op, va, vb, vc)
        if tangents:
            tu[d] = _tangent(op, v, va, vb, vc, tu[a], tu[b], tu[c])
            tw[d] = _tangent(op, v, va, vb, vc, tw[a], tw[b], tw[c])
        regs[d] = v
    if tangents:
        return regs[prog.out], tu[prog.out], tw[prog.out]
    return regs[prog.out]


def normals(prog: Program, x, y):
    """Unit normals (N, 3) of the sag ``prog`` at (x, y) from its partials
    by forward mode, normalized as the kernel does:
    n = (−∂z/∂x, −∂z/∂y, 1) / √(∂z/∂x² + ∂z/∂y² + 1)."""
    _, dx, dy = evaluate(prog, x, y, tangents=True)
    nx, ny = -dx, -dy
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    return torch.stack([nx / norm, ny / norm, 1.0 / norm], dim=-1)
