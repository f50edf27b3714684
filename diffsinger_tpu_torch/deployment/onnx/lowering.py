"""``torch.export`` program -> ONNX graph (opset 17).

The JAX package lowers a jaxpr (``diffsinger_tpu/deployment/onnx/lowering.py``);
the port lowers the FX graph of a ``torch.export`` ``ExportedProgram``:

1. the kernels' custom ops (``ds::fused_conv_module``, ``ds::flash_attention``,
   ``ds::depthwise_conv1d_prelu``, ``ds::wavenet_stack``) are replaced by their plain PyTorch
   versions through ``run_decompositions``: ONNX cannot hold a CUDA kernel,
   as the JAX package's graphs hold no Pallas;
2. everything else is decomposed to core ATen;
3. the graph is lowered node by node: parameters, buffers and constants
   become initializers, the user inputs graph inputs. Nodes whose inputs are
   all known at lowering time (weight views, ``arange``, ``full``, schedule
   tables) are computed here and stored as initializers; an initializer is
   written only where a lowered node reads it;
4. ``torch.ops.higher_order.while_loop`` becomes an ONNX ``Loop`` with a live
   condition and the body as a subgraph that reads the loop's other inputs
   from the enclosing scope, as the JAX package lowers ``lax.while_loop``.

Every op type emitted is in :data:`EMITTED_OPS`, a subset of the JAX
package's audited set (``docs/onnx_ops.md``), on which OpenUTAU's
onnxruntime coverage was judged. A node with no lowering raises
:class:`LoweringError` naming the ATen op. Shapes are static: every FX node
carries its shape and dtype in ``node.meta["val"]``, and the lowering reads
them from there. ATen's type promotion is made explicit with ``Cast``.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .builder import NP_TO_DT, GraphBuilder

aten = torch.ops.aten


class LoweringError(NotImplementedError):
    pass


# the op types this lowering can emit (all in the JAX package's EMITTED_OPS)
EMITTED_OPS = frozenset({
    "Identity", "Cast", "Reshape", "Transpose", "Expand", "Concat", "Slice", "Split", "Pad",
    "Gather", "GatherElements", "ScatterND",
    "Add", "Sub", "Mul", "Div", "Pow", "Max", "Min", "Neg", "Abs", "Sign", "Floor", "Ceil",
    "Round", "Exp", "Log", "Sqrt", "Reciprocal", "Sin", "Cos", "Tanh", "Sigmoid", "Erf",
    "Not", "And", "Or", "Xor", "Mod", "Clip", "Where",
    "Equal", "Less", "LessOrEqual", "Greater", "GreaterOrEqual",
    "ReduceSum", "ReduceMax", "ReduceMin", "ArgMax", "ArgMin", "CumSum",
    "MatMul", "Conv", "ConvTranspose", "Loop",
    "ConstantOfShape", "RandomNormalLike",  # GraphBuilder.internalize_noise
})

# a node whose inputs are all known is computed at lowering time unless its
# output is larger than this and than each of its inputs (an expand of a
# constant stays a node)
FOLD_LIMIT = 1 << 16


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _dt(dtype: torch.dtype) -> int:
    return NP_TO_DT[_np_dtype(dtype)]


class Value:
    """A lowered tensor: its ONNX name (None until a constant is written),
    its dtype and static shape, and its value where it is known."""

    def __init__(self, name: Optional[str], dtype: torch.dtype, shape: Sequence[int],
                 const: Optional[torch.Tensor] = None):
        self.name, self.dtype, self.shape, self.const = name, dtype, tuple(shape), const


class Ctx:
    """One ONNX graph being built (the main graph or a Loop body): the FX node
    -> :class:`Value` map of the FX graph it lowers, and the root builder that
    holds every initializer."""

    def __init__(self, gb: GraphBuilder, root: "Ctx" = None):
        self.gb = gb
        self.root = root or self
        self.env: Dict[Any, Any] = {}
        if root is None:
            self.const_names: Dict[int, tuple] = {}

    def name(self, v: Value) -> str:
        """The ONNX name of ``v``, writing its value as an initializer of the
        main graph the first time a node reads it."""
        if v.name is None:
            key = id(v.const)
            cached = self.root.const_names.get(key)
            if cached is None:
                arr = v.const.detach().cpu().contiguous().numpy()
                cached = (self.root.gb.constant(arr, "init"), v.const)
                self.root.const_names[key] = cached
            v.name = cached[0]
        return v.name

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1, **attrs) -> List[str]:
        return self.gb.add_node(op, inputs, n_out=n_out, **attrs)

    def const(self, value, dtype: torch.dtype) -> str:
        return self.name(Value(None, dtype, np.shape(value),
                               torch.from_numpy(np.array(value, _np_dtype(dtype)))))

    def ints(self, values) -> str:
        return self.const(np.asarray(values, np.int64), torch.int64)

    def cast(self, v: Value, dtype: torch.dtype) -> str:
        if v.dtype == dtype:
            return self.name(v)
        if v.const is not None:
            return self.name(Value(None, dtype, v.shape, v.const.to(dtype)))
        return self.node("Cast", [self.name(v)], to=_dt(dtype))[0]


def _meta(node):
    return node.meta["val"]


def _out(ctx: Ctx, node, name: str) -> Value:
    val = _meta(node)
    return Value(name, val.dtype, val.shape)


def _operand(ctx: Ctx, arg, dtype: torch.dtype) -> str:
    """An ATen argument (a lowered value or a Python number) as an ONNX name of ``dtype``."""
    if isinstance(arg, Value):
        return ctx.cast(arg, dtype)
    return ctx.const(arg, dtype)


def _proxy(arg):
    """A stand-in for ``torch.result_type``: shape rank and dtype decide promotion."""
    if isinstance(arg, Value):
        return torch.zeros((1,) * len(arg.shape) if arg.shape else (), dtype=arg.dtype)
    return arg


def _promoted(a, b) -> torch.dtype:
    """The dtype ATen computes ``a`` (op) ``b`` in."""
    pa = _proxy(a)
    return torch.result_type(pa if isinstance(pa, torch.Tensor) else torch.tensor(pa), _proxy(b))


def _dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


HANDLERS: Dict[Any, Callable] = {}


def register(*targets):
    def deco(fn):
        for t in targets:
            HANDLERS[t] = fn
        return fn
    return deco


# ------------------------------------------------------------- elementwise

_BINARY = {
    aten.add.Tensor: "Add", aten.add.Scalar: "Add", aten.sub.Tensor: "Sub",
    aten.sub.Scalar: "Sub", aten.mul.Tensor: "Mul", aten.mul.Scalar: "Mul",
    aten.div.Tensor: "Div", aten.div.Scalar: "Div", aten.maximum.default: "Max",
    aten.minimum.default: "Min", aten.pow.Tensor_Tensor: "Pow", aten.pow.Scalar: "Pow",
}


@register(*_BINARY)
def _binary(ctx, node, a, b, alpha=1):
    out = _meta(node).dtype
    op = _BINARY[node.target]
    if op == "Pow" and not isinstance(b, Value) and float(b) == 2.0:
        x = _operand(ctx, a, out)
        return ctx.node("Mul", [x, x])
    bn = _operand(ctx, b, out)
    if alpha != 1:
        bn = ctx.node("Mul", [bn, ctx.const(alpha, out)])[0]
    return ctx.node(op, [_operand(ctx, a, out), bn])


@register(aten.pow.Tensor_Scalar)
def _pow(ctx, node, a, exponent):
    out = _meta(node).dtype
    x = _operand(ctx, a, out)
    if float(exponent) == 2.0:
        return ctx.node("Mul", [x, x])
    if float(exponent) == 0.5:
        return ctx.node("Sqrt", [x])
    return ctx.node("Pow", [x, ctx.const(exponent, out)])


@register(aten.div.Tensor_mode)
def _div_mode(ctx, node, a, b, *, rounding_mode=None):
    out = _meta(node).dtype
    x, y = _operand(ctx, a, out), _operand(ctx, b, out)
    if out.is_floating_point:
        q = ctx.node("Div", [x, y])
        if rounding_mode == "floor":
            return ctx.node("Floor", q)
        if rounding_mode is None:
            return q
        raise LoweringError(f"div rounding_mode {rounding_mode!r} on floats")
    q = ctx.node("Div", [x, y])[0]  # ONNX integer Div truncates
    if rounding_mode == "trunc":
        return [q]
    # floor: one less where the remainder is non-zero and the signs differ
    r = ctx.node("Mod", [x, y], fmod=1)[0]
    zero = ctx.const(0, out)
    inexact = ctx.node("Not", ctx.node("Equal", [r, zero]))[0]
    signs = ctx.node("Xor", [ctx.node("Less", [x, zero])[0], ctx.node("Less", [y, zero])[0]])[0]
    fix = ctx.node("And", [inexact, signs])[0]
    return ctx.node("Where", [fix, ctx.node("Sub", [q, ctx.const(1, out)])[0], q])


@register(aten.remainder.Tensor, aten.remainder.Scalar)
def _remainder(ctx, node, a, b):
    """torch's remainder: fmod, then + b where it is non-zero and its sign differs from b's."""
    out = _meta(node).dtype
    x, y = _operand(ctx, a, out), _operand(ctx, b, out)
    r = ctx.node("Mod", [x, y], fmod=1)[0]
    zero = ctx.const(0, out)
    nonzero = ctx.node("Not", ctx.node("Equal", [r, zero]))[0]
    signs = ctx.node("Xor", [ctx.node("Less", [y, zero])[0], ctx.node("Less", [r, zero])[0]])[0]
    fix = ctx.node("And", [nonzero, signs])[0]
    return ctx.node("Where", [fix, ctx.node("Add", [r, y])[0], r])


_UNARY = {
    aten.neg.default: "Neg", aten.abs.default: "Abs", aten.sign.default: "Sign",
    aten.floor.default: "Floor", aten.ceil.default: "Ceil", aten.round.default: "Round",
    aten.exp.default: "Exp", aten.log.default: "Log", aten.sqrt.default: "Sqrt",
    aten.reciprocal.default: "Reciprocal", aten.sin.default: "Sin", aten.cos.default: "Cos",
    aten.tanh.default: "Tanh", aten.sigmoid.default: "Sigmoid", aten.erf.default: "Erf",
}


@register(*_UNARY)
def _unary(ctx, node, a):
    return ctx.node(_UNARY[node.target], [_operand(ctx, a, _meta(node).dtype)])


@register(aten.rsqrt.default)
def _rsqrt(ctx, node, a):
    return ctx.node("Reciprocal", ctx.node("Sqrt", [_operand(ctx, a, _meta(node).dtype)]))


@register(aten.log1p.default)
def _log1p(ctx, node, a):
    """log(1 + x), as the JAX package lowers ``log1p``."""
    dt = _meta(node).dtype
    return ctx.node("Log", ctx.node("Add", [_operand(ctx, a, dt), ctx.const(1, dt)]))


@register(aten.relu.default)
def _relu(ctx, node, a):
    dt = _meta(node).dtype
    return ctx.node("Max", [_operand(ctx, a, dt), ctx.const(0, dt)])


@register(aten.gelu.default)
def _gelu(ctx, node, a, approximate="none"):
    """Exact GELU as torch computes it: x * 0.5 * (1 + erf(x / sqrt(2)))."""
    if approximate != "none":
        raise LoweringError(f"gelu approximate={approximate!r}")
    dt = _meta(node).dtype
    x = _operand(ctx, a, dt)
    erf = ctx.node("Erf", ctx.node("Mul", [x, ctx.const(math.sqrt(0.5), dt)]))[0]
    half_x = ctx.node("Mul", [x, ctx.const(0.5, dt)])[0]
    return ctx.node("Mul", [half_x, ctx.node("Add", [erf, ctx.const(1, dt)])[0]])


@register(aten.leaky_relu.default)
def _leaky_relu(ctx, node, a, slope=0.01):
    dt = _meta(node).dtype
    x = _operand(ctx, a, dt)
    pos = ctx.node("Greater", [x, ctx.const(0, dt)])[0]
    return ctx.node("Where", [pos, x, ctx.node("Mul", [x, ctx.const(slope, dt)])[0]])


_CMP = {"eq": "Equal", "ne": "Equal", "lt": "Less", "le": "LessOrEqual",
        "gt": "Greater", "ge": "GreaterOrEqual"}


def _cmp_handler(kind):
    def handler(ctx, node, a, b):
        dt = _promoted(a, b)
        out = ctx.node(_CMP[kind], [_operand(ctx, a, dt), _operand(ctx, b, dt)])
        return ctx.node("Not", out) if kind == "ne" else out
    return handler


for _kind in _CMP:
    for _overload in ("Tensor", "Scalar"):
        HANDLERS[getattr(getattr(aten, _kind), _overload)] = _cmp_handler(_kind)


_LOGIC = {aten.bitwise_and.Tensor: "And", aten.logical_and.default: "And",
          aten.bitwise_or.Tensor: "Or", aten.logical_or.default: "Or",
          aten.bitwise_xor.Tensor: "Xor", aten.logical_xor.default: "Xor"}


@register(*_LOGIC)
def _logic(ctx, node, a, b):
    if _meta(node).dtype != torch.bool:
        raise LoweringError(f"{node.target} on {_meta(node).dtype} (bool only)")
    return ctx.node(_LOGIC[node.target], [_operand(ctx, a, torch.bool),
                                          _operand(ctx, b, torch.bool)])


@register(aten.bitwise_not.default, aten.logical_not.default)
def _not(ctx, node, a):
    if isinstance(a, Value) and a.dtype != torch.bool and node.target == aten.bitwise_not.default:
        raise LoweringError(f"bitwise_not on {a.dtype} (bool only)")
    return ctx.node("Not", [_operand(ctx, a, torch.bool)])


@register(aten.where.self)
def _where(ctx, node, cond, a, b):
    dt = _meta(node).dtype
    return ctx.node("Where", [_operand(ctx, cond, torch.bool), _operand(ctx, a, dt),
                              _operand(ctx, b, dt)])


@register(aten.clamp.default)
def _clamp(ctx, node, a, lo=None, hi=None):
    dt = _meta(node).dtype
    x = _operand(ctx, a, dt)
    # both bounds given: an absent one is the dtype's end of the range
    info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
    lo = (-math.inf if dt.is_floating_point else info.min) if lo is None else lo
    hi = (math.inf if dt.is_floating_point else info.max) if hi is None else hi
    return ctx.node("Clip", [x, ctx.const(lo, dt), ctx.const(hi, dt)])


# ------------------------------------------------------------- copies, casts

@register(aten._to_copy.default)
def _to_copy(ctx, node, a, **kwargs):
    return [ctx.cast(a, _meta(node).dtype)]


@register(aten.clone.default, aten.alias.default)
def _identity(ctx, node, a, **kwargs):
    return ctx.node("Identity", [ctx.name(a)])


@register(aten.full.default, aten.full_like.default, aten.zeros_like.default,
          aten.ones_like.default)
def _full(ctx, node, *args, **kwargs):
    """A filled tensor too large to store: its value expanded to its shape."""
    val = _meta(node)
    fill = {aten.full.default: args[1] if len(args) > 1 else None,
            aten.full_like.default: args[1] if len(args) > 1 else None,
            aten.zeros_like.default: 0, aten.ones_like.default: 1}[node.target]
    return ctx.node("Expand", [ctx.const(fill, val.dtype), ctx.ints(val.shape)])


# ------------------------------------------------------------- shapes

@register(aten.view.default, aten._unsafe_view.default, aten.reshape.default,
          aten.squeeze.dims, aten.squeeze.dim, aten.squeeze.default, aten.unsqueeze.default)
def _reshape(ctx, node, a, *args):
    return ctx.node("Reshape", [ctx.name(a), ctx.ints(_meta(node).shape)])


@register(aten.permute.default)
def _permute(ctx, node, a, dims):
    rank = len(a.shape)
    return ctx.node("Transpose", [ctx.name(a)], perm=[_dim(d, rank) for d in dims])


@register(aten.expand.default)
def _expand(ctx, node, a, size, implicit=False):
    return ctx.node("Expand", [ctx.name(a), ctx.ints(_meta(node).shape)])


@register(aten.slice.Tensor)
def _slice(ctx, node, a, dim=0, start=None, end=None, step=1):
    rank = len(a.shape)
    d = _dim(dim, rank)
    n = a.shape[d]
    start = 0 if start is None else (start + n if start < 0 else start)
    end = n if end is None else (end + n if end < 0 else end)
    start, end = min(max(start, 0), n), min(max(end, 0), n)
    return ctx.node("Slice", [ctx.name(a), ctx.ints([start]), ctx.ints([end]), ctx.ints([d]),
                              ctx.ints([step])])


@register(aten.flip.default)
def _flip(ctx, node, a, dims):
    axes = [_dim(d, len(a.shape)) for d in dims]
    return ctx.node("Slice", [ctx.name(a), ctx.ints([a.shape[d] - 1 for d in axes]),
                              ctx.ints([-a.shape[d] - 1 for d in axes]), ctx.ints(axes),
                              ctx.ints([-1] * len(axes))])


@register(aten.select.int)
def _select(ctx, node, a, dim, index):
    d = _dim(dim, len(a.shape))
    index = index + a.shape[d] if index < 0 else index
    return ctx.node("Gather", [ctx.name(a), ctx.const(np.int64(index), torch.int64)], axis=d)


@register(aten.cat.default)
def _cat(ctx, node, tensors, dim=0):
    val = _meta(node)
    return ctx.node("Concat", [_operand(ctx, t, val.dtype) for t in tensors],
                    axis=_dim(dim, len(val.shape)))


@register(aten.split_with_sizes.default)
def _split_sizes(ctx, node, a, sizes, dim=0):
    d = _dim(dim, len(a.shape))
    return [tuple(ctx.node("Split", [ctx.name(a), ctx.ints(sizes)], n_out=len(sizes), axis=d))]


@register(aten.constant_pad_nd.default)
def _pad(ctx, node, a, pad, value=0):
    rank = len(a.shape)
    if any(p < 0 for p in pad):
        raise LoweringError("constant_pad_nd with negative padding")
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):  # torch lists the last axis first
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    return ctx.node("Pad", [ctx.name(a), ctx.ints(begins + ends), ctx.const(value, a.dtype)])


# ------------------------------------------------------------- indexing

@register(aten.embedding.default)
def _embedding(ctx, node, weight, indices, *args):
    return ctx.node("Gather", [ctx.name(weight), ctx.name(indices)], axis=0)


@register(aten.index.Tensor)
def _index(ctx, node, a, indices):
    used = [(d, i) for d, i in enumerate(indices) if i is not None]
    if len(used) != 1:
        raise LoweringError("aten.index.Tensor with more than one index tensor")
    d, idx = used[0]
    return ctx.node("Gather", [ctx.name(a), ctx.name(idx)], axis=d)


@register(aten.gather.default)
def _gather(ctx, node, a, dim, index, sparse_grad=False):
    return ctx.node("GatherElements", [ctx.name(a), ctx.name(index)],
                    axis=_dim(dim, len(a.shape)))


@register(aten.scatter_add.default)
def _scatter_add(ctx, node, a, dim, index, src):
    """ScatterND with reduction 'add': the coordinates of every other axis are
    constants of the index's static shape, the scattered axis is the index."""
    rank = len(index.shape)
    d = _dim(dim, rank)
    coords = []
    for axis in range(rank):
        if axis == d:
            coords.append(ctx.node("Reshape", [ctx.cast(index, torch.int64),
                                               ctx.ints(index.shape + (1,))])[0])
        else:
            grid = np.broadcast_to(
                np.arange(index.shape[axis], dtype=np.int64).reshape(
                    [-1 if k == axis else 1 for k in range(rank)]), index.shape)
            coords.append(ctx.const(grid[..., None], torch.int64))
    idx = ctx.node("Concat", coords, axis=rank)[0]
    upd = ctx.cast(src, a.dtype)
    if tuple(src.shape) != tuple(index.shape):
        upd = ctx.node("Slice", [upd, ctx.ints([0] * rank), ctx.ints(index.shape),
                                 ctx.ints(list(range(rank)))])[0]
    return ctx.node("ScatterND", [ctx.name(a), idx, upd], reduction="add")


@register(aten.searchsorted.Tensor)
def _searchsorted(ctx, node, seq, values, *, out_int32=False, right=False, side=None,
                  sorter=None):
    """The insertion index of each value: how many entries of the sorted row
    are below it (``right``: not above it), a broadcast compare summed over
    the row, as the JAX package lowers ``length_regulator``'s count."""
    if sorter is not None:
        raise LoweringError("searchsorted with a sorter")
    right = right or side == "right"
    dt = _promoted(seq, values)
    s = ctx.node("Reshape", [_operand(ctx, seq, dt),
                             ctx.ints(seq.shape[:-1] + (1, seq.shape[-1]))])[0]
    v = ctx.node("Reshape", [_operand(ctx, values, dt), ctx.ints(values.shape + (1,))])[0]
    hit = ctx.node("LessOrEqual" if right else "Less", [s, v])[0]
    count = ctx.node("Cast", [hit], to=_dt(torch.int64))[0]
    count = _reduce(ctx, "ReduceSum", count, [len(values.shape)], False)[0]
    return [ctx.cast(Value(count, torch.int64, values.shape), _meta(node).dtype)]


# ------------------------------------------------------------- reductions

def _axes(dims, rank):
    if dims is None or len(dims) == 0:
        return list(range(rank))
    return [_dim(d, rank) for d in dims]


def _reduce(ctx, op, x, axes, keepdim):
    if op == "ReduceSum":  # opset 17: only ReduceSum takes the axes as an input
        return ctx.node(op, [x, ctx.ints(axes)], keepdims=int(keepdim))
    return ctx.node(op, [x], axes=axes, keepdims=int(keepdim))


@register(aten.sum.dim_IntList, aten.sum.default)
def _sum(ctx, node, a, dims=None, keepdim=False, *, dtype=None):
    return _reduce(ctx, "ReduceSum", ctx.cast(a, _meta(node).dtype), _axes(dims, len(a.shape)),
                   keepdim)


@register(aten.mean.dim, aten.mean.default)
def _mean(ctx, node, a, dims=None, keepdim=False, *, dtype=None):
    dt = _meta(node).dtype
    axes = _axes(dims, len(a.shape))
    total = _reduce(ctx, "ReduceSum", ctx.cast(a, dt), axes, keepdim)[0]
    return ctx.node("Div", [total, ctx.const(math.prod(a.shape[i] for i in axes), dt)])


@register(aten.amax.default, aten.amin.default)
def _amax(ctx, node, a, dims=(), keepdim=False):
    op = "ReduceMax" if node.target == aten.amax.default else "ReduceMin"
    return _reduce(ctx, op, ctx.name(a), _axes(dims, len(a.shape)), keepdim)


@register(aten.argmax.default, aten.argmin.default)
def _argmax(ctx, node, a, dim=None, keepdim=False):
    if dim is None:
        raise LoweringError(f"{node.target} without dim")
    op = "ArgMax" if node.target == aten.argmax.default else "ArgMin"
    return ctx.node(op, [ctx.name(a)], axis=_dim(dim, len(a.shape)), keepdims=int(keepdim))


@register(aten.cumsum.default)
def _cumsum(ctx, node, a, dim, *, dtype=None):
    return ctx.node("CumSum", [ctx.cast(a, _meta(node).dtype),
                               ctx.const(np.int64(_dim(dim, len(a.shape))), torch.int64)])


@register(aten._softmax.default)
def _softmax(ctx, node, a, dim, half_to_float=False):
    dt = _meta(node).dtype
    x = ctx.cast(a, dt)
    axes = [_dim(dim, len(a.shape))]
    m = _reduce(ctx, "ReduceMax", x, axes, True)[0]
    e = ctx.node("Exp", ctx.node("Sub", [x, m]))[0]
    return ctx.node("Div", [e, _reduce(ctx, "ReduceSum", e, axes, True)[0]])


@register(aten.native_layer_norm.default)
def _layer_norm(ctx, node, a, normalized_shape, weight, bias, eps):
    dt = a.dtype
    rank = len(a.shape)
    axes = list(range(rank - len(normalized_shape), rank))
    n = ctx.const(math.prod(normalized_shape), dt)
    x = ctx.name(a)
    mean = ctx.node("Div", [_reduce(ctx, "ReduceSum", x, axes, True)[0], n])[0]
    xc = ctx.node("Sub", [x, mean])[0]
    var = ctx.node("Div", [_reduce(ctx, "ReduceSum", ctx.node("Mul", [xc, xc])[0], axes,
                                   True)[0], n])[0]
    rstd = ctx.node("Reciprocal", ctx.node("Sqrt", [ctx.node("Add", [var, ctx.const(eps, dt)])[0]]))[0]
    y = ctx.node("Mul", [xc, rstd])[0]
    if weight is not None:
        y = ctx.node("Mul", [y, ctx.name(weight)])[0]
    if bias is not None:
        y = ctx.node("Add", [y, ctx.name(bias)])[0]
    return [(y, mean, rstd)]


# ------------------------------------------------------------- products, convolutions

@register(aten.mm.default, aten.bmm.default, aten.matmul.default)
def _mm(ctx, node, a, b):
    return ctx.node("MatMul", [ctx.name(a), ctx.name(b)])


@register(aten.addmm.default)
def _addmm(ctx, node, bias, a, b, *, beta=1, alpha=1):
    dt = _meta(node).dtype
    prod = ctx.node("MatMul", [ctx.name(a), ctx.name(b)])[0]
    if alpha != 1:
        prod = ctx.node("Mul", [prod, ctx.const(alpha, dt)])[0]
    c = _operand(ctx, bias, dt)
    if beta != 1:
        c = ctx.node("Mul", [c, ctx.const(beta, dt)])[0]
    return ctx.node("Add", [c, prod])


@register(aten.convolution.default)
def _convolution(ctx, node, x, w, b, stride, padding, dilation, transposed, output_padding,
                 groups):
    n_sp = len(x.shape) - 2
    inputs = [ctx.name(x), ctx.name(w)] + ([ctx.name(b)] if b is not None else [])
    attrs = dict(strides=list(stride), pads=list(padding) * 2, dilations=list(dilation),
                 group=int(groups), kernel_shape=list(w.shape[2:]))
    if len(attrs["strides"]) != n_sp:
        raise LoweringError("convolution with broadcast stride")
    if transposed:
        if any(output_padding):
            raise LoweringError("transposed convolution with output_padding")
        return ctx.node("ConvTranspose", inputs, **attrs)
    return ctx.node("Conv", inputs, **attrs)


# ------------------------------------------------------------- control flow

def lower_graph(ctx: Ctx, gm: torch.fx.GraphModule, inputs: Sequence[Value]) -> List[Value]:
    """Lower ``gm`` into ``ctx`` with its placeholders bound to ``inputs``;
    returns its outputs."""
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != len(inputs):
        raise LoweringError(f"{len(placeholders)} placeholders, {len(inputs)} inputs")
    for n, v in zip(placeholders, inputs):
        ctx.env[n] = v
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            outs = node.args[0]
            return [ctx.env[o] for o in (outs if isinstance(outs, (tuple, list)) else [outs])]
        if node.op == "get_attr":
            ctx.env[node] = getattr(gm, node.target)
            continue
        if node.op != "call_function":
            raise LoweringError(f"FX node {node.op} {node.target}")
        lower_node(ctx, node)
    raise LoweringError("graph without output")


def _while_loop(ctx: Ctx, node, cond_gm, body_gm, carried, additional, **kwargs):
    """``while_loop`` -> ``Loop`` with a live condition and no trip count: the
    condition is lowered once in the enclosing graph on the initial carry and
    once in the body on the new carry; the body reads ``additional`` (the
    captured tensors) from the enclosing scope."""
    carried = list(carried)
    init_cond = lower_graph(Ctx(ctx.gb, ctx.root), cond_gm, carried + list(additional))[0]
    body_name = ctx.gb.fresh("while_body")
    body = GraphBuilder(body_name, prefix=body_name + "/")
    bctx = Ctx(body, ctx.root)
    body.add_input(body.fresh("iter"), np.int64, ())
    body.add_input(body.fresh("cond_in"), np.bool_, ())
    carry_in = []
    for v in carried:
        name = body.fresh("carry_in")
        body.add_input(name, _np_dtype(v.dtype), v.shape)
        carry_in.append(Value(name, v.dtype, v.shape))
    new_carry = lower_graph(bctx, body_gm, carry_in + list(additional))
    cond_next = lower_graph(Ctx(body, ctx.root), cond_gm, new_carry + list(additional))[0]
    body.outputs = []
    out = bctx.node("Identity", [bctx.cast(cond_next, torch.bool)])[0]
    body.add_output(out, np.bool_, ())
    for v, old in zip(new_carry, carried):
        out = bctx.node("Identity", [bctx.cast(v, old.dtype)])[0]
        body.add_output(out, _np_dtype(old.dtype), old.shape)
    names = ctx.node("Loop", ["", ctx.cast(init_cond, torch.bool)]
                     + [ctx.name(v) for v in carried], n_out=len(carried), body=body)
    return [tuple(names)]


HANDLERS[torch.ops.higher_order.while_loop] = _while_loop

# nodes that check metadata and compute nothing
_SKIP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default,
         aten.sym_constrain_range_for_size.default}


def _known(arg):
    return not isinstance(arg, Value) or arg.const is not None


def _fold_args(arg):
    if isinstance(arg, Value):
        return arg.const
    if isinstance(arg, (list, tuple)):
        return type(arg)(_fold_args(a) for a in arg)
    return arg


def _fold(ctx: Ctx, node, args, kwargs) -> bool:
    """Compute ``node`` here when every input is known and the result is not
    much larger than its inputs; binds its value and returns True if so."""
    flat = [a for a in list(args) + list(kwargs.values())
            for a in (a if isinstance(a, (list, tuple)) else [a])]
    if not all(_known(a) for a in flat) or node.target == torch.ops.higher_order.while_loop:
        return False
    val = _meta(node)
    if not isinstance(val, torch.Tensor):
        return False
    sizes = [a.const.numel() for a in flat if isinstance(a, Value)]
    if val.numel() > max([FOLD_LIMIT] + sizes):
        return False
    kwargs = {k: v for k, v in kwargs.items() if k not in ("device", "pin_memory")}
    if "device" in node.kwargs:
        kwargs["device"] = "cpu"
    with torch.no_grad():
        result = node.target(*_fold_args(list(args)), **_fold_args(kwargs))
    ctx.env[node] = Value(None, result.dtype, result.shape, result)
    return True


def _bind(ctx: Ctx, arg):
    if isinstance(arg, torch.fx.Node):
        return ctx.env[arg]
    if isinstance(arg, (list, tuple)):
        return type(arg)(_bind(ctx, a) for a in arg)
    return arg


def lower_node(ctx: Ctx, node) -> None:
    args = _bind(ctx, node.args)
    kwargs = {k: _bind(ctx, v) for k, v in node.kwargs.items()}
    if node.target in _SKIP:
        return
    if node.target is operator.getitem:
        src, i = args
        ctx.env[node] = src[i] if isinstance(src, (list, tuple)) else src
        return
    if _fold(ctx, node, args, kwargs):
        return
    handler = HANDLERS.get(node.target)
    if handler is None:
        raise LoweringError(f"no ONNX lowering for ATen op '{node.target}'")
    outs = handler(ctx, node, *args, **kwargs)
    val = _meta(node)
    if isinstance(val, (list, tuple)):
        names = outs[0]
        ctx.env[node] = tuple(Value(n, v.dtype, v.shape) for n, v in zip(names, val))
    else:
        ctx.env[node] = _out(ctx, node, outs[0])


# ------------------------------------------------------------- driver

def plain_decompositions() -> dict:
    """The default core-ATen table, with each kernel's custom op replaced by
    its plain PyTorch version, which takes the op's arguments as they are
    (K1's and K2's ``activation`` included: SiLU decomposes to a product
    with a sigmoid, ReLU to a maximum)."""
    from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused, wavenet_block

    table = torch.export.default_decompositions()
    table[torch.ops.ds.fused_conv_module.default] = lynx_fused.fused_conv_module_plain
    table[torch.ops.ds.depthwise_conv1d_prelu.default] = depthwise_conv.depthwise_conv1d_prelu_plain
    table[torch.ops.ds.flash_attention.default] = (
        lambda q, k, v, mask, sm_scale: flash_attention.flash_attention_plain(
            q, k, v, mask, sm_scale=sm_scale))
    table[torch.ops.ds.wavenet_stack.default] = wavenet_block.residual_stack_plain
    return table


def lower_program(ep, *, name: str, input_names: Sequence[str],
                  output_names: Sequence[str]) -> GraphBuilder:
    """Lower an ``ExportedProgram`` to an ONNX :class:`GraphBuilder`.

    ``input_names`` name the program's user inputs in order, ``output_names``
    its outputs. The program is decomposed first (:func:`plain_decompositions`).
    """
    ep = ep.run_decompositions(plain_decompositions())
    sig = ep.graph_signature
    gb = GraphBuilder(name)
    ctx = Ctx(gb)
    known = {**ep.state_dict, **ep.constants}
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    user = iter(input_names)
    inputs = []
    for node, spec in zip(placeholders, sig.input_specs):
        val = _meta(node)
        if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
            iname = next(user)
            gb.add_input(iname, _np_dtype(val.dtype), tuple(val.shape))
            inputs.append(Value(iname, val.dtype, val.shape))
        else:
            t = known[spec.target].detach().cpu()
            inputs.append(Value(None, t.dtype, t.shape, t))
    if next(user, None) is not None:
        raise ValueError("more input names than the program's user inputs")
    outs = lower_graph(ctx, ep.graph_module, inputs)
    if len(outs) != len(output_names):
        raise ValueError(f"{len(outs)} outputs, {len(output_names)} names given")
    for v, oname in zip(outs, output_names):
        gb.add_node("Identity", [ctx.name(v)], outputs=[oname])
        gb.add_output(oname, _np_dtype(v.dtype), v.shape)
    return gb
