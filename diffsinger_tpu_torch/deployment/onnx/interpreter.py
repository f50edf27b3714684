"""Numpy evaluator for the ONNX op subset emitted by lowering.py.

onnx/onnxruntime are not installed in this environment, so emitted models are
validated by parsing the serialized bytes (builder.parse_model — which also
exercises the wire format) and executing them with numpy against the eager
outputs of the program they were lowered from. Supports subgraph scoping (Loop/If with outer-scope captures),
the conv/conv-transpose family via tap loops, and RandomNormalLike for the
noise prelude the exporters prepend.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .builder import DT_TO_NP, Graph, Node, parse_model


class Scope:
    def __init__(self, values: Dict[str, np.ndarray], parent: Optional["Scope"] = None):
        self.values = values
        self.parent = parent

    def get(self, name: str) -> np.ndarray:
        s = self
        while s is not None:
            if name in s.values:
                return s.values[name]
            s = s.parent
        raise KeyError(name)

    def set(self, name: str, value):
        self.values[name] = value


def _conv_core(x, w, strides, pads, dilations, group):
    """x [N, C, *S], w [O, C/g, *K] -> [N, O, *S_out]; direct tap loop."""
    n_sp = x.ndim - 2
    pad_width = [(0, 0), (0, 0)] + [(pads[i], pads[n_sp + i]) for i in range(n_sp)]
    xp = np.pad(x, pad_width)
    N, C = x.shape[:2]
    O = w.shape[0]
    K = w.shape[2:]
    S = xp.shape[2:]
    out_sp = [
        (S[i] - ((K[i] - 1) * dilations[i] + 1)) // strides[i] + 1 for i in range(n_sp)
    ]
    xg = xp.reshape(N, group, C // group, *S)
    wg = w.reshape(group, O // group, C // group, *K)
    y = np.zeros((N, group, O // group, *out_sp), dtype=np.result_type(x, w))
    if n_sp == 1:
        for t in range(K[0]):
            sl = xg[:, :, :, t * dilations[0]: t * dilations[0] + out_sp[0] * strides[0]: strides[0]]
            y += np.einsum("ngct,goc->ngot", sl, wg[:, :, :, t])
    elif n_sp == 2:
        for ti in range(K[0]):
            for tj in range(K[1]):
                sl = xg[:, :, :,
                        ti * dilations[0]: ti * dilations[0] + out_sp[0] * strides[0]: strides[0],
                        tj * dilations[1]: tj * dilations[1] + out_sp[1] * strides[1]: strides[1]]
                y += np.einsum("ngchw,goc->ngohw", sl, wg[:, :, :, ti, tj])
    else:  # pragma: no cover
        raise NotImplementedError(f"{n_sp}-D conv")
    return y.reshape(N, O, *out_sp)


def _conv_transpose(x, w, strides, pads, dilations, group):
    """w [C, O/g, *K] (ONNX ConvTranspose layout)."""
    n_sp = x.ndim - 2
    K = w.shape[2:]
    ke = [(K[i] - 1) * dilations[i] + 1 for i in range(n_sp)]
    # zero-stuff the input by stride
    N, C = x.shape[:2]
    S = x.shape[2:]
    up_shape = [N, C] + [(S[i] - 1) * strides[i] + 1 for i in range(n_sp)]
    up = np.zeros(up_shape, x.dtype)
    sl = tuple([slice(None), slice(None)] + [slice(None, None, strides[i]) for i in range(n_sp)])
    up[sl] = x
    # flip kernel spatially, swap C<->O: conv weight [O, C/g, *K]
    wf = w
    for i in range(n_sp):
        wf = np.flip(wf, axis=2 + i)
    # [C, O/g, *K] -> per group [g, C/g, O/g, *K] -> [g, O/g, C/g, *K]
    wf = wf.reshape(group, C // group, *wf.shape[1:])
    wf = np.swapaxes(wf, 1, 2)
    wf = wf.reshape(group * wf.shape[1], C // group, *K)
    new_pads = [ke[i] - 1 - pads[i] for i in range(n_sp)] + \
               [ke[i] - 1 - pads[n_sp + i] for i in range(n_sp)]
    if any(p < 0 for p in new_pads):  # pragma: no cover
        raise NotImplementedError("conv_transpose over-padding")
    return _conv_core(up, wf, [1] * n_sp, new_pads, dilations, group)


class Interpreter:
    def __init__(self, graph: Graph, rng_seed: int = 0):
        self.graph = graph
        self.rng = np.random.default_rng(rng_seed)

    def run(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        scope = Scope(dict(self.graph.initializers))
        for k, v in inputs.items():
            scope.set(k, np.asarray(v))
        self._run_nodes(self.graph.nodes, scope)
        return [scope.get(o) for o in self.graph.outputs]

    # ------------------------------------------------------------------
    def _run_nodes(self, nodes: List[Node], scope: Scope):
        for node in nodes:
            outs = self._op(node, scope)
            for name, val in zip(node.outputs, outs):
                if name:
                    scope.set(name, val)

    def _op(self, node: Node, scope: Scope):
        get = scope.get
        op = node.op_type
        a = node.attrs
        x = [get(i) if i else None for i in node.inputs]

        if op == "Identity":
            return [x[0]]
        if op in ("Add", "Sub", "Mul", "Div", "Pow"):
            # ONNX integer Div truncates toward zero (C semantics), not floor
            f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                 "Div": lambda p, q: (p / q if np.issubdtype(np.result_type(p, q), np.floating)
                                      else (np.abs(p) // np.abs(q) * np.sign(p) * np.sign(q))
                                      .astype(np.result_type(p, q))),
                 "Pow": np.power}[op]
            return [f(x[0], x[1])]
        if op == "Max":
            out = x[0]
            for v in x[1:]:
                out = np.maximum(out, v)
            return [out]
        if op == "Min":
            out = x[0]
            for v in x[1:]:
                out = np.minimum(out, v)
            return [out]
        if op == "Neg":
            return [-x[0]]
        if op == "Sign":
            return [np.sign(x[0])]
        if op == "Abs":
            return [np.abs(x[0])]
        if op in ("Floor", "Ceil"):
            return [getattr(np, op.lower())(x[0])]
        if op == "Round":
            return [np.round(x[0])]  # nearest-even, matches ONNX
        if op in ("Exp", "Log", "Tanh", "Sin", "Cos", "Sqrt"):
            return [getattr(np, op.lower())(x[0])]
        if op == "Atan":
            return [np.arctan(x[0])]
        if op == "Reciprocal":
            return [1.0 / x[0]]
        if op == "Sigmoid":
            return [1.0 / (1.0 + np.exp(-x[0]))]
        if op == "Erf":
            from scipy.special import erf as _erf

            return [_erf(x[0]).astype(x[0].dtype)]
        if op == "Not":
            return [~x[0]]
        if op in ("And", "Or", "Xor"):
            f = {"And": np.logical_and, "Or": np.logical_or, "Xor": np.logical_xor}[op]
            return [f(x[0], x[1])]
        if op == "Mod":
            if a.get("fmod"):
                return [np.fmod(x[0], x[1])]
            return [np.mod(x[0], x[1])]
        if op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None else -np.inf
            hi = x[2] if len(x) > 2 and x[2] is not None else np.inf
            return [np.clip(x[0], lo, hi)]
        if op == "Where":
            return [np.where(x[0], x[1], x[2])]
        if op in ("Equal", "Less", "LessOrEqual", "Greater", "GreaterOrEqual"):
            f = {"Equal": np.equal, "Less": np.less, "LessOrEqual": np.less_equal,
                 "Greater": np.greater, "GreaterOrEqual": np.greater_equal}[op]
            return [f(x[0], x[1])]
        if op == "Cast":
            return [x[0].astype(DT_TO_NP[a["to"]])]
        if op == "Reshape":
            return [x[0].reshape([int(d) for d in x[1]])]
        if op == "Transpose":
            return [np.transpose(x[0], a.get("perm"))]
        if op == "Expand":
            return [np.broadcast_to(x[0], [int(d) for d in x[1]]).copy()]
        if op == "Concat":
            return [np.concatenate(x, axis=a["axis"])]
        if op == "Slice":
            data = x[0]
            starts, ends = np.atleast_1d(x[1]), np.atleast_1d(x[2])
            axes = np.atleast_1d(x[3]) if len(x) > 3 and x[3] is not None else np.arange(len(starts))
            steps = np.atleast_1d(x[4]) if len(x) > 4 and x[4] is not None else np.ones(len(starts), np.int64)
            sl = [slice(None)] * data.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                s, e, ax, st = int(s), int(e), int(ax), int(st)
                dim = data.shape[ax]
                # ONNX clamping semantics
                if st > 0:
                    s = min(max(s, -dim), dim) % dim if -dim <= s < 0 else min(s, dim)
                    e = min(max(e, -dim), dim) % dim if -dim <= e < 0 else min(e, dim)
                    sl[ax] = slice(s, e, st)
                else:
                    s = s % dim if -dim <= s < 0 else min(s, dim - 1)
                    e = None if e < -dim else (e % dim if e < 0 else min(e, dim))
                    sl[ax] = slice(s, e, st)
            return [data[tuple(sl)]]
        if op == "Pad":
            pads = np.asarray(x[1], np.int64)
            value = x[2] if len(x) > 2 and x[2] is not None else 0
            n = x[0].ndim
            pw = [(int(pads[i]), int(pads[n + i])) for i in range(n)]
            return [np.pad(x[0], pw, constant_values=value)]
        if op == "Gather":
            return [np.take(x[0], x[1].astype(np.int64), axis=a.get("axis", 0))]
        if op == "GatherElements":
            return [np.take_along_axis(x[0], x[1].astype(np.int64), axis=a.get("axis", 0))]
        if op == "MatMul":
            return [np.matmul(x[0], x[1])]
        if op == "Einsum":
            return [np.einsum(a["equation"], *x)]
        if op == "Conv":
            n_sp = x[0].ndim - 2
            return [_conv_core(
                x[0], x[1],
                a.get("strides", [1] * n_sp), a.get("pads", [0] * 2 * n_sp),
                a.get("dilations", [1] * n_sp), a.get("group", 1),
            ) + (x[2].reshape(1, -1, *([1] * n_sp)) if len(x) > 2 and x[2] is not None else 0)]
        if op == "ConvTranspose":
            n_sp = x[0].ndim - 2
            y = _conv_transpose(
                x[0], x[1],
                a.get("strides", [1] * n_sp), a.get("pads", [0] * 2 * n_sp),
                a.get("dilations", [1] * n_sp), a.get("group", 1),
            )
            if len(x) > 2 and x[2] is not None:
                y = y + x[2].reshape(1, -1, *([1] * n_sp))
            return [y]
        if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
            f = {"ReduceSum": np.sum, "ReduceMax": np.max,
                 "ReduceMin": np.min, "ReduceProd": np.prod}[op]
            # opset 17: ReduceSum takes axes as input #2; Max/Min/Prod carry
            # the `axes` attribute (input form only arrives in opset 18)
            if len(x) > 1 and x[1] is not None:
                axes = tuple(int(v) for v in x[1])
            elif a.get("axes") is not None:
                axes = tuple(int(v) for v in a["axes"])
            else:
                axes = None
            keep = bool(a.get("keepdims", 1))
            return [f(x[0], axis=axes, keepdims=keep)]
        if op in ("ArgMax", "ArgMin"):
            f = np.argmax if op == "ArgMax" else np.argmin
            r = f(x[0], axis=a.get("axis", 0))
            if a.get("keepdims", 1):
                r = np.expand_dims(r, a.get("axis", 0))
            return [r.astype(np.int64)]
        if op == "CumSum":
            axis = int(np.asarray(x[1]))
            data = x[0]
            if a.get("reverse"):
                data = np.flip(data, axis)
            r = np.cumsum(data, axis=axis, dtype=data.dtype)
            if a.get("reverse"):
                r = np.flip(r, axis)
            return [r]
        if op == "ScatterND":
            data = x[0].copy()
            idx = x[1].astype(np.int64)
            upd = x[2]
            red = a.get("reduction", "none")
            flat_idx = tuple(idx[..., k] for k in range(idx.shape[-1]))
            if red == "add":
                np.add.at(data, flat_idx, upd)
            elif red == "none":
                data[flat_idx] = upd
            else:  # pragma: no cover
                raise NotImplementedError(f"ScatterND reduction {red}")
            return [data]
        if op == "RandomNormalLike":
            scale = a.get("scale", 1.0)
            mean = a.get("mean", 0.0)
            return [(mean + scale * self.rng.standard_normal(x[0].shape)).astype(
                DT_TO_NP[a["dtype"]] if "dtype" in a else x[0].dtype)]
        if op == "Loop":
            trip = int(np.asarray(x[0])) if node.inputs[0] else None
            cond = bool(np.asarray(x[1])) if node.inputs[1] else True
            carry = [np.asarray(v) for v in x[2:]]
            body: Graph = a["body"]
            n_carry = len(carry)
            body_inputs = body.inputs
            scan_outs: List[List[np.ndarray]] = [
                [] for _ in range(len(body.outputs) - 1 - n_carry)]
            i = 0
            while cond and (trip is None or i < trip):
                sub = Scope(dict(body.initializers), parent=scope)
                sub.set(body_inputs[0], np.asarray(i, np.int64))
                sub.set(body_inputs[1], np.asarray(cond))
                for nm, v in zip(body_inputs[2:], carry):
                    sub.set(nm, v)
                self._run_nodes(body.nodes, sub)
                outs = [sub.get(o) for o in body.outputs]
                cond = bool(np.asarray(outs[0]))
                carry = outs[1: 1 + n_carry]
                for j, v in enumerate(outs[1 + n_carry:]):
                    scan_outs[j].append(v)
                i += 1
            stacked = [np.stack(s) if s else np.zeros((0,)) for s in scan_outs]
            return carry + stacked
        if op == "If":
            branch: Graph = a["then_branch"] if bool(np.asarray(x[0])) else a["else_branch"]
            sub = Scope(dict(branch.initializers), parent=scope)
            self._run_nodes(branch.nodes, sub)
            return [sub.get(o) for o in branch.outputs]
        if op == "Split":
            axis = a.get("axis", 0)
            if len(x) > 1 and x[1] is not None:
                sizes = [int(v) for v in x[1]]
                points = np.cumsum(sizes)[:-1]
            else:
                points = a.get("num_outputs")
            return np.split(x[0], points, axis=axis)
        if op == "ConstantOfShape":
            val = a.get("value")
            fill = val.reshape(-1)[0] if isinstance(val, np.ndarray) else np.float32(0)
            return [np.full([int(d) for d in x[0]], fill)]
        if op == "Range":
            return [np.arange(int(x[0]), int(x[1]), int(x[2]))]
        if op == "Softmax":
            z = x[0] - np.max(x[0], axis=a.get("axis", -1), keepdims=True)
            e = np.exp(z)
            return [e / e.sum(axis=a.get("axis", -1), keepdims=True)]
        raise NotImplementedError(f"interpreter: op {op}")  # pragma: no cover


def run_model(model_bytes: bytes, inputs: Dict[str, np.ndarray],
              rng_seed: int = 0) -> List[np.ndarray]:
    graph = parse_model(model_bytes)
    return Interpreter(graph, rng_seed=rng_seed).run(inputs)
