"""Why K3's backward kernel holds the float32 tolerance: 3xTF32 arithmetic.

The CUDA backward (``ops/csrc/flash_attention.cu``) takes its five products
(S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) on the tensor
cores in TF32, which keeps 10 mantissa bits. Each operand x is split into
hi = tf32(x) and lo = x - hi, of which the tensor core reads the top 19 bits
(its low 13 bits are ignored), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
is accumulated in float32. These tests emulate that arithmetic on the CPU
(TF32 rounding: round to nearest, ties away from zero, 10 mantissa bits kept;
products of TF32 values are exact in float32, so a float32 matmul of the
parts is the tensor core's sum up to summation order) and hold it
against float64 at [4, 2, 128, 128] with the padded mask of the card tests:
the error is well inside the 1e-4-of-the-largest-entry bound that the card
tests use, and single-pass TF32 is not. So the bound holds because of the
arithmetic, not because it was tuned to the kernel.
"""

import numpy as np
import pytest
import torch

B, H, L, D = 4, 2, 128, 128
TOL = 1e-4  # of the largest reference entry, as the card tests hold the kernel


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (cvt.rna.tf32.f32): 13 low bits dropped, to
    nearest with ties away from zero (the bits are sign and magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_truncated(a - a_hi), tf32_truncated(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def _inputs():
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
                     for _ in range(4))
    pad = torch.zeros(B, L, dtype=torch.bool)
    for i in range(B):  # the card tests' padding: row i's last (7 i) % (L / 2)
        pad[i, L - (7 * i) % (L // 2):] = True
    return q, k, v, dout, pad


def _backward(mm, q, k, v, dout, pad, dtype):
    """(dq, dk, dv) by the kernel's formulas with every product through mm;
    lse and delta come from a float64 forward, as the forward kernel gives
    them to float32 accuracy."""
    scale = D ** -0.5
    visible = pad[:, None, :, None] == pad[:, None, None, :]
    q64, k64, v64 = q.double(), k.double(), v.double()
    s64 = (q64 @ k64.transpose(-1, -2) * scale).masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(s64, -1)
    out = torch.softmax(s64, -1) @ v64
    delta = (dout.double() * out).sum(-1)
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    lse, delta = lse.to(dtype), delta.to(dtype)
    s = mm(q, k.transpose(-1, -2))
    p = torch.exp(s * scale - lse[..., None]).masked_fill(~visible, 0.0)
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), dout))


@pytest.fixture(scope="module")
def errors():
    """max |err| / max |reference| of dq, dk, dv for each arithmetic."""
    q, k, v, dout, pad = _inputs()
    ref = _backward(torch.matmul, q, k, v, dout, pad, torch.float64)
    out = {}
    for name, mm, dtype in (("float32", torch.matmul, torch.float32),
                            ("3xtf32", mm_3xtf32, torch.float32),
                            ("tf32", mm_tf32, torch.float32)):
        got = _backward(mm, q, k, v, dout, pad, dtype)
        out[name] = [((g.double() - r).abs().max() / r.abs().max()).item()
                     for g, r in zip(got, ref)]
    return out


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    # exact, a tie (away from zero), below the tie, a negative tie, zero
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11), 0.0])
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -9), 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    rel = ((tf32(y) - y).abs() / y.abs()).max().item()
    assert 2 ** -12 < rel <= 2 ** -11  # half an ulp of 10 mantissa bits, at most
    assert ((tf32(y).view(torch.int32) & 0x1FFF) == 0).all()
    # the split's low half as the tensor core reads it: at most 2^-21 of x off
    lo = tf32_truncated(y - tf32(y))
    assert ((tf32(y) + lo - y).abs() <= y.abs() * 2 ** -21).all()


@pytest.mark.parametrize("i,name", [(0, "dq"), (1, "dk"), (2, "dv")])
def test_3xtf32_backward_is_well_inside_the_float32_bound(errors, i, name):
    """3xTF32 within a tenth of the card tests' bound, and of the same order
    as plain float32 arithmetic."""
    assert errors["3xtf32"][i] <= TOL / 10, (name, errors)
    assert errors["3xtf32"][i] <= 10 * max(errors["float32"][i], 1e-7), (name, errors)


def test_single_pass_tf32_misses_the_bound(errors):
    """One TF32 product per pair would fail the card tests' bound."""
    assert max(errors["tf32"]) > TOL, errors
    assert max(errors["tf32"]) > 10 * max(errors["3xtf32"]), errors
