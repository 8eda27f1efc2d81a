"""Error-free-transform (double-word) reductions.

Counterpart of ``lanczos_tpu/ops/compensated.py``: the exact
transformations of Ogita, Rump & Oishi ("Accurate Sum and Dot Product",
SISC 2005) with Dekker's splitting (no FMA needed):

* ``two_sum`` / ``quick_two_sum`` / ``two_prod`` — a + b = s + e and
  a * b = p + e, exactly;
* ``dd_add`` — accurate double-word addition (Joldes, Muller & Popescu 2017,
  Algorithm 6); ``dd_sum_tree`` — a vectorized binary-tree double-word sum;
* ``dot2`` / ``dot2_rounded`` / ``norm2`` — dot products and norms correct
  to about eps^2, as (hi, lo) pairs or rounded to the working dtype.

**Contraction.**  A fused multiply-add rounds ``a*b + c`` once, which is
what breaks these transforms: the JAX package measured jitted dd residuals
degrading from 1e-14 to 2e-8 on XLA:CPU.  Every transform here is a chain
of separate eager tensor operations, each rounded on its own (no
``addcmul``, ``lerp`` or ``torch.compile``); PyTorch's eager CPU and CUDA
element-wise kernels do not contract across operations.

**float32 operands.**  The H100 runs float64 at full rate, and the product
of two float32 numbers is exact in float64, so ``dot2``, ``dot2_rounded``
and ``norm2`` sum the exact float32 products in float64 (one ``torch.dot``
of the float64 casts) and return the float32 (hi, lo) split of that sum:
more accurate than Dot2's ~n eps32^2 bound and one pass over the inputs.
float64 operands have no wider type and take the error-free transforms.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "two_sum",
    "quick_two_sum",
    "two_prod",
    "dd_add",
    "dd_sum_tree",
    "dot2",
    "norm2",
    "dot2_rounded",
]


def two_sum(a, b):
    """Knuth's branch-free exact addition: a + b = s + e, exactly."""
    s = a + b
    bp = s - a
    t = s - bp
    e = (a - t) + (b - bp)
    return s, e


def quick_two_sum(a, b):
    """Exact addition assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _splitter(dtype) -> float:
    # 2^ceil(p/2) + 1 with p the significand width: float32 p=24 -> 2^12+1,
    # float64 p=53 -> 2^27+1 (Dekker 1971).
    p = 1 - round(math.log2(torch.finfo(dtype).eps))
    return float(2 ** ((p + 1) // 2) + 1)


def two_prod(a, b):
    """Dekker's exact multiplication: a * b = p + e, exactly (17 flops, no FMA)."""
    # A Python number, not a tensor made on the device: that would be a
    # host-to-device copy, which a CUDA graph's capture refuses.
    c = _splitter(a.dtype)
    p = a * b
    a_big = c * a
    a_hi = a_big - (a_big - a)
    a_lo = a - a_hi
    b_big = c * b
    b_hi = b_big - (b_big - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def dd_add(a_hi, a_lo, b_hi, b_lo):
    """Double-word + double-word addition, accurate variant: both the hi and
    the lo pairs go through an exact two_sum before renormalization, so the
    low-order word survives heavy hi-word cancellation."""
    s, e = two_sum(a_hi, b_hi)
    t, f = two_sum(a_lo, b_lo)
    c = e + t
    v, w = quick_two_sum(s, c)
    z = w + f
    return quick_two_sum(v, z)


def dd_sum_tree(hi, lo):
    """Sum a vector of double-word numbers by a vectorized binary tree: each
    level adds the first half to the second with one dd_add.  Returns 0-d
    (hi, lo)."""
    n = hi.shape[0]
    while n > 1:
        half = (n + 1) // 2
        pad = 2 * half - n
        if pad:
            z = torch.zeros(pad, dtype=hi.dtype, device=hi.device)
            hi = torch.cat([hi, z])
            lo = torch.cat([lo, z])
        hi, lo = dd_add(hi[:half], lo[:half], hi[half:], lo[half:])
        n = half
    return hi[0], lo[0]


def _split64(s: torch.Tensor, dtype):
    """(hi, lo) of a float64 value in ``dtype``: hi = s rounded, lo = the
    rest rounded."""
    hi = s.to(dtype)
    return hi, (s - hi.double()).to(dtype)


def dot2(a, b):
    """Dot product as (hi, lo) with a.b = hi + lo + O(eps^2 sum |a_i b_i|).

    float32: the exact products summed in float64; float64: Dot2 (exact
    products, then a double-word tree sum of (product, error) pairs)."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return _split64(torch.dot(a.double(), b.double()), torch.float32)
    p, e = two_prod(a, b)
    return dd_sum_tree(p, e)


def dot2_rounded(a, b):
    """dot2 rounded to the working dtype (a drop-in for ``torch.dot``)."""
    hi, lo = dot2(a, b)
    return hi + lo


def norm2(x):
    """2-norm of x as a double-word (hi, lo) pair.

    float32: the square root of the float64 sum of squares, split; float64:
    Dot2 for the sum of squares and one double-word Newton step around the
    float64 square root."""
    if x.dtype == torch.float32:
        return _split64(torch.sqrt(torch.dot(x.reshape(-1).double(), x.reshape(-1).double())),
                        torch.float32)
    s_hi, s_lo = dot2(x, x)
    r = torch.sqrt(s_hi)
    safe = r > 0
    r_ = torch.where(safe, r, torch.ones_like(r))
    # Newton: sqrt(s) ~ r + (s - r^2) / (2r), with s - r^2 in double-word.
    rr_hi, rr_e = two_prod(r_, r_)
    d_hi, d_lo = dd_add(s_hi, s_lo, -rr_hi, -rr_e)
    corr = (d_hi + d_lo) / (2.0 * r_)
    hi, lo = quick_two_sum(r_, corr)
    zero = torch.zeros_like(hi)
    return torch.where(safe, hi, zero), torch.where(safe, lo, zero)
