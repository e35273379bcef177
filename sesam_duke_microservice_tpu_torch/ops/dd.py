"""Two-float ("double-double") emulated-f64 arithmetic in PyTorch.

Counterpart of the JAX package's ``ops/dd.py``: a value is an unevaluated
sum ``hi + lo`` of two float32 tensors with ``|lo| <= ulp(hi)/2``, about 49
bits of significand.  The certified finalization path (``ops.scoring``'s
dd rescorer, ``engine.finalize``) redoes the ratio -> probability map ->
clamped log-odds pipeline of the surviving pairs in this arithmetic, so
that most survivor verdicts are certified against the host's exact f64
``Processor.compare``.

**No fused multiply-add, anywhere on this path.**  The error-free
transforms below (Knuth two-sum, Dekker split / two-product) are exact
only if every float32 ``+ - * /`` is rounded on its own.  The JAX package
commits each intermediate through ``lax.reduce_precision`` so that XLA
cannot contract ``a*b + c`` into an FMA or cancel ``x - (x - a)``.  Eager
PyTorch runs every operator as its own kernel, so separate operators never
contract and nothing simplifies them; ``_f32`` is therefore the identity
here.  What must never appear in this module or its callers' dd code:

  * the ``alpha=`` argument of ``add``/``sub`` (a fused ``a + alpha*b``);
  * ``addcmul``, ``addcdiv``, ``lerp``, ``baddbmm`` or any other fused
    operator;
  * ``torch.compile`` (Inductor fuses elementwise chains into one kernel
    that the compiler may contract);
  * division by a Python scalar (PyTorch's CUDA kernel multiplies by the
    reciprocal instead): every divisor is a tensor.

Every public function takes and returns ``(hi, lo)`` tuples of same-shape
float32 tensors on one device.  ``const(x, like)`` splits a Python f64 on
the host and broadcasts it as a device pair; integers below 2^24 are exact
in one float32 (``from_int``).  The error model (``DD_EPS`` per operation,
``LOG_ERR_ABS`` for ``log``) is the JAX package's, unchanged.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# Per-operation relative error budget charged by certified_dd_margin: the
# published double-float worst cases at f32 unit roundoff u = 2^-24 are
# add22 <= 3u^2, mul22 <= 5u^2, div22 <= 12u^2; 2^-44 covers them with room.
DD_EPS = 2.0 ** -44
# Absolute error budget of log() beyond the DD_EPS-relative term: series
# truncation (2^-55-level) plus ~40 dd operations on operands <= 1.3.
LOG_ERR_ABS = 2.0 ** -38

DD = Tuple[torch.Tensor, torch.Tensor]

_SPLITTER = 4097.0  # 2^12 + 1 (Dekker split for 24-bit significands)


# -- error-free transforms -----------------------------------------------------


def _f32(x):
    """The identity: an eager PyTorch operator already rounds its float32
    result on its own (see the module docstring), which is what the JAX
    package's ``reduce_precision`` commit enforces under XLA."""
    return x


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b)."""
    s = _f32(a + b)
    bb = _f32(s - a)
    e = _f32(_f32(a - _f32(s - bb)) + _f32(b - bb))
    return s, e


def fast_two_sum(a, b):
    """Dekker quick-two-sum; requires |a| >= |b| (or a == 0)."""
    s = _f32(a + b)
    e = _f32(b - _f32(s - a))
    return s, e


def split(a):
    """Dekker split: a == hi + lo with hi, lo 12-bit-significand halves."""
    t = _f32(a * _SPLITTER)
    hi = _f32(t - _f32(t - a))
    return hi, _f32(a - hi)


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b)."""
    p = _f32(a * b)
    ah, al = split(a)
    bh, bl = split(b)
    e = _f32(
        _f32(_f32(_f32(_f32(ah * bh) - p) + _f32(ah * bl)) + _f32(al * bh))
        + _f32(al * bl)
    )
    return p, e


# -- construction -------------------------------------------------------------


def from_f32(a) -> DD:
    """Lift a float32 tensor (exactly) into dd."""
    a = a.to(torch.float32)
    return a, torch.zeros_like(a)


def from_int(i) -> DD:
    """Exact dd from integer tensors with |i| < 2^24 (comparator counts)."""
    return from_f32(i.to(torch.float32))


def const_pair(x: float) -> Tuple[float, float]:
    """Host-side split of a Python f64 into (hi, lo) float32 values (as
    Python floats, each exactly a float32).  Reproduces ``x`` to ~2^-48
    relative; the residual is charged to ``DD_EPS`` by the margin."""
    hi = np.float32(x)
    lo = np.float32(x - float(hi))
    return float(hi), float(lo)


def const(x: float, like: torch.Tensor) -> DD:
    """``const_pair(x)`` as a pair of tensors shaped and placed like
    ``like``."""
    hi, lo = const_pair(x)
    return (torch.full_like(like, hi, dtype=torch.float32),
            torch.full_like(like, lo, dtype=torch.float32))


def to_f64(x: DD) -> np.ndarray:
    """Host-side exact read-back: f64(hi) + f64(lo) (both exact in f64)."""
    return (x[0].detach().cpu().numpy().astype(np.float64)
            + x[1].detach().cpu().numpy().astype(np.float64))


# -- arithmetic ---------------------------------------------------------------


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def add(x: DD, y: DD) -> DD:
    """Accurate dd addition (add22 with both low-order terms folded)."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    e = _f32(e + t)
    s, e = fast_two_sum(s, e)
    e = _f32(e + f)
    return fast_two_sum(s, e)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def mul(x: DD, y: DD) -> DD:
    """dd multiplication (mul22): two-product + cross terms."""
    p, e = two_prod(x[0], y[0])
    e = _f32(e + _f32(_f32(x[0] * y[1]) + _f32(x[1] * y[0])))
    return fast_two_sum(p, e)


def div(x: DD, y: DD) -> DD:
    """dd division via long division with two correction terms.
    Denominators on the scoring path are >= 1e-12 in magnitude, far from
    float32's denormal floor, so no scaling pass is needed."""
    q1 = _f32(x[0] / y[0])
    r = sub(x, mul(y, from_f32(q1)))
    q2 = _f32(r[0] / y[0])
    r = sub(r, mul(y, from_f32(q2)))
    q3 = _f32(r[0] / y[0])
    s, e = fast_two_sum(q1, q2)
    return fast_two_sum(s, _f32(e + q3))


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32 for integer k in [-126, 127], built from its bits
    (exact; ``torch.ldexp`` goes through ``pow``, whose exactness is the
    math library's business)."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _frexp(x: torch.Tensor):
    """(m, k) with x == m * 2^k and m in [0.5, 1), for positive normal
    float32 x, read off its bits (what ``frexp`` returns there)."""
    bits = x.view(torch.int32)
    k = ((bits >> 23) & 0xFF) - 126
    m = ((bits & 0x7FFFFF) | (126 << 23)).view(torch.float32)
    return m, k


def scale_pow2(x: DD, k) -> DD:
    """Multiply by 2^k (k integer tensor): exact, no rounding."""
    s = _pow2(k)
    return _f32(x[0] * s), _f32(x[1] * s)


# -- comparisons / selection --------------------------------------------------


def lt(x: DD, y: DD):
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] < y[1]))


def le(x: DD, y: DD):
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))


def ge(x: DD, y: DD):
    return le(y, x)


def where(cond, x: DD, y: DD) -> DD:
    return torch.where(cond, x[0], y[0]), torch.where(cond, x[1], y[1])


def maximum(x: DD, y: DD) -> DD:
    return where(lt(x, y), y, x)


def minimum(x: DD, y: DD) -> DD:
    return where(lt(x, y), x, y)


def clamp(x: DD, lo: DD, hi: DD) -> DD:
    return minimum(maximum(x, lo), hi)


# -- logarithm ----------------------------------------------------------------

# ln(2) as a dd constant (error ~2^-49 relative, charged via LOG_ERR_ABS).
_LN2 = const_pair(math.log(2.0))
# atanh-series order: |t| <= 0.1716, so 11 terms put the truncation tail
# below 2^-55 relative.
_LOG_TERMS = 11
_SQRT_HALF = float(np.float32(0.7071067811865476))


def log(x: DD) -> DD:
    """Natural log of a positive dd value.

    ``x = m * 2^k`` with ``m`` in [sqrt(1/2), sqrt(2)) by an exact
    power-of-two rescale of both components, then ``ln m = 2 atanh(t)``
    with ``t = (m-1)/(m+1)`` summed as the odd atanh series in dd, plus
    ``k * ln2`` from the dd ln2 constant.  No math-library transcendental
    takes part, so the error bound follows from the dd operation count.
    Domain: finite positive ``x`` in about [1e-12, 1e12].
    """
    m, k = _frexp(x[0])  # m in [0.5, 1)
    adjust = m < _SQRT_HALF
    k = k - adjust.to(torch.int32)
    mx = scale_pow2(x, -k)  # in [sqrt(1/2), sqrt(2))
    one = from_f32(torch.ones_like(x[0]))
    t = div(sub(mx, one), add(mx, one))
    t2 = mul(t, t)
    s = const(1.0 / (2 * _LOG_TERMS + 1), like=x[0])
    for i in range(_LOG_TERMS - 1, -1, -1):
        s = add(mul(s, t2), const(1.0 / (2 * i + 1), like=x[0]))
    r = mul(t, s)
    r = add(r, r)  # 2 * t * series
    kf = k.to(torch.float32)  # |k| <= ~128: exact in f32
    ln2 = (torch.full_like(x[0], _LN2[0]), torch.full_like(x[0], _LN2[1]))
    return add(r, mul(ln2, from_f32(kf)))
