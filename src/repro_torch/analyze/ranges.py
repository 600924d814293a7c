"""Interval / quantization-error lattice for the abstract interpreter.

One :class:`AbsVal` summarizes every element of one array:

* ``lo``/``hi`` — a closed interval bounding every element's value.  ``±inf``
  endpoints mean "unbounded on that side"; the interval is a *bound on
  values*, not a claim that the endpoints are attained.
* ``exact`` — every element is an exactly-representable integer (quantized
  codes after SR rounding, token ids, iota, booleans).  Integer dtypes are
  exact by construction; floats become exact through ``floor``/``round`` and
  stay exact under +, -, * and integer conversion.
* ``qerr`` — worst-case rounding deviation accrued by round-family ops,
  scaled through subsequent arithmetic: after ``codes = round(x/step)`` and
  ``deq = codes * step`` the lattice carries ``qerr(deq) <= step * 0.5`` (or
  ``step * 1.0`` for stochastic rounding via floor), which is exactly the
  per-role resolution ``delta = s/(2^q - 1)`` the convergence bound feeds
  GBD.  ``qerr`` is a *reconstruction* of that bound from the traced graph,
  not a full relational error analysis.

Everything here is pure host math over Python floats — no tensors — so
the interpreter can run over a traced step's thousands of operations
without touching a device.  A line-for-line port of ``repro/analyze/
ranges.py``: every operation gives the reference's fields bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

INF = math.inf


def _clean(x: float) -> float:
    """Map NaN endpoint candidates (0*inf, inf-inf) to the safe extreme."""
    return x if x == x else INF


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Abstract value: interval + integer-exactness + quantization error."""

    lo: float = -INF
    hi: float = INF
    exact: bool = False
    qerr: float = 0.0

    def __post_init__(self):
        # Normalize away NaN endpoints and empty intervals defensively: a
        # wrong-way interval would make every downstream bound unsound.
        lo, hi = self.lo, self.hi
        if lo != lo:
            lo = -INF
        if hi != hi:
            hi = INF
        if lo > hi:
            lo, hi = -INF, INF
        object.__setattr__(self, "lo", float(lo))
        object.__setattr__(self, "hi", float(hi))
        object.__setattr__(self, "qerr", float(max(self.qerr, 0.0)))

    # -- predicates ------------------------------------------------------
    @property
    def mag(self) -> float:
        """Largest absolute value any element can take."""
        return max(abs(self.lo), abs(self.hi))

    def contains(self, x: float) -> bool:
        return self.lo <= x <= self.hi

    @property
    def bounded(self) -> bool:
        return self.lo > -INF and self.hi < INF

    def __repr__(self):  # compact for findings / debugging
        e = "i" if self.exact else "f"
        q = f",q<={self.qerr:g}" if self.qerr else ""
        return f"[{self.lo:g},{self.hi:g}]{e}{q}"


TOP = AbsVal()
UNIT = AbsVal(0.0, 1.0)          # probabilities, sigmoids, uniforms
BOOL = AbsVal(0.0, 1.0, exact=True)


def point(v: float, *, exact: bool | None = None) -> AbsVal:
    v = float(v)
    if exact is None:
        exact = float(v).is_integer()
    return AbsVal(v, v, exact=exact)


def interval(lo: float, hi: float, *, exact: bool = False,
             qerr: float = 0.0) -> AbsVal:
    return AbsVal(lo, hi, exact=exact, qerr=qerr)


def join(a: AbsVal, b: AbsVal) -> AbsVal:
    """Least upper bound: either value could flow here (cond joins, select)."""
    return AbsVal(min(a.lo, b.lo), max(a.hi, b.hi),
                  exact=a.exact and b.exact, qerr=max(a.qerr, b.qerr))


def widen(old: AbsVal, new: AbsVal) -> AbsVal:
    """Widening for loop carries: any still-growing bound jumps to ±inf.

    Guarantees fixpoint termination in one extra iteration — a carry whose
    interval grew twice is assumed unbounded rather than chased.
    """
    return AbsVal(old.lo if new.lo >= old.lo else -INF,
                  old.hi if new.hi <= old.hi else INF,
                  exact=old.exact and new.exact,
                  qerr=old.qerr if new.qerr <= old.qerr else INF)


def meet_interval(a: AbsVal, lo: float, hi: float) -> AbsVal:
    """Refine ``a`` with external knowledge ``value in [lo, hi]``."""
    nlo, nhi = max(a.lo, lo), min(a.hi, hi)
    if nlo > nhi:                 # contradictory refinement: keep original
        return a
    return AbsVal(nlo, nhi, exact=a.exact, qerr=a.qerr)


# ---------------------------------------------------------------------------
# Arithmetic transfer functions
# ---------------------------------------------------------------------------


def _mul_e(x: float, y: float) -> float:
    """Endpoint product with the interval convention 0 * inf = 0."""
    if x == 0.0 or y == 0.0:
        return 0.0
    return x * y


def add(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(_clean(a.lo + b.lo), _clean(a.hi + b.hi),
                  exact=a.exact and b.exact, qerr=a.qerr + b.qerr)


def sub(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(_clean(a.lo - b.hi), _clean(a.hi - b.lo),
                  exact=a.exact and b.exact, qerr=a.qerr + b.qerr)


def neg(a: AbsVal) -> AbsVal:
    return AbsVal(-a.hi, -a.lo, exact=a.exact, qerr=a.qerr)


#: smallest positive double: keeps strictly-positive bounds strictly
#: positive when an endpoint product/quotient underflows to 0.0
TINY = 5e-324


def mul(a: AbsVal, b: AbsVal) -> AbsVal:
    cands = [_mul_e(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    lo, hi = min(cands), max(cands)
    if a.lo > 0 and b.lo > 0:
        lo = max(lo, TINY)            # pos * pos stays pos despite underflow
    # |a*b - a'*b'| <= |a| qb + |b| qa + qa qb for |a-a'|<=qa, |b-b'|<=qb
    q = a.mag * b.qerr + b.mag * a.qerr + a.qerr * b.qerr
    return AbsVal(lo, hi, exact=a.exact and b.exact, qerr=_clean(q))


def div(a: AbsVal, b: AbsVal) -> AbsVal:
    if b.contains(0.0):
        return AbsVal(exact=False, qerr=INF if (a.qerr or b.qerr) else 0.0)
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            c = x / y if y != 0 else INF
            if c != c:                # inf/inf endpoint: unbounded limit
                cands += [-INF, INF]
            else:
                cands.append(c)
    lo, hi = min(cands), max(cands)
    if a.lo > 0 and b.lo > 0:
        lo = max(lo, TINY)
    bmin = min(abs(b.lo), abs(b.hi))
    q = (a.qerr + max(abs(lo), abs(hi)) * b.qerr) / bmin \
        if (a.qerr or b.qerr) else 0.0
    return AbsVal(lo, hi, exact=False, qerr=_clean(q))


def abs_(a: AbsVal) -> AbsVal:
    if a.lo >= 0:
        return a
    if a.hi <= 0:
        return neg(a)
    return AbsVal(0.0, a.mag, exact=a.exact, qerr=a.qerr)


def min_(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(min(a.lo, b.lo), min(a.hi, b.hi),
                  exact=a.exact and b.exact, qerr=max(a.qerr, b.qerr))


def max_(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(max(a.lo, b.lo), max(a.hi, b.hi),
                  exact=a.exact and b.exact, qerr=max(a.qerr, b.qerr))


def clamp(lo_b: AbsVal, x: AbsVal, hi_b: AbsVal) -> AbsVal:
    """``lax.clamp(min, x, max) = max(min, min(x, max))`` elementwise."""
    return max_(lo_b, min_(x, hi_b))


def scale_by_count(a: AbsVal, n: int) -> AbsVal:
    """Sum of ``n`` values each in ``a``: psum, reduce_sum, dot contraction."""
    n = int(n)
    return AbsVal(_mul_e(float(n), a.lo), _mul_e(float(n), a.hi),
                  exact=a.exact, qerr=_clean(n * a.qerr))


def to_integer(a: AbsVal) -> AbsVal:
    """Any int-rounding conversion: result integral, within [floor, ceil]."""
    lo = math.floor(a.lo) if a.lo > -INF else -INF
    hi = math.ceil(a.hi) if a.hi < INF else INF
    # rounding moves a value by < 1 relative to its float input
    q = a.qerr if a.exact else a.qerr + 1.0
    return AbsVal(lo, hi, exact=True, qerr=q)


def round_family(a: AbsVal, *, max_delta: float = 1.0) -> AbsVal:
    """floor/ceil/round: integral result within ``max_delta`` of the input."""
    lo = math.floor(a.lo) if a.lo > -INF else -INF
    hi = math.ceil(a.hi) if a.hi < INF else INF
    return AbsVal(lo, hi, exact=True,
                  qerr=a.qerr if a.exact else a.qerr + max_delta)


# -- monotone unary wrappers -------------------------------------------------


def _mono(fn, a: AbsVal, *, exact=False, qerr=INF) -> AbsVal:
    """Apply a monotone-increasing fn to both endpoints."""
    def safe(x):
        try:
            return fn(x)
        except (ValueError, OverflowError):
            return INF if x > 0 else -INF
    return AbsVal(safe(a.lo), safe(a.hi), exact=exact,
                  qerr=0.0 if a.qerr == 0 else qerr)


def exp(a: AbsVal) -> AbsVal:
    return _mono(math.exp, a)


def log(a: AbsVal) -> AbsVal:
    def f(x):
        if x <= 0:
            return -INF
        return math.log(x)
    return _mono(f, a)


def log1p(a: AbsVal) -> AbsVal:
    def f(x):
        if x <= -1:
            return -INF
        return math.log1p(x)
    return _mono(f, a)


def sqrt(a: AbsVal) -> AbsVal:
    def f(x):
        return math.sqrt(max(x, 0.0)) if x < INF else INF
    return _mono(f, a)


def rsqrt(a: AbsVal) -> AbsVal:
    if a.hi <= 0:
        return TOP
    lo = 0.0 if a.hi == INF else 1.0 / math.sqrt(a.hi)
    hi = INF if a.lo <= 0 else 1.0 / math.sqrt(a.lo)
    return AbsVal(lo, hi)


def integer_pow(a: AbsVal, k: int) -> AbsVal:
    k = int(k)
    if k == 0:
        return point(1.0)
    if k < 0:
        return div(point(1.0), integer_pow(a, -k))
    cands = [_clean(a.lo ** k), _clean(a.hi ** k)]
    lo, hi = min(cands), max(cands)
    if k % 2 == 0 and a.lo < 0 < a.hi:
        lo = 0.0
    q = 0.0 if a.qerr == 0 else INF if k > 1 else a.qerr
    return AbsVal(lo, hi, exact=a.exact, qerr=q)


def dtype_top(dtype) -> AbsVal:
    """Default (sound, maximally imprecise) value for an array of ``dtype``
    (a numpy dtype or a name such as ``"int8"``, ``"bool"``, ``"bfloat16"``)."""
    import numpy as np
    name = str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        return TOP
    dt = np.dtype(name if isinstance(dtype, str) or "torch." in str(dtype) else dtype)
    if dt.kind == "b":
        return BOOL
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return AbsVal(float(info.min), float(info.max), exact=True)
    return TOP
