"""Forward abstract interpreter over a traced step's operation graph.

Walks the same graph :mod:`repro_torch.analyze.precision_flow` taint-walks
(:class:`~repro_torch.roofline.count.Graph`), but instead of boolean taint
it propagates an :class:`repro_torch.analyze.ranges.AbsVal` per value — an
interval, an integer-exactness flag and a quantization-error bound —
through arithmetic, the dequant idiom (``_to_copy`` + ``mul`` by a scale),
in-place writes (a partial write joins into its storage), kernel nodes and
collective nodes (an integer all-reduce sum multiplies its operand's interval
by the group size).  The reference (``repro/analyze/absint.py``) walks a
jaxpr with scan/while/cond fixpoints; an eager trace has already unrolled
every loop, so each iteration is interpreted as it ran.

Two refinements make real transformer graphs provable instead of drowning
in top, as in the reference:

* **comparison-guarded selects** — ``where(x > k, x, fallback)`` refines the
  taken branch with the predicate, so the ``s = where(s > 0, s, 1)`` guard
  of the wire quantizer yields a provably positive scale;
* **the max-subtraction idiom** — ``exp(x - amax(x))`` is recognised by a
  walk back through producers (``amax``, ``max``, ``maximum``,
  ``logsumexp``), bounding the exponent by 0 and the sum of the result
  below by 1, which keeps softmax / logsumexp free of domain findings.

Kernel nodes have transfer functions: K2 (``sr_pack*``) writes codes in
``[-lim, lim]``, exact integers, ``lim`` the call's argument, because the
kernel saturates its codes (the port gets the wire's bound from K2's
contract where the reference reads a ``jnp.clip`` in its graph); K1's
straight-through value lies in ``[-s, s]`` with ``s`` the weight's largest
magnitude; K3-K5 give their dtype's whole range, as the reference treats a
``pallas_call``.

Rule families emitted here:

* ``overflow.wire_accumulator`` (error) — an integer all-reduce (or
  reduce-scatter) whose operand's interval, multiplied by the group size,
  cannot be proven to fit its recorded dtype.  A well-formed wire path
  *proves* and is recorded in ``AbsintResult.proofs`` with its headroom.
* ``numerics.unguarded`` (warn) — exp/log/log1p/div/rsqrt/sqrt consuming an
  interval containing 0 (domain edge) or of unbounded magnitude, with no
  clamp/where/eps guard visible upstream.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.analyze import ranges as R
from repro_torch.analyze.findings import Finding, source_key
from repro_torch.analyze.precision_flow import INT_DTYPES, base_name, graph_of
from repro_torch.analyze.ranges import INF, AbsVal
from repro_torch.roofline.count import Ref

#: ops whose output carries the first operand's values unchanged (and
#: through which the max-sub / attains-one provenance walks)
_PASSTHROUGH = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as", "expand", "expand_as",
    "broadcast_to", "permute", "transpose", "t", "squeeze", "unsqueeze", "flatten",
    "unflatten", "detach", "alias", "clone", "contiguous", "lift_fresh", "lift_fresh_copy",
    "movedim", "repeat", "resolve_conj", "resolve_neg", "as_strided",
})

#: pass-through, but element-dropping: values stay bounded by the operand's
#: interval, yet "contains an element == 1" style facts do NOT survive
_SUBSET = frozenset({
    "slice", "select", "narrow", "split", "split_with_sizes", "unbind", "chunk",
    "index_select", "gather", "index", "take", "diagonal", "masked_select", "unfold",
})

#: reductions whose result dominates (>=) every element reduced
_MAXES = frozenset({"amax", "max", "logsumexp"})

_BOUNDED_UNARY = {
    "tanh": (-1.0, 1.0), "sin": (-1.0, 1.0), "cos": (-1.0, 1.0),
    "sigmoid": (0.0, 1.0), "erf": (-1.0, 1.0), "erfc": (0.0, 2.0),
    "atan": (-math.pi / 2, math.pi / 2), "asin": (-math.pi / 2, math.pi / 2),
    "acos": (0.0, math.pi), "_softmax": (0.0, 1.0), "softmax": (0.0, 1.0),
    "rand": (0.0, 1.0), "rand_like": (0.0, 1.0), "hardtanh": (-1.0, 1.0),
}

#: kernel entries by family (kernels/sr_quant.py, quant_matmul.py, ...)
_K1 = frozenset({"sr_quant", "sr_quant_keyed", "sr_quant_inline"})
_K2 = frozenset({"sr_pack", "sr_pack_keyed"})

_LN2 = math.log(2.0)
#: min over x of x * sigmoid(x) (SiLU) and of x * Phi(x) (GELU)
_SILU_MIN = -0.27846454276107380
_GELU_MIN = -0.17004075057125000


@dataclasses.dataclass
class AbsintResult:
    """What one interpretation produced."""
    findings: list
    proofs: list          # dicts: integer all-reduce overflow proof certificates
    out: list             # AbsVal per graph output (``Graph.outputs``)


def headroom_bits(capacity: float, need: float) -> int:
    """Whole powers of two between the worst-case sum and the dtype limit."""
    if need <= 0:
        return int(capacity).bit_length()
    if need > capacity:
        return 0
    return int(math.floor(math.log2(capacity / need)))


def _nmant(dtype: str) -> int:
    return {"bfloat16": 7, "float16": 10, "float32": 23, "float64": 52}.get(dtype, 23)


def _is_float(dtype: str) -> bool:
    return dtype in ("float32", "bfloat16", "float16", "float64")


class _Interp:
    def __init__(self, graph, *, cell="", rules=None):
        self.g = graph
        self.cell = cell
        self.rules = frozenset(rules if rules is not None else ("overflow", "numerics"))
        self.findings: dict[tuple, Finding] = {}
        self.proofs: list[dict] = []
        self._proof_sites: set = set()
        self.env: dict = {}
        self.maxsub: set = set()        # values of the form x - max(x)
        self.attains_one: set = set()   # values containing an element == 1

    # -- findings --------------------------------------------------------
    def _emit(self, rule, severity, message, op):
        if rule.split(".")[0] not in self.rules:
            return
        key, where = source_key(op)
        ident = (rule, key, where)
        if ident not in self.findings:
            self.findings[ident] = Finding(rule=rule, severity=severity, message=message,
                                           key=key, where=where, cell=self.cell)

    # -- values ------------------------------------------------------------
    def dtype(self, vid) -> str:
        return self.g.meta[vid][0]

    def top(self, vid) -> AbsVal:
        return R.dtype_top(self.dtype(vid))

    def read(self, vid) -> AbsVal:
        got = self.env.get(vid)
        if got is None:
            got = self.top(vid)
            self.env[vid] = got
        return got

    def arg(self, op, pos, name=None, default=None):
        """``(AbsVal, value id or None)`` of argument ``pos`` (or kwarg
        ``name``); a scalar is its point, a missing one ``default``."""
        a = op.args[pos] if pos < len(op.args) else op.kwargs.get(name, default)
        if isinstance(a, Ref):
            v = op.ins[a.i]
            return self.read(v), v
        if isinstance(a, bool):
            return R.point(float(a)), None
        if isinstance(a, (int, float)):
            return R.point(a), None
        return None, None

    def tensor_args(self, op, pos):
        """The values of a list argument (``cat``'s tensors)."""
        a = op.args[pos] if pos < len(op.args) else ()
        return [self.read(op.ins[x.i]) for x in a if isinstance(x, Ref)]

    def producer(self, vid):
        i = self.g.producer.get(vid)
        return None if i is None else self.g.ops[i]

    def origin(self, vid):
        """Chase a value back through shape-only ops to its producing value."""
        seen = 0
        while vid is not None and seen < 128:
            seen += 1
            op = self.producer(vid)
            if op is None or op.kind != "aten" or not op.ins:
                return vid
            name = base_name(op.op)
            if (name in _PASSTHROUGH or name == "_to_copy") and op.outs[0] == vid:
                vid = self._first_in(op)
                continue
            return vid
        return vid

    @staticmethod
    def _first_in(op):
        a = op.args[0] if op.args else None
        return op.ins[a.i] if isinstance(a, Ref) else op.ins[0]

    def max_dominators(self, vid) -> set:
        """Values ``x`` with ``vid >= x`` elementwise (maybe via a row max).

        Walks value-preserving ops down from ``vid``; at ``maximum(a, b)``
        (or binary ``max``) both operands are dominated and the walk goes on
        through them (an unrolled online softmax's ``m - max(m, ...)``
        reaches ``m``); at an ``amax``/``max``/``logsumexp`` reduction the
        origin of its input is dominated.  Only values reached through a max
        enter the set: ``x_i - x_j`` of two broadcasts of one ``x`` proves
        nothing."""
        out, work, visited = set(), [vid], set()
        while work and len(visited) < 256:
            v = work.pop()
            if v is None or v in visited:
                continue
            visited.add(v)
            op = self.producer(v)
            if op is None or op.kind != "aten" or not op.ins:
                continue
            name = base_name(op.op)
            if name in _PASSTHROUGH or name == "_to_copy":
                work.append(self._first_in(op))
            elif name in ("maximum", "fmax") or (name == "max" and op.overload == "other"):
                for a in op.ins:
                    out.add(a)
                    out.add(self.origin(a))
                    work.append(a)
            elif name in _MAXES and op.outs[0] == v:
                out.add(self.origin(self._first_in(op)))
        return out

    # -- interpretation ----------------------------------------------------
    def run(self, in_vals=None) -> None:
        given = dict(zip(self.g.inputs, in_vals or ()))
        for op in self.g.ops:
            outs = self._op(op, given)
            for v, val in zip(op.outs, outs):
                c = self.g.const.get(v)
                if c is not None:           # the fake tensor knows the value
                    val = AbsVal(c[0], c[1], exact=c[2] or self.dtype(v) in INT_DTYPES)
                self.env[v] = val

    def _tops(self, op) -> list:
        return [self.top(v) for v in op.outs]

    def _op(self, op, given) -> list:
        if op.kind == "input":
            v = op.outs[0]
            val = given.get(v)
            return [val if val is not None else self.top(v)]
        if op.kind == "join":
            return [R.join(self.read(op.ins[0]), self.read(op.ins[1]))]
        if op.kind == "kernel":
            return self._kernel(op)
        if op.kind == "collective":
            self._collective(op)
            return []
        name = base_name(op.op)
        handler = getattr(self, "_p_" + name, None)
        if handler is not None:
            out = handler(op)
            out = out if isinstance(out, list) else [out]
            return out + self._tops(op)[len(out):]
        if not op.ins:
            return self._tops(op)
        x = self.read(self._first_in(op))
        if name in _PASSTHROUGH:
            self._propagate_marks(op)
            return [x for _ in op.outs]
        if name in _SUBSET:
            return [x for _ in op.outs]
        if name in _BOUNDED_UNARY:
            lo, hi = _BOUNDED_UNARY[name]
            return [R.meet_interval(R.TOP, lo, hi)]
        return self._tops(op)

    def _propagate_marks(self, op):
        src = self._first_in(op)
        if src in self.maxsub:
            self.maxsub.update(op.outs)
        if src in self.attains_one:
            self.attains_one.update(op.outs)

    # ================= kernels and collectives =========================
    def _kernel(self, op) -> list:
        k = op.params.get("kernel")
        outs = self._tops(op)
        if op.op in _K2 or k == "K2":
            lim = float(op.params.get("lim", INF))
            outs[0] = AbsVal(-lim, lim, exact=True)
            if len(outs) > 1:
                outs[1] = AbsVal(0.0, INF)                       # the pitches
            if len(outs) > 2:
                outs[2] = AbsVal(0.0, float(op.params.get("elements", INF)), exact=True)
        elif op.op in _K1 or k == "K1":
            # the weights: every leaf of the keyed entry (then delta), else w
            ws = op.ins[:-1] if op.op == "sr_quant_keyed" else op.ins[:1]
            mag = max((self.read(v).mag for v in ws), default=INF)
            outs = [AbsVal(-mag, mag) for _ in op.outs]
        return outs

    def _collective(self, op) -> None:
        n = int(op.params.get("group", 1))
        dtype = op.params.get("dtype", "float32")
        if op.op not in ("all-reduce", "reduce-scatter") or n <= 1 or dtype not in INT_DTYPES:
            return
        if op.params.get("reduction", "sum") != "sum":
            return                              # a max or min keeps its operand's range
        val = self.read(op.ins[0]) if op.ins else R.dtype_top(dtype)
        summed = R.scale_by_count(val, n)
        kind = "psum" if op.op == "all-reduce" else "reduce-scatter"
        self._check_int_accumulator(op, dtype, val, summed, n, kind)

    def _check_int_accumulator(self, op, dtype, val, summed, n, kind):
        if "overflow" not in self.rules:
            return
        info = np.iinfo(np.dtype(dtype))
        cap_hi, cap_lo = float(info.max), float(info.min)
        top = R.dtype_top(dtype)
        need = summed.mag
        ok = summed.hi <= cap_hi and summed.lo >= cap_lo
        key, where = source_key(op)
        site = (kind, key, where, dtype, n)
        if site not in self._proof_sites:
            self._proof_sites.add(site)
            self.proofs.append({
                "kind": kind, "dtype": dtype, "n": n,
                "bound": None if not val.bounded else val.mag,
                "worst_sum": None if need == INF else need,
                "capacity": cap_hi,
                "headroom_bits": headroom_bits(cap_hi, need) if ok else 0,
                "ok": bool(ok), "key": key, "where": where,
                "name": op.params.get("name", ""),
            })
        if ok:
            return
        if val.lo <= top.lo and val.hi >= top.hi:
            msg = (f"{kind} over n={n} shards accumulates {dtype} values with no "
                   "provable bound (no clamp upstream): the integer sum cannot be proven "
                   "to fit the accumulator")
        else:
            msg = (f"{kind} over n={n} shards of {dtype} values in [{val.lo:g}, "
                   f"{val.hi:g}] sums to ±{need:g} > {dtype} capacity {cap_hi:g}: the "
                   "reduction wraps on the wire")
        self._emit("overflow.wire_accumulator", "error", msg, op)

    # ================= arithmetic ======================================
    def _binary(self, op):
        a, av = self.arg(op, 0, "self")
        b, bv = self.arg(op, 1, "other")
        return a or R.TOP, av, b or R.TOP, bv

    def _p_add(self, op):
        a, _, b, _ = self._binary(op)
        alpha, _ = self.arg(op, 2, "alpha")
        if alpha is not None and alpha.lo != 1.0:
            b = R.mul(b, alpha)
        return R.add(a, b)

    def _p_sub(self, op):
        a, av, b, bv = self._binary(op)
        alpha, _ = self.arg(op, 2, "alpha")
        if alpha is not None and alpha.lo != 1.0:
            b = R.mul(b, alpha)
        out = R.sub(a, b)
        # max-subtraction idiom: x - max(x) <= 0 elementwise
        if bv is not None and av is not None:
            doms = self.max_dominators(bv)
            if self.origin(av) in doms:
                out = R.meet_interval(out, -INF, 0.0)
                self.maxsub.update(op.outs)
        return out

    def _p_rsub(self, op):
        a, _, b, _ = self._binary(op)
        return R.sub(b, a)

    def _p_mul(self, op):
        a, av, b, bv = self._binary(op)
        out = R.mul(a, b)
        if av is not None and bv is not None and self.origin(av) == self.origin(bv):
            out = R.meet_interval(out, 0.0, INF)        # x * x is a square
        return out

    def _p_div(self, op):
        a, _, den, _ = self._binary(op)
        if den.contains(0.0):
            self._emit("numerics.unguarded", "warn",
                       f"div by interval {den} containing 0 with no positive guard "
                       "upstream (clamp / where(x > 0, ...) / +eps would bound it)", op)
        out = R.div(a, den)
        mode = op.kwargs.get("rounding_mode")
        if mode in ("floor", "trunc"):
            out = R.round_family(out)
        return out

    def _p_reciprocal(self, op):
        x, _ = self.arg(op, 0, "self")
        if x.contains(0.0):
            self._emit("numerics.unguarded", "warn",
                       f"div by interval {x} containing 0 with no positive guard "
                       "upstream (clamp / where(x > 0, ...) / +eps would bound it)", op)
        return R.div(R.point(1.0), x)

    def _p_neg(self, op):
        return R.neg(self.arg(op, 0, "self")[0])

    def _p_abs(self, op):
        return R.abs_(self.arg(op, 0, "self")[0])

    def _p_maximum(self, op):
        a, _, b, _ = self._binary(op)
        return R.max_(a, b)

    def _p_minimum(self, op):
        a, _, b, _ = self._binary(op)
        return R.min_(a, b)

    def _p_clamp(self, op):
        x, _ = self.arg(op, 0, "self")
        lo, _ = self.arg(op, 1, "min")
        hi, _ = self.arg(op, 2, "max")
        if hi is not None:
            x = R.min_(x, hi)
        if lo is not None:
            x = R.max_(lo, x)
        return x

    def _p_clamp_min(self, op):
        x, _ = self.arg(op, 0, "self")
        lo, _ = self.arg(op, 1, "min")
        return R.max_(lo, x) if lo is not None else x

    def _p_clamp_max(self, op):
        x, _ = self.arg(op, 0, "self")
        hi, _ = self.arg(op, 1, "max")
        return R.min_(x, hi) if hi is not None else x

    def _p_exp(self, op):
        v, vid = self.arg(op, 0, "self")
        if vid in self.maxsub:
            self.attains_one.update(op.outs)            # exp(0) = 1 is attained
            return R.exp(R.meet_interval(v, -INF, 0.0))
        if v.hi == INF and _is_float(self.dtype(vid)):
            self._emit("numerics.unguarded", "warn",
                       f"exp of unbounded interval {v} overflows to inf for moderate "
                       "inputs; subtract the running max (softmax idiom) or clamp the "
                       "exponent", op)
        return R.exp(v)

    def _p_exp2(self, op):
        return R._mono(lambda x: 2.0 ** min(x, 4000.0), self.arg(op, 0, "self")[0])

    def _p_expm1(self, op):
        v, _ = self.arg(op, 0, "self")
        return R._mono(lambda x: math.expm1(min(x, 800.0)), v)

    def _p_log(self, op):
        v, vid = self.arg(op, 0, "self")
        if v.lo <= 0 and _is_float(self.dtype(vid)):
            self._emit("numerics.unguarded", "warn",
                       f"log of interval {v} whose domain includes <= 0 with no guard "
                       "upstream (max(x, eps) or the logsumexp idiom would bound it)", op)
        return R.log(v)

    def _p_log1p(self, op):
        v, vid = self.arg(op, 0, "self")
        if v.lo <= -1 and _is_float(self.dtype(vid)):
            self._emit("numerics.unguarded", "warn",
                       f"log1p of interval {v} reaching <= -1 with no guard upstream", op)
        return R.log1p(v)

    def _p_sqrt(self, op):
        v, vid = self.arg(op, 0, "self")
        if v.lo < 0 and _is_float(self.dtype(vid)):
            self._emit("numerics.unguarded", "warn",
                       f"sqrt of interval {v} reaching below 0 (NaN) with no clamp "
                       "upstream", op)
        return R.sqrt(v)

    def _p_rsqrt(self, op):
        v, vid = self.arg(op, 0, "self")
        if v.lo <= 0 and _is_float(self.dtype(vid)):
            self._emit("numerics.unguarded", "warn",
                       f"rsqrt of interval {v} whose domain includes <= 0 with no +eps "
                       "guard upstream (rmsnorm-style `rsqrt(mean(x^2)+eps)` is the "
                       "provable form)", op)
        return R.rsqrt(v)

    def _p_pow(self, op):
        a, av, b, _ = self._binary(op)
        if op.overload == "Tensor_Scalar" and b.lo == b.hi:
            k = b.lo
            if float(k).is_integer():
                out = R.integer_pow(a, int(k))
                if int(k) % 2 == 0:
                    out = R.meet_interval(out, 0.0, INF)
                return out
            if k == 0.5:
                return R.sqrt(a)
        if a.lo > 0 and a.bounded and b.bounded:
            cands = []
            for x in (a.lo, a.hi):
                for y in (b.lo, b.hi):
                    try:
                        cands.append(x ** y)
                    except OverflowError:
                        cands.append(INF)
            return AbsVal(min(cands), max(cands))
        return R.TOP

    def _p_square(self, op):
        return R.integer_pow(self.arg(op, 0, "self")[0], 2)

    def _p_floor(self, op):
        return R.round_family(self.arg(op, 0, "self")[0], max_delta=1.0)

    _p_ceil = _p_trunc = _p_floor

    def _p_round(self, op):
        return R.round_family(self.arg(op, 0, "self")[0], max_delta=0.5)

    def _p_sign(self, op):
        return AbsVal(-1.0, 1.0, exact=True)

    def _p_relu(self, op):
        x, _ = self.arg(op, 0, "self")
        return AbsVal(max(x.lo, 0.0), max(x.hi, 0.0))

    def _p_silu(self, op):
        x, _ = self.arg(op, 0, "self")
        return AbsVal(_SILU_MIN if x.lo < 0 else 0.0, max(x.hi, 0.0))

    def _p_gelu(self, op):
        x, _ = self.arg(op, 0, "self")
        return AbsVal(_GELU_MIN if x.lo < 0 else 0.0, max(x.hi, 0.0))

    def _p_softplus(self, op):
        x, _ = self.arg(op, 0, "self")
        return AbsVal(0.0, R._clean(max(x.hi, 0.0) + _LN2))

    def _p__log_softmax(self, op):
        return AbsVal(-INF, 0.0)

    def _p_logsumexp(self, op):
        x, _ = self.arg(op, 0, "self")
        return AbsVal(x.lo, R._clean(x.hi + math.log(max(self._reduced_count(op), 1))))

    # ================= conversions / construction =====================
    def _convert(self, v: AbsVal, src: str, dst: str) -> AbsVal:
        if dst == "bool":
            return R.BOOL
        if dst in INT_DTYPES:
            conv = v if src in INT_DTYPES or src == "bool" else R.to_integer(v)
            info = np.iinfo(np.dtype(dst))
            if conv.lo < info.min or conv.hi > info.max:
                return R.dtype_top(dst)          # narrowing wraps: all bets off
            return conv
        # float target: integer exactness survives while the mantissa holds
        if v.exact and v.mag > 2.0 ** _nmant(dst):
            return AbsVal(v.lo, v.hi, exact=False, qerr=v.qerr)
        return v

    def _p__to_copy(self, op):
        self._propagate_marks(op)
        v, vid = self.arg(op, 0, "self")
        return self._convert(v, self.dtype(vid), self.dtype(op.outs[0]))

    _p_to = _p__to_copy

    def _p_copy(self, op):
        src, sid = self.arg(op, 1, "src")
        return self._convert(src, self.dtype(sid), self.dtype(op.outs[0]))

    def _fill(self, op, pos, name):
        v, _ = self.arg(op, pos, name)
        return v if v is not None else self._tops(op)[0]

    def _p_full(self, op):
        return self._fill(op, 1, "fill_value")

    _p_full_like = _p_new_full = _p_full

    def _p_fill(self, op):
        return self._fill(op, 1, "value")

    def _p_scalar_tensor(self, op):
        return self._fill(op, 0, "s")

    def _p_zeros(self, op):
        return R.point(0.0)

    _p_zeros_like = _p_new_zeros = _p_zero = _p_zeros

    def _p_ones(self, op):
        return R.point(1.0)

    _p_ones_like = _p_new_ones = _p_ones

    def _p_arange(self, op):
        nums = [a for a in op.args if isinstance(a, (int, float)) and not isinstance(a, bool)]
        start, end = (0.0, nums[0]) if len(nums) == 1 else (nums[0], nums[1])
        step = nums[2] if len(nums) > 2 else 1
        last = start + step * max(math.ceil((end - start) / step) - 1, 0)
        exact = all(float(x).is_integer() for x in (start, step))
        return AbsVal(min(start, last), max(start, last), exact=exact)

    def _p_cat(self, op):
        vals = self.tensor_args(op, 0)
        out = vals[0] if vals else R.TOP
        for v in vals[1:]:
            out = R.join(out, v)
        return out

    _p_stack = _p_cat

    def _p_constant_pad_nd(self, op):
        x, _ = self.arg(op, 0, "self")
        pad, _ = self.arg(op, 2, "value")
        return R.join(x, pad if pad is not None else R.point(0.0))

    def _p_where(self, op):
        pred_v = op.ins[op.args[0].i] if isinstance(op.args[0], Ref) else None
        a, av = self.arg(op, 1, "self")
        b, bv = self.arg(op, 2, "other")
        a, b = a or R.TOP, b or R.TOP
        # NaN-propagation selects (``where(x != x, nan_path, y)``): intervals
        # bound the real-valued elements, for which the is-NaN branch is
        # vacuous — keep the other branch instead of joining in its top
        prod = self.producer(self.origin(pred_v)) if pred_v is not None else None
        if prod is not None and prod.kind == "aten":
            pname = base_name(prod.op)
            if pname == "isnan":
                return b
            if pname in ("ne", "eq") and len(prod.ins) == 2 and \
                    self.origin(prod.ins[0]) == self.origin(prod.ins[1]):
                return b if pname == "ne" else a
        ra = self._refine_case(pred_v, av, a, taken=True)
        rb = self._refine_case(pred_v, bv, b, taken=False)
        return R.join(ra, rb)

    def _refine_case(self, pred, case_vid, case_val, *, taken) -> AbsVal:
        """Narrow a ``where`` branch with its comparison predicate.

        For ``where(x > k, x, other)`` the taken branch only sees ``x > k``:
        when the branch value IS ``x``, meet its interval with the
        half-line.  ``taken=False`` refines with the negated predicate.
        """
        if pred is None or case_vid is None:
            return case_val
        prod = self.producer(self.origin(pred))
        if prod is None or prod.kind != "aten" or base_name(prod.op) not in (
                "gt", "ge", "lt", "le"):
            return case_val
        cmp = base_name(prod.op)
        x, xv = self.arg(prod, 0, "self")
        y, yv = self.arg(prod, 1, "other")
        corigin = self.origin(case_vid)
        if xv is not None and self.origin(xv) == corigin and y is not None:
            kside = y
        elif yv is not None and self.origin(yv) == corigin and x is not None:
            kside = x
            cmp = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge"}[cmp]
        else:
            return case_val
        if kside.lo != kside.hi:
            return case_val
        kval = kside.lo
        if not taken:
            cmp = {"gt": "le", "ge": "lt", "lt": "ge", "le": "gt"}[cmp]
        eps_up = float(np.nextafter(kval, np.inf))
        eps_dn = float(np.nextafter(kval, -np.inf))
        if cmp == "gt":
            return R.meet_interval(case_val, eps_up, INF)
        if cmp == "ge":
            return R.meet_interval(case_val, kval, INF)
        if cmp == "lt":
            return R.meet_interval(case_val, -INF, eps_dn)
        return R.meet_interval(case_val, -INF, kval)

    def _p_masked_fill(self, op):
        x, _ = self.arg(op, 0, "self")
        v, _ = self.arg(op, 2, "value")
        return R.join(x, v if v is not None else R.TOP)

    def _p_index_put(self, op):
        x, _ = self.arg(op, 0, "self")
        v, vid = self.arg(op, 2, "values")
        acc = op.args[3] if len(op.args) > 3 else op.kwargs.get("accumulate", False)
        if acc:
            n = int(np.prod(self.g.meta[vid][1])) if vid is not None else 1
            return R.add(x, R.scale_by_count(R.join(R.point(0.0), v), n))
        return R.join(x, v)

    def _scatter_like(self, op, pos, name):
        x, _ = self.arg(op, 0, "self")
        v, _ = self.arg(op, pos, name)
        return R.join(x, v if v is not None else R.TOP)

    def _p_scatter(self, op):
        return self._scatter_like(op, 3, "src")

    def _p_index_copy(self, op):
        return self._scatter_like(op, 3, "source")

    def _p_slice_scatter(self, op):
        return self._scatter_like(op, 1, "src")

    _p_select_scatter = _p_slice_scatter

    def _scatter_add(self, op, pos, name):
        x, _ = self.arg(op, 0, "self")
        v, vid = self.arg(op, pos, name)
        n = int(np.prod(self.g.meta[vid][1])) if vid is not None else 1
        return R.add(x, R.scale_by_count(R.join(R.point(0.0), v or R.TOP), n))

    def _p_scatter_add(self, op):
        return self._scatter_add(op, 3, "src")

    def _p_index_add(self, op):
        return self._scatter_add(op, 3, "source")

    # ================= reductions ======================================
    def _reduced_count(self, op) -> int:
        try:
            inn = int(np.prod(self.g.meta[op.ins[0]][1]))
            out = max(int(np.prod(self.g.meta[op.outs[0]][1])), 1)
            return max(inn // out, 1)
        except (IndexError, ValueError):
            return 1

    def _p_sum(self, op):
        v, vid = self.arg(op, 0, "self")
        src = self.dtype(vid)
        dst = self.dtype(op.outs[0])
        if dst in INT_DTYPES and src not in INT_DTYPES and src != "bool":
            v = R.to_integer(v)
        out = R.scale_by_count(v, self._reduced_count(op))
        if vid in self.attains_one and v.lo >= 0.0:
            # the tensor provably holds an element == 1 and none negative
            out = R.meet_interval(out, 1.0, INF)
        return out

    def _p_mean(self, op):
        return self.arg(op, 0, "self")[0]

    def _p_amax(self, op):
        v, vid = self.arg(op, 0, "self")
        if vid in self.attains_one:
            v = R.meet_interval(v, 1.0, INF)
        return v

    def _p_max(self, op):
        if op.overload == "other":
            a, _, b, _ = self._binary(op)
            return R.max_(a, b)
        v = self._p_amax(op)
        if len(op.outs) > 1:                   # (values, indices)
            return [v, self._index_range(op)]
        return v

    def _p_amin(self, op):
        return self.arg(op, 0, "self")[0]

    def _p_min(self, op):
        if op.overload == "other":
            a, _, b, _ = self._binary(op)
            return R.min_(a, b)
        v = self._p_amin(op)
        return [v, self._index_range(op)] if len(op.outs) > 1 else v

    def _index_range(self, op) -> AbsVal:
        return AbsVal(0.0, float(max(self._reduced_count(op) - 1, 0)), exact=True)

    def _p_argmax(self, op):
        v, vid = self.arg(op, 0, "self")
        if len(op.args) < 2 or op.args[1] is None:
            n = int(np.prod(self.g.meta[vid][1]))
            return AbsVal(0.0, float(max(n - 1, 0)), exact=True)
        return self._index_range(op)

    _p_argmin = _p_argmax

    def _p_cumsum(self, op):
        v, vid = self.arg(op, 0, "self")
        dim = op.args[1] if len(op.args) > 1 else op.kwargs.get("dim", 0)
        try:
            n = int(self.g.meta[vid][1][dim])
        except (IndexError, TypeError):
            n = 1
        return R.scale_by_count(v, n)

    def _p_topk(self, op):
        v, vid = self.arg(op, 0, "self")
        n = self.g.meta[vid][1][-1] if self.g.meta[vid][1] else 1
        return [v, AbsVal(0.0, float(max(n - 1, 0)), exact=True)]

    _p_sort = _p_topk

    def _dot(self, op, a_pos, b_pos):
        a, av = self.arg(op, a_pos, "mat1")
        b, _ = self.arg(op, b_pos, "mat2")
        try:
            k = int(self.g.meta[av][1][-1])
        except (IndexError, TypeError):
            k = 1
        return R.scale_by_count(R.mul(a or R.TOP, b or R.TOP), k)

    def _p_mm(self, op):
        return self._dot(op, 0, 1)

    _p_bmm = _p_dot = _p_vdot = _p_mv = _p_matmul = _p_mm

    def _p_addmm(self, op):
        bias, _ = self.arg(op, 0, "self")
        return R.add(bias or R.TOP, self._dot(op, 1, 2))

    _p_baddbmm = _p_addmv = _p_addmm

    # ================= predicates ======================================
    def _p_eq(self, op):
        return R.BOOL

    _p_ne = _p_lt = _p_le = _p_gt = _p_ge = _p_eq
    _p_isfinite = _p_isnan = _p_isinf = _p_logical_and = _p_logical_or = _p_eq
    _p_logical_not = _p_logical_xor = _p_eq

    def _p_bitwise_not(self, op):
        return R.BOOL if self.dtype(op.outs[0]) == "bool" else self._tops(op)[0]

    _p_bitwise_and = _p_bitwise_or = _p_bitwise_xor = _p_bitwise_not


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def abstract_eval(record, in_vals=None, *, axis_sizes=None, rules=()) -> list[AbsVal]:
    """Propagate AbsVals through a traced step; returns the values of its
    marked outputs (``Graph.outputs``).

    ``in_vals``: one AbsVal per recording argument tensor (None entries
    default to the dtype top).  With ``rules=()`` this is a pure evaluator —
    the form the soundness property tests drive.
    """
    return interpret_jaxpr(record, in_vals=in_vals, axis_sizes=axis_sizes, rules=rules).out


def interpret_jaxpr(record, *, in_vals=None, axis_sizes=None, cell="",
                    rules=("overflow", "numerics")) -> AbsintResult:
    """Interpret one traced step (a Record kept with ``graph=True``, or its
    graph; the reference's name, which took a jaxpr); returns findings +
    proofs + output values.  ``axis_sizes`` is accepted for the reference's
    signature: each collective node carries its group size."""
    del axis_sizes
    g = graph_of(record)
    interp = _Interp(g, cell=cell, rules=rules)
    interp.run(in_vals)
    return AbsintResult(findings=list(interp.findings.values()), proofs=interp.proofs,
                        out=[interp.read(v) if v is not None else R.TOP for v in g.outputs])
