"""The port's graph rules (repro_torch.analyze: ranges, precision_flow,
absint) against the JAX reference's (repro.analyze).

* lattice parity: every ``ranges`` operation gives the reference's fields
  bit for bit on the same intervals (seeded and hypothesis-drawn);
* seeded defects: tiny torch functions traced through
  ``count.recording(graph=True)`` under ``FakeTensorMode``, one finding per
  planted defect and none for the guarded idiom (the rules of
  tests/test_analyze.py and tests/test_absint.py; the reference fails some
  of those under jax 0.9.0, ROADMAP §3, and the port is held to the rule);
* soundness: the function run on concrete CPU tensors lands inside the
  interval the interpreter gives for its trace;
* the graph changes no cost, peak or collective of a record.
"""

import math
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

import repro  # noqa: F401  (installs the jax compat shims)
from repro.analyze import ranges as RR
from repro_torch.analyze import ranges as R
from repro_torch.analyze.absint import abstract_eval, interpret_jaxpr
from repro_torch.analyze.precision_flow import lint_jaxpr
from repro_torch.analyze.ranges import INF, AbsVal
from repro_torch.api import PrecisionPolicy
from repro_torch.kernels import ops
from repro_torch.roofline import count

LAZY = PrecisionPolicy.lazy_int8()


def trace(fn, *specs):
    """Trace ``fn`` on fake tensors of ``specs`` ((shape, dtype) each) with
    the graph kept; the function's tensor results are the graph's outputs."""
    with FakeTensorMode():
        args = [torch.empty(shape, dtype=dtype) for shape, dtype in specs]
        with count.recording(args, graph=True) as rec:
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            rec.graph.mark_outputs(*[o for o in outs if isinstance(o, torch.Tensor)])
    return rec


# ---------------------------------------------------------------------------
# Lattice parity with the reference
# ---------------------------------------------------------------------------


def _bits(v):
    return (struct.pack("<d", v.lo), struct.pack("<d", v.hi), v.exact,
            struct.pack("<d", v.qerr))


def _pair(lo, hi, exact=False, qerr=0.0):
    return AbsVal(lo, hi, exact=exact, qerr=qerr), RR.AbsVal(lo, hi, exact=exact, qerr=qerr)


_EDGES = [-INF, INF, 0.0, -0.0, 1.0, -1.0, 0.5, 255.0, -255.0, 1e-300, 5e-324, 1e300,
          float("nan")]
_ENDS = st.one_of(st.sampled_from(_EDGES), st.floats(-1e6, 1e6), st.floats(-3.0, 3.0))
_ABSVALS = st.tuples(_ENDS, _ENDS, st.booleans(), st.sampled_from([0.0, 0.5, 1e-3, INF]))

_BINARY = ("join", "widen", "add", "sub", "mul", "div", "min_", "max_")
_UNARY = ("neg", "abs_", "to_integer", "round_family", "exp", "log", "log1p", "sqrt",
          "rsqrt")


def _outcome(fn, *args, **kw):
    """The bits of ``fn``'s result, or the exception it raises (the
    reference raises on some degenerate intervals, and so must the port)."""
    try:
        return _bits(fn(*args, **kw))
    except Exception as e:                                # noqa: BLE001
        return type(e).__name__


def _same(name, port_args, ref_args, **kw):
    got = _outcome(getattr(R, name), *port_args, **kw)
    want = _outcome(getattr(RR, name), *ref_args, **kw)
    assert got == want, (name, port_args, got, want)


@settings(max_examples=150, deadline=None)
@given(a=_ABSVALS, b=_ABSVALS, c=_ABSVALS, n=st.integers(0, 1 << 20), k=st.integers(-3, 4))
def test_every_lattice_operation_is_the_references_bit_for_bit(a, b, c, n, k):
    (pa, ra), (pb, rb), (pc, rc) = _pair(*a), _pair(*b), _pair(*c)
    assert _bits(pa) == _bits(ra)
    for name in _BINARY:
        _same(name, (pa, pb), (ra, rb))
    for name in _UNARY:
        _same(name, (pa,), (ra,))
    _same("clamp", (pa, pb, pc), (ra, rb, rc))
    _same("scale_by_count", (pa, n), (ra, n))
    _same("integer_pow", (pa, k), (ra, k))
    _same("round_family", (pa,), (ra,), max_delta=0.5)
    lo, hi = sorted(x if x == x else 0.0 for x in (b[0], b[1]))
    _same("meet_interval", (pa, lo, hi), (ra, lo, hi))
    assert (pa.mag, pa.bounded, pa.contains(b[0]), repr(pa)) == \
        (ra.mag, ra.bounded, ra.contains(b[0]), repr(ra))


def test_lattice_parity_on_seeded_intervals():
    rng = np.random.default_rng(26)
    for _ in range(200):
        lo, hi = sorted(rng.normal(0, 10.0 ** rng.integers(-3, 6), 2).tolist())
        a, ra = _pair(lo, hi, bool(rng.integers(2)), float(rng.choice([0.0, 0.25])))
        b, rb = _pair(*sorted(rng.normal(0, 5, 2).tolist()))
        for name in _BINARY:
            _same(name, (a, b), (ra, rb))
        for name in _UNARY:
            _same(name, (a,), (ra,))
        assert _bits(R.point(lo)) == _bits(RR.point(lo))
        assert _bits(R.interval(lo, hi, exact=True)) == _bits(RR.interval(lo, hi, exact=True))


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint8", "bool",
                                   "float32", "float64"])
def test_dtype_tops_are_the_references(dtype):
    assert _bits(R.dtype_top(dtype)) == _bits(RR.dtype_top(np.dtype(dtype)))
    assert _bits(R.dtype_top(getattr(torch, dtype))) == _bits(RR.dtype_top(np.dtype(dtype)))


def test_lattice_units():
    """The reference's TestLattice cases, on the port's lattice."""
    assert (R.join(AbsVal(0, 1), AbsVal(3, 5)).lo, R.join(AbsVal(0, 1), AbsVal(3, 5)).hi) == (0, 5)
    assert R.widen(AbsVal(0, 1), AbsVal(0, 2)).hi == INF
    assert R.widen(AbsVal(0, INF), AbsVal(0, INF)) == AbsVal(0, INF)
    assert R.mul(AbsVal(0, 0), AbsVal(-INF, INF)).contains(0.0)
    assert (AbsVal(math.nan, math.nan).lo, AbsVal(3, 1).hi) == (-INF, INF)
    s = R.scale_by_count(AbsVal(-3, 7, exact=True), 4)
    assert (s.lo, s.hi, s.exact) == (-12, 28, True)
    assert R.exp(AbsVal(-INF, 0)).hi <= 1.0 + 1e-12
    assert R.mul(AbsVal(-1, 1, qerr=0.5), AbsVal(2, 2)).qerr == pytest.approx(1.0)
    assert R.dtype_top("bfloat16") == R.TOP


# ---------------------------------------------------------------------------
# precision.* — the taint walk
# ---------------------------------------------------------------------------


def _eager(x, codes, scale):
    w = codes.to(torch.float32) * scale                  # eager dequant
    return x @ w


def test_eager_dequant_matmul_exactly_one():
    rec = trace(_eager, ((4, 64), torch.float32), ((64, 64), torch.int8), ((), torch.float32))
    found = [f for f in lint_jaxpr(rec, policy=LAZY) if f.severity == "error"]
    assert len(found) == 1
    f = found[0]
    assert f.rule == "precision.eager_dequant"
    assert f.key == "test_torch_analyze.py:_eager"        # file provenance
    assert "rhs" in f.message


def test_unrolled_loop_dequant_reported_once():
    def step(x, codes, scale):
        for layer in range(3):                            # an eager trace unrolls it
            x = x @ (codes[layer].to(torch.float32) * scale)
        return x

    rec = trace(step, ((4, 64), torch.float32), ((3, 64, 64), torch.int8), ((), torch.float32))
    found = [f for f in lint_jaxpr(rec, policy=LAZY) if f.rule == "precision.eager_dequant"]
    assert len(found) == 1, "one finding per (rule, key, where)"


def test_quant_matmul_fast_path_clean():
    rec = trace(ops.quant_matmul, ((8, 128), torch.float32), ((128, 128), torch.int8),
                ((1,), torch.float32))
    assert lint_jaxpr(rec, policy=LAZY, expect_fastpath=True) == []
    assert [op.op for op in rec.graph.by_kind("kernel")] == ["quant_matmul"]


def test_no_fastpath_warning():
    rec = trace(lambda x, w: x @ w, ((4, 64), torch.float32), ((64, 64), torch.float32))
    found = lint_jaxpr(rec, policy=LAZY, expect_fastpath=True)
    assert [f.rule for f in found] == ["precision.no_fastpath"]
    assert found[0].severity == "warn"
    assert lint_jaxpr(rec, policy=LAZY, expect_fastpath=False) == []


def test_int32_token_ids_do_not_taint():
    def step(tokens, table, w):
        return torch.nn.functional.embedding(tokens, table) @ w

    rec = trace(step, ((4,), torch.int32), ((100, 64), torch.float32),
                ((64, 64), torch.float32))
    assert [f for f in lint_jaxpr(rec, policy=LAZY)
            if f.rule == "precision.eager_dequant"] == []


def test_embedding_of_codes_does_not_taint_but_a_partial_write_does():
    def step(tokens, codes, buf, w):
        rows = codes[tokens].to(torch.float32)           # a lookup: no taint
        y = rows @ w
        buf[:2] = codes[:2].to(torch.float32)            # dequant into a view
        return y, buf @ w

    rec = trace(step, ((4,), torch.int64), ((64, 64), torch.int8),
                ((64, 64), torch.float32), ((64, 64), torch.float32))
    found = [f for f in lint_jaxpr(rec, policy=LAZY) if f.rule == "precision.eager_dequant"]
    assert len(found) == 1 and "lhs" in found[0].message


def _record(dtype, group=4):
    def step(c):
        count.record_collective("all-reduce", dtype, c.numel(), group, "codes psum",
                                operand=c)
        return c
    return step


def test_narrow_accumulator_exactly_one():
    # 4 clients of 8-bit codes need int16: an int8 accumulator overflows
    rec = trace(_record(torch.int8), ((4, 64), torch.int8))
    found = lint_jaxpr(rec, policy=PrecisionPolicy(comm=8))
    assert [f.rule for f in found] == ["precision.narrow_accumulator"]
    assert found[0].severity == "error"
    assert found[0].key == "test_torch_analyze.py:step"
    rec32 = trace(_record(torch.int32), ((4, 64), torch.int32))
    assert lint_jaxpr(rec32, policy=PrecisionPolicy(comm=8)) == []


# ---------------------------------------------------------------------------
# overflow.* / numerics.* — the interval interpreter
# ---------------------------------------------------------------------------


def _quant_allreduce(wire_dtype):
    def step(g):
        codes = torch.clamp(torch.round(g * 255.0), 0, 255).to(wire_dtype)
        count.record_collective("all-reduce", wire_dtype, codes.numel(), 4, "codes psum",
                                operand=codes)
        return codes
    return trace(step, ((16,), torch.float32))


def test_clipped_codes_into_wide_accumulator_prove():
    res = interpret_jaxpr(_quant_allreduce(torch.int32), rules=("overflow",))
    assert not res.findings
    ps = [p for p in res.proofs if p["kind"] == "psum"]
    assert ps and all(p["ok"] for p in ps)
    assert ps[0]["worst_sum"] == 1020
    assert ps[0]["headroom_bits"] >= 20


def test_seeded_negative_narrow_accumulator():
    res = interpret_jaxpr(_quant_allreduce(torch.int8), rules=("overflow",))
    errs = [f for f in res.findings if f.rule == "overflow.wire_accumulator"]
    assert len(errs) == 1
    assert errs[0].severity == "error" and "int8" in errs[0].message


def test_unclamped_int_sum_flagged():
    res = interpret_jaxpr(trace(_record(torch.int32), ((8,), torch.int32)),
                          rules=("overflow",))
    errs = [f for f in res.findings if f.rule == "overflow.wire_accumulator"]
    assert len(errs) == 1
    assert "no provable bound" in errs[0].message


def test_k2_contract_bounds_the_wire():
    """The port's bound comes from K2's contract: codes in [-lim, lim]."""
    def step(g, u):
        step_ = torch.full((1,), 0.01)
        offsets = torch.tensor([0, g.shape[1]], dtype=torch.int32)
        codes = ops.sr_pack_segments(g, offsets, step_, u, 255, torch.int16)
        count.record_collective("all-reduce", torch.int16, codes.numel(), 4, "codes",
                                operand=codes)
        return codes

    res = interpret_jaxpr(trace(step, ((4, 32), torch.float32), ((4, 32), torch.float32)))
    (p,) = res.proofs
    assert (p["bound"], p["worst_sum"], p["headroom_bits"], p["ok"]) == (255.0, 1020.0, 5, True)
    assert res.findings == []


def _numerics(fn, *specs):
    return interpret_jaxpr(trace(fn, *specs), rules=("overflow", "numerics")).findings


X8 = ((8,), torch.float32)


def test_unguarded_exp_flagged():
    assert [f.rule for f in _numerics(lambda x: torch.exp(x).sum(), X8)] == \
        ["numerics.unguarded"]


def test_softmax_idioms_proven():
    def explicit(x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)

    assert _numerics(lambda x: torch.softmax(x, -1), ((4, 8), torch.float32)) == []
    assert _numerics(explicit, ((4, 8), torch.float32)) == []
    # logsumexp dominates its input: the cross-entropy backward's exp(x - lse)
    assert _numerics(lambda x: torch.exp(x - torch.logsumexp(x, -1, True)),
                     ((4, 8), torch.float32)) == []


def test_online_softmax_unrolled_proven():
    """m_new = max(m, rowmax(s)) over an unrolled loop of key blocks."""
    def online(s_all):
        m = torch.full((4,), -torch.inf)
        acc = torch.zeros((4, 1))
        for s in s_all:
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            acc = acc * corr[..., None] + p.sum(-1, keepdim=True)
            m = m_new
        return acc

    assert _numerics(online, ((3, 4, 8), torch.float32)) == []


def test_differences_of_one_value_prove_nothing():
    """x_i - x_j of two broadcasts of one value is not a max subtraction."""
    found = _numerics(lambda x: torch.exp(x[:, None] - x[None, :]), X8)
    assert [f.rule for f in found] == ["numerics.unguarded"]


def test_guarded_log_clean_unguarded_flagged():
    assert _numerics(lambda x: torch.log(torch.clamp(x, min=1e-9)), X8) == []
    assert [f.rule for f in _numerics(torch.log, X8)] == ["numerics.unguarded"]


def test_div_by_eps_guarded_clean():
    assert _numerics(lambda x: x / (x.abs() + 1e-6), X8) == []
    assert [f.rule for f in _numerics(lambda x: 1.0 / x, X8)] == ["numerics.unguarded"]


def test_where_guard_gives_a_positive_scale():
    """The wire quantizer's ``s = where(s > 0, s, 1)``: dividing by it is clean."""
    def step(g):
        s = g.abs().amax()
        s = torch.where(s > 0, s, torch.ones_like(s))
        return g / s

    assert _numerics(step, X8) == []
    assert [f.rule for f in _numerics(lambda g: g / g.abs().amax(), X8)] == \
        ["numerics.unguarded"]


def test_rmsnorm_rsqrt_proven():
    assert _numerics(lambda x: x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6),
                     ((4, 8), torch.float32)) == []


# ---------------------------------------------------------------------------
# Soundness: concrete values land inside the interpreter's interval
# ---------------------------------------------------------------------------


def _assert_inside(val, iv: AbsVal, slack=1e-6):
    arr = np.asarray(val, dtype=np.float64)
    assert np.all(arr >= iv.lo - slack), (arr.min(), iv)
    assert np.all(arr <= iv.hi + slack), (arr.max(), iv)


@settings(max_examples=20, deadline=None)
@given(x=st.floats(-50.0, 50.0), bits=st.sampled_from([2, 4, 8]))
def test_soundness_dequant_idiom(x, bits):
    """round(x/step)*step stays in the interval AND within qerr."""
    step = 2.0 / (2 ** bits - 1)

    def deq(v):
        return torch.round(v / step) * step

    (iv,) = abstract_eval(trace(deq, ((4,), torch.float32)), [AbsVal(-abs(x), abs(x))])
    v = np.clip(np.array([x, -x, x / 3, 0.0], np.float32), -abs(x), abs(x))
    _assert_inside(deq(torch.from_numpy(v)), iv, slack=step)
    assert iv.qerr >= step * 0.5 - 1e-12


@settings(max_examples=15, deadline=None)
@given(x=st.floats(0.1, 100.0))
def test_soundness_rsqrt(x):
    def run(v):
        return torch.rsqrt(v + 1e-6)

    (iv,) = abstract_eval(trace(run, ((), torch.float32)), [AbsVal(0.1, 100.0)])
    _assert_inside(run(torch.tensor(x, dtype=torch.float32)), iv)


@settings(max_examples=15, deadline=None)
@given(x=st.floats(-10.0, 10.0), flag=st.booleans())
def test_soundness_where_join(x, flag):
    """A where's result lands inside the join of its branches' intervals."""
    def run(p, v):
        return torch.where(p, torch.tanh(v), torch.clamp(v, -2.0, 2.0))

    (iv,) = abstract_eval(trace(run, ((), torch.bool), ((), torch.float32)),
                          [None, AbsVal(-abs(x), abs(x))])
    _assert_inside(run(torch.tensor(flag), torch.tensor(x, dtype=torch.float32)), iv)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 6), x0=st.floats(-2.0, 2.0))
def test_soundness_unrolled_carry(n, x0):
    """A decaying carry over an unrolled loop stays inside its interval."""
    def run(x):
        c = torch.zeros(())
        for _ in range(n):
            c = 0.5 * c + torch.clamp(x.sum(), -1.0, 1.0)
        return c

    (iv,) = abstract_eval(trace(run, ((2,), torch.float32)), [AbsVal(-abs(x0), abs(x0))])
    _assert_inside(run(torch.tensor([x0 / 2, x0 / 2], dtype=torch.float32)), iv)


# ---------------------------------------------------------------------------
# The graph: values keyed by storage, view and version; nothing else changes
# ---------------------------------------------------------------------------


def test_in_place_write_through_a_view_joins_into_its_storage():
    def step(base, src):
        base.zero_()
        base[1:3].copy_(torch.clamp(src, 5.0, 6.0))      # a partial write
        return base

    (iv,) = abstract_eval(trace(step, ((4, 2), torch.float32), ((2, 2), torch.float32)))
    assert (iv.lo, iv.hi) == (0.0, 6.0)


def test_graph_holds_no_tensor_and_numbers_values():
    rec = trace(_eager, ((4, 64), torch.float32), ((64, 64), torch.int8), ((), torch.float32))
    g = rec.graph
    assert len(g.inputs) == 3 and g.outputs[0] is not None
    for op in g.ops:
        for v in (*op.args, *op.kwargs.values()):
            assert not isinstance(v, torch.Tensor)
    assert [op.op for op in g.ops if op.kind == "aten"] == ["_to_copy", "mul", "mm"]


def test_a_smoke_cell_records_alike_with_and_without_the_graph():
    from repro_torch.api import RunSpec, Session
    from repro_torch.configs.base import ShapeSpec

    for kind, mesh, seq, policy in (("train", "4x1", 16, PrecisionPolicy(comm=8)),
                                    ("decode", "1x1", 32, LAZY)):
        sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=mesh, precision=policy),
                       device="cpu")
        recs = [sess.trace(ShapeSpec("cell", seq, 4, kind), graph=g)[0] for g in (False, True)]
        a, b = recs
        assert a.graph is None and b.graph is not None
        assert a.nodes == b.nodes
        assert (a.peak_bytes, a.argument_bytes, a.output_bytes) == \
            (b.peak_bytes, b.argument_bytes, b.output_bytes)
        assert count.costs(a).to_dict() == count.costs(b).to_dict()
