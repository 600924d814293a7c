"""``Session.analyze`` of the port against the JAX reference's.

``tests/fixtures/analyze_reference.json`` (written by
``tests/analyze_reference.py``) holds the reference's findings and proof
records for three smoke specs: yi-6b serve 1x1 ``lazy_int8(7)``, yi-6b train
4x1 comm 8, mamba2-780m train 1x1.  The port's
``Session(spec, device="cpu").analyze(compile=True, allowlist=None,
proofs=[])`` gives the same identities and the same proof numbers, up to
the divergences named in ROADMAP §3, each with a test here:

* D8: the reference's keys are ``?`` (under jax 0.9.0 its ``source_key``
  cannot read a frame), so identities are compared with the key masked and
  the port's keys are held on their own;
* D9: the reference's packed decode cell reports ``precision.no_fastpath``
  (its ``pallas_call`` equations carry no ``name_and_src_info`` under jax
  0.9.0, so no K3 counts as the fast path); the port's has K3 nodes and no
  finding;
* D10: the wire's bound comes from K2's contract, not from a clip in the
  graph (the same proof numbers).

The module's first test starts the reference's rerun of one fixture entry
in a subprocess, which the other tests overlap.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.api import RunSpec, Session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from analyze_reference import PROOF_FIELDS, SPECS, entry  # noqa: E402

with open(os.path.join(ROOT, "tests", "fixtures", "analyze_reference.json")) as fh:
    FIXTURE = json.load(fh)

#: the cell rerun live with the reference (the cheapest)
LIVE = "mamba"


@pytest.fixture(autouse=True, scope="module")
def _reference_rerun():
    """The reference's analysis of the LIVE spec, in a subprocess."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "analyze_reference.py"),
                             "--only", LIVE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    yield proc
    proc.kill() if proc.poll() is None else None


@pytest.fixture(scope="module")
def port():
    """``{name: (findings, proofs)}`` of the port's analysis of each spec."""
    out = {}
    for name, d in SPECS.items():
        proofs = []
        findings = Session(RunSpec.from_dict(d), device="cpu").analyze(
            compile=True, allowlist=None, proofs=proofs)
        out[name] = (findings, proofs)
    return out


def _masked(findings):
    """``{rule|?|cell: severity}``: identities with the key masked (D8)."""
    return sorted({"|".join((r, "?", c)): s for r, _k, c, s in (
        (*ident.split("|"), sev) for ident, sev in findings)}.items())


def _masked_proofs(proofs):
    return sorted((json.dumps({**{k: p.get(k) for k in PROOF_FIELDS}, "key": "?"},
                              sort_keys=True) for p in proofs))


#: D9: what the reference reports and the port does not
D9 = {"serve": ["precision.no_fastpath|?|serve:decode"]}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_identities_and_proofs_equal_the_references(name, port):
    want = FIXTURE["entries"][name]
    got = entry(*port[name])
    ref = [(i, s) for i, s in _masked(want["findings"]) if i not in D9.get(name, [])]
    assert _masked(got["findings"]) == ref
    assert _masked_proofs(got["proofs"]) == _masked_proofs(want["proofs"])


def test_d8_the_ports_keys_name_file_and_function(port):
    """The reference's keys are all ``?``; the port's are ``file.py:function``
    (mamba2: the A = -exp(a_log) helper and the SSD scan of ``ssm.py``, where
    the reference's committed baseline, written under an older jax, names
    ``ssm.py:ssm_block``)."""
    assert [i for i, _s in FIXTURE["entries"]["mamba"]["findings"]] == \
        ["numerics.unguarded|?|train:train_step"]
    assert all(p["key"] == "?" for p in FIXTURE["entries"]["train"]["proofs"]
               if p["kind"] == "psum")
    mamba = {f.key for f in port["mamba"][0]}
    assert mamba == {"ssm.py:_dt_and_decay_rate", "ssm.py:_ssd_scan"}
    train = {f.key for f in port["train"][0]}
    assert train == {"module:comm_report", "all-reduce:s32"}
    keys = {p["key"] for p in port["train"][1] if p["kind"] == "psum"}
    assert keys == {"collectives.py:_record_codes", "collectives.py:_record_wire"}


def test_d9_the_packed_decode_cell_keeps_its_fast_path(port):
    assert dict(FIXTURE["entries"]["serve"]["findings"]) == \
        {"precision.no_fastpath|module:no_fastpath|serve:decode": "warn"}
    rules = {f.rule for f in port["serve"][0]}
    assert "precision.no_fastpath" not in rules and "precision.eager_dequant" not in rules
    sess = Session(RunSpec.from_dict(SPECS["serve"]), device="cpu")
    from repro_torch.analyze.runner import lint_cells

    (label, decode), _prefill = lint_cells(sess)
    rec, _meta = sess.trace(decode, graph=True)
    k3 = [op for op in rec.graph.by_kind("kernel") if op.op == "quant_matmul"]
    assert label == "serve:decode" and len(k3) == 15


def test_d10_the_wire_bound_is_k2s_contract(port):
    """The codes' all-reduce reads K2's codes, whose interval is [-lim, lim]
    by the kernel's contract: 8-bit codes over 4 clients sum to 1,020 in int16."""
    (p,) = [p for p in port["train"][1] if p.get("name") == "quantized_psum_batch codes"]
    assert (p["bound"], p["worst_sum"], p["dtype"], p["headroom_bits"]) == \
        (255.0, 1020.0, "int16", 5)
    sess = Session(RunSpec.from_dict(SPECS["train"]), device="cpu")
    from repro_torch.analyze.runner import lint_cells

    ((_label, cell),) = lint_cells(sess)
    rec, _ = sess.trace(cell, graph=True)
    g = rec.graph
    codes = [op for op in g.by_kind("collective") if op.params["name"].endswith("codes")]
    assert codes and all(g.ops[g.producer[op.ins[0]]].op == "sr_pack_keyed" for op in codes)


def test_d5_more_records_than_the_combiner_leaves_and_no_finding_more(port):
    """The port records every all-reduce the reference issues (D5: 32 here,
    12 after XLA's combiner): the rules are per record and the byte check
    sums, so the findings are the reference's."""
    sess = Session(RunSpec.from_dict(SPECS["train"]), device="cpu")
    from repro_torch.analyze.runner import lint_cells

    ((_label, cell),) = lint_cells(sess)
    rec, _ = sess.trace(cell, graph=True)
    assert sum(c.kind == "all-reduce" for c in rec.collectives) == 32
    wire = sorted({f.rule for f in port["train"][0] if f.rule.startswith("wire.")})
    assert wire == ["wire.comm_report_mismatch", "wire.wide_allreduce"]


def test_comm_report_differs_by_the_non_finite_counts_only():
    """check_comm_report's mismatch is the int32 non-finite count a
    replicated leaf (4 bytes each), which comm_report() does not account;
    the codes' bytes agree (the analyze_torch.toml entry's reason)."""
    sess = Session(RunSpec.from_dict(SPECS["train"]), device="cpu")
    from repro_torch.analyze.runner import lint_cells

    ((_label, cell),) = lint_cells(sess)
    rec, _ = sess.trace(cell)
    rep = sess.comm_report()
    codes = [c for c in rec.collectives if c.name.endswith("codes")]
    counts = [c for c in rec.collectives if c.name.endswith("non-finite count")]
    assert sum(c.elems * 2 * c.mult for c in codes) == rep["replicated_elems"] * 2
    assert len(counts) == len(codes) and all(c.dtype == "s32" for c in counts)


def test_allowlisted_cells_have_no_error(port, tmp_path):
    from repro_torch.analyze.allowlist import apply_allowlist, load_allowlist
    from repro_torch.analyze.findings import at_or_above

    entries = load_allowlist(os.path.join(ROOT, "analyze_torch.toml"))
    for name, (findings, _proofs) in port.items():
        assert at_or_above(apply_allowlist(findings, entries), "error") == [], name


def test_fixture_is_the_reference_here(_reference_rerun):
    """The cheapest fixture entry, rerun with the reference."""
    out, err = _reference_rerun.communicate(timeout=600)
    assert _reference_rerun.returncode == 0, err[-2000:]
    assert json.loads(out.strip().splitlines()[-1]) == FIXTURE["entries"][LIVE]
