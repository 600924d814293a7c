"""Orchestrate the rule families over one Session (nothing executed).

:func:`analyze_session` is what ``Session.analyze()`` and the CLI call: it
decides which step graphs a RunSpec implies (train -> its train step; serve
-> the packed decode step plus a prefill; dryrun -> its shape cell), traces
each with :meth:`~repro_torch.api.session.Session.trace` (``graph=True``:
under ``FakeTensorMode`` on the session's device, K1-K5 on their trace
route) for the precision-flow lint and the interval interpreter, runs the
wire lint over the trace's collective records, and the kernel checker over
the shipped :class:`~repro_torch.kernels.spec.KernelSpec` metadata at this
config's dimensions.  ``fl-sim`` cells have no model-zoo step graph to lint
(the CNN simulation is not a model-zoo graph) and are skipped with an info
finding.  A mesh with a model axis above 1 is traced as one device of it,
its model group a stand-in (:func:`repro_torch.launch.mesh.trace_axis_ctx`),
so its model collectives are ``collective`` nodes of the graph and records
of the wire lint like the batch group's.  Counterpart of ``repro/analyze/runner.py``.
"""

from __future__ import annotations

from repro_torch.analyze.allowlist import apply_allowlist, load_allowlist
from repro_torch.analyze.findings import Finding

DEFAULT_ALLOWLIST = "analyze_torch.toml"


def _pow2_at_least(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def lint_cells(session) -> list[tuple[str, object]]:
    """(label, shape-arg for ``Session.trace``) per step graph to lint."""
    from repro_torch.configs.base import ShapeSpec

    spec = session.spec
    wl = spec.workload
    if wl == "dryrun":
        name = spec.opt("shape")
        return [(f"dryrun:{name}", name)]
    if wl in ("train", "fl-orchestrate"):
        n_clients = max(_axes(session).dp, 1)
        cell = ShapeSpec("train_step", seq_len=spec.seq, global_batch=n_clients * spec.batch,
                         kind="train")
        return [(f"{wl}:train_step", cell)]
    if wl == "serve":
        s_max = int(spec.opt("s_max", spec.seq))
        bucket = _pow2_at_least(int(spec.opt("prompt_len", 8)))
        return [
            ("serve:decode",
             ShapeSpec("serve_decode", seq_len=s_max, global_batch=spec.batch, kind="decode")),
            ("serve:prefill",
             ShapeSpec("serve_prefill", seq_len=bucket, global_batch=spec.batch,
                       kind="prefill")),
        ]
    return []                                     # fl-sim


def _axes(session):
    """The axis sizes of the session's mesh, as one traced device sees them
    (no process group needed)."""
    from repro_torch.launch.mesh import trace_axis_ctx

    return trace_axis_ctx(session.spec.mesh)


def _wire_context(session, kind: str):
    from repro_torch.analyze.wire_lint import WireContext, expected_gathers

    axes, policy = _axes(session), session.policy
    fsdp, tp = axes.fsdp, axes.tp
    return WireContext(
        policy=policy, kind=kind, n_clients=max(axes.dp, 1), fsdp=fsdp, tp=tp,
        expected_gather_dtypes=expected_gathers(
            fsdp=fsdp, tp=tp, packed=policy.packed and kind != "train",
            gather_bf16=getattr(session.cfg, "fsdp_gather_dtype", "") == "bfloat16"))


def _kernel_cells(session) -> list:
    """The shipped specs at this config's dimensions.  A head dim the
    kernels do not take (an SSM config has none) is checked at the
    smallest one they take above it.  An encoder's self-attention runs K4
    without its causal mask (``models/encdec.py:encode``), so an enc-dec
    config adds K4's two paths non-causal."""
    import torch

    from repro_torch.analyze.kernel_check import shipped_kernel_specs
    from repro_torch.kernels.flash_attention import HEAD_DIMS, attention_spec

    cfg = session.cfg
    d = int(getattr(cfg, "d_model", 512)) or 512
    heads = int(getattr(cfg, "n_heads", 8)) or 8
    hd = int(cfg.resolved_head_dim) if hasattr(cfg, "resolved_head_dim") \
        else max(d // heads, 8)
    hd = next((h for h in HEAD_DIMS if h >= max(hd, 8)), HEAD_DIMS[-1])
    batch = max(int(session.spec.batch), 1)
    seq = max(int(session.spec.opt("prompt_len", 8)), 8) * 2 + 1
    specs = shipped_kernel_specs(
        # SSM archs have no MLP (d_ff == 0): check the kernel at 4*d
        d_model=d, d_ff=int(getattr(cfg, "d_ff", 0) or 4 * d), heads=heads,
        head_dim=hd, batch=batch, seq=seq,
        page=int(session.spec.opt("page_size", 8)),
        n_pool=int(session.spec.opt("pool_pages", 6)))
    if int(getattr(cfg, "n_encoder_layers", 0) or 0):
        specs += [attention_spec(batch * heads, seq, hd, dtype=dt, causal=False)
                  for dt in (torch.float32, torch.bfloat16)]
    return specs


#: the rule families ``analyze_session`` can run (``rules=None`` = all)
ALL_RULE_FAMILIES = ("precision", "wire", "kernel", "overflow", "numerics")


def _want(rules, family: str) -> bool:
    return rules is None or family in rules


def normalize_rules(rules) -> frozenset | None:
    """Parse a rules selection (None / iterable / comma string) -> set."""
    if rules is None:
        return None
    if isinstance(rules, str):
        rules = [r for r in rules.split(",") if r]
    out = frozenset(str(r).strip() for r in rules)
    unknown = out - set(ALL_RULE_FAMILIES)
    if unknown:
        raise ValueError(f"unknown rule families {sorted(unknown)}; "
                         f"options: {ALL_RULE_FAMILIES}")
    return out


def analyze_session(session, *, compile: bool = True, allowlist_path=None,
                    check_kernels: bool = True, rules=None,
                    proofs: list | None = None) -> list[Finding]:
    """All rule families over one Session's step graphs.

    ``compile=False`` skips the wire lint (graph and kernel rules only);
    the port compiles nothing, so ``compile=True`` means the wire rules run
    over the trace's collective records.  ``allowlist_path=None`` skips
    allowlisting (the CLI passes ``analyze_torch.toml``).  ``rules`` selects
    families from :data:`ALL_RULE_FAMILIES` (``None`` = all):
    ``overflow``/``numerics`` drive the interval interpreter over each
    traced graph plus the analytic per-cell accumulator proof;
    ``precision`` adds the error-budget certificate.  Positive proof
    records (accumulator fits, budget holds) are appended to ``proofs``
    when a list is passed — findings only report failures.
    """
    from repro_torch.analyze.absint import interpret_jaxpr
    from repro_torch.analyze.kernel_check import check_kernel_spec
    from repro_torch.analyze.precision_flow import lint_jaxpr
    from repro_torch.analyze.static_proofs import prove_spec
    from repro_torch.analyze.wire_lint import check_comm_report, lint_module

    rules = normalize_rules(rules)
    absint_rules = tuple(r for r in ("overflow", "numerics") if _want(rules, r))
    findings: list[Finding] = []
    spec = session.spec

    if spec.workload == "fl-sim":
        findings.append(Finding(
            rule="analyze.skipped", severity="info",
            message="fl-sim cells have no model-zoo step graph to lint; analytic proofs only",
            key=f"fl-sim:{spec.arch}", cell=f"fl-sim:{spec.arch}"))
    else:
        policy = session.policy
        for label, shape in lint_cells(session):
            rec, meta = session.trace(shape, graph=True)
            kind = meta["kind"]
            if _want(rules, "precision"):
                findings.extend(lint_jaxpr(
                    rec, policy=policy, cell=label,
                    expect_fastpath=policy.lazy and policy.packed and kind == "decode"))
            if absint_rules:
                res = interpret_jaxpr(rec, cell=label, rules=absint_rules)
                findings.extend(res.findings)
                if proofs is not None:
                    proofs.extend(res.proofs)
            if compile and _want(rules, "wire"):
                findings.extend(lint_module(rec, _wire_context(session, kind), cell=label))
                if kind == "train":
                    findings.extend(check_comm_report(rec, session.comm_report(), cell=label))

    proof_rules = tuple(r for r in ("overflow", "precision") if _want(rules, r))
    if proof_rules:
        records, fs = prove_spec(spec, rules=proof_rules)
        findings.extend(fs)
        if proofs is not None:
            proofs.extend(records)

    if check_kernels and spec.workload != "fl-sim" and _want(rules, "kernel"):
        for ks in _kernel_cells(session):
            findings.extend(check_kernel_spec(ks, cell=f"kernels:{ks.name}"))

    if allowlist_path:
        findings = apply_allowlist(findings, load_allowlist(allowlist_path))
    return findings
