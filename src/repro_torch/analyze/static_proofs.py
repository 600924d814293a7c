"""Analytic (spec-level) proofs: wire-accumulator overflow + error budget.

The closed-form complement of a graph interpreter (the reference's
``analyze/absint.py``; the port's graph half is ROADMAP item 13): pure host
arithmetic over a RunSpec's precision policy and mesh topology — no tracing,
no compilation.  That makes the same two guarantees available for cells that
have no model-zoo graph to interpret (``fl-sim``) and cheap enough to
recompute per sweep cell at report time.

* :func:`prove_wire_accumulator` — the accumulator of the SR-quantized
  all-reduce must hold ``n_clients * code_bound(bits)``; both sides of the
  comparison come from :mod:`repro_torch.dist.collectives` (the exactness
  contract), so the static proof and the runtime clip can't drift apart.
  ``force_dtype`` overrides the accumulator for seeded-negative tests.
* :func:`check_error_budget` — reconstruct the worst-case per-device
  quantization error ``sum_i delta_i^2`` implied by the policy's bits and
  compare it against the convergence-bound budget (constraint 23) that
  ``core/convergence.py`` feeds GBD; also cross-check that the trainer's
  ``delta_for_clients`` vector agrees elementwise with the
  optimizer's ``quant_noise`` model.
"""

from __future__ import annotations

import math

from repro_torch.analyze.findings import Finding

#: options / defaults mirrored from ``fed.orchestrator.OrchestratorConfig``
_DEFAULT_LAMBDA = 0.05
_DEFAULT_E2 = 9.0
_DEFAULT_MODEL_DIM = 1 << 20


def headroom_bits(capacity: float, need: float) -> int:
    """Whole bits of slack between a worst-case sum and its accumulator."""
    if need <= 0:
        return 0
    return max(int(math.floor(math.log2(capacity / need))), 0)


def spec_n_clients(spec) -> int:
    """Data-parallel world size (= FL clients) a RunSpec implies.

    ``fl-sim`` carries it explicitly in options; every other workload
    derives it from the mesh string — the product of all axes except the
    trailing model axis (``"4x1"`` -> 4, ``"2x16x16"`` -> 32).
    """
    if spec.workload == "fl-sim":
        return max(int(spec.opt("n_clients", 1)), 1)
    parts = [int(p) for p in str(spec.mesh).split("x")]
    n = 1
    for p in parts[:-1]:
        n *= max(p, 1)
    return max(n, 1)


def prove_wire_accumulator(comm_bits: int, n_clients: int, *,
                           force_dtype=None, cell: str = "",
                           key: str = "policy.comm"):
    """(proof record, findings) for one (comm bits, client count) cell.

    The proof obligation is ``n * code_bound(bits) <= iinfo(dtype).max``
    where ``dtype`` is what :func:`repro_torch.dist.collectives.wire_dtype` would
    pick (or ``force_dtype``, for seeded negatives).  ``bits >= 32`` or a
    single client means no integer accumulator exists — trivially safe,
    recorded as an ``uncompressed`` proof so tables stay total.
    """
    import numpy as np

    from repro_torch.core.quantization import FULL_PRECISION_BITS
    from repro_torch.dist.collectives import code_bound, wire_dtype

    bits, n = int(comm_bits), max(int(n_clients), 1)
    if bits >= FULL_PRECISION_BITS or n == 1:
        return ({"kind": "uncompressed", "bits": bits, "n": n,
                 "dtype": "f32", "code_bound": 0, "worst_sum": 0,
                 "capacity": 0, "headroom_bits": 0, "ok": True,
                 "key": key, "cell": cell}, [])

    bound = code_bound(bits)
    worst = n * bound
    if force_dtype is None:
        try:
            dt = np.dtype(wire_dtype(bits, n))
        except ValueError as e:
            return ({"kind": "wire_accumulator", "bits": bits, "n": n,
                     "dtype": "none", "code_bound": bound, "worst_sum": worst,
                     "capacity": 0, "headroom_bits": 0, "ok": False,
                     "key": key, "cell": cell}, [Finding(
                         rule="overflow.wire_accumulator", severity="error",
                         message=f"no supported accumulator holds the code "
                                 f"sum: {e}", key=key, cell=cell)])
    else:
        dt = np.dtype(force_dtype)
    capacity = int(np.iinfo(dt).max)
    ok = worst <= capacity
    proof = {"kind": "wire_accumulator", "bits": bits, "n": n,
             "dtype": dt.name, "code_bound": bound, "worst_sum": worst,
             "capacity": capacity,
             "headroom_bits": headroom_bits(capacity, worst) if ok else 0,
             "ok": ok, "key": key, "cell": cell}
    findings = []
    if not ok:
        findings.append(Finding(
            rule="overflow.wire_accumulator", severity="error",
            message=(f"{n} clients x code_bound({bits}) = {worst} exceeds "
                     f"{dt.name} capacity {capacity}: the integer all-reduce "
                     "provably overflows"),
            key=key, cell=cell))
    return proof, findings


def check_error_budget(policy, n_clients: int, *, lam: float | None = None,
                       e2: float | None = None, d: int | None = None,
                       scale: float = 1.0, cell: str = ""):
    """(record, findings) certifying the policy against constraint (23).

    Three obligations, all against ``core/convergence.py`` closed forms:

    1. *model agreement* — the trainer's ``delta_for_clients``
       resolutions equal the optimizer's ``quant_noise`` deltas elementwise
       (the two implementations of ``s/(2^q - 1)`` must not drift);
    2. *instance feasibility* — the widest option in ``bit_options``
       satisfies the budget (otherwise GBD has no feasible point);
    3. *policy feasibility* — if the policy pins concrete weight bits, the
       implied ``sum_i delta_i^2`` fits the budget the orchestrator would
       hand the master problem.
    """
    import numpy as np

    from repro_torch.core.convergence import (
        error_budget_bound,
        feasible_bits_budget,
        quant_noise,
    )
    from repro_torch.core.fwq import delta_for_clients

    lam = _DEFAULT_LAMBDA if lam is None else float(lam)
    e2 = _DEFAULT_E2 if e2 is None else float(e2)
    d = _DEFAULT_MODEL_DIM if d is None else int(d)
    n = max(int(n_clients), 1)
    key = "policy.weights"

    budget = error_budget_bound(lam, e2, d, n)
    bits = policy.bits_vector(n)
    noise = quant_noise(bits, scale)
    sum_dsq = float(np.sum(noise ** 2))
    traced = delta_for_clients(bits, scale=scale).double().numpy()
    agree = bool(np.allclose(traced, noise, rtol=1e-5, atol=1e-12))
    feasible = feasible_bits_budget(policy.bit_options, n, budget, scale)

    record = {"kind": "error_budget", "n": n, "lam": lam, "e2": e2, "d": d,
              "budget": budget, "sum_delta_sq": sum_dsq,
              "bits": [int(b) for b in bits], "model_agreement": agree,
              "max_bits_feasible": feasible, "ok": agree and feasible
              and sum_dsq <= budget, "key": key, "cell": cell}
    findings = []
    if not agree:
        findings.append(Finding(
            rule="precision.error_budget", severity="error",
            message=("trainer delta_for_clients disagrees with the "
                     "optimizer's quant_noise model: the executed graph and "
                     "GBD reason about different quantization error"),
            key=key, cell=cell))
    if not feasible:
        findings.append(Finding(
            rule="precision.error_budget", severity="error",
            message=(f"even max bits {max(policy.bit_options)} violates the "
                     f"budget sum delta^2 <= {budget:.3e}: the GBD instance "
                     "is infeasible (loosen lambda or shrink d)"),
            key=key, cell=cell))
    if sum_dsq > budget:
        findings.append(Finding(
            rule="precision.error_budget", severity="error",
            message=(f"policy bits {sorted(set(record['bits']))} imply "
                     f"sum delta^2 = {sum_dsq:.3e} > budget {budget:.3e} "
                     f"(lambda={lam:g}, e2={e2:g}, d={d}, N={n}): the "
                     "executed quantization error exceeds what the "
                     "convergence bound was optimized against"),
            key=key, cell=cell))
    return record, findings


def prove_spec(spec, *, rules=("overflow", "precision"), cell: str = ""):
    """All analytic proofs one RunSpec admits: (records, findings).

    ``overflow`` covers the comm role (train / fl-orchestrate) and, for
    ``fl-sim``, every option of the policy's bit lattice — the scheme grid
    re-quantizes at whichever width GBD picks per round, so each must hold.
    A ``precision_program`` option widens the obligation to the program's
    comm ENVELOPE (every wire width any schedule it emits can visit), so
    one green analyze run certifies the whole adaptive run, not just the
    base policy.  ``precision`` (the error budget) applies to the FL
    workloads, where the spec's options carry the constraint-(23)
    constants.
    """
    cell = cell or f"{spec.workload}:{spec.arch}"
    n = spec_n_clients(spec)
    policy = spec.precision
    records, findings = [], []

    if any(r.startswith("overflow") for r in rules):
        bit_cells = [("policy.comm", policy.comm)]
        if spec.workload == "fl-sim":
            bit_cells += [(f"policy.bit_options[{b}]", b)
                          for b in policy.bit_options]
        prog_opt = spec.opt("precision_program")
        if prog_opt is not None:
            from repro_torch.api.program import build_program

            program = build_program(prog_opt)
            seen = {b for _, b in bit_cells}
            bit_cells += [(f"program.comm[{b}]", b)
                          for b in program.comm_envelope(policy)
                          if b not in seen]
        for key, bits in bit_cells:
            proof, fs = prove_wire_accumulator(bits, n, cell=cell, key=key)
            records.append(proof)
            findings.extend(fs)

    if (any(r.startswith("precision") for r in rules)
            and spec.workload in ("fl-sim", "fl-orchestrate")):
        rec, fs = check_error_budget(
            policy, n,
            lam=spec.opt("error_tolerance"), e2=spec.opt("e2"),
            d=spec.opt("model_dim_d"), cell=cell)
        records.append(rec)
        findings.extend(fs)
    return records, findings


# ---------------------------------------------------------------------------
# Overflow-margin table (EXPERIMENTS.md §analyze)
# ---------------------------------------------------------------------------


def overflow_margin_rows(preset_names=("grad-comm-wire",
                                       "fl-codesign-grid")) -> list[dict]:
    """One row per distinct proved accumulator margin, per preset.

    Deterministic in the presets alone (no store, no tracing), so the
    generated table never goes stale against old results.  Cells that
    prove the identical obligation (same bits / clients / dtype — e.g.
    every fl-codesign scheme shares one bit lattice) collapse into one
    row labeled by the first cell that carries it.
    """
    from repro_torch.sweep.grid import get_preset

    rows, seen = [], set()
    for name in preset_names:
        for c in get_preset(name).cells():
            records, _ = prove_spec(c.spec, rules=("overflow",),
                                    cell=c.label)
            for r in records:
                sig = (name, r["bits"], r["n"], r["dtype"])
                if sig in seen:
                    continue
                seen.add(sig)
                rows.append({"sweep": name, "cell": c.label,
                             "bits": r["bits"], "n": r["n"],
                             "dtype": r["dtype"],
                             "worst_sum": r["worst_sum"],
                             "capacity": r["capacity"],
                             "headroom_bits": r["headroom_bits"],
                             "ok": r["ok"]})
    return rows


def overflow_margin_table(preset_names=("grad-comm-wire",
                                        "fl-codesign-grid")) -> str:
    """Markdown overflow-margin table for :func:`overflow_margin_rows`."""
    rows = overflow_margin_rows(preset_names)
    head = ("| sweep | cell | bits | clients | accumulator | worst sum "
            "| capacity | headroom | proved |")
    sep = "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"
    out = [head, sep]
    for r in rows:
        uncompressed = r["dtype"] == "f32"
        dt = "exact f32 pmean" if uncompressed else r["dtype"]
        ws = "-" if uncompressed else f"{r['worst_sum']:,}"
        cap = "-" if uncompressed else f"{r['capacity']:,}"
        hr = "-" if uncompressed else f"{r['headroom_bits']}b"
        ok = "yes" if r["ok"] else "**NO**"
        out.append(f"| {r['sweep']} | {r['cell']} | {r['bits']} | {r['n']} "
                   f"| {dt} | {ws} | {cap} | {hr} | {ok} |")
    return "\n".join(out)
