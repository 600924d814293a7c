"""Declarative sweep grids: cross-products of RunSpec fields -> cells.

A :class:`Sweep` is a named experiment grid built from one base
:class:`~repro_torch.api.spec.RunSpec` dict plus :class:`Axis` cross-products
over its fields — including nested ``options.*`` keys and the
:class:`~repro_torch.api.precision.PrecisionPolicy` sub-dict — so "arch x mesh
x workload x {weights, kv_cache, comm} bits x serve flags" grids are one
declaration, not a hand-rolled loop (cf. the quantization x channel grids of
arXiv:2402.12957 / arXiv:2101.04866).

Every cell is keyed by a **content hash** of its canonical spec JSON
(:func:`cell_key`); the hash is what makes sweeps resumable — a results
store that has a key already holds that exact experiment, whatever order or
process produced it.  The grids, the spec dicts and therefore the keys are
the JAX package's, byte for byte: a key finds the same experiment in either
package's store.

Named presets (:func:`get_preset`) cover the ROADMAP grids:

* ``roofline-all-archs``       — all 10 archs x {train_4k, prefill_32k,
  decode_32k} dryrun on the 16x16 pod, long_500k rows for the
  sub-quadratic archs, plus one 2x16x16 multi-pod cell.
* ``serve-precision-ablation`` — serve smokes over weight bits x kv-cache
  storage x KV layout (paged vs contiguous).
* ``fl-codesign-grid``         — the paper's Fig. 2 scheme grid (fl-sim).
* ``fl-fault-grid``            — fault intensity x {GBD co-design,
  fixed-bit baseline} degradation grid through the resilient round
  executor (``repro_torch.faults``).
* ``grad-comm-wire``           — train smokes over gradient wire bits
  (consumes :func:`repro_torch.dist.wire.grad_wire_report`).
* ``ci-tiny``                  — 2 dryrun cells + 1 fl-sim cell + 1
  long-context paged serve cell; the CI smoke grid.

The ``dryrun`` cells (``roofline-all-archs`` and two of ``ci-tiny``) keep
the reference's keys and run through the port's dry run on their pod
meshes (:meth:`repro_torch.api.session.Session.run_dryrun`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json

from repro_torch.api.spec import RunSpec


def canonical_json(d: dict) -> str:
    """Key-order-independent JSON (the hashing form)."""
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def cell_key(spec_dict: dict) -> str:
    """Content hash of one cell's full spec — the resume identity.

    Two cells collide iff their RunSpecs are identical, so a store lookup by
    key is exactly "has this experiment already run".
    """
    return hashlib.sha256(canonical_json(spec_dict).encode()).hexdigest()[:16]


def set_field(d: dict, field: str, value) -> None:
    """Dotted-path assignment (``options.shape``); dict values deep-merge."""
    parts = field.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    leaf = parts[-1]
    if isinstance(value, dict) and isinstance(d.get(leaf), dict):
        d[leaf] = {**d[leaf], **value}
    else:
        d[leaf] = value


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept dimension: a dotted RunSpec field and its values.

    ``field`` may target a top-level RunSpec field (``arch``, ``mesh``), an
    options key (``options.shape``), a precision role
    (``precision.kv_cache``), or a whole sub-dict (``precision``) — dict
    values merge into the existing sub-dict, so one axis can move several
    coupled knobs (e.g. ``{"weights": 7, "lazy": True}``).
    """

    field: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclasses.dataclass(frozen=True)
class Cell:
    """One grid point: a concrete RunSpec plus its content-hash key."""

    spec: RunSpec
    key: str
    sweep: str

    @property
    def label(self) -> str:
        """Compact human identity for progress lines and table rows."""
        s = self.spec
        if s.workload == "dryrun":
            return f"{s.arch} x {s.opt('shape')} x {s.mesh}"
        if s.workload == "serve":
            return (f"{s.arch} w{s.precision.weights} "
                    f"kv{s.precision.kv_cache}")
        if s.workload == "fl-sim":
            f = s.opt("faults") or {}
            tag = f" faults[pl={f.get('packet_loss', 0):g}]" if f else ""
            return f"{s.arch} {s.opt('scheme', 'fwq')}{tag}"
        return f"{s.arch} {s.workload} comm{s.precision.comm}"


@dataclasses.dataclass(frozen=True)
class Sweep:
    """A named grid: base spec dict x axes, plus explicit extra cells.

    ``base`` is a RunSpec dict template; ``axes`` cross-product into it;
    ``extra_cells`` are standalone full spec dicts appended after the
    product (e.g. the one multi-pod roofline cell).
    """

    name: str
    base: dict
    axes: tuple[Axis, ...] = ()
    extra_cells: tuple[dict, ...] = ()

    def spec_dicts(self) -> list[dict]:
        out = []
        for combo in itertools.product(*[a.values for a in self.axes]):
            d = json.loads(json.dumps(self.base))        # deep copy
            for axis, v in zip(self.axes, combo):
                set_field(d, axis.field, v)
            out.append(d)
        out.extend(json.loads(json.dumps(d)) for d in self.extra_cells)
        return out

    def cells(self) -> list[Cell]:
        out = []
        for d in self.spec_dicts():
            spec = RunSpec.from_dict(d)
            # hash the ROUND-TRIPPED dict so defaults are always explicit:
            # the key identifies the experiment, not the spelling of it
            out.append(Cell(spec=spec, key=cell_key(spec.to_dict()),
                            sweep=self.name))
        return out


# ---------------------------------------------------------------------------
# Named presets (the ROADMAP grids)
# ---------------------------------------------------------------------------


def preset_roofline_all_archs(
        shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")) -> Sweep:
    """All 10 archs x shape rows (train / prefill / decode) on 16x16, plus a
    ``long_500k`` row per sub-quadratic arch and one 2x16x16 multi-pod cell.

    The train_4k cells keep their original content hashes (the shape axis
    writes the same ``options.shape`` the old single-shape preset did), so a
    pre-existing store resumes instead of recompiling them.
    """
    from repro_torch.configs import ARCH_NAMES, get_config

    dry = {"workload": "dryrun", "mesh": "16x16", "smoke": False,
           "options": {"shape": shapes[0]}}
    long_cells = tuple(
        {"arch": a, **dry, "options": {"shape": "long_500k"}}
        for a in ARCH_NAMES if get_config(a).supports_long_context)
    return Sweep(
        name="roofline-all-archs",
        base={"arch": "", **dry},
        axes=(Axis("arch", ARCH_NAMES), Axis("options.shape", shapes)),
        extra_cells=long_cells + (
            {"arch": "mamba2-780m", **dry, "mesh": "2x16x16"},))


def preset_serve_precision_ablation(steps: int = 12,
                                    arch: str = "yi-6b",
                                    weights: tuple = (32, 7, 12),
                                    kv_cache: tuple = (32, 16),
                                    kv_layout: tuple = ("paged",
                                                        "contiguous"),
                                    s_max: int = 64) -> Sweep:
    """Serving-policy ablation: weight bits x kv-cache storage x KV layout.

    The kv_layout axis is the paged-vs-contiguous comparison on a
    mixed-length workload (``vary_prompt`` draws ragged prompts): same
    tokens, same weights — only the KV residency changes.
    """
    w_axis = tuple({"weights": 32, "lazy": False} if b >= 32
                   else {"weights": b, "lazy": True} for b in weights)
    return Sweep(
        name="serve-precision-ablation",
        base={"arch": arch, "workload": "serve", "smoke": True, "batch": 2,
              "seq": s_max, "precision": {"weights": 32},
              "options": {"steps": steps, "prompt_len": 8,
                          "attn_impl": "ref", "vary_prompt": True,
                          "quiet": True}},
        axes=(Axis("precision", w_axis),
              Axis("precision.kv_cache", kv_cache),
              Axis("options.kv_layout", kv_layout)))


def preset_fl_codesign_grid(rounds: int = 60, n_clients: int = 8,
                            arch: str = "resnet") -> Sweep:
    """Paper Fig. 2 grid: co-design scheme x (CNN fl-sim)."""
    return Sweep(
        name="fl-codesign-grid",
        base={"arch": arch, "workload": "fl-sim", "rounds": rounds,
              "batch": 16,
              "options": {"n_clients": n_clients, "lr": 0.2,
                          "error_tolerance": 4.5, "eval_every": 10}},
        axes=(Axis("options.scheme",
                   ("fwq", "full_precision", "unified_q", "rand_q")),))


def preset_fl_fault_grid(rounds: int = 24, n_clients: int = 6,
                         arch: str = "resnet") -> Sweep:
    """Degradation grid: fault intensity x co-design scheme (fl-sim).

    Three fault levels (none / mild / severe) against the GBD co-design
    (``fwq``) and the fixed-bit ``unified_q`` baseline.  Every cell runs the
    resilient round executor (deadline + retransmission + aggregation gate),
    with drift-triggered warm GBD re-solves enabled, so the table reads as
    "how gracefully does each scheme degrade": loss/energy deltas plus the
    explicit retransmission, rejected-update, and undelivered counters.
    """
    mild = {"dropout_prob": 0.05, "fade_prob": 0.1, "packet_loss": 0.05,
            "corrupt_prob": 0.05}
    severe = {"dropout_prob": 0.15, "fade_prob": 0.3, "packet_loss": 0.2,
              "corrupt_prob": 0.1, "slowdown_prob": 0.1}
    return Sweep(
        name="fl-fault-grid",
        base={"arch": arch, "workload": "fl-sim", "rounds": rounds,
              "batch": 16,
              "options": {"n_clients": n_clients, "lr": 0.2,
                          "error_tolerance": 4.5, "eval_every": 8,
                          "resolve_drift_db": 6.0}},
        axes=(Axis("options.scheme", ("fwq", "unified_q")),
              Axis("options.faults", (None, mild, severe))))


def preset_fl_adaptive_grid(rounds: int = 24, n_clients: int = 6,
                            arch: str = "resnet",
                            budget_j: float = 430.0) -> Sweep:
    """Adaptive precision program vs static fwq, with and without faults.

    2x2 grid: fault level (none / severe, the ``fl-fault-grid`` severe
    preset) x precision program (static GBD policy / ``energy_budget``
    controller).  The budget is set between the measured no-fault and
    severe-fault static totals, so the adaptive cells tell the paper's
    story: under faults the static co-design OVERSHOOTS the budget (it
    never sees the retransmission bill), while the controller demotes
    weight/comm bits as cumulative measured energy tracks over pace and
    finishes within it.  The fault-free cells double as a no-regression
    check — under budget the controller never clamps, so its cell matches
    the static one.
    """
    severe = {"dropout_prob": 0.15, "fade_prob": 0.3, "packet_loss": 0.2,
              "corrupt_prob": 0.1, "slowdown_prob": 0.1}
    # restore below the default 0.90: the severe-fault spend sits close to
    # pace, and a quick restore oscillates demote/restore and lands over
    # budget — holding demotions until spend is clearly under keeps it in
    program = {"kind": "energy_budget", "budget_j": budget_j,
               "restore": 0.75}
    return Sweep(
        name="fl-adaptive-grid",
        base={"arch": arch, "workload": "fl-sim", "rounds": rounds,
              "batch": 16,
              "options": {"n_clients": n_clients, "lr": 0.2,
                          "error_tolerance": 4.5, "eval_every": 8,
                          "scheme": "fwq", "resolve_drift_db": 6.0}},
        axes=(Axis("options.faults", (None, severe)),
              Axis("options.precision_program", (None, program))))


def preset_grad_comm_wire(rounds: int = 2) -> Sweep:
    """Gradient wire-compression ablation: train smokes over comm bits.

    The 4x1 mesh puts 4 FL clients in a loop on one device
    (``launch/mesh.py``), so the SR-quantized all-reduce actually runs — comm bits change both the
    on-wire dtype and the training noise, not just the accounting.
    """
    return Sweep(
        name="grad-comm-wire",
        base={"arch": "yi-6b", "workload": "train", "mesh": "4x1",
              "smoke": True, "batch": 1, "seq": 16, "rounds": rounds,
              "options": {"lr": 0.05, "quiet": True}},
        axes=(Axis("precision.comm", (32, 8, 4)),))


def preset_ci_tiny() -> Sweep:
    """The CI smoke grid: 2 dryrun cells + 1 fl-sim cell, minutes on CPU.

    The dryrun cells are spec-identical to their ``roofline-all-archs``
    counterparts (same content hash), so CI exercises the exact cells the
    EXPERIMENTS.md grid records.
    """
    dry = {"workload": "dryrun", "mesh": "16x16", "smoke": False,
           "options": {"shape": "train_4k"}}
    return Sweep(
        name="ci-tiny",
        base={"arch": "", **dry},
        axes=(Axis("arch", ("mamba2-780m", "yi-6b")),),
        extra_cells=(
            {"arch": "resnet", "workload": "fl-sim", "rounds": 2, "batch": 8,
             "options": {"scheme": "fwq", "n_clients": 4, "lr": 0.1}},
            # long-context serve smoke on the PAGED path: a 5-page pool
            # against 3-page requests forces deferred admissions and page
            # reclaim, and ragged prompts exercise the prefill buckets
            {"arch": "yi-6b", "workload": "serve", "smoke": True, "batch": 2,
             "seq": 128,
             "precision": {"weights": 7, "lazy": True},
             "options": {"steps": 48, "s_max": 128, "prompt_len": 8,
                         "max_new": 10, "requests": 4, "kv_layout": "paged",
                         "page_size": 8, "pool_pages": 5,
                         "vary_prompt": True, "quiet": True}},
            # fault-injected fl-sim: nonzero dropout + packet loss + corrupt
            # through the resilient round executor — the CI contract is that
            # it completes with zero unhandled exceptions and reports the
            # retransmission / rejected-update counters
            {"arch": "resnet", "workload": "fl-sim", "rounds": 3, "batch": 8,
             "options": {"scheme": "fwq", "n_clients": 4, "lr": 0.1,
                         "faults": {"dropout_prob": 0.2, "packet_loss": 0.15,
                                    "corrupt_prob": 0.25}}},
            # adaptive-precision smoke: a deliberately tight energy budget so
            # the energy_budget controller actually demotes bits in CI, and
            # the analyzer's envelope proofs cover the demoted widths
            {"arch": "resnet", "workload": "fl-sim", "rounds": 3, "batch": 8,
             "options": {"scheme": "fwq", "n_clients": 4, "lr": 0.1,
                         "precision_program": {"kind": "energy_budget",
                                               "budget_j": 14.0}}},))


PRESETS = {
    "roofline-all-archs": preset_roofline_all_archs,
    "serve-precision-ablation": preset_serve_precision_ablation,
    "fl-codesign-grid": preset_fl_codesign_grid,
    "fl-fault-grid": preset_fl_fault_grid,
    "fl-adaptive-grid": preset_fl_adaptive_grid,
    "grad-comm-wire": preset_grad_comm_wire,
    "ci-tiny": preset_ci_tiny,
}


def get_preset(name: str, **kw) -> Sweep:
    if name not in PRESETS:
        raise KeyError(f"unknown sweep preset {name!r}; "
                       f"options: {sorted(PRESETS)}")
    return PRESETS[name](**kw)
