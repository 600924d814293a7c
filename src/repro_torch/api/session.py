"""Session: the front door of the port (the ``serve``, ``fl-sim``, ``train``
and ``fl-orchestrate`` workloads).

``Session(RunSpec(...), device=None)`` owns the model, the axis context and
the precision plumbing for one spec and runs on ``device`` — ``"cuda"``
unless the caller asks for ``"cpu"``.  Asking for CUDA on a machine without
it raises; nothing falls back to the CPU::

    from repro_torch.api import PrecisionPolicy, RunSpec, Session

    stats = Session(RunSpec("yi-6b", workload="serve", smoke=False,
                            precision=PrecisionPolicy.lazy_int8())).serve()

``serve`` options: ``steps``, ``s_max``, ``prompt_len``, ``attn_impl``,
``requests``, ``max_new``, ``kv_layout``, ``page_size``, ``pool_pages``,
``vary_prompt``, ``precision_program``, ``quiet``.  On a ``Dx1`` mesh the
batch splits into D data shards, run in a loop on the device or one a rank
under a process group; on a ``DxT`` mesh (T > 1, every family) each of
the D·T ranks of a group holds one model shard of one data shard
(:meth:`Session.serve`).

``fl-sim`` options (the paper's loop, :meth:`Session.run_fl_sim`):
``scheme``, ``n_clients``, ``lr``, ``error_tolerance``, ``eval_every``,
``faults``, ``resolve_drift_db``, ``precision_program``, ``model_dim_d``,
``grad_bytes``, ``ckpt_dir``, ``ckpt_every``.

``train`` / ``fl-orchestrate`` options (the pod trainer,
:meth:`Session.run_train`): ``scheme`` (fl-orchestrate only), ``lr``,
``ckpt_dir``, ``ckpt_every``, ``out``, ``quiet``, ``nonfinite_grads``,
``faults``, ``resolve_drift_db``, ``precision_program``.  ``train`` runs
federated rounds at the spec's fixed :class:`PrecisionPolicy`;
``fl-orchestrate`` is the paper's full loop, the GBD co-design choosing each
round's per-client bits.  A ``Dx1`` mesh runs its D clients on one device,
or, when a ``torch.distributed`` group of D ranks is initialized (torchrun;
:func:`repro_torch.launch.mesh.init_distributed`), one client a rank: each
rank holds its FSDP shards and its client's rows of the global batch, rank 0
plans the rounds and broadcasts them, and checkpoints are the one-process
format (rank 0 writes the gathered leaves; every rank loads and slices).  A
``1xT`` / ``DxT`` mesh (tensor parallelism) runs one rank a mesh device
under a group of D·T ranks: the D clients are its data rows, each rank
holds its model shard's slices (FSDP-sharded over its batch group) and its
client's rows, and checkpoints join the slices into the same one-process
format.

``dryrun`` (:meth:`Session.run_dryrun`; options ``shape``, ``variant``)
traces one shape cell's step under ``FakeTensorMode``, nothing allocated,
and prices it on one H100 (:mod:`repro_torch.roofline`); on the CPU::

    Session(RunSpec("yi-6b", workload="dryrun", mesh="16x16", smoke=False),
            device="cpu").run_dryrun(shape="decode_32k")

On any mesh, the reference's ``16x16`` and ``2x16x16`` pods included, the
traced cell is one device of it (data index 0, model index 0) in one
process with no process group: its model shard's slices, its client's rows,
and every collective it issues over its model group (a stand-in,
:func:`repro_torch.launch.mesh.trace_axis_ctx`) and its batch group.

:meth:`Session.analyze` lints the step graphs a spec implies (precision
taint, the interval interpreter, the wire lint, the kernels' launch grids;
:mod:`repro_torch.analyze`) without executing them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import time

import numpy as np
import torch

from repro_torch.api.precision import PrecisionPolicy
from repro_torch.api.spec import SIM_ARCHS, RunSpec

log = logging.getLogger("repro_torch.api")

BOS_ID = 1
#: seed offsets of the stub frontends' serving inputs (VLM images, enc-dec
#: frames), as in the reference
_MEMORY_SEED_OFFSET = {"images": 101, "frames": 102}


def serve_memory_inputs(pf_spec: dict, seed: int, device) -> dict:
    """The stub frontends' serving inputs of the global batch (VLM
    ``images``, enc-dec ``frames``; nothing for the text families): seeded
    normal draws on ``device`` of the prefill spec's shapes, the same every
    admission and on every rank (the reference draws them from fixed keys).
    The serving driver cuts them over its data shards."""
    return {name: torch.randn(tuple(t.shape), dtype=t.dtype, device=device,
                              generator=torch.Generator(device=device).manual_seed(
                                  seed + _MEMORY_SEED_OFFSET[name]))
            for name, t in pf_spec.items() if name != "tokens"}


@dataclasses.dataclass
class ServeStats:
    """What one driver run measured."""

    arch: str
    bits: int
    attn_impl: str
    decode_steps: int
    decoded_tokens: int          # tokens produced by ACTIVE slots only
    completed: int               # sequences finished
    admitted: int                # sequences admitted (>= batch when the
                                 # queue forced mid-flight admissions)
    wall_s: float                # decode-loop wall clock (after the first step)
    tok_s: float
    bytes_per_step_packed: int   # weight bytes streamed per decode step
    bytes_per_step_f32: int      # same weights at f32
    packed_vs_f32: float         # packed / f32 byte ratio
    sample: list                 # first finished sequence's tokens
    kv_layout: str = "contiguous"    # "paged" | "contiguous"
    page_size: int = 0               # tokens per page (0 = contiguous)
    kv_bytes: int = 0                # resident K/V bytes, this layout
    kv_bytes_contiguous: int = 0     # what a contiguous cache would reserve
    capacity_stops: int = 0          # sequences stopped AT CACHE CAPACITY
    deferred_admissions: int = 0     # admissions that waited for page reclaim
    prompt_buckets: list = dataclasses.field(default_factory=list)
    kv_demotions: int = 0            # f32 -> bf16 pool casts under pressure
    kv_bits_final: int = 0           # KV element bits when the run ended
    device: str = ""                 # the card (or "cpu") the run used


def _weight_bytes(params: dict) -> int:
    from repro_torch.models.common import leaf_bytes

    return sum(leaf_bytes(w) for w in params.values())


def resolve_device(device) -> torch.device:
    """``None`` means CUDA.  CUDA without a card raises (no quiet CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the CPU")
    return dev


def _fake_like(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """An empty tensor of ``t``'s shape (under ``FakeTensorMode``: fake)."""
    return torch.empty(tuple(t.shape), dtype=dtype or t.dtype, device=device)


def _bf16(dtype):
    return torch.bfloat16 if dtype.is_floating_point else dtype


class Session:
    """Owns model + axes + precision plumbing for one RunSpec on one device."""

    def __init__(self, spec: RunSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.last_tokens: list = []     # every token the last serve() sampled
        self._train_state: dict | None = None

    # -- lazily-built shared structure ----------------------------------
    @functools.cached_property
    def policy(self) -> PrecisionPolicy:
        return self.spec.precision

    @functools.cached_property
    def program(self):
        """The precision controller (``precision_program`` option; defaults
        to the identity ``constant`` program)."""
        from repro_torch.api.program import build_program

        return build_program(self.spec.opt("precision_program"))

    @functools.cached_property
    def cfg(self):
        from repro_torch.configs import get_config, smoke_variant

        if self.spec.arch in SIM_ARCHS:
            raise ValueError(f"{self.spec.arch!r} is an fl-sim architecture; "
                             "the model-zoo config registry does not apply")
        cfg = get_config(self.spec.arch)
        return smoke_variant(cfg) if self.spec.smoke else cfg

    @functools.cached_property
    def model(self):
        from repro_torch.models.model import build_model

        return build_model(self.cfg)

    @functools.cached_property
    def axes(self):
        """The mesh's axis context: a ``Dx1`` mesh runs its D clients on the
        session's device, or one a rank when a process group is initialized;
        a ``DxT`` mesh (T > 1) one mesh device a rank of the group (without
        a group it raises)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import axis_ctx_for

        group = "default" if dist.is_available() and dist.is_initialized() else None
        return axis_ctx_for(self.spec.mesh, group=group)

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 without a group)."""
        return self.axes.rank

    def _groups(self) -> list:
        """The rank's group transports, the model group's first (empty in one
        process): a broadcast or barrier over each in turn reaches every
        rank of the mesh from rank 0."""
        return [t for t in (self.axes.model_transport, self.axes.transport) if t is not None]

    @functools.cached_property
    def ckpt(self):
        from repro_torch.ckpt import CheckpointManager

        ckpt_dir = self.spec.opt("ckpt_dir", "")
        every = int(self.spec.opt("ckpt_every", 10))
        return CheckpointManager(ckpt_dir, every=every) if ckpt_dir else None

    def train_config(self):
        from repro_torch.configs.base import TrainConfig

        return TrainConfig(
            learning_rate=float(self.spec.opt("lr", 0.05)),
            seed=self.spec.seed,
            grad_compression_bits=self.policy.grad_compression_bits,
            nonfinite_grads=str(self.spec.opt("nonfinite_grads", "raise")))

    def comm_report(self) -> dict:
        """Bytes-on-wire for gradient reduction on this mesh, per round.

        The flat top-level keys are the base policy's one-round accounting:
        replicated leaves move ``policy.comm``-bit codes through the
        SR-quantized all-reduce, FSDP leaves reduce-scatter in f32, over the
        reference's per-shard parameter layout (:func:`local_param_shapes`).
        ``rounds`` adds one row per round with the comm bits that round used
        (executed bits once rounds have run, else the base policy every
        round); ``program`` carries the controller's comm envelope and the
        widest wire accumulator any member needs.
        """
        from repro_torch.dist.collectives import envelope_wire_dtype
        from repro_torch.dist.wire import grad_wire_report, grad_wire_rounds
        from repro_torch.launch.mesh import trace_axis_ctx
        from repro_torch.launch.steps import local_param_shapes

        axes = trace_axis_ctx(self.spec.mesh)   # the mesh's sizes; no group needed
        tree = local_param_shapes(self.model, axes)
        fsdp, n = axes.fsdp, max(axes.dp, 1)
        rep = grad_wire_report(tree, fsdp=fsdp, n_clients=n,
                               comm_bits=self.policy.comm)
        bits_seq = self._executed_comm_bits()
        if bits_seq is None:
            bits_seq = [int(self.policy.comm)] * max(self.spec.rounds, 1)
        rows = grad_wire_rounds(tree, fsdp=fsdp, n_clients=n, comm_bits_seq=bits_seq)
        rep["rounds"] = rows
        rep["total_bytes_wire"] = int(sum(r["replicated_bytes_wire"] for r in rows))
        rep["total_bytes_f32"] = int(sum(r["replicated_bytes_f32"] for r in rows))
        env = self.program.comm_envelope(self.policy)
        dt = envelope_wire_dtype(env, n)
        rep["program"] = {
            "kind": self.program.kind,
            "comm_envelope": [int(b) for b in env],
            "envelope_wire_dtype": (np.dtype(dt).name if dt is not None
                                    else "float32"),
        }
        return rep

    def _executed_comm_bits(self) -> "list[int] | None":
        """Per-round comm bits actually run so far, oldest first (None
        before any round has executed)."""
        st = self._train_state
        if not st:
            return None
        orch = st.get("orch")
        if orch is not None and orch.energy_log:
            return [int(e.get("comm_bits", self.policy.comm))
                    for e in orch.energy_log]
        hist = st.get("history") or []
        if hist and "comm_bits" in hist[0]:
            return [int(h["comm_bits"]) for h in hist]
        return None

    # -- primitive builders ---------------------------------------------
    def init_params(self, generator: torch.Generator | None = None) -> dict:
        """Random f32 parameters on the session's device, drawn from
        ``generator`` (default: seeded with ``spec.seed``); under a group the
        rank's storage of the same init (its FSDP shards,
        :func:`~repro_torch.launch.steps.build_init_fn`)."""
        from repro_torch.launch.steps import build_init_fn

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        return build_init_fn(self.model, self.axes, device=self.device)(generator)

    def train_step(self, opt=None, *, attn_impl: str = "auto"):
        """Policy-driven :class:`~repro_torch.launch.steps.TrainStep` builder."""
        from repro_torch.launch.steps import build_train_step
        from repro_torch.optim import build_optimizer

        tc = self.train_config()
        if opt is None:
            opt = build_optimizer("sgd", tc.learning_rate)
        return build_train_step(self.model, self.axes, opt, tc, attn_impl=attn_impl)

    def round_draws(self, r: int):
        """Round ``r``'s SR uniforms (weights and wire): the one seam of the
        trainer's randomness (see :class:`~repro_torch.launch.steps.SRDraws`)."""
        from repro_torch.launch.steps import SRDraws

        return SRDraws(self.spec.seed, r)

    # -- workload dispatch ----------------------------------------------
    def run(self):
        wl = self.spec.workload
        if wl in ("train", "fl-orchestrate"):
            return self.run_train()
        if wl == "serve":
            return self.serve()
        if wl == "fl-sim":
            return self.run_fl_sim()
        if wl == "dryrun":
            return self.run_dryrun()
        raise ValueError(wl)

    # ------------------------------------------------------------------
    # dryrun: a traced step and its roofline
    # ------------------------------------------------------------------
    def trace(self, shape=None, variant: dict | None = None, *, decode_len=None,
              graph: bool = False):
        """Trace one (arch x shape) cell's step on this mesh, nothing allocated.

        ``shape``: a cell name from ``configs.shapes_for`` or a
        :class:`~repro_torch.configs.base.ShapeSpec` (default: the ``shape``
        option).  ``variant`` (default: the ``variant`` option) takes the
        reference's knobs ``gather_bf16``, ``capacity`` and ``no_remat``.  The
        reference's train, prefill and decode cells are built from the port's
        step builders and run under ``FakeTensorMode`` on the session's
        device inside :func:`repro_torch.roofline.count.recording`, with the
        kernels on their trace route.  Per device means one device of the
        mesh, data index 0 and model index 0 (:func:`~repro_torch.launch.mesh.trace_axis_ctx`:
        no process group, the model group a stand-in that records its
        collectives): its model shard's slice of every leaf (then its FSDP
        shard), a train cell its own client's rows of the global batch at
        share 1, a serving cell one device's batch (the whole batch where
        it does not divide by D, as the reference's ``serving_axes``).  A
        decode cell's caches are bf16, as the reference's, and K5 counts
        ``decode_len`` tokens a slot (an int, or the slots' lengths; default
        the cell's ``seq_len``).  A prefill cell runs the policy's weights
        (packed where it packs) and the ``attn_impl`` option, which at the
        defaults is the reference's cell.  ``graph``: also keep the step's
        operation graph (``record.graph``, what :meth:`analyze` walks).
        Returns ``(record, meta)``; :attr:`traced_axes` keeps the traced
        device's axis context (its stand-in model group's ``issued``).
        """
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.configs.base import ShapeSpec, shapes_for
        from repro_torch.launch.mesh import trace_axis_ctx
        from repro_torch.models.common import fsdp_plan
        from repro_torch.models.model import build_model
        from repro_torch.roofline import count

        spec = self.spec
        variant = dict(variant or spec.opt("variant") or {})
        shape = shape if shape is not None else spec.opt("shape")
        if shape is None:
            raise ValueError("a dry run needs a shape cell: pass shape= or set the "
                             "'shape' option (a name from configs.shapes_for or a ShapeSpec)")
        cfg = self.cfg
        if variant.get("gather_bf16"):
            cfg = dataclasses.replace(cfg, fsdp_gather_dtype="bfloat16")
        if variant.get("capacity"):
            cfg = dataclasses.replace(cfg, capacity_factor=float(variant["capacity"]))
        if variant.get("no_remat"):
            cfg = dataclasses.replace(cfg, remat=False)
        model = build_model(cfg)
        cell = shape if isinstance(shape, ShapeSpec) else {
            s.name: s for s in shapes_for(cfg)}[shape]
        axes, dev = trace_axis_ctx(spec.mesh), self.device
        self.traced_axes = axes
        D = axes.dp
        # the model shard's slice of every leaf (the model cut)
        meta_params = model.init(torch.Generator().manual_seed(0), axes.tp, device="meta")
        paths, _, plan = fsdp_plan(meta_params, axes.fsdp)
        fsdp_of = dict(zip(paths, plan))

        def per_device(tree, share_of) -> int:
            """Bytes one device of the mesh holds of a tree of tensors."""
            return int(sum(count.tree_bytes(v) * share_of(k) for k, v in tree.items()))

        def param_share(path) -> float:
            """The FSDP cut of a model-cut leaf."""
            return 1.0 / axes.fsdp if fsdp_of.get(path) is not None else 1.0

        with FakeTensorMode(allow_fallback_kernels=False):
            if cell.kind == "train":
                rec, outs = self._trace_train(model, axes, cell, dev, meta_params, per_device,
                                              param_share, graph)
            elif cell.kind == "prefill":
                rec, outs = self._trace_prefill(model, axes, cell, dev, meta_params,
                                                per_device, param_share, graph)
            else:
                rec, outs = self._trace_decode(model, axes, cell, dev, meta_params,
                                               per_device, param_share, decode_len, graph)
            rec.output_bytes = outs
        meta = dict(arch=spec.arch, shape=cell.name, mesh=spec.mesh, n_devices=D * axes.tp,
                    kind=cell.kind, seq_len=cell.seq_len, global_batch=cell.global_batch)
        return rec, meta

    def _trace_train(self, model, axes, cell, dev, meta_params, per_device, param_share,
                     graph):
        from repro_torch.launch.steps import SRDraws, build_train_step
        from repro_torch.optim import build_optimizer
        from repro_torch.roofline import count

        D = axes.dp
        if cell.global_batch % D:
            raise ValueError(f"train cell {cell.name!r}: global batch {cell.global_batch} does "
                             f"not divide over the mesh's {D} batch shards")
        opt = build_optimizer("sgd", 1e-3)
        ts = build_train_step(model, axes, opt, self.train_config(), one_device=True)
        params = {k: _fake_like(v, dev) for k, v in meta_params.items()}
        opt_state = opt.init(params)
        # the device's client: its rows of the global batch
        batch = {k: _fake_like(v, dev) for k, v in model.train_batch_spec(
            cell.global_batch // D, cell.seq_len).items()}
        delta = torch.empty(D, dtype=torch.float32, device=dev)
        args = (params, opt_state, batch, delta)
        with count.recording(args, computation="train", graph=graph) as rec:
            rec.argument_bytes = (per_device(params, param_share)
                                  + count.tree_bytes(opt_state)
                                  + count.tree_bytes(batch) + 4)
            new_params, new_state, metrics = ts.fn(params, opt_state, batch, delta,
                                                   SRDraws(self.spec.seed, 0))
            outs = (per_device(new_params, param_share) + count.tree_bytes(new_state)
                    + count.tree_bytes(metrics))
        return rec, outs

    @staticmethod
    def _local_batch(axes, cell) -> int:
        """One device's batch: the global batch over the batch axes, or all
        of it where it does not divide (the reference's ``serving_axes``)."""
        D = axes.dp
        return cell.global_batch // D if cell.global_batch % D == 0 else cell.global_batch

    def _serving_params(self, meta_params, dev, *, packed: bool) -> dict:
        """bf16 serving parameters, as the reference's serving cells cast
        them; with ``packed`` the policy's codes (int8/int16) and scales
        (a stacked leaf's per layer) where ``pack_params_for_serving`` packs."""
        from repro_torch.core.quantization import default_exempt, storage_dtype
        from repro_torch.models.common import QTensor, is_stacked

        out = {}
        for k, v in meta_params.items():
            if packed and not default_exempt(k, v):
                lead = (v.shape[0],) if is_stacked(k) and v.ndim >= 2 else ()
                out[k] = QTensor(_fake_like(v, dev, storage_dtype(self.policy.serve_bits)),
                                 torch.empty(lead, dtype=torch.bfloat16, device=dev))
            else:
                out[k] = _fake_like(v, dev, _bf16(v.dtype))
        return out

    def _trace_prefill(self, model, axes, cell, dev, meta_params, per_device, param_share,
                       graph):
        from repro_torch.launch.steps import build_prefill_step
        from repro_torch.roofline import count

        step = build_prefill_step(model, axes, policy=self.policy,
                                  attn_impl=self.spec.opt("attn_impl", "auto"))
        params = self._serving_params(meta_params, dev, packed=self.policy.packed)
        b = self._local_batch(axes, cell)
        batch = {k: _fake_like(v, dev)
                 for k, v in model.train_batch_spec(b, cell.seq_len).items() if k != "labels"}
        with count.recording((params, batch), computation="prefill", graph=graph) as rec:
            rec.argument_bytes = per_device(params, param_share) + count.tree_bytes(batch)
            out = step.fn(params, batch)
            outs = count.tree_bytes(out)
        return rec, outs

    def _trace_decode(self, model, axes, cell, dev, meta_params, per_device, param_share,
                      decode_len, graph):
        from repro_torch.launch.steps import build_decode_step, init_global_caches
        from repro_torch.roofline import count

        spec = self.spec
        page_size = spec.opt("page_size")
        step = build_decode_step(model, axes, policy=self.policy,
                                 attn_impl=spec.opt("attn_impl", "ref"))
        params = self._serving_params(meta_params, dev, packed=self.policy.packed)
        b = self._local_batch(axes, cell)
        # one device's caches at b slots (b * dp over the shards), its model
        # shard's KV heads or sequence positions
        caches = init_global_caches(model, axes, s_max=cell.seq_len,
                                    batch_global=b * axes.dp, dtype=torch.bfloat16,
                                    device=dev,
                                    page_size=None if page_size is None else int(page_size),
                                    pool_pages=spec.opt("pool_pages"))
        batch = {"token": torch.empty((b, 1), dtype=torch.int32, device=dev)}
        with count.recording((params, batch, caches), computation="decode", graph=graph,
                             decode_len=cell.seq_len if decode_len is None else decode_len) as rec:
            rec.argument_bytes = (per_device(params, param_share) + count.tree_bytes(caches)
                                  + count.tree_bytes(batch))
            tok, new_caches = step.fn(params, batch, caches)
            outs = count.tree_bytes(tok) + count.tree_bytes(new_caches)
        return rec, outs

    def analyze(self, *, compile: bool = True, allowlist: str | None = None,
                check_kernels: bool = True, rules=None,
                proofs: list | None = None) -> list:
        """Static precision / wire / kernel / range lint over this spec.

        Traces the step graphs the RunSpec implies (:meth:`trace` with
        ``graph=True``: fake tensors on the session's device, nothing
        executed or allocated) and returns a list of
        :class:`repro_torch.analyze.findings.Finding`.  ``compile=True``
        runs the wire lint over the trace's collective records (the port
        compiles nothing); ``allowlist`` names an allowlist file such as
        ``analyze_torch.toml`` to mark known-legitimate findings (``None``
        skips allowlisting).  ``rules`` selects rule families (see
        ``repro_torch.analyze.runner.ALL_RULE_FAMILIES``); the
        ``overflow``/``numerics`` families run the interval interpreter and
        append positive proof records (accumulator headroom, error budget)
        to ``proofs`` when a list is passed.
        """
        from repro_torch.analyze.runner import analyze_session

        return analyze_session(self, compile=compile, allowlist_path=allowlist,
                               check_kernels=check_kernels, rules=rules, proofs=proofs)

    def run_dryrun(self, shape=None, variant: dict | None = None, *,
                   verbose: bool = True, decode_len=None) -> dict:
        """Trace one cell (:meth:`trace`; ``decode_len`` as there) and derive
        its roofline report dict on the port's H100."""
        from repro_torch.configs.base import ShapeSpec, shapes_for
        from repro_torch.roofline import H100_SXM, analyze_trace, model_flops

        t0 = time.time()
        shape = shape if shape is not None else self.spec.opt("shape")
        variant = dict(variant or self.spec.opt("variant") or {})
        rec, meta = self.trace(shape, variant, decode_len=decode_len)
        if variant:
            meta["variant"] = dict(variant)
        cell = (shape if isinstance(shape, ShapeSpec)
                else {s.name: s for s in shapes_for(self.cfg)}[meta["shape"]])
        mf = model_flops(self.cfg, cell.kind, cell.seq_len, cell.global_batch)
        rep = analyze_trace(rec, arch=meta["arch"], shape=meta["shape"],
                            mesh_name=meta["mesh"], n_devices=meta["n_devices"],
                            model_flops_global=mf, chip=H100_SXM)
        d = rep.to_dict()
        d.update(meta, compile_s=round(time.time() - t0, 1), status="ok")
        if verbose:
            print(f"[{meta['arch']} x {meta['shape']} x {meta['mesh']}] "
                  f"trace={d['compile_s']}s  "
                  f"compute={rep.compute_s:.3e}s memory={rep.memory_s:.3e}s "
                  f"collective={rep.collective_s:.3e}s kernels={rep.kernel_s:.3e}s  "
                  f"dominant={rep.dominant}  useful={rep.useful_flops_ratio:.3f}")
            print("  memory:", rep.memory_stats)
            print("  collectives:", rep.collective_breakdown)
        return d

    # ------------------------------------------------------------------
    # train / fl-orchestrate: the pod FWQ-FL loop
    # ------------------------------------------------------------------
    def orchestrator(self, n_clients: int):
        """The fl-orchestrate round planner for ``n_clients`` devices (host
        math: channel, GBD co-design, energy, faults)."""
        from repro_torch.core.energy import heterogeneous_fleet, memory_capacities
        from repro_torch.fed.orchestrator import FLOrchestrator, OrchestratorConfig

        spec, cfg = self.spec, self.cfg
        fleet = heterogeneous_fleet(n_clients, seed=spec.seed, group_step_mhz=5.0)
        caps = memory_capacities(n_clients, lo_mb=8, hi_mb=64) * 1e6
        n_params = cfg.param_count()
        return FLOrchestrator(
            OrchestratorConfig(n_devices=n_clients, n_rounds=spec.rounds,
                               scheme=spec.opt("scheme", "fwq"),
                               model_dim_d=n_params,
                               precision=self.policy, seed=spec.seed,
                               faults=spec.opt("faults"),
                               program=spec.opt("precision_program"),
                               resolve_drift_db=float(
                                   spec.opt("resolve_drift_db", 0.0))),
            fleet, caps, grad_bytes=4.0 * n_params)

    def _ensure_train_state(self) -> dict:
        if self._train_state is not None:
            return self._train_state
        from repro_torch.data.pipeline import TokenBatcher
        from repro_torch.data.synthetic import SyntheticTokens
        from repro_torch.optim import build_optimizer

        spec, cfg = self.spec, self.cfg
        tc = self.train_config()
        opt = build_optimizer("sgd", tc.learning_rate)
        ts = self.train_step(opt)
        n_clients = ts.n_clients
        B = n_clients * spec.batch

        params = self.init_params()
        opt_state = opt.init(params)

        tokens = SyntheticTokens(n_tokens=300_000, vocab=cfg.vocab_size,
                                 seed=spec.seed).generate()
        batcher = TokenBatcher(tokens, spec.seq, seed=spec.seed)
        orch = self.orchestrator(n_clients) if spec.workload == "fl-orchestrate" else None

        start = 0
        if self.ckpt:
            from repro_torch.ckpt.checkpoint import shard_state

            expect = None
            if orch is not None:
                expect = {"faults": (orch.cfg.faults.to_dict()
                                     if orch.cfg.faults is not None else None)}
            state, start, _ = self.ckpt.restore_or({"p": params, "o": opt_state},
                                                   expect_extra=expect)
            if start:
                state = shard_state(state, params, self.axes, cfg)
                params, opt_state = state["p"], state["o"]
                log.info("resumed at round %d", start)
                if orch is not None:
                    # replay the completed rounds' planning (seeded host
                    # math), so the resumed run plans as the uninterrupted
                    # one (rank 0 plans for every rank)
                    for r in range(start if self.rank == 0 else 0):
                        orch.plan_round(r)
                else:
                    for r in range(start):
                        self.program.policy_for_round(
                            r, self.policy, self._observe_train(r))

        self._train_state = dict(
            opt=opt, params=params, opt_state=opt_state, batcher=batcher, orch=orch,
            n_clients=n_clients, B=B, start=start, history=[],
            step_cache={self.policy.grad_compression_bits: ts.fn}, energy_cum=0.0)
        return self._train_state

    def _observe_train(self, r: int):
        """Controller observation for the plain ``train`` workload (no
        orchestrator energy model: cumulative spend is what the history rows
        have recorded, 0.0 before any round runs)."""
        from repro_torch.api.program import Observation

        st = self._train_state or {}
        hist = st.get("history") or []
        return Observation(
            round=r, rounds_total=self.spec.rounds,
            energy_cum_j=float(st.get("energy_cum", 0.0)),
            energy_round_j=float(hist[-1]["energy_j"]) if hist else 0.0)

    def _train_step_for(self, policy: PrecisionPolicy):
        """The train step for ``policy``, cached by the gradient wire width
        (weight bits reach the step through ``delta``)."""
        from repro_torch.launch.steps import build_train_step

        st = self._ensure_train_state()
        key = policy.grad_compression_bits
        cache = st["step_cache"]
        if key not in cache:
            tc = dataclasses.replace(self.train_config(), grad_compression_bits=key)
            cache[key] = build_train_step(self.model, self.axes, st["opt"], tc).fn
        return cache[key]

    def fl_round(self, r: int) -> dict:
        """One federated round: per-round policy -> delta -> step.

        Under ``fl-orchestrate`` the round's :class:`PrecisionPolicy` comes
        from the GBD co-design (``plan["policy"]``); under ``train`` the
        spec's fixed policy (through the precision program) applies.
        """
        st = self._ensure_train_state()
        spec, cfg, dev = self.spec, self.cfg, self.device
        n_clients, B = st["n_clients"], st["B"]

        plan = None
        if st["orch"] is not None:
            # rank 0 plans (host math), every rank runs its plan
            plan = st["orch"].plan_round(r) if self.rank == 0 else None
            for group in self._groups():
                plan = group.broadcast_object(plan)
        if plan is not None:
            policy = plan["policy"]
        else:
            policy = self.program.policy_for_round(r, self.policy,
                                                   self._observe_train(r))
        bits = policy.bits_vector(n_clients)

        raw = st["batcher"].sample_round(r, n_clients, spec.batch)
        rows = slice(0, B)
        if self.axes.transport is not None:     # every rank draws the global batch
            c = self.axes.dp_index()            # and keeps its client's rows
            rows = slice(c * spec.batch, (c + 1) * spec.batch)
        batch = {k: torch.as_tensor(raw[k].reshape(B, spec.seq)[rows], device=dev)
                 for k in ("tokens", "labels")}
        # the stub frontends' inputs (VLM images, enc-dec frames) are zeros,
        # as in the reference
        for name, t in self.model.train_batch_spec(rows.stop - rows.start, spec.seq).items():
            if name not in batch:
                batch[name] = torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev)
        delta = policy.delta(n_clients)
        step = self._train_step_for(policy)
        t0 = time.time()
        st["params"], st["opt_state"], m = step(
            st["params"], st["opt_state"], batch, delta, self.round_draws(r))
        rec = {"round": r, "loss": float(m["loss"]),
               "bits": bits.tolist(),
               "comm_bits": int(policy.comm),
               "energy_j": plan["energy_round"] if plan else 0.0,
               "t_round_s": plan["t_round"] if plan else 0.0,
               "wall_s": round(time.time() - t0, 3),
               "cohort": int(plan["cohort"].sum()) if plan else n_clients}
        if plan is not None and "retransmissions" in plan:
            rec.update(retransmissions=plan["retransmissions"],
                       retx_energy_j=plan["retx_energy_j"],
                       undelivered=plan["undelivered"],
                       dropped_midround=plan["dropped_midround"])
        st["history"].append(rec)
        st["energy_cum"] += float(rec["energy_j"])
        if self.ckpt and self.ckpt.due(r + 1):
            from repro_torch.ckpt.checkpoint import gather_state

            extra = {"round": r + 1}
            orch = st["orch"]
            if orch is not None:
                extra["faults"] = (orch.cfg.faults.to_dict()
                                   if orch.cfg.faults is not None else None)
            state = gather_state({"p": st["params"], "o": st["opt_state"]}, st["params"],
                                 self.axes, cfg)
            if self.rank == 0:
                self.ckpt.maybe_save(r + 1, state, extra=extra)
            for group in self._groups():
                group.barrier()                 # the checkpoint is whole before any rank reads
        return rec

    def run_train(self) -> list[dict]:
        """The ``train`` / ``fl-orchestrate`` loop: ``spec.rounds`` rounds
        (from a checkpoint's round when ``ckpt_dir`` holds one)."""
        st = self._ensure_train_state()
        quiet = bool(self.spec.opt("quiet", False)) or self.rank != 0   # rank 0's rows
        for r in range(st["start"], self.spec.rounds):
            rec = self.fl_round(r)
            if not quiet:
                log.info("round %d loss=%.4f bits=%s energy=%.2fJ",
                         r, rec["loss"], sorted(set(rec["bits"])), rec["energy_j"])
        history = st["history"]
        total_e = sum(h["energy_j"] for h in history)
        if not quiet and history:
            scheme = (self.spec.opt("scheme", "fwq")
                      if self.spec.workload == "fl-orchestrate" else "fixed")
            print(f"\nscheme={scheme} rounds={len(history)} "
                  f"final_loss={history[-1]['loss']:.4f} "
                  f"total_energy={total_e:.2f}J")
        out = self.spec.opt("out", "")
        if out and self.rank == 0:
            with open(out, "w") as f:
                json.dump(history, f, indent=1)
        return history

    # ------------------------------------------------------------------
    # serve: continuous-batching quantized decode driver
    # ------------------------------------------------------------------
    def serve(self, **overrides) -> ServeStats:
        """Drive the continuous-batching decode loop; returns ServeStats.

        Weight precision comes from the session policy: ``packed`` policies
        store int8/int16 ``QTensor`` codes, and ``policy.lazy`` keeps them
        packed through the ``quant_matmul`` kernel.  ``overrides`` patch
        individual options (steps, requests, ...) for this call only.

        KV-cache layout (``kv_layout`` option, default ``"paged"``; an SSM
        model, whose state is O(1), serves contiguous whatever is asked):
        the paged layout allocates each request's pages ON ADMIT for its full
        capacity (prompt + max_new, page-rounded) from a shared pool sized by
        ``pool_pages`` (default: the largest ``batch`` concurrent requests),
        reclaims them on completion, and DEFERS admissions the pool cannot
        hold until a completion frees pages.  Either layout enforces
        capacity: a slot whose cache fills up is stopped and counted in
        ``capacity_stops``.  Prompts are right-padded to power-of-two
        buckets (``vary_prompt`` draws ragged prompt lengths).

        On a ``Dx1`` mesh the batch splits into D data shards as in the
        reference: shard ``c`` owns slots ``[c*b, (c+1)*b)``, ``b = batch //
        D`` (a batch that does not divide raises), and runs the prefills and
        decode steps on its own slots, caches and, on the paged layout, its
        own whole pool of ``pool_pages`` pages (page ids from the one pager
        over every slot).  One host scheduler plans over the global batch.
        In one process the D shards run one after another on the device,
        the packed weights held whole; under a process group each rank is
        one shard, holds its FSDP slice of the packed weights (packed leaf by
        leaf, the codes gathered as bytes at each use), runs every prefill
        and decode step (a collective skipped would hang the group), and
        all-gathers its sampled tokens, so every rank's schedule, tokens and
        :class:`ServeStats` (its clocks apart) are the same; rank 0 prints.

        On a ``DxT`` mesh with T > 1 (every family, under a group of D·T
        ranks) each rank is one model shard of one data shard:
        it draws the whole model leaf by leaf, packs each whole leaf and
        keeps its tensor-parallel slice (then its FSDP slice), runs every
        prefill and decode step with its model group (the row-parallel
        projections' ``psum``, the greedy pick's ``pmax`` and ``pmin``), so
        every model rank holds the same tokens, and the data shards
        all-gather theirs over the batch group.  Where the KV heads do not
        split over T the cache is sequence-parallel, which this driver
        serves contiguous, as the reference's does: an explicit
        ``kv_layout="paged"`` there raises (the paged sequence-parallel
        decode runs at the step level, with per-shard page tables:
        ``paging.set_page_tables(model_shard=, tp=)``).  ``kv_bytes`` and
        ``kv_bytes_contiguous`` are the reference's global figures, joined
        over the batch and the model axes.
        """
        from repro_torch.core.quantization import default_exempt
        from repro_torch.dist.sharding import (batch_specs, cache_specs, cut_batch, join_batch,
                                               join_model)
        from repro_torch.launch.paging import (SlotPager, kv_cache_bytes, pages_for,
                                               plan_admissions, set_page_tables)
        from repro_torch.launch.steps import (build_cached_prefill, build_decode_step,
                                              build_init_fn, init_global_caches)
        from repro_torch.models.common import pack_params_for_policy

        spec, policy, dev = self.spec, self.policy, self.device
        o = dict(spec.options)
        o.update(overrides)
        steps = int(o.get("steps", 16))
        batch = spec.batch
        s_max = int(o.get("s_max", spec.seq))
        prompt_len = min(int(o.get("prompt_len", 8)), s_max)
        attn_impl = o.get("attn_impl", "ref")
        requests = o.get("requests")
        max_new = o.get("max_new")
        quiet = bool(o.get("quiet", False))
        vary_prompt = bool(o.get("vary_prompt", False))
        seed = spec.seed

        if attn_impl not in ("ref", "flash"):
            raise ValueError(f"attn_impl must be 'ref' or 'flash', "
                             f"got {attn_impl!r}")
        impl = "auto" if attn_impl == "ref" else "flash"

        cfg, model, axes = self.cfg, self.model, self.axes
        ranks = axes.transport is not None      # one shard a process
        quiet = quiet or self.rank != 0

        def say(msg):
            if not quiet:
                print(msg)

        D = axes.dp
        if batch % D:
            raise ValueError(
                f"serve on mesh {spec.mesh!r}: batch {batch} does not divide over its {D} "
                "data shards (the reference's serve fails there too: its page tables and "
                "batch inputs do not split into equal shards)")
        b = batch // D
        shards = [axes.dp_index()] if ranks else list(range(D))
        shard_axes = {c: axes if ranks else axes.at_client(c) for c in shards}
        rows = {c: slice(c * b, (c + 1) * b) for c in shards}

        # ---- KV layout ---------------------------------------------------
        kv_layout = o.get("kv_layout") or ("paged" if model.supports_paged_kv
                                           else "contiguous")
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"kv_layout must be 'paged' or 'contiguous', "
                             f"got {kv_layout!r}")
        if kv_layout == "paged" and not model.supports_paged_kv:
            kv_layout = "contiguous"    # SSM: O(1) state, nothing to page
        if kv_layout == "paged" and axes.tp > 1:
            from repro_torch.models.attention import kv_cache_seq_parallel
            from repro_torch.models.transformer import attn_dims

            if kv_cache_seq_parallel(attn_dims(cfg, axes.tp)):
                # the host pager covers the KV-sharded and tp = 1 layouts; a
                # defaulted layout serves the sequence-parallel cache
                # contiguous, an explicit paged request raises (as the
                # reference's driver)
                if o.get("kv_layout") is None:
                    kv_layout = "contiguous"
                else:
                    raise ValueError(
                        "kv_layout='paged' is not supported by the serving driver on "
                        "sequence-parallel (kv-replicated, tp>1) meshes; drop the option "
                        "to fall back to contiguous or drive build_decode_step directly")
        page_size = o.get("page_size")
        if page_size is None:
            page_size = next(p for p in (16, 8, 4, 2, 1) if s_max % p == 0)
        page_size = int(page_size)

        # ---- pack to the policy's storage (norm exemptions as in training)
        serve_bits = policy.serve_bits

        def pack(leaves):
            return pack_params_for_policy(leaves, policy, exempt=default_exempt)

        # the whole model's figures from its shapes; the storage drawn from
        # spec.seed and packed (under a group leaf by leaf, then sliced:
        # build_init_fn)
        whole = model.init(torch.Generator().manual_seed(0), 1, device="meta")
        raw_bytes = _weight_bytes(whole)
        f32_bytes = sum(w.numel() * 4 for w in whole.values())
        q_bytes = _weight_bytes(pack(whole))
        qparams = build_init_fn(model, axes, device=dev, pack=pack)(
            torch.Generator(device=dev).manual_seed(spec.seed))
        if policy.packed:
            say(f"params: {raw_bytes/1e6:.1f} MB f32 -> {q_bytes/1e6:.1f} MB "
                f"packed ({raw_bytes/q_bytes:.2f}x smaller, bits={serve_bits})")
        else:
            say(f"params: {raw_bytes/1e6:.1f} MB f32 (unpacked baseline)")

        # ---- synthetic request queue ------------------------------------
        n_requests = requests if requests is not None else 2 * batch
        rng = np.random.RandomState(seed)
        # default cap: ~half the step budget, so completions (and therefore
        # mid-flight admissions) happen within a demo-sized run.  An EXPLICIT
        # max_new is honored as asked — a request that outgrows its cache
        # stops at capacity and is counted, never silently clipped.
        if max_new is not None:
            cap = max(1, int(max_new))
        else:
            cap = max(1, min(max(2, steps // 2), s_max - prompt_len - 1))
        # what the prefill takes: tokens (the text families, the VLM with
        # images) or the source frames alone (enc-dec: no prompt is cached)
        pf_spec = model.prefill_batch_spec(batch, prompt_len, s_max)
        needs_tokens = "tokens" in pf_spec
        queue = []
        for i in range(n_requests):
            plen = (int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
                    if vary_prompt else prompt_len)
            queue.append(
                {"id": i,
                 "prompt": rng.randint(2, cfg.vocab_size, size=(plen,)),
                 "prompt_len": plen if needs_tokens else 0,
                 # staggered lengths so completions (and admissions) interleave
                 "max_new": int(rng.randint(max(1, cap // 2), cap + 1))})

        def bucket_of(plen: int) -> int:
            b = 4
            while b < plen:
                b *= 2
            return min(b, s_max)

        # ---- caches + pager ---------------------------------------------
        if kv_layout == "paged":
            def req_pages(req):
                tokens_cap = min(req["prompt_len"] + req["max_new"], s_max)
                return pages_for(tokens_cap, page_size)

            pool_pages = o.get("pool_pages")
            if pool_pages is None:
                # hold the `batch` largest concurrent requests — strictly
                # below the contiguous batch*s_max worst case on mixed loads
                demand = sorted((req_pages(r) for r in queue), reverse=True)
                pool_pages = max(sum(demand[:batch]), 1)
            pool_pages = int(pool_pages)
            pager = SlotPager.build(batch, s_max, page_size, pool_pages)
            cache_kw = {"page_size": page_size, "pool_pages": pool_pages}
        else:
            pager = None
            cache_kw = {}
        # one cache tree a shard (b slots; a paged shard's pool whole)
        caches = {c: init_global_caches(model, shard_axes[c], s_max=s_max,
                                        batch_global=batch, dtype=policy.kv_cache_dtype(),
                                        device=dev, **cache_kw) for c in shards}

        def global_bytes(shard) -> int:
            """K/V bytes of the reference's global arrays: the D x T mesh
            devices' trees joined over the batch (one pool, every slot's
            slab) and over the model axis (every KV head, or every position
            of a sequence-parallel cache; every model shard's pool)."""
            specs = cache_specs(shard, axes, cfg)
            joined = join_batch([shard] * D, specs, axes)
            return kv_cache_bytes(join_model([joined] * axes.tp, specs, axes))

        meta = dict(s_max=s_max, batch_global=batch, dtype=policy.kv_cache_dtype(),
                    device="meta")
        shard_meta = init_global_caches(model, axes, **meta, **cache_kw)
        kv_bytes = global_bytes(shard_meta)
        kv_bytes_contig = global_bytes(init_global_caches(model, axes, **meta))
        if D * axes.tp > 1:
            held = D * axes.tp * kv_cache_bytes(shard_meta)
            say(f"kv cache: {held/1e6:.2f} MB held over {D} data shards of {b} slots x "
                f"{axes.tp} model shards ({'a pool' if pager is not None else 'a slab'} each; "
                f"{kv_bytes/1e6:.2f} MB in the reference's global figure)")

        # ---- steps (one a shard) ------------------------------------------
        ss = {c: build_decode_step(model, shard_axes[c], policy=policy, attn_impl=attn_impl)
              for c in shards}
        pf = {c: build_cached_prefill(model, shard_axes[c], attn_impl=impl, policy=policy,
                                      bos_id=BOS_ID) for c in shards}
        buckets_used: set = set()

        def shard_tokens(outs: dict) -> np.ndarray:
            """The global batch's sampled tokens from the shards' ``(b, 1)``:
            concatenated in one process, all-gathered (int32) under a group."""
            if ranks:
                tok = axes.transport.all_gather(outs[shards[0]].to(torch.int32))
            else:
                tok = torch.cat([outs[c] for c in shards])
            return tok.cpu().numpy()             # waits for the device

        memory_inputs = serve_memory_inputs(pf_spec, seed, dev)

        kv_bits = 16 if policy.kv_cache_dtype() == torch.bfloat16 else 32
        kv_demotions = 0
        pool_pressure = 0.0

        # ---- slot state (host side) -------------------------------------
        active = np.zeros((batch,), bool)
        remaining = np.zeros((batch,), np.int64)
        slot_plen = np.zeros((batch,), np.int64)   # tokens cached at admit
        slot_cap = np.full((batch,), s_max, np.int64)
        seqs = [[] for _ in range(batch)]
        finished = []
        sampled: list = []
        cur_tok = np.full((batch, 1), BOS_ID, np.int32)
        admitted = completed = decoded = 0
        capacity_stops = 0
        deferred_ids: set = set()   # requests that waited at least once

        def req_cap(req):
            return min(req["prompt_len"] + req["max_new"], s_max)

        def set_tables():
            for c in shards:
                caches[c] = set_page_tables(caches[c], pager.table, rows[c])

        def admit():
            nonlocal cur_tok, admitted, pool_pressure
            free = [i for i in range(batch) if not active[i]]
            fill = []
            if pager is None:
                while free and queue:
                    fill.append((free.pop(0), queue.pop(0)))
            else:
                # FIFO with cascading reservation (plan_admissions)
                demands = [pager.pages_for(req_cap(r)) for r in queue]
                take, blocked = plan_admissions(pager.pool.free_pages,
                                                len(free), demands)
                for qi in blocked:
                    if demands[qi] > pager.pool.n_pages:
                        raise ValueError(
                            f"page pool ({pager.pool.n_pages} pages) can "
                            f"never fit a {demands[qi]}-page request; raise "
                            "pool_pages")
                    deferred_ids.add(queue[qi]["id"])
                for qi in take:
                    req = queue[qi]
                    slot = free.pop(0)
                    if not pager.admit(slot, req_cap(req)):
                        raise RuntimeError(
                            "admission plan out of sync with page pool")
                    fill.append((slot, req))
                for qi in sorted(take, reverse=True):
                    queue.pop(qi)
                # watermark signal: a page-blocked admission saturates it
                pool_pressure = 1.0 if blocked else pager.pool.pressure
            if not fill:
                return
            if pager is not None:
                set_tables()
            new_tok = cur_tok.copy()
            by_bucket: dict[int, list] = {}
            for s, req in fill:
                by_bucket.setdefault(bucket_of(len(req["prompt"])), []).append((s, req))
            for bucket, group in sorted(by_bucket.items()):
                buckets_used.add(bucket)
                mask = np.zeros((batch,), bool)
                plens = np.ones((batch,), np.int32)
                toks = np.ones((batch, bucket), np.int32)
                for s, req in group:
                    mask[s] = True
                    plens[s] = len(req["prompt"])
                    toks[s, : len(req["prompt"])] = req["prompt"]
                pf_batch = dict(memory_inputs)
                if needs_tokens:
                    pf_batch["tokens"] = torch.as_tensor(toks, device=dev)
                pf_batch["mask"] = torch.as_tensor(mask, device=dev)
                pf_batch["plens"] = torch.as_tensor(plens, device=dev)
                specs = batch_specs(pf_batch, axes)
                outs = {}
                for c in shards:                # every shard, its slots masked or not
                    sb = cut_batch(pf_batch, specs, axes, c)
                    m, pl = sb.pop("mask"), sb.pop("plens")
                    outs[c], caches[c] = pf[c].fn(qparams, sb, caches[c], m, pl)
                tok = shard_tokens(outs)
                for s, req in group:
                    active[s] = True
                    remaining[s] = req["max_new"]
                    slot_plen[s] = req["prompt_len"]
                    slot_cap[s] = (pager.slot_capacity(s) if pager is not None
                                   else s_max)
                    seqs[s] = [int(tok[s, 0])]
                    sampled.append(int(tok[s, 0]))
                    new_tok[s] = tok[s]
                    admitted += 1
            cur_tok = new_tok

        def maybe_demote_kv():
            """f32 -> bf16 pool demotion when paged-KV pressure crosses the
            program's watermark (a one-way ratchet)."""
            nonlocal kv_bits, kv_demotions
            if pager is None or kv_bits <= 16:
                return
            from repro_torch.api.program import Observation

            obs = Observation(round=admitted, pool_pressure=pool_pressure)
            if self.program.kv_demote(obs):
                from repro_torch.models.attention import demote_kv_cache

                for c in shards:
                    caches[c] = demote_kv_cache(caches[c], torch.bfloat16)
                kv_bits = 16
                kv_demotions += 1
                say(f"kv cache: pool pressure {pool_pressure:.2f} >= "
                    f"watermark {self.program.kv_watermark} -> demoted "
                    "f32 pools to bf16")

        def step(tokens):
            tok_t = torch.as_tensor(tokens, device=dev)
            outs = {}
            for c in shards:                    # every shard, active slots or not
                outs[c], caches[c] = ss[c].fn(qparams, {"token": tok_t[rows[c]]}, caches[c])
            out = shard_tokens(outs)
            sampled.extend(int(t) for t in out[active, 0])
            return out

        admit()
        maybe_demote_kv()
        # the first step is not timed (it pays one-off costs, e.g. the
        # kernels' first launch); its output is a real decode step
        tok_h = step(cur_tok)
        t0, step_i, decoded_at_t0 = time.time(), 1, 0
        while True:
            done_any = False
            for s in range(batch):
                if not active[s]:
                    continue
                seqs[s].append(int(tok_h[s, 0]))
                decoded += 1
                remaining[s] -= 1
                # tokens cached so far (the newest token is not written until
                # it is fed back)
                cached = slot_plen[s] + len(seqs[s]) - 1
                done = remaining[s] <= 0
                if not done and cached >= slot_cap[s]:
                    # cache full: STOP the slot rather than drop K/V writes
                    done = True
                    capacity_stops += 1
                if done:
                    active[s] = False
                    if pager is not None:
                        pager.evict(s)
                    finished.append(seqs[s])
                    completed += 1
                    done_any = True
            if step_i == 1:
                decoded_at_t0 = decoded       # step 1 ran before the timer
            if step_i >= steps or (not active.any() and not queue):
                break
            if done_any and pager is not None:
                # cleared table rows make the evicted slots' future writes
                # drop instead of landing on reclaimed pages
                set_tables()
            cur_tok = tok_h.copy()            # each slot feeds its own last token
            if done_any and queue:
                admit()                       # mid-flight slot reuse
                maybe_demote_kv()
            tok_h = step(cur_tok)
            step_i += 1
        wall = time.time() - t0
        self.last_tokens = sampled

        dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        stats = ServeStats(
            arch=self.spec.arch, bits=serve_bits, attn_impl=attn_impl,
            decode_steps=step_i, decoded_tokens=decoded, completed=completed,
            admitted=admitted, wall_s=wall,
            tok_s=(decoded - decoded_at_t0) / max(wall, 1e-9),
            bytes_per_step_packed=q_bytes, bytes_per_step_f32=f32_bytes,
            packed_vs_f32=q_bytes / max(f32_bytes, 1),
            sample=(finished[0] if finished else seqs[0])[:16],
            kv_layout=kv_layout,
            page_size=page_size if kv_layout == "paged" else 0,
            kv_bytes=kv_bytes, kv_bytes_contiguous=kv_bytes_contig,
            capacity_stops=capacity_stops,
            deferred_admissions=len(deferred_ids),
            prompt_buckets=sorted(buckets_used),
            kv_demotions=kv_demotions,
            kv_bits_final=kv_bits,
            device=dev_name,
        )
        # one scheduler run on every rank: every rank's stats and tokens must
        # be rank 0's (the clocks apart): held to its model row's first rank,
        # and to its model column's first rank, which row 0 holds to rank 0
        mine = {"stats": {k: v for k, v in vars(stats).items()
                          if k not in ("wall_s", "tok_s")}, "tokens": sampled}
        for group in (axes.model_transport, axes.transport):
            if group is not None and group.broadcast_object(mine) != mine:
                raise RuntimeError(f"serve: rank {self.rank}'s schedule, tokens or stats "
                                   "differ from rank 0's")
        say(f"decoded {stats.decoded_tokens} tokens over {stats.decode_steps} "
            f"steps x {batch} slots in {wall:.3f}s = {stats.tok_s:.1f} tok/s "
            f"on {dev_name}")
        say(f"admitted {stats.admitted} / completed {stats.completed} sequences "
            f"(continuous batching over {n_requests} requests; "
            f"{capacity_stops} capacity stops, "
            f"{len(deferred_ids)} deferred admissions)")
        say(f"weight stream: {q_bytes/1e6:.1f} MB/step packed vs "
            f"{f32_bytes/1e6:.1f} MB/step f32 -> ratio {stats.packed_vs_f32:.3f}")
        if kv_layout == "paged":
            say(f"kv cache: {kv_bytes/1e6:.2f} MB paged pool "
                f"(page={page_size}, buckets={stats.prompt_buckets}) vs "
                f"{kv_bytes_contig/1e6:.2f} MB contiguous")
        say(f"sample: {stats.sample}")
        return stats

    # ------------------------------------------------------------------
    # fl-sim: the paper's CIFAR-class experiment loop
    # ------------------------------------------------------------------
    def run_fl_sim(self) -> dict:
        """FLSimulation (Algorithm 1, one K1 launch a round) + the GBD
        orchestrator, CNN-scale, on the session's device."""
        from repro_torch.core.energy import heterogeneous_fleet, memory_capacities
        from repro_torch.data import ClientBatcher, SyntheticImages, dirichlet_partition
        from repro_torch.fed.orchestrator import FLOrchestrator, OrchestratorConfig
        from repro_torch.fed.simulation import FLSimulation, SimConfig
        from repro_torch.models.cnn import mobilenet, resnet, xent_loss

        spec, dev = self.spec, self.device
        o = spec.options
        n_clients = int(o.get("n_clients", 8))
        seed = spec.seed
        if spec.arch == "resnet":
            model = resnet(depth_blocks=(1, 1), width=8)
        elif spec.arch == "mobilenet":
            model = mobilenet(width=8, n_stages=2)
        else:
            raise ValueError(f"fl-sim arch must be one of {SIM_ARCHS}, "
                             f"got {spec.arch!r}")
        loss = xent_loss(model)
        sim = FLSimulation(loss, model.init,
                           SimConfig(n_clients=n_clients,
                                     lr=float(o.get("lr", 0.08)), seed=seed),
                           device=dev)
        imgs, labels = SyntheticImages(n=2048, hw=16, seed=seed).generate()
        parts = dirichlet_partition(labels, n_clients, alpha=0.5, seed=seed)
        batcher = ClientBatcher(imgs, labels, parts, batch=spec.batch,
                                seed=seed)
        fleet = heterogeneous_fleet(n_clients, seed=seed, group_step_mhz=5.0)
        caps = memory_capacities(n_clients, lo_mb=2.0, hi_mb=8.0) * 1e6
        orch = FLOrchestrator(
            OrchestratorConfig(
                n_devices=n_clients, n_rounds=spec.rounds,
                scheme=o.get("scheme", "fwq"),
                model_dim_d=int(o.get("model_dim_d", 1 << 16)),
                error_tolerance=float(o.get("error_tolerance", 4.5)),
                precision=self.policy, seed=seed,
                faults=o.get("faults"),
                program=o.get("precision_program"),
                resolve_drift_db=float(o.get("resolve_drift_db", 0.0)),
                ckpt_dir=str(o.get("ckpt_dir", "")),
                ckpt_every=int(o.get("ckpt_every", 10))),
            fleet, caps, grad_bytes=float(o.get("grad_bytes", 1e6)))

        def batch_fn(r, cohort):
            x, y = batcher.sample_round(r, cohort)
            return {"x": torch.as_tensor(x, device=dev), "y": torch.as_tensor(y, device=dev)}

        eval_every = int(o.get("eval_every", 0))
        eval_fn = None
        if eval_every:
            eimgs, elabels = SyntheticImages(n=512, hw=16,
                                             seed=seed + 999).generate()
            ebatch = {"x": torch.as_tensor(eimgs, device=dev),
                      "y": torch.as_tensor(elabels, device=dev)}
            eval_fn = lambda s: s.evaluate(loss, ebatch)  # noqa: E731

        return orch.run(sim, batch_fn, eval_fn=eval_fn, eval_every=eval_every)
