"""One rank of the port's multi-process CPU tests (``gloo``, one client a
process).  Not a test module: the tests start ``n`` of these with
:func:`run_ranks`, each with ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set and
a ``FileStore`` rendezvous in the test's temporary directory (no port is
bound, so parallel test workers cannot collide)::

    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 python tests/torch_dist_worker.py job.json

``job.json``: ``{"store": path, "out": path, "tasks": [{"kind": ..., ...}]}``.
Each task's result lands in ``out`` (rank 0's; every rank's under
``"ranks"``), arrays in the ``.npz`` files the tasks name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def run_ranks(n: int, job: dict, tmp_dir: str, timeout: float = 300.0) -> dict:
    """Run ``job`` on ``n`` ranks; returns rank 0's results (with every
    rank's under ``"ranks"``).  A rank that fails fails the call."""
    job = {**job, "store": os.path.join(tmp_dir, "store"), "out": os.path.join(tmp_dir,
                                                                                "out.json")}
    path = os.path.join(tmp_dir, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src"),
           "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_worker.py"), path],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(log[-3000:] for log in logs)
    with open(job["out"]) as f:
        return json.load(f)


def step_cfg(n_layers: int = 2):
    """The smoke yi-6b widened to d_model 256 (``tests/test_torch_train``'s
    step config): FSDP-sharded and replicated leaves both occur."""
    from repro_torch.configs import get_config, smoke_variant

    return dataclasses.replace(smoke_variant(get_config("yi-6b")), d_model=256, n_heads=4,
                               n_kv_heads=2, head_dim=64, d_ff=512, remat=True,
                               n_layers=n_layers)


def file_draws(data, seed: int, round_idx: int):
    """An :class:`SRDraws` whose weight and wire uniforms are the arrays
    ``w:{client}:{path}`` and ``u:{leaf}`` of ``data`` (the reference's
    draws, made by the test)."""
    from repro_torch.launch.steps import SRDraws

    class FileDraws(SRDraws):
        def weights(self, client, path, shape, device):
            u = torch.from_numpy(data[f"w:{client}:{path}"])
            assert tuple(u.shape) == tuple(shape), (path, u.shape, shape)
            return u

        def wire(self, leaf, n_clients, shape, device):
            u = torch.from_numpy(data[f"u:{leaf}"])
            assert tuple(u.shape) == (n_clients, *shape), (leaf, u.shape, shape)
            return u

    return FileDraws(seed, round_idx)


def task_step(t: dict, rank: int) -> dict:
    """One train step from the params ``init:{path}`` of ``t["data"]`` at
    comm ``t["bits"]``; the gathered params go to ``t["save"]``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import SRDraws, build_train_step
    from repro_torch.models.common import apply_fsdp_sharding, fsdp_plan, gather_leaf
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer

    data = dict(np.load(t["data"]))
    axes = axis_ctx_for(t["mesh"], group="default")
    model = build_model(step_cfg(t.get("layers", 2)))
    whole = {k[5:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("init:")}
    params = apply_fsdp_sharding(whole, axes)
    D = axes.dp
    b = data["tokens"].shape[0] // D
    batch = {k: torch.from_numpy(data[k][rank * b:(rank + 1) * b]) for k in ("tokens", "labels")}
    opt = build_optimizer("sgd", t["lr"])
    tc = TrainConfig(learning_rate=t["lr"], seed=t["seed"], grad_compression_bits=t["bits"])
    step = build_train_step(model, axes, opt, tc)
    draws = (file_draws(data, t["seed"], t["round"]) if t.get("draws") == "file"
             else SRDraws(t["seed"], t["round"]))
    p1, _o, m = step.fn(params, opt.init(params), batch,
                        delta_for_clients(np.array(t["client_bits"])), draws)
    paths, _leaves, plan = fsdp_plan(p1, axes.fsdp, check_divisibility=False)
    full = {p: gather_leaf(p1[p], dim, axes) for p, dim in zip(paths, plan)}
    if rank == 0:
        np.savez(t["save"], **{k: v.numpy() for k, v in full.items()})
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_sq_shard_sum"]),
            "issued": axes.transport.report()["issued"],
            "staged": axes.transport.report()["staged"]}


def task_init(t: dict, rank: int) -> dict:
    """``build_init_fn`` at seed ``t["seed"]``: the rank's storage, gathered
    to ``t["save"]``, and its local shapes."""
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_init_fn
    from repro_torch.models.common import fsdp_plan, gather_leaf
    from repro_torch.models.model import build_model

    axes = axis_ctx_for(t["mesh"], group="default")
    model = build_model(step_cfg())
    local = build_init_fn(model, axes)(torch.Generator().manual_seed(t["seed"]))
    paths, _leaves, plan = fsdp_plan(local, axes.fsdp, check_divisibility=False)
    full = {p: gather_leaf(local[p], dim, axes) for p, dim in zip(paths, plan)}
    if rank == 0:
        np.savez(t["save"], **{k: v.numpy() for k, v in full.items()})
    return {"local_shapes": {p: list(local[p].shape) for p in paths}}


def task_wire(t: dict, rank: int) -> dict:
    """The keyed wire on rows drawn from ``t["seed"]`` (rank r takes row r
    of each leaf; ``t["nan"]`` poisons rank 1's first leaf): ``"raise"``
    must raise on every rank; ``"saturate"``'s means go to ``t["save"]``."""
    from repro_torch.dist.collectives import quantized_psum_batch
    from repro_torch.launch.mesh import axis_ctx_for

    axes = axis_ctx_for(f"{t['ranks']}x1", group="default")
    gen = torch.Generator().manual_seed(t["seed"])
    leaves = [torch.randn(axes.dp, n, generator=gen) * (i + 1) for i, n in enumerate(t["sizes"])]
    if t.get("nan"):
        leaves[0][1, 2] = float("nan")
        leaves[-1][1, 0] = float("inf")
    mine = [[g[rank]] for g in leaves]
    raised = None
    try:
        quantized_psum_batch(axes, mine, None, t["bits"], key=t["key"])
    except FloatingPointError as e:
        raised = str(e)
    means = quantized_psum_batch(axes, mine, None, t["bits"], key=t["key"],
                                 on_nonfinite="saturate")
    if rank == 0:
        np.savez(t["save"], *[m.numpy() for m in means])
    return {"raised": raised}


def task_comm_report(t: dict, rank: int) -> dict:
    """``Session.comm_report()`` of a ``train`` spec under the group."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session

    sess = Session(RunSpec("yi-6b", workload="train", mesh=t["mesh"], smoke=True, batch=2,
                           seq=32, rounds=1, precision=PrecisionPolicy(comm=t["comm"]),
                           options={"quiet": True}), device="cpu")
    assert sess.axes.transport is not None
    return {"comm_report": sess.comm_report()}


def task_packed_gather(t: dict, rank: int) -> dict:
    """``ParamCtx.use`` of packed FSDP leaves (int8 and int16 codes, shard
    dims first and last) under a lazy policy: the gathered ``QTensor``s'
    codes go to ``t["save"]``."""
    import types

    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.models.common import (ParamCtx, QTensor, fsdp_shard_dim, shard_leaf)

    axes = axis_ctx_for(f"{t['ranks']}x1", group="default")
    pc = ParamCtx(ctx=axes, policy=types.SimpleNamespace(lazy=True))
    gen = torch.Generator().manual_seed(t["seed"])
    got = {}
    for path, shape, dtype in (("blocks/attn/wq", (64, 512), torch.int16),
                               ("embed/table", (512, 64), torch.int8)):
        whole = torch.randint(-300 if dtype == torch.int16 else -127, 127, shape,
                              generator=gen).to(dtype)
        q = QTensor(shard_leaf(whole, fsdp_shard_dim(path, 2), axes), torch.tensor(0.5))
        out = pc.use(path, q)
        assert isinstance(out, QTensor) and out.codes.dtype == dtype
        got[path] = out.codes.numpy()
    if rank == 0:
        np.savez(t["save"], **{k.replace("/", "."): v for k, v in got.items()})
    return {}


def fixed_init(whole: dict):
    """A model init that draws nothing and returns copies of ``whole`` (on
    the meta device, their shapes): ``Session.serve`` then packs, and under
    a group slices, exactly these parameters."""
    def init(gen, tp, device=None):
        if device == "meta":
            return {k: torch.empty_like(v, device="meta") for k, v in whole.items()}
        return {k: v.clone() for k, v in whole.items()}
    return init


def task_serve(t: dict, rank: int) -> dict:
    """``Session.serve`` of ``t["arch"]`` (smoke size, lazy int8) on mesh
    ``t["mesh"]`` under the group, from the whole parameters of ``t["data"]``:
    the model's init is replaced by them, so each rank packs them leaf by
    leaf and keeps its slice.  The stats (clocks apart), the sampled
    tokens, the transport's counts and the prefills and decode steps run."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.models.model import count_passes

    whole = {k: torch.from_numpy(v) for k, v in np.load(t["data"]).items()}
    sess = Session(RunSpec(t["arch"], workload="serve", mesh=t["mesh"], smoke=True, seed=0,
                           batch=t["batch"], seq=t["options"]["s_max"],
                           precision=PrecisionPolicy.lazy_int8(7), options=t["options"]),
                   device="cpu")
    passes = {"prefill": 0, "decode": 0}
    sess.model = count_passes(dataclasses.replace(sess.model, init=fixed_init(whole)), passes)
    stats = sess.serve()
    return {"stats": {k: v for k, v in vars(stats).items() if k not in ("wall_s", "tok_s")},
            "tokens": sess.last_tokens, "passes": passes,
            "issued": sess.axes.transport.report()["issued"],
            "staged": sess.axes.transport.report()["staged"]}


def task_pack(t: dict, rank: int) -> dict:
    """The serving storage of ``t["arch"]`` (smoke size, widened to
    ``t["d_model"]``) drawn from seed ``t["seed"]`` and packed leaf by leaf
    under the group (``build_init_fn(..., pack=...)``): the rank's codes and
    scales to ``t["save"]`` with ``{rank}`` filled in."""
    from repro_torch.api import PrecisionPolicy
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.quantization import default_exempt
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_init_fn
    from repro_torch.models.common import QTensor, pack_params_for_policy
    from repro_torch.models.model import build_model

    axes = axis_ctx_for(t["mesh"], group="default")
    cfg = dataclasses.replace(smoke_variant(get_config(t["arch"])), d_model=t["d_model"])
    policy = PrecisionPolicy.lazy_int8(t["bits"])
    local = build_init_fn(build_model(cfg), axes, pack=lambda p: pack_params_for_policy(
        p, policy, exempt=default_exempt))(torch.Generator().manual_seed(t["seed"]))
    out = {}
    for path, w in local.items():
        if isinstance(w, QTensor):
            out[f"codes:{path}"], out[f"scale:{path}"] = w.codes.numpy(), w.scale.numpy()
        else:
            out[f"dense:{path}"] = w.numpy()
    np.savez(t["save"].format(rank=rank), **out)
    return {}


def _recorded_steps(calls: list):
    """Patch ``repro_torch.launch.steps``' serving step builders so every
    call's sampled tokens (this rank's slots) are appended to ``calls``;
    returns the undo."""
    from repro_torch.launch import steps

    builders = steps.build_decode_step, steps.build_cached_prefill

    def recording(builder, kind):
        def build(*a, **kw):
            ss = builder(*a, **kw)

            def call(*args):
                tok, caches = ss.fn(*args)
                calls.append([kind, tok[:, 0].tolist()])
                return tok, caches
            return dataclasses.replace(ss, fn=call)
        return build

    steps.build_decode_step = recording(builders[0], "decode")
    steps.build_cached_prefill = recording(builders[1], "prefill")

    def undo():
        steps.build_decode_step, steps.build_cached_prefill = builders
    return undo


def _wait_for(path: str, timeout: float = 240.0) -> None:
    import time

    t0 = time.time()
    while not os.path.exists(path + ".done"):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.2)


def task_serve_tp(t: dict, rank: int) -> dict:
    """``Session.serve`` of ``t["arch"]`` (smoke size, lazy int8) on mesh
    ``t["mesh"]`` (a model axis above 1) under the group, from the whole
    parameters of ``t["data"]`` (waited for: a reference run writes them)
    or, without, from the port's own init at seed 0; with ``t["memory"]``
    the stub frontends' inputs (images, frames) are that file's arrays.
    Every prefill's and decode step's tokens of this rank's slots, the
    stats (clocks apart), the sampled tokens, the passes (and the prompt
    tokens the prefills ran, ``prefill_tokens``), and each transport's
    counts; with ``t["expect"]`` the error the serve raised instead."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.api import session as session_mod
    from repro_torch.models.model import count_passes

    sess = Session(RunSpec(t["arch"], workload="serve", mesh=t["mesh"], smoke=True, seed=0,
                           batch=t["batch"], seq=t["options"]["s_max"],
                           precision=PrecisionPolicy.lazy_int8(7), options=t["options"]),
                   device="cpu")
    passes = {"prefill": 0, "decode": 0, "prefill_tokens": 0}
    model = sess.model
    if t.get("data"):
        _wait_for(t["data"])
        whole = {k: torch.from_numpy(v) for k, v in np.load(t["data"]).items()}
        model = dataclasses.replace(model, init=fixed_init(whole))
    model = count_passes(model, passes)
    prefill = model.prefill

    def widths(pc, params, batch, caches, **kw):
        if "tokens" in batch:
            passes["prefill_tokens"] += int(batch["tokens"].shape[1])
        return prefill(pc, params, batch, caches, **kw)

    sess.model = dataclasses.replace(model, prefill=widths)
    drawn = session_mod.serve_memory_inputs
    if t.get("memory"):
        memory = {k: torch.from_numpy(v) for k, v in np.load(t["memory"]).items()}
        session_mod.serve_memory_inputs = lambda spec, seed, device: {
            k: v.to(device) for k, v in memory.items()}
    calls: list = []
    undo = _recorded_steps(calls)
    try:
        stats = sess.serve()
    except Exception as e:          # noqa: BLE001 - the error is the result
        if not t.get("expect"):
            raise
        return {"raised": f"{type(e).__name__}: {e}"}
    finally:
        undo()
        session_mod.serve_memory_inputs = drawn
    axes = sess.axes

    def report(tr):
        return None if tr is None else tr.report()
    return {"stats": {k: v for k, v in vars(stats).items() if k not in ("wall_s", "tok_s")},
            "tokens": sess.last_tokens, "calls": calls, "passes": passes,
            "at": [axes.dp_index(), axes.tp_index()],
            "model": report(axes.model_transport), "batch": report(axes.transport)}


def task_steps_tp(t: dict, rank: int) -> dict:
    """One decode step and one prefill step of the dry run's cells
    ``t["decode"]`` and ``t["prefill"]`` (``[seq_len, global batch]``) of
    ``t["arch"]`` (smoke size, lazy int8, ``t["options"]``) on mesh
    ``t["mesh"]`` under the group, as ``Session.trace`` builds them, on
    zero weights (bf16, the policy's codes where it packs) and zero caches:
    each step's model-group calls and bytes by kind and dtype."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, init_global_caches
    from repro_torch.models.common import QTensor

    opts = t["options"]
    sess = Session(RunSpec(t["arch"], workload="dryrun", mesh=t["mesh"], smoke=True,
                           precision=PrecisionPolicy.lazy_int8(7), options=opts), device="cpu")
    axes = axis_ctx_for(t["mesh"], group="default")
    model, policy = sess.model, sess.policy
    meta = model.init(torch.Generator().manual_seed(0), axes.tp, device="meta")
    params = {k: (QTensor(v.codes.zero_(), v.scale.fill_(1.0)) if isinstance(v, QTensor)
                  else v.zero_())
              for k, v in sess._serving_params(meta, "cpu", packed=policy.packed).items()}
    tr = axes.model_transport

    def issued_by(step):
        before = {k: list(v) for k, v in tr.issued.items()}
        step()
        return {f"{k} {dt}": [n - before.get((k, dt), [0, 0])[0],
                              b - before.get((k, dt), [0, 0])[1]]
                for (k, dt), (n, b) in tr.issued.items()
                if (n, b) != tuple(before.get((k, dt), [0, 0]))}

    s_dec, b_dec = t["decode"]
    b = b_dec // axes.dp
    caches = init_global_caches(model, axes, s_max=s_dec, batch_global=b * axes.dp,
                                dtype=torch.bfloat16, device="cpu",
                                page_size=opts.get("page_size"), pool_pages=opts.get("pool_pages"))
    dec = build_decode_step(model, axes, policy=policy, attn_impl=opts.get("attn_impl", "ref"))
    out = {"decode": issued_by(lambda: dec.fn(
        params, {"token": torch.zeros((b, 1), dtype=torch.int32)}, caches))}
    s_pf, b_pf = t["prefill"]
    pf = build_prefill_step(model, axes, policy=policy, attn_impl=opts.get("attn_impl", "auto"))
    batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype)
             for k, v in model.train_batch_spec(b_pf // axes.dp, s_pf).items() if k != "labels"}
    out["prefill"] = issued_by(lambda: pf.fn(params, batch))
    return out


def task_layout(t: dict, rank: int) -> dict:
    """The rank's place on mesh ``t["mesh"]``: its data and model index, its
    groups' ranks and sizes, and the sums of the global ranks over each
    group (which ranks are in it)."""
    from repro_torch.launch.mesh import axis_ctx_for

    axes = axis_ctx_for(t["mesh"], group="default")
    me = torch.tensor([float(rank)])
    return {"rank": axes.rank, "dp_index": axes.dp_index(), "tp_index": axes.tp_index(),
            "batch": [axes.transport.rank, axes.transport.size],
            "model": [axes.model_transport.rank, axes.model_transport.size],
            "batch_ranks": axes.transport.all_gather(me).tolist(),
            "model_ranks": axes.model_transport.all_gather(me).tolist(),
            "batch_sum": float(axes.psum_batch(me)), "model_sum": float(axes.psum_model(me))}


def task_model_collectives(t: dict, rank: int) -> dict:
    """The model-axis collectives on mesh ``t["mesh"]`` over seeded inputs
    (rank r draws the r-th of the ranks' draws): ``psum_model``,
    ``pmax_model``, ``pmin_model`` (f32 and int32), ``all_gather_model``
    along axes 0, 1 and 2; the results and the transport's counts."""
    from repro_torch.launch.mesh import axis_ctx_for

    axes = axis_ctx_for(t["mesh"], group="default")
    gen = torch.Generator().manual_seed(t["seed"])
    xs = [torch.randn(2, 3, 4, generator=gen) for _ in range(axes.tp)]
    ints = [torch.randint(-50, 50, (5,), generator=gen, dtype=torch.int32)
            for _ in range(axes.tp)]
    x, i = xs[axes.tp_index()], ints[axes.tp_index()]
    out = {"psum": axes.psum_model(x), "pmax": axes.pmax_model(x), "pmin": axes.pmin_model(x),
           "pmin_int": axes.pmin_model(i), "pmax_int": axes.pmax_model(i)}
    for ax in (0, 1, 2):
        out[f"gather{ax}"] = axes.all_gather_model(x, axis=ax)
    return {"out": {k: v.tolist() for k, v in out.items()},
            "dtypes": {k: str(v.dtype) for k, v in out.items()},
            "issued": axes.model_transport.report()["issued"]}


def task_init_tp(t: dict, rank: int) -> dict:
    """``build_init_fn`` of ``t["arch"]`` (smoke size) at seed ``t["seed"]``
    on mesh ``t["mesh"]``, packed (lazy int8) when ``t["packed"]``: the
    rank's storage to ``t["save"]`` with ``{rank}`` filled in."""
    from repro_torch.api import PrecisionPolicy
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.quantization import default_exempt
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_init_fn
    from repro_torch.models.common import QTensor, pack_params_for_policy
    from repro_torch.models.model import build_model

    axes = axis_ctx_for(t["mesh"], group="default")
    model = build_model(smoke_variant(get_config(t["arch"])))
    pack = None
    if t.get("packed"):
        policy = PrecisionPolicy.lazy_int8(7)
        pack = lambda p: pack_params_for_policy(p, policy, exempt=default_exempt)  # noqa: E731
    local = build_init_fn(model, axes, pack=pack)(torch.Generator().manual_seed(t["seed"]))
    out = {}
    for path, w in local.items():
        if isinstance(w, QTensor):
            out[f"codes:{path}"], out[f"scale:{path}"] = w.codes.numpy(), w.scale.numpy()
        else:
            out[f"dense:{path}"] = w.numpy()
    np.savez(t["save"].format(rank=rank), **out)
    return {}


def task_paged_tp(t: dict, rank: int) -> dict:
    """The step-level sequence-parallel paged decode of ``t["arch"]``
    (smoke size, f32, the port's own init at seed 0) on mesh ``t["mesh"]``,
    as the reference's ``tests/test_paged_kv.py`` tp=4 case builds it: a
    prefill of ragged prompts (lengths ``t["plens"]``), then decode steps
    fed a fixed token stream; every step's full logits (the shards' vocab
    all-gathered) for the contiguous cache and for the paged one with
    per-shard page tables (slot b's local pages ``[b*n_loc, (b+1)*n_loc)``
    of every shard's pool), through ``impl`` ``"ref"`` (the gathered view)
    and ``"flash"`` (K5 on each shard's pool, the partials merged) to
    ``t["save"]``; the K5 calls' local lengths a step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.paging import set_page_tables
    from repro_torch.launch.steps import build_init_fn, init_global_caches
    from repro_torch.models.common import ParamCtx
    from repro_torch.models.model import build_model

    axes = axis_ctx_for(t["mesh"], group="default")
    T, B, S_MAX, PAGE = axes.tp, len(t["plens"]), t["s_max"], t["page"]
    model = build_model(smoke_variant(get_config(t["arch"])))
    params = build_init_fn(model, axes)(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    plens = torch.tensor(t["plens"], dtype=torch.int32)
    prompt = torch.randint(2, model.cfg.vocab_size, (B, int(plens.max())), generator=gen,
                           dtype=torch.int32)
    pc = ParamCtx(ctx=axes, compute_dtype=torch.float32)
    lengths: list = []
    decode = ops.flash_paged_decode

    def recording(q, kp, vp, pt, lloc):
        lengths[-1].append(lloc.tolist())
        return decode(q, kp, vp, pt, lloc)

    def run(paged: bool, impl: str):
        kw = {"page_size": PAGE} if paged else {}
        caches = init_global_caches(model, axes, s_max=S_MAX, batch_global=B, **kw)
        if paged:
            n_loc = (S_MAX // T) // PAGE
            table = np.zeros((B, T * n_loc), np.int32)
            for b in range(B):
                for s in range(T):
                    table[b, s * n_loc:(s + 1) * n_loc] = np.arange(b * n_loc, (b + 1) * n_loc)
            caches = set_page_tables(caches, table, model_shard=axes.tp_index(),
                                     tp=T)
        _lg, caches = model.prefill(pc, params, {"tokens": prompt}, caches, attn_impl="flash",
                                    prompt_lens=plens)
        outs = []
        for step in range(t["steps"]):
            lengths.append([])
            lg, caches = model.decode_step(pc, params,
                                           {"token": torch.full((B, 1), 2 + step,
                                                                dtype=torch.int32)},
                                           caches, attn_impl=impl)
            outs.append(axes.all_gather_model(lg, axis=2))
        return torch.stack(outs).numpy()

    ops.flash_paged_decode = recording
    try:
        got = {"contiguous": run(False, "ref"), "paged_ref": run(True, "ref")}
        lengths.clear()
        got["paged_flash"] = run(True, "flash")
    finally:
        ops.flash_paged_decode = decode
    if rank == 0:
        np.savez(t["save"], **got)
    return {"k5_local_lengths": lengths}


#: the families' step-level batch: B slots, prompts of S_P tokens, s_max
FAMILY_STEP = dict(B=2, S_P=6, S_MAX=32)


def family_cfg(arch: str, overrides: dict | None = None):
    """``arch``'s smoke config, with ``overrides`` (dataclass fields)."""
    from repro_torch.configs import get_config, smoke_variant

    return dataclasses.replace(smoke_variant(get_config(arch)), **(overrides or {}))


def family_step_batch(model) -> dict:
    """The prefill batch of the families' step-level tp checks: prompt
    tokens from seed 5 (where the family takes tokens) and the stub
    frontend's inputs (images spanning ``n_image_tokens``, frames spanning
    s_max) from seed 6, f32."""
    b, s_p, s_max = FAMILY_STEP["B"], FAMILY_STEP["S_P"], FAMILY_STEP["S_MAX"]
    gen = torch.Generator().manual_seed(5)
    mem = torch.Generator().manual_seed(6)
    out = {}
    for name, spec in model.prefill_batch_spec(b, s_p, s_max).items():
        if name == "tokens":
            out[name] = torch.randint(2, model.cfg.vocab_size, tuple(spec.shape), generator=gen,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(tuple(spec.shape), generator=mem)
    return out


def set_cross_gates(params: dict) -> dict:
    """A VLM's zero-initialised cross gates set to 0.5 (attention) and -0.7
    (MLP), so the image memory reaches the logits; other trees unchanged."""
    for path, value in (("periods/cross/gate", 0.5), ("periods/cross/mlp_gate", -0.7)):
        if path in params:
            params[path] = torch.full_like(params[path], value)
    return params


def task_families_tp(t: dict, rank: int) -> dict:
    """Each of ``t["archs"]`` (smoke size, f32, the port's own init at seed
    0, VLM gates set) on mesh ``t["mesh"]``: the rank's parameter and cache
    shapes (contiguous and paged), then a flash prefill of
    :func:`family_step_batch` into the contiguous caches and a flash decode
    step of token 3; the logits all-gathered over the model axis (the
    prefill's where it returns any) to ``t["save"]``."""
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_init_fn, init_global_caches
    from repro_torch.models.common import ParamCtx
    from repro_torch.models.model import build_model

    axes = axis_ctx_for(t["mesh"], group="default")
    pc = ParamCtx(ctx=axes, compute_dtype=torch.float32)
    b, s_max = FAMILY_STEP["B"], FAMILY_STEP["S_MAX"]
    out, arrays = {}, {}
    for arch in t["archs"]:
        model = build_model(family_cfg(arch))
        params = set_cross_gates(build_init_fn(model, axes)(torch.Generator().manual_seed(0)))
        caches = init_global_caches(model, axes, s_max=s_max, batch_global=b)
        paged = init_global_caches(model, axes, s_max=s_max, batch_global=b, page_size=4,
                                   device="meta") if model.supports_paged_kv else None
        lg, caches = model.prefill(pc, params, family_step_batch(model), caches,
                                   attn_impl="flash")
        dl, caches = model.decode_step(pc, params, {"token": torch.full((b, 1), 3,
                                                                       dtype=torch.int32)},
                                       caches, attn_impl="flash")
        if lg is not None:
            arrays[f"{arch}:prefill"] = axes.all_gather_model(lg, axis=2).numpy()
        arrays[f"{arch}:decode"] = axes.all_gather_model(dl, axis=2).numpy()
        out[arch] = {"params": {p: list(w.shape) for p, w in params.items()},
                     "caches": tree_shapes(caches),
                     "paged": None if paged is None else tree_shapes(paged)}
    if rank == 0:
        np.savez(t["save"], **arrays)
    return out


def tree_shapes(tree):
    """A cache tree's leaf shapes, keyed by their paths."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": s for k, v in tree.items() for p, s in tree_shapes(v).items()}
    if isinstance(tree, tuple):
        return {f"{f}/{p}".rstrip("/"): s for f, v in zip(tree._fields, tree)
                for p, s in tree_shapes(v).items()}
    return {"": list(tree.shape)}


def task_cross_seqpar(t: dict, rank: int) -> dict:
    """The step level of a VLM whose KV heads replicate over the model axis
    (``t["overrides"]``, e.g. 2 KV heads over 4 shards): the cross K/V whole
    on every shard, each shard's q heads taking their range, the self
    caches sequence-parallel and contiguous.  From the global parameters,
    images and prompt of ``t["data"]`` (waited for: the reference writes
    them), cut to this shard on the launch's layout, f32: a prefill and
    ``t["steps"]`` decode steps fed tokens 2, 3, ...; every call's logits
    all-gathered over the model axis to ``t["save"]``."""
    from repro_torch.dist.sharding import cut_model, tree_param_specs
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import init_global_caches
    from repro_torch.models.common import ParamCtx
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import attn_dims

    axes = axis_ctx_for(t["mesh"], group="default")
    cfg = family_cfg(t["arch"], t["overrides"])
    model = build_model(cfg)
    _wait_for(t["data"])
    data = dict(np.load(t["data"]))
    whole = {k[6:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("param:")}
    kv = attn_dims(cfg, axes.tp).kv_sharded
    params = cut_model(whole, tree_param_specs(whole, cfg, axes, 1, kv), axes, axes.tp_index())
    batch = {"tokens": torch.from_numpy(data["tokens"]),
             "images": torch.from_numpy(data["images"])}
    B = batch["tokens"].shape[0]
    pc = ParamCtx(ctx=axes, compute_dtype=torch.float32)
    caches = init_global_caches(model, axes, s_max=t["s_max"], batch_global=B)
    lg, caches = model.prefill(pc, params, batch, caches)
    outs = {"prefill": axes.all_gather_model(lg, axis=2).numpy()}
    for step in range(t["steps"]):
        lg, caches = model.decode_step(pc, params, {"token": torch.full((B, 1), 2 + step,
                                                                       dtype=torch.int32)},
                                       caches)
        outs[f"decode{step}"] = axes.all_gather_model(lg, axis=2).numpy()
    if rank == 0:
        np.savez(t["save"], **outs)
    return {"kv_sharded": kv, "self_cache": list(caches["self0"].k.shape),
            "cross_cache": list(caches["cross_k"].shape)}


#: the tensor-parallel train steps' batch: B rows a client, S positions
#: (dividing the model axis and the xent chunk), sgd's learning rate
TRAIN_TP = dict(B=2, S=32, LR=0.5)


def train_tp_batch(model, D: int) -> dict:
    """The global batch of a tp train step on ``D`` clients: tokens and
    labels from seed 3, the stub frontends' images or frames normal (f32)."""
    gen = torch.Generator().manual_seed(3)
    out = {}
    for k, t in model.train_batch_spec(TRAIN_TP["B"] * D, TRAIN_TP["S"]).items():
        shape = tuple(t.shape)
        out[k] = (torch.randint(0, model.cfg.vocab_size, shape, generator=gen,
                                dtype=torch.int32) if t.dtype == torch.int32
                  else torch.randn(shape, generator=gen))
    return out


def train_tp_step(model, axes, params, batch, bits: int, draws=None):
    """One ``build_train_step`` step (sgd at ``TRAIN_TP["LR"]``, no wire) at
    ``bits``-wide weights on every client; ``draws`` defaults to seed 0,
    round 1.  ``(params, metrics)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.launch.steps import SRDraws, build_train_step
    from repro_torch.optim import build_optimizer

    opt = build_optimizer("sgd", TRAIN_TP["LR"])
    ts = build_train_step(model, axes, opt, TrainConfig(learning_rate=TRAIN_TP["LR"], seed=0))
    p1, _o, m = ts.fn(params, opt.init(params), batch,
                      delta_for_clients(np.array([bits] * axes.dp)), draws or SRDraws(0, 1))
    return p1, m


def task_train_tp(t: dict, rank: int) -> dict:
    """One train step of ``t["arch"]`` (smoke size, ``t["overrides"]``) on
    mesh ``t["mesh"]`` at
    ``t["bits"]``-wide weights: from the whole parameters ``param:{path}``
    of ``t["data"]`` (the reference's init; with ``t["draws"] == "file"``
    its weight uniforms ``w:{client}:{path}``) or the port's own at seed 0
    (a VLM's gates set), each rank cut to its slice, the batch
    :func:`train_tp_batch`.  The whole parameters after the step (FSDP
    shards gathered, model slices joined) to ``t["save"]``; the loss,
    ``grad_sq_shard_sum``, the replicated leaves that differ across the
    model group, and the model group's collectives."""
    from repro_torch.ckpt.checkpoint import gather_state
    from repro_torch.dist.sharding import _model_dims, cut_model, tree_param_specs
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import SRDraws, build_init_fn
    from repro_torch.models.common import apply_fsdp_sharding
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import attn_dims

    axes = axis_ctx_for(t["mesh"], group="default")
    cfg = family_cfg(t["arch"], t.get("overrides"))
    model = build_model(cfg)
    kv = attn_dims(cfg, axes.tp).kv_sharded if cfg.n_kv_heads else True
    draws = None
    if t.get("data"):
        data = dict(np.load(t["data"]))
        whole = {k[6:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("param:")}
        params = apply_fsdp_sharding(cut_model(whole, tree_param_specs(whole, cfg, axes, 1, kv),
                                               axes, axes.tp_index()), axes)
        if t.get("draws") == "file":
            draws = file_draws(data, 0, 1)
    else:
        params = set_cross_gates(build_init_fn(model, axes)(torch.Generator().manual_seed(0)))
    c = axes.dp_index()
    B = TRAIN_TP["B"]
    batch = {k: v[c * B:(c + 1) * B] for k, v in train_tp_batch(model, axes.dp).items()}
    issued0 = {k: list(v) for k, v in axes.model_transport.issued.items()}
    p1, m = train_tp_step(model, axes, params, batch, t["bits"], draws or SRDraws(0, 1))
    step_issued = {f"{k} {dt}": [n - issued0.get((k, dt), [0, 0])[0],
                                 b - issued0.get((k, dt), [0, 0])[1]]
                   for (k, dt), (n, b) in axes.model_transport.issued.items()}
    issued = {k: n for k, (n, _b) in step_issued.items()}
    specs = tree_param_specs(p1, cfg, axes, 1, kv)
    differ = []
    for p, w in p1.items():
        if not _model_dims(specs[p], axes.model_axis):
            copies = axes.model_transport.all_gather(w[None])
            if not all(torch.equal(copies[0], x) for x in copies):
                differ.append(p)
    full = gather_state({"p": p1}, p1, axes, cfg)["p"]
    if rank == 0 and t.get("save"):
        np.savez(t["save"], **{k: v.numpy() for k, v in full.items()})
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_sq_shard_sum"]),
            "replicated_differ": differ, "model_calls": issued, "model_issued": step_issued}


def task_wire_tp(t: dict, rank: int) -> dict:
    """The SR wire on mesh ``t["mesh"]`` from ``t["data"]``: rank (d, t)
    sends leaf i's gradient ``g:{i}`` at ``[d, t]`` with the uniforms
    ``u:{i}`` at ``[d]`` through :func:`quantized_psum_batch` at
    ``t["bits"]``; its means to ``t["save"]`` with ``{rank}`` filled in."""
    from repro_torch.dist.collectives import quantized_psum_batch
    from repro_torch.launch.mesh import axis_ctx_for

    axes = axis_ctx_for(t["mesh"], group="default")
    data = dict(np.load(t["data"]))
    n = len([k for k in data if k.startswith("g:")])
    d, m = axes.dp_index(), axes.tp_index()
    grads = [torch.from_numpy(data[f"g:{i}"][d, m])[None] for i in range(n)]
    us = [torch.from_numpy(data[f"u:{i}"][d])[None] for i in range(n)]
    means = quantized_psum_batch(axes, grads, us, t["bits"])
    np.savez(t["save"].format(rank=rank), *[x.numpy() for x in means])
    return {"at": [d, m]}


def task_ckpt_tp(t: dict, rank: int) -> dict:
    """``Session.run_train`` of the smoke yi-6b (``train``, 32-bit weights
    and wire) on mesh ``t["mesh"]``: 3 rounds uninterrupted, then 2 rounds
    checkpointing every round into ``t["dir"]`` and a 3-round run resuming
    there (its round 2 is not checkpointed).  Each run's losses; the uninterrupted run's whole parameters
    after round 2 and after round 3 to ``t["save"]`` (``{r}`` filled in)."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.ckpt.checkpoint import gather_state

    def session(rounds, **opts):
        return Session(RunSpec("yi-6b", workload="train", mesh=t["mesh"], smoke=True,
                               batch=2, seq=32, rounds=rounds,
                               precision=PrecisionPolicy.uniform(32, comm=32),
                               options={"quiet": True, **opts}), device="cpu")

    def whole(sess):
        st = sess._train_state
        return gather_state({"p": st["params"]}, st["params"], sess.axes, sess.cfg)["p"]

    full = session(3)
    losses = [full.fl_round(r)["loss"] for r in range(2)]
    saved = {2: whole(full)}
    losses.append(full.fl_round(2)["loss"])
    saved[3] = whole(full)
    first = [h["loss"] for h in session(2, ckpt_dir=t["dir"], ckpt_every=1).run_train()]
    resumed_sess = session(3, ckpt_dir=t["dir"])     # writes nothing more
    resumed = [h["loss"] for h in resumed_sess.run_train()]
    got = whole(resumed_sess)
    same = all(torch.equal(got[p], saved[3][p]) for p in got)
    if rank == 0:
        for r, tree in saved.items():
            np.savez(t["save"].format(r=r), **{k: v.numpy() for k, v in tree.items()})
    return {"losses": losses, "first": first, "resumed": resumed,
            "resumed_equal": bool(same)}


TASKS = {"step": task_step, "serve": task_serve, "pack": task_pack,
         "packed_gather": task_packed_gather, "init": task_init, "wire": task_wire,
         "comm_report": task_comm_report, "serve_tp": task_serve_tp, "layout": task_layout,
         "model_collectives": task_model_collectives, "init_tp": task_init_tp,
         "paged_tp": task_paged_tp, "families_tp": task_families_tp,
         "cross_seqpar": task_cross_seqpar, "train_tp": task_train_tp, "steps_tp": task_steps_tp,
         "wire_tp": task_wire_tp, "ckpt_tp": task_ckpt_tp}


def main() -> None:
    with open(sys.argv[1]) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    import torch.distributed as dist

    init_distributed("gloo", "cpu", init_method="file://" + job["store"])
    rank = dist.get_rank()
    out = {}
    for t in job["tasks"]:
        out[t["name"]] = TASKS[t["kind"]](t, rank)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    if rank == 0:
        with open(job["out"], "w") as f:
            json.dump({**out, "ranks": every}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
