"""Batch-sharded serving: the port's ``Session.serve`` on a ``Dx1`` mesh
against the reference's on 2 fake devices, on the CPU.

Continuous batching of yi-6b and olmoe-1b-7b at their smoke size with
int8-packed weights (``lazy_int8(7)``), flash prefill and paged flash decode,
batch 4 over 2 data shards, 6 requests with ragged prompts, max_new 6, s_max
64, 12 steps.  The reference runs once in subprocesses started at the
module's first test (XLA's device count is fixed at start-up), with every
prefill's and decode step's sampled tokens recorded by wrapping its step
builders from here.  The port runs its shards in one process (a loop) and as
2 ``gloo`` ranks (``tests/torch_dist_worker.py``), each fed the reference's
parameters.  The MoE capacity is a shard's own (olmoe at 2x1 samples other
tokens than at 1x1, in both packages alike).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.dist.collectives import AxisCtx
from repro_torch.dist.sharding import batch_specs, cache_specs, cut_batch, join_batch
from repro_torch.launch import paging
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.models.common import QTensor, fsdp_plan, is_stacked
from repro_torch.models.model import build_model
from torch_dist_worker import fixed_init, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
EQUAL_FIELDS = ("admitted", "completed", "decoded_tokens", "decode_steps",
                "capacity_stops", "deferred_admissions", "prompt_buckets",
                "kv_bytes", "kv_bytes_contiguous", "bytes_per_step_packed",
                "bytes_per_step_f32", "sample", "kv_layout", "page_size",
                "kv_demotions", "kv_bits_final")
OPTS = dict(steps=12, s_max=64, prompt_len=8, requests=6, max_new=6, attn_impl="flash",
            kv_layout="paged", vary_prompt=True, quiet=True)
RUNS = (("yi-6b", "2x1", "paged"), ("olmoe-1b-7b", "2x1", "paged"),
        ("olmoe-1b-7b", "1x1", "paged"), ("yi-6b", "2x1", "contiguous"))
CLI = ["--arch", "yi-6b", "--smoke", "--mesh", "2x1", "--steps", "24", "--batch", "4",
       "--s-max", "32", "--attn-impl", "flash", "--device", "cpu"]

_REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
from repro.api import PrecisionPolicy, RunSpec, Session
from repro.launch import steps
from repro_torch.models.convert import params_from_jax

arch, mesh, layout, batch, out_dir = sys.argv[1:4] + [int(sys.argv[4]), sys.argv[5]]
EQUAL, OPTS = %(consts)s
OPTS = {**OPTS, "kv_layout": layout}
calls = []

def recording(builder, kind):
    def build(*a, **kw):
        ss = builder(*a, **kw)
        fn = ss.fn
        def call(*args):
            tok, caches = fn(*args)
            calls.append([kind, np.asarray(tok)[:, 0].tolist()])
            return tok, caches
        return dataclasses.replace(ss, fn=call)
    return build

steps.build_decode_step = recording(steps.build_decode_step, "decode")
steps.build_cached_prefill = recording(steps.build_cached_prefill, "prefill")
sess = Session(RunSpec(arch, workload="serve", mesh=mesh, smoke=True, seed=0, batch=batch,
                       seq=OPTS["s_max"], precision=PrecisionPolicy.lazy_int8(7), options=OPTS))
out = {}
try:
    if mesh == "2x1" and layout == "paged" and batch %% 2 == 0:
        np.savez(os.path.join(out_dir, f"{arch}.npz"),
                 **{k: v.numpy() for k, v in params_from_jax(sess.init_params()).items()})
    st = sess.serve()
    out = {"stats": {f: getattr(st, f) for f in EQUAL}, "calls": calls}
except Exception as e:
    out = {"raised": f"{type(e).__name__}: {e}"}
print("RESULT " + json.dumps(out))
""" % {"consts": repr((EQUAL_FIELDS, OPTS))}


def _whole_params(arch: str) -> dict:
    """The reference's smoke init at seed 0 (its 2x1 init is the same
    leaves), as the port's dict."""
    from repro.api import PrecisionPolicy as JPolicy
    from repro.api import RunSpec as JRunSpec
    from repro.api import Session as JSession
    from repro_torch.models.convert import params_from_jax

    jsess = JSession(JRunSpec(arch, workload="serve", smoke=True, seed=0, batch=4,
                              seq=OPTS["s_max"], precision=JPolicy.lazy_int8(7)))
    return params_from_jax(jsess.init_params())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Everything that runs in other processes, started at once at the
    module's first test: the reference's serves (one process a run, and
    batch 3 on 2x1), the 2-rank gloo job (serves fed the reference's
    parameters, packing leaf by leaf) and the serve CLI under torchrun."""
    tmp = str(tmp_path_factory.mktemp("serve_sharded"))

    def reference_run(arch, mesh, layout, batch):
        return subprocess.Popen([sys.executable, "-c", _REFERENCE, arch, mesh, layout, batch,
                                 tmp],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env={**ENV, "JAX_PLATFORMS": "cpu"})

    refs = {run: reference_run(*run, "4") for run in RUNS}
    refs["uneven"] = reference_run("yi-6b", "2x1", "paged", "3")
    cli = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node=2", "-m", "repro_torch.launch.serve",
                            "--backend", "gloo", *CLI], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=tmp, env=ENV)
    whole = {arch: _whole_params(arch) for arch in ("yi-6b", "olmoe-1b-7b")}
    for arch, params in whole.items():
        np.savez(os.path.join(tmp, f"whole-{arch}.npz"), **{k: v.numpy()
                                                           for k, v in params.items()})
    tasks = [dict(name=arch, kind="serve", arch=arch, mesh="2x1", batch=4, options=OPTS,
                  data=os.path.join(tmp, f"whole-{arch}.npz")) for arch in whole]
    tasks.append(dict(name="pack", kind="pack", arch="olmoe-1b-7b", mesh="2x1", d_model=256,
                      bits=7, seed=3, save=os.path.join(tmp, "pack{rank}.npz")))
    os.makedirs(os.path.join(tmp, "ranks"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(run_ranks, 2, {"tasks": tasks}, os.path.join(tmp, "ranks"), 300)

    done: dict = {}

    def result(proc, what):
        if what not in done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{what}:\n{out[-3000:]}\n{err[-3000:]}"
            done[what] = out
        return done[what]

    def reference(run):
        out = result(refs[run], f"the reference's {run}")
        return json.loads(out.split("RESULT ", 1)[1])

    try:
        yield dict(tmp=tmp, whole=whole, reference=reference, ranks=ranks.result,
                   cli=lambda: result(cli, "the serve CLI under torchrun"))
    finally:
        for p in (*refs.values(), cli):
            if p.poll() is None:
                p.kill()
        pool.shutdown(wait=True)


def _port_serve(arch: str, mesh: str, params: dict, **kw):
    """The port's ``Session.serve`` in one process from ``params``, every
    shard's sampled tokens a call recorded and joined into the global
    batch's (shards in order)."""
    calls = []
    builders = tsteps.build_decode_step, tsteps.build_cached_prefill

    def recording(builder, kind):
        def build(*a, **bkw):
            ss = builder(*a, **bkw)

            def call(*args):
                tok, caches = ss.fn(*args)
                calls.append([kind, tok[:, 0].tolist()])
                return tok, caches
            return dataclasses.replace(ss, fn=call)
        return build

    sess = Session(RunSpec(arch, workload="serve", mesh=mesh, smoke=True, seed=0,
                           batch=kw.pop("batch", 4), seq=OPTS["s_max"],
                           precision=PrecisionPolicy.lazy_int8(7), options={**OPTS, **kw}),
                   device="cpu")
    sess.model = dataclasses.replace(sess.model, init=fixed_init(params))
    tsteps.build_decode_step = recording(builders[0], "decode")
    tsteps.build_cached_prefill = recording(builders[1], "prefill")
    try:
        stats = sess.serve()
    finally:
        tsteps.build_decode_step, tsteps.build_cached_prefill = builders
    D = sess.axes.dp
    joined = [[calls[i][0], sum((c[1] for c in calls[i:i + D]), [])]
              for i in range(0, len(calls), D)]
    return stats, joined, sess.last_tokens


@pytest.mark.parametrize("arch,layout", [("yi-6b", "paged"), ("olmoe-1b-7b", "paged"),
                                         ("yi-6b", "contiguous")])
def test_one_process_2x1_equals_the_reference(jobs, arch, layout):
    """The one-process shard loop, from the reference's parameters (its 2x1
    init, written by the reference's run), equals the reference's 2x1 serve
    in every ``EQUAL_FIELDS`` field and in every token each prefill and
    decode step sampled, the idle slots' included; paged (a pool a shard)
    and contiguous (a shard's slab rows)."""
    want = jobs["reference"]((arch, "2x1", layout))
    ref_params = dict(np.load(os.path.join(jobs["tmp"], f"{arch}.npz")))
    assert all(np.array_equal(ref_params[k], v.numpy()) for k, v in jobs["whole"][arch].items())
    params = {k: torch.from_numpy(v) for k, v in ref_params.items()}
    stats, calls, _tokens = _port_serve(arch, "2x1", params, kv_layout=layout)
    for name in EQUAL_FIELDS:
        assert getattr(stats, name) == want["stats"][name], name
    assert calls == want["calls"]
    assert stats.admitted == 6 and stats.completed == 6
    # the reference's global figures: one pool (or both shards' slabs)
    assert stats.kv_bytes == (65_536 if layout == "paged" else 262_144)
    assert stats.kv_bytes_contiguous == 262_144


def test_moe_capacity_is_a_shards_own(jobs):
    """olmoe's expert capacity comes from a shard's own tokens: its 2x1 serve
    samples other tokens than its 1x1 serve, in the reference and in the port
    alike (the port's 1x1 run equals the reference's 1x1 run too); a dense
    model's do not depend on the mesh."""
    params = {k: v.clone() for k, v in jobs["whole"]["olmoe-1b-7b"].items()}
    got = {mesh: _port_serve("olmoe-1b-7b", mesh, params) for mesh in ("2x1", "1x1")}
    want = {mesh: jobs["reference"](("olmoe-1b-7b", mesh, "paged")) for mesh in ("2x1", "1x1")}
    for mesh in ("2x1", "1x1"):
        assert got[mesh][1] == want[mesh]["calls"], mesh
        assert got[mesh][0].sample == want[mesh]["stats"]["sample"], mesh
    assert got["2x1"][0].sample != got["1x1"][0].sample
    assert got["2x1"][1] != got["1x1"][1]
    yi = {k: v.clone() for k, v in jobs["whole"]["yi-6b"].items()}
    assert _port_serve("yi-6b", "1x1", yi)[1] == _port_serve("yi-6b", "2x1", yi)[1]


def _predicted_gathers(params: dict, fsdp: int) -> tuple[int, int]:
    """``(calls, bytes)`` of a pass's FSDP gathers on one rank: one
    all-gather a use of each FSDP-stored leaf (a stacked leaf once a layer),
    of its whole packed codes as bytes."""
    paths, leaves, plan = fsdp_plan(params, fsdp)
    calls = nbytes = 0
    for path, w, dim in zip(paths, leaves, plan):
        if dim is None:
            continue
        calls += w.shape[0] if is_stacked(path) else 1
        nbytes += w.numel()             # int8 codes: a byte an element
    return calls, nbytes


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_two_ranks_equal_the_loop(jobs, arch):
    """2 gloo ranks, one shard each, fed the same parameters: every rank's
    stats (clocks apart) and sampled tokens equal the one-process loop's bit
    for bit (and so the reference's ``EQUAL_FIELDS``); a rank's collectives
    are one uint8 all-gather a use of each FSDP leaf (``fsdp_plan``) and one
    int32 all-gather of the shards' tokens a prefill or decode step, and the
    closing check's one broadcast; nothing is staged."""
    params = jobs["whole"][arch]
    stats, _calls, tokens = _port_serve(arch, "2x1", {k: v.clone() for k, v in params.items()})
    want = {k: v for k, v in vars(stats).items() if k not in ("wall_s", "tok_s")}
    ref = jobs["reference"]((arch, "2x1", "paged"))
    out = jobs["ranks"]()
    g_calls, g_bytes = _predicted_gathers(params, 2)
    for rk in out["ranks"]:
        res = rk[arch]
        assert res["stats"] == json.loads(json.dumps(want))
        assert res["tokens"] == tokens
        assert all(res["stats"][f] == ref["stats"][f] for f in EQUAL_FIELDS)
        n = res["passes"]["prefill"] + res["passes"]["decode"]
        assert res["passes"]["decode"] == stats.decode_steps and n > stats.decode_steps
        assert res["issued"] == {
            "all-gather uint8": {"calls": n * g_calls, "bytes": n * g_bytes},
            "all-gather int32": {"calls": n, "bytes": n * 4 * 4},
            "broadcast object": {"calls": 1, "bytes": 0}}
        assert res["staged"] == {}


def test_packing_leaf_by_leaf_slices_the_one_process_packing(jobs):
    """Under 2 ranks each leaf is drawn whole, packed (the whole leaf's
    scale) and sliced before the next: each rank's codes are the
    one-process packing's codes sliced, its scales the whole leaves', bit
    for bit, and its replicated leaves whole."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.quantization import default_exempt
    from repro_torch.models.common import pack_params_for_policy, shard_leaf

    jobs["ranks"]()
    cfg = dataclasses.replace(smoke_variant(get_config("olmoe-1b-7b")), d_model=256)
    whole = build_model(cfg).init(torch.Generator().manual_seed(3), 1)
    paths, _leaves, plan = fsdp_plan(whole, 2)
    dims = dict(zip(paths, plan))
    packed = pack_params_for_policy(whole, PrecisionPolicy.lazy_int8(7), exempt=default_exempt)
    assert {d is None for d in plan} == {True, False}
    for rank in (0, 1):
        got = dict(np.load(os.path.join(jobs["tmp"], f"pack{rank}.npz")))
        axes = axis_ctx_for("2x1").at_client(rank)
        for path, w in packed.items():
            mine = shard_leaf(w, dims[path], axes)
            if isinstance(w, QTensor):
                assert np.array_equal(got[f"codes:{path}"], mine.codes.numpy()), path
                assert np.array_equal(got[f"scale:{path}"], w.scale.numpy()), path
            else:
                assert np.array_equal(got[f"dense:{path}"], mine.numpy()), path


def test_uneven_batch_raises_as_the_reference_fails(jobs):
    """Batch 3 over 2 data shards: the reference's serve fails (its page
    tables do not split into the shards' slots), and the port's raises a
    ValueError that says so, before anything is built."""
    assert jobs["reference"]("uneven")["raised"].startswith("ValueError")
    with pytest.raises(ValueError, match="batch 3 does not divide over its 2 data shards"):
        _port_serve("yi-6b", "2x1", {}, batch=3)


def test_cut_and_join_by_the_cache_specs():
    """``cut_batch`` gives shard c the slots ``[c*b, (c+1)*b)`` of every
    batch dim the specs name (page tables, lengths, slabs, batch inputs)
    and a paged pool whole; ``join_batch`` puts the shards back, a pool
    from shard 0; ``set_page_tables(rows=)`` writes a shard's rows."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config("yi-6b"))
    model, axes = build_model(cfg), axis_ctx_for("2x1")
    gen = torch.Generator().manual_seed(0)
    for kw in ({"page_size": 16, "pool_pages": 5}, {}):
        caches = model.init_caches(4, 64, 1, dtype=torch.float32, device="cpu", **kw)
        caches = type(caches)(*(torch.randint(-9, 9, t.shape, generator=gen).to(t.dtype)
                                for t in caches))
        specs = cache_specs(caches, axes, cfg)
        pieces = [cut_batch(caches, specs, axes, c) for c in (0, 1)]
        for c, piece in enumerate(pieces):
            if kw:
                assert piece.k_pages is caches.k_pages          # the pool, whole
                assert torch.equal(piece.page_table, caches.page_table[:, 2 * c:2 * c + 2])
            else:
                assert torch.equal(piece.k, caches.k[:, 2 * c:2 * c + 2])
            assert torch.equal(piece.length, caches.length[:, 2 * c:2 * c + 2])
        joined = join_batch(pieces, specs, axes)
        assert all(torch.equal(a, b) for a, b in zip(joined, caches))
        if kw:
            table = np.arange(4 * 4, dtype=np.int32).reshape(4, 4)
            pushed = paging.set_page_tables(pieces[1], table, slice(2, 4))
            assert torch.equal(pushed.page_table, torch.from_numpy(table[2:4])[None].expand(
                pushed.page_table.shape))
    batch = {"tokens": torch.arange(12).reshape(4, 3), "mask": torch.tensor([1, 0, 0, 1])}
    bspecs = batch_specs(batch, axes)
    assert torch.equal(cut_batch(batch, bspecs, axes, 1)["tokens"], batch["tokens"][2:])
    assert torch.equal(join_batch([cut_batch(batch, bspecs, axes, c) for c in (0, 1)],
                                  bspecs, axes)["mask"], batch["mask"])
    # one shard's caches: b = batch / D slots, the pool whole
    shard = tsteps.init_global_caches(model, axes, s_max=64, batch_global=4, device="meta",
                                      page_size=16, pool_pages=5)
    assert shard.page_table.shape[1] == 2 and shard.k_pages.shape[1] == 5
    assert tsteps.init_global_caches(model, AxisCtx(), s_max=64, batch_global=4,
                                     device="meta").k.shape[1] == 4


def test_serve_cli_mesh_in_one_process_and_under_torchrun(jobs, capsys):
    """``--mesh 2x1 --device cpu`` in one process, and under torchrun on 2
    gloo ranks: the same admitted and completed line (printed by rank 0
    alone) and the same sample."""
    stats = tserve.main(CLI)
    one = capsys.readouterr().out
    line = next(ln for ln in one.splitlines() if ln.startswith("admitted"))
    assert stats.admitted == stats.completed == 8
    two = jobs["cli"]()
    assert [ln for ln in two.splitlines() if ln.startswith("admitted")] == [line]
    assert f"sample: {stats.sample}" in two.splitlines()


def test_sharded_serve_without_a_card_raises(monkeypatch):
    """A 2x1 serve asks for CUDA unless given ``device="cpu"``, as the 1x1
    serve does; the torchrun-only flags outside torchrun are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = RunSpec("yi-6b", workload="serve", mesh="2x1", precision=PrecisionPolicy.lazy_int8(7))
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "yi-6b", "--smoke", "--mesh", "2x1", "--steps", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        tserve.main([*CLI, "--backend", "gloo"])
