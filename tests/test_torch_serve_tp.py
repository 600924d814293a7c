"""Tensor-parallel serving: the port's ``Session.serve`` on ``1xT`` and
``DxT`` meshes, one gloo rank a mesh device, against the reference's on
forced host devices, on the CPU.

Continuous batching at smoke size with int8-packed weights
(``lazy_int8(7)``), flash prefill and decode, batch 4, 6 requests with
ragged prompts, max_new 6, s_max 64, 12 steps: yi-6b at 1x2 (its 4 KV heads
split, paged), olmoe-1b-7b at 1x2 (KV heads and its 8 experts split, paged),
glm4-9b at 1x4 (2 KV heads replicated: the sequence-parallel cache, served
contiguous as the reference's driver does by default) and yi-6b at 2x2 (two
data shards of two model shards).  The reference runs once a mesh in
subprocesses started at the module's first test, every prefill's and decode
step's sampled tokens recorded by wrapping its step builders, with its init
canonicalized through the host (its model shards draw replicated leaves
from their own keys: ROADMAP §3, D14) and its KV spec inference given the
launch's KV split (its driver reads the global packed tree's shapes and
takes a split KV projection for a replicated one: D15); it writes its
global parameters, which the port's ranks carry into their slices
(``dist/sharding.cut_model``).  A row-parallel ``psum`` over 2 ranks has two
addends, which sum alike in any order; over 4 ranks (glm4 1x4) the order
may differ from the reference's all-reduce by an ulp, below what a greedy
token at smoke size resolves: the tokens are held equal.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.api import PrecisionPolicy, RunSpec, Session
from torch_dist_worker import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
EQUAL_FIELDS = ("admitted", "completed", "decoded_tokens", "decode_steps",
                "capacity_stops", "deferred_admissions", "prompt_buckets",
                "kv_bytes", "kv_bytes_contiguous", "bytes_per_step_packed",
                "bytes_per_step_f32", "sample", "kv_layout", "page_size",
                "kv_demotions", "kv_bits_final")
OPTS = dict(steps=12, s_max=64, prompt_len=8, requests=6, max_new=6, attn_impl="flash",
            vary_prompt=True, quiet=True)
#: the dry run's options and cells (``[seq_len, global batch]``) whose
#: traced device is held to rank 0's model group: flash, 16-token pages
TRACED_OPTS = dict(attn_impl="flash", page_size=16)
TRACED_CELLS = dict(decode=[64, 4], prefill=[16, 4])
#: (arch, mesh, kv layout option or None for the driver's default)
RUNS = (("yi-6b", "1x2", "paged"), ("olmoe-1b-7b", "1x2", "paged"),
        ("glm4-9b", "1x4", None), ("yi-6b", "2x2", "paged"))

_REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
import jax
from repro.api import PrecisionPolicy, RunSpec, Session
from repro.dist import sharding as rsharding
from repro.launch import steps
from repro_torch.models.convert import params_from_jax

arch, mesh, layout, out = sys.argv[1:5]
EQUAL, OPTS = %(consts)s
if layout != "default":
    OPTS = {**OPTS, "kv_layout": layout}
TP = int(mesh.split("x")[-1])
calls = []

def kv_of_the_launch(path, per_layer_shape, cfg):
    # D15: the driver builds its steps' specs from the GLOBAL packed tree, where a
    # split KV projection has the replicated width; say what the launch splits
    if rsharding._basename(path) not in ("wk", "wv") or not cfg.n_kv_heads:
        return True
    return cfg.n_kv_heads %% TP == 0 and cfg.n_kv_heads >= TP

rsharding._kv_sharded = kv_of_the_launch

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

build_init = steps.build_init_fn

def canonical(*a, **kw):
    # D14: each model shard draws its replicated leaves from its own key; keep
    # device 0's copy, as the reference's own tp tests do
    fn, specs = build_init(*a, **kw)
    def init(key):
        return jax.tree_util.tree_map(lambda x: jax.device_put(np.asarray(x), x.sharding),
                                      fn(key))
    return init, specs

steps.build_init_fn = canonical
steps.build_decode_step = recording(steps.build_decode_step, "decode")
steps.build_cached_prefill = recording(steps.build_cached_prefill, "prefill")
sess = Session(RunSpec(arch, workload="serve", mesh=mesh, smoke=True, seed=0, batch=4,
                       seq=OPTS["s_max"], precision=PrecisionPolicy.lazy_int8(7), options=OPTS))
np.savez(out, **{k: v.numpy() for k, v in params_from_jax(sess.init_params()).items()})
open(out + ".done", "w").close()
st = sess.serve()
print("RESULT " + json.dumps({"stats": {f: getattr(st, f) for f in EQUAL}, "calls": calls}))
""" % {"consts": repr((EQUAL_FIELDS, OPTS))}


def _npz(tmp: str, arch: str, mesh: str) -> str:
    return os.path.join(tmp, f"{arch}-{mesh}.npz")


def _serve_task(arch, mesh, layout, data=None, name=None):
    opts = dict(OPTS) if layout is None else {**OPTS, "kv_layout": layout}
    return dict(name=name or f"{arch} {mesh}", kind="serve_tp", arch=arch, mesh=mesh, batch=4,
                options=opts, data=data)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Everything that runs in other processes, started at once at the
    module's first test: the reference's four serves (one process a mesh),
    the 2-rank gloo job (yi-6b and olmoe at 1x2 from the reference's
    parameters, yi-6b at 1x2 from the port's own init) and the 4-rank one
    (yi-6b at 2x2, glm4-9b at 1x4); the ranks wait for the parameters the
    reference writes before it serves."""
    tmp = str(tmp_path_factory.mktemp("serve_tp"))
    refs = {run: subprocess.Popen([sys.executable, "-c", _REFERENCE, run[0], run[1],
                                   run[2] or "default", _npz(tmp, run[0], run[1])],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env={**ENV, "JAX_PLATFORMS": "cpu"})
            for run in RUNS}
    two = [_serve_task(a, m, lay, _npz(tmp, a, m)) for a, m, lay in RUNS if m == "1x2"]
    two.append(_serve_task("yi-6b", "1x2", "paged", name="yi-6b own init"))
    two.append(dict(name="steps", kind="steps_tp", arch="yi-6b", mesh="1x2",
                    options=TRACED_OPTS, **TRACED_CELLS))
    four = [_serve_task(a, m, lay, _npz(tmp, a, m)) for a, m, lay in RUNS if m != "1x2"]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}
    for n, tasks in ((2, two), (4, four)):
        os.makedirs(os.path.join(tmp, f"ranks{n}"))
        futures[n] = pool.submit(run_ranks, n, {"tasks": tasks}, os.path.join(tmp, f"ranks{n}"),
                                 400)
    done: dict = {}

    def reference(run):
        if run not in done:
            out, err = refs[run].communicate(timeout=600)
            assert refs[run].returncode == 0, \
                f"the reference's {run}:\n{out[-3000:]}\n{err[-3000:]}"
            done[run] = json.loads(out.split("RESULT ", 1)[1])
        return done[run]

    try:
        yield dict(tmp=tmp, reference=reference, ranks=lambda n: futures[n].result())
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
        pool.shutdown(wait=True)


def _joined_calls(ranks: list, name: str, D: int, T: int) -> list:
    """The global batch's tokens a call: the data shards' slots in order
    (model index 0's rank of each data row; every model rank holds the
    same tokens, which is asserted)."""
    by_at = {tuple(rk[name]["at"]): rk[name]["calls"] for rk in ranks}
    for d in range(D):
        for t in range(1, T):
            assert by_at[(d, t)] == by_at[(d, 0)], (name, d, t)
    rows = [by_at[(d, 0)] for d in range(D)]
    return [[rows[0][i][0], sum((r[i][1] for r in rows), [])] for i in range(len(rows[0]))]


@pytest.mark.parametrize("arch,mesh,layout", RUNS)
def test_ranks_equal_the_reference_serve(jobs, arch, mesh, layout):
    """Each run's ranks, fed the reference's canonical parameters, sample
    the reference's tokens at every prefill and decode step (the idle slots'
    too) and give its ``EQUAL_FIELDS``; every rank's stats (clocks apart)
    and sampled tokens are the same."""
    want = jobs["reference"]((arch, mesh, layout))
    D, T = (int(x) for x in mesh.split("x"))
    ranks = jobs["ranks"](D * T)["ranks"]
    name = f"{arch} {mesh}"
    assert _joined_calls(ranks, name, D, T) == want["calls"]
    first = ranks[0][name]
    for rk in ranks:
        assert rk[name]["stats"] == first["stats"] and rk[name]["tokens"] == first["tokens"]
        for f in EQUAL_FIELDS:
            assert rk[name]["stats"][f] == want["stats"][f], (name, f)
    assert first["stats"]["admitted"] == first["stats"]["completed"] == 6


def test_kv_bytes_are_the_reference_global_figures(jobs):
    """``kv_bytes`` joins the mesh devices' caches over the batch and the
    model axes: yi-6b's pool holds every KV head (1x2 and 2x2 alike: one
    pool a data shard, the reference's global pool), glm4-9b's contiguous
    sequence-parallel slabs every position; a rank holds 1/T of it."""
    got = {}
    for n in (2, 4):
        for name, res in jobs["ranks"](n).items():
            if name not in ("ranks", "steps"):      # the serves
                got[name] = res["stats"]
    assert got["yi-6b 1x2"]["kv_bytes"] == got["yi-6b 2x2"]["kv_bytes"] == 65_536
    assert got["yi-6b 1x2"]["kv_bytes_contiguous"] == 262_144
    assert got["glm4-9b 1x4"]["kv_layout"] == "contiguous"
    # 2 layers x 4 slots x 64 positions x 2 KV heads x 16 x 4 bytes x (K, V)
    assert got["glm4-9b 1x4"]["kv_bytes"] == 2 * 4 * 64 * 2 * 16 * 4 * 2


def _predicted_model_collectives(cfg, mesh: str, passes: dict) -> dict:
    """A rank's model-axis collective calls over a serve's passes, by kind
    and dtype: a prefill or decode pass all-reduces the embedding and each
    layer's attention and feed-forward outputs (sums, f32 at smoke size),
    and the greedy pick's max (f32) and min (int32); a sequence-parallel
    decode layer adds q's all-gather and the softmax merge's max and two
    sums.  (Ragged prompts make a prefill's bytes depend on its bucket, so
    only the calls are predicted; ``chip_smoke.tp_collectives`` predicts
    the bytes of fixed-length prompts.)"""
    from repro_torch.models.attention import kv_cache_seq_parallel
    from repro_torch.models.transformer import attn_dims

    D, T = (int(x) for x in mesh.split("x"))
    L = cfg.n_layers
    n = passes["prefill"] + passes["decode"]
    sums = n * (1 + 2 * L)
    out = {"all-reduce sum float32": sums, "all-reduce max float32": n,
           "all-reduce min int32": n}
    if kv_cache_seq_parallel(attn_dims(cfg, T)):
        out["all-reduce sum float32"] += passes["decode"] * 2 * L
        out["all-reduce max float32"] += passes["decode"] * L
        out["all-gather float32"] = passes["decode"] * L
    return out


@pytest.mark.parametrize("arch,mesh", [("yi-6b", "1x2"), ("olmoe-1b-7b", "1x2"),
                                       ("glm4-9b", "1x4"), ("yi-6b", "2x2")])
def test_a_ranks_collectives_are_the_model_psums_and_the_pick(jobs, arch, mesh):
    """Each rank's model group carries exactly the predicted all-reduces
    and gathers (calls by kind and dtype), its batch group on 2x2 one int32
    all-gather of the shards' tokens a pass and the closing check's
    broadcast, and nothing is staged."""
    from repro_torch.configs import get_config, smoke_variant

    D, T = (int(x) for x in mesh.split("x"))
    cfg = smoke_variant(get_config(arch))
    for rk in jobs["ranks"](D * T)["ranks"]:
        res = rk[f"{arch} {mesh}"]
        want = _predicted_model_collectives(cfg, mesh, res["passes"])
        got = {k: v["calls"] for k, v in res["model"]["issued"].items() if k != "broadcast object"}
        assert got == want, (arch, mesh, got, want)
        assert res["model"]["staged"] == {}
        n = res["passes"]["prefill"] + res["passes"]["decode"]
        if D > 1:
            assert res["batch"]["issued"]["all-gather int32"] == {"calls": n, "bytes": n * 4 * 4}
            assert res["batch"]["staged"] == {}
        else:
            assert res["batch"] is None
        # the decode pass's pick: one f32 max and one int32 min of b slots
        b = 4 // D
        assert res["model"]["issued"]["all-reduce min int32"]["bytes"] == n * 4 * b


def test_own_init_1x2_serves_the_1x1_tokens(jobs):
    """From the port's own init (seed 0) the 1x2 ranks hold the 1x1 model
    cut (every rank draws the whole model from one generator): their serve
    samples the one-process 1x1 serve's tokens, every step's, and its stats
    (the clocks apart)."""
    from repro_torch.launch import steps as tsteps

    calls: list = []
    builders = tsteps.build_decode_step, tsteps.build_cached_prefill

    def recording(builder, kind):
        def build(*a, **kw):
            ss = builder(*a, **kw)

            def call(*args):
                tok, caches = ss.fn(*args)
                calls.append([kind, tok[:, 0].tolist()])
                return tok, caches
            return dataclasses.replace(ss, fn=call)
        return build

    sess = Session(RunSpec("yi-6b", workload="serve", mesh="1x1", smoke=True, seed=0, batch=4,
                           seq=OPTS["s_max"], precision=PrecisionPolicy.lazy_int8(7),
                           options={**OPTS, "kv_layout": "paged"}), device="cpu")
    tsteps.build_decode_step = recording(builders[0], "decode")
    tsteps.build_cached_prefill = recording(builders[1], "prefill")
    try:
        stats = sess.serve()
    finally:
        tsteps.build_decode_step, tsteps.build_cached_prefill = builders
    want = {k: v for k, v in vars(stats).items() if k not in ("wall_s", "tok_s")}
    for rk in jobs["ranks"](2)["ranks"]:
        res = rk["yi-6b own init"]
        assert res["calls"] == calls
        assert res["tokens"] == sess.last_tokens
        assert res["stats"] == json.loads(json.dumps(want))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_a_traced_step_issues_rank_0s_model_collectives(jobs, kind):
    """The dry run's traced device of yi-6b's 1x2 cell (one device, its
    model group a stand-in) issues over its model group exactly the calls
    and bytes, by kind and dtype, that rank 0's model group carried for the
    same step under the gloo group."""
    from repro_torch.configs.base import ShapeSpec

    want = jobs["ranks"](2)["ranks"][0]["steps"][kind]
    sess = Session(RunSpec("yi-6b", workload="dryrun", mesh="1x2", smoke=True,
                           precision=PrecisionPolicy.lazy_int8(7), options=TRACED_OPTS),
                   device="cpu")
    seq, batch = TRACED_CELLS[kind]
    sess.trace(ShapeSpec(f"traced_{kind}", seq, batch, kind))
    got = {k: [v["calls"], v["bytes"]]
           for k, v in sess.traced_axes.model_transport.report()["issued"].items()}
    assert got == want and got
    assert not torch.distributed.is_initialized()
