"""Tensor-parallel serving of the SSM, hybrid, VLM and enc-dec families: the
port's ``Session.serve`` on ``1xT`` and ``DxT`` meshes, one gloo rank a
mesh device, against the reference's on forced host devices, on the CPU.

The harness is ``tests/test_torch_serve_tp.py``'s: continuous batching at
smoke size with int8-packed weights (``lazy_int8(7)``), flash prefill and
decode, batch 4, 6 requests with ragged prompts, max_new 6, s_max 64, 12
steps; the reference's init canonicalized through the host (ROADMAP §3,
D14) and its KV spec inference given the launch's KV split (D15, which the
VLM and the enc-dec need as much as the dense families: without it their
cross K/V cannot broadcast against the split q heads).  The runs:
mamba2-780m at 1x2 and 1x4 (its gated norm in 2 and 4 groups of channels,
the reference's semantics), jamba at 1x2 (attention, SSM, MLP and MoE
sublayers), llama-3.2-vision at 1x2 and seamless-m4t at 1x2 and 2x2 (the
cross K/V split with the KV heads, the self caches paged).  The stub
frontends' inputs (images, frames) are the reference's draws, handed to the
port's ranks.  The reference runs once a mesh in subprocesses started at
the module's first test; the module takes about a minute of wall time.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
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
#: (arch, mesh); the driver's default layout (paged, an SSM model contiguous)
RUNS = (("mamba2-780m", "1x2"), ("mamba2-780m", "1x4"), ("jamba-1.5-large-398b", "1x2"),
        ("llama-3.2-vision-90b", "1x2"), ("seamless-m4t-large-v2", "1x2"),
        ("seamless-m4t-large-v2", "2x2"))

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

arch, mesh, out = sys.argv[1:4]
EQUAL, OPTS = %(consts)s
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
cfg = sess.cfg
# the serving driver's stub frontend inputs (its prefill_batch's draws)
memory = {}
if cfg.family == "vlm":
    memory["images"] = jax.random.normal(jax.random.PRNGKey(101), (4, cfg.n_image_tokens,
                                                                  cfg.d_frontend))
if cfg.family == "encdec":
    memory["frames"] = jax.random.normal(jax.random.PRNGKey(102), (4, OPTS["s_max"],
                                                                  cfg.d_frontend))
np.savez(out + ".memory.npz", **{k: np.asarray(v) for k, v in memory.items()})
np.savez(out, **{k: v.numpy() for k, v in params_from_jax(sess.init_params()).items()})
open(out + ".done", "w").close()
st = sess.serve()
print("RESULT " + json.dumps({"stats": {f: getattr(st, f) for f in EQUAL}, "calls": calls}))
""" % {"consts": repr((EQUAL_FIELDS, OPTS))}


def _npz(tmp: str, arch: str, mesh: str) -> str:
    return os.path.join(tmp, f"{arch}-{mesh}.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Everything that runs in other processes, started at once at the
    module's first test: the reference's six serves (one process a run),
    the 2-rank gloo job (the four 1x2 runs) and the 4-rank one (mamba2 at
    1x4, seamless at 2x2); the ranks wait for the parameters and frontend
    inputs the reference writes before it serves."""
    tmp = str(tmp_path_factory.mktemp("serve_tp_families"))
    refs = {run: subprocess.Popen([sys.executable, "-c", _REFERENCE, run[0], run[1],
                                   _npz(tmp, *run)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env={**ENV, "JAX_PLATFORMS": "cpu"})
            for run in RUNS}

    def task(arch, mesh):
        return dict(name=f"{arch} {mesh}", kind="serve_tp", arch=arch, mesh=mesh, batch=4,
                    options=OPTS, data=_npz(tmp, arch, mesh),
                    memory=_npz(tmp, arch, mesh) + ".memory.npz")

    two = [task(a, m) for a, m in RUNS if m == "1x2"]
    four = [task(a, m) for a, m in RUNS if m != "1x2"]
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


def _ranks(jobs, mesh: str) -> list:
    D, T = (int(x) for x in mesh.split("x"))
    return jobs["ranks"](D * T)["ranks"]


@pytest.mark.parametrize("arch,mesh", RUNS)
def test_ranks_equal_the_reference_serve(jobs, arch, mesh):
    """Each run's ranks, fed the reference's canonical parameters and
    frontend inputs, sample the reference's tokens at every prefill and
    decode step (the idle slots' too) and give its ``EQUAL_FIELDS``; every
    rank's stats (clocks apart) and sampled tokens are the same."""
    want = jobs["reference"]((arch, mesh))
    D, T = (int(x) for x in mesh.split("x"))
    ranks = _ranks(jobs, mesh)
    name = f"{arch} {mesh}"
    assert _joined_calls(ranks, name, D, T) == want["calls"]
    first = ranks[0][name]
    for rk in ranks:
        assert rk[name]["stats"] == first["stats"] and rk[name]["tokens"] == first["tokens"]
        for f in EQUAL_FIELDS:
            assert rk[name]["stats"][f] == want["stats"][f], (name, f)
    assert first["stats"]["admitted"] == first["stats"]["completed"] == 6


def test_layouts_and_kv_bytes(jobs):
    """The driver's layout rule: an SSM model serves contiguous and holds no
    per-token K/V (``kv_bytes`` 0: its state is not what paging changes, as
    the reference counts it); the attention families, their KV heads split
    at T 2, serve paged, their ``kv_bytes`` the reference's global pool
    (the self caches of every model shard; the cross K/V are not counted).
    seamless's 1x2 and 2x2 agree: one pool a data shard joins to the same
    figure as one pool."""
    got = {}
    for mesh in ("1x2", "1x4"):
        for rk in _ranks(jobs, mesh):
            got.update({k: v["stats"] for k, v in rk.items()})
    for mesh in ("1x2", "1x4"):
        st = got[f"mamba2-780m {mesh}"]
        assert (st["kv_layout"], st["kv_bytes"], st["kv_bytes_contiguous"]) == \
            ("contiguous", 0, 0)
    for arch in ("jamba-1.5-large-398b", "llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        assert got[f"{arch} 1x2"]["kv_layout"] == "paged"
    assert got["seamless-m4t-large-v2 1x2"]["kv_bytes"] == \
        got["seamless-m4t-large-v2 2x2"]["kv_bytes"]


def _predicted_model_collectives(cfg, passes: dict) -> dict:
    """A rank's model-axis collective calls over a serve's passes, by kind
    and dtype (f32 at smoke size): every pass that samples ends in the
    greedy pick's max (f32) and min (int32); the sums a pass are

    * SSM: the embedding and each layer's ``wo``; its prefill is one pass
      a prompt token (a loop of decode steps), the pick once at its end;
    * hybrid: the embedding and each sublayer's mixer (attention ``wo``,
      SSM ``wo``) and feed-forward (MLP, MoE) outputs; prefill as the SSM's;
    * VLM: the embedding and two a layer (cross attention and its gated
      MLP; self attention and its MLP), the prefill one pass;
    * enc-dec: two an encoder layer at a prefill (attention, MLP), which
      samples nothing (decoding starts from BOS); the embedding and three a
      decoder layer (self, cross, MLP) at a decode step.

    (Ragged prompts make a prefill's bytes depend on its bucket, so only
    the calls are predicted; ``chip_smoke.tp_collectives`` predicts the
    bytes of fixed-length prompts.)"""
    L, pf, dec = cfg.n_layers, passes["prefill"], passes["decode"]
    picks = pf + dec
    if cfg.family in ("ssm", "hybrid"):
        per = 1 + L if cfg.family == "ssm" else 1 + 2 * L
        sums = (passes["prefill_tokens"] + dec) * per
    elif cfg.family == "vlm":
        sums = (pf + dec) * (1 + 2 * L)
    else:
        sums = pf * 2 * cfg.n_encoder_layers + dec * (1 + 3 * L)
        picks = dec
    return {"all-reduce sum float32": sums, "all-reduce max float32": picks,
            "all-reduce min int32": picks}


@pytest.mark.parametrize("arch,mesh", RUNS)
def test_a_ranks_collectives_are_the_model_psums_and_the_pick(jobs, arch, mesh):
    """Each rank's model group carries exactly the predicted all-reduces
    (calls by kind and dtype; no all-gather: every KV split here is over
    heads), its batch group on 2x2 one int32 all-gather of the shards'
    tokens a pass (a seamless prefill's BOS too), and nothing is staged."""
    D, T = (int(x) for x in mesh.split("x"))
    cfg = smoke_variant(get_config(arch))
    for rk in _ranks(jobs, mesh):
        res = rk[f"{arch} {mesh}"]
        want = _predicted_model_collectives(cfg, res["passes"])
        got = {k: v["calls"] for k, v in res["model"]["issued"].items() if k != "broadcast object"}
        assert got == want, (arch, mesh, got, want)
        assert res["model"]["staged"] == {}
        n = res["passes"]["prefill"] + res["passes"]["decode"]
        if D > 1:
            assert res["batch"]["issued"]["all-gather int32"] == {"calls": n, "bytes": n * 4 * 4}
            assert res["batch"]["staged"] == {}
        else:
            assert res["batch"] is None
