"""Slice-level parity: the port's ``Session.serve`` against the reference's.

Continuous batching of yi-6b at its smoke size with int8-packed weights
(``lazy_int8(7)``), at the sizes of ``test_serving.py``'s packed driver test
(batch 2, s_max 32, prompt_len 8, 4 requests, max_new 6, 24 steps).  The
port's model init is replaced by the reference's parameters carried
across with ``convert.params_from_jax``; everything the driver counts and
the greedy sample must then be equal.
"""

import dataclasses

import pytest
import torch

from repro.api import PrecisionPolicy as JPolicy
from repro.api import RunSpec as JRunSpec
from repro.api import Session as JSession
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from torch_dist_worker import fixed_init

EQUAL_FIELDS = ("admitted", "completed", "decoded_tokens", "decode_steps",
                "capacity_stops", "deferred_admissions", "prompt_buckets",
                "kv_bytes", "kv_bytes_contiguous", "bytes_per_step_packed",
                "bytes_per_step_f32", "sample", "kv_layout", "page_size",
                "kv_demotions", "kv_bits_final")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and the suite runs
    several workers on few cores: keep this module's PyTorch to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_both(options: dict):
    common = dict(arch="yi-6b", workload="serve", smoke=True, seed=0, batch=2, seq=32)
    jsess = JSession(JRunSpec(precision=JPolicy.lazy_int8(7), options=options, **common))
    jparams = jsess.init_params()
    want = jsess.serve()
    tsess = Session(RunSpec(precision=PrecisionPolicy.lazy_int8(7), options=options,
                            **common), device="cpu")
    tparams = params_from_jax(jparams)
    tsess.model = dataclasses.replace(tsess.model, init=fixed_init(tparams))
    return tsess.serve(), want


@pytest.mark.parametrize("options", [
    # the main path: flash prefill + paged flash-decode, ragged prompts
    dict(attn_impl="flash", kv_layout="paged", vary_prompt=True),
    # a one-page pool: every admission after the first waits for a reclaim
    # (3 deferred), and the KV watermark demotes the pool to bf16 mid-run
    dict(attn_impl="flash", kv_layout="paged", pool_pages=1,
         precision_program={"kind": "constant", "kv_watermark": 0.5}),
    # the reference attention over the contiguous slab
    dict(attn_impl="ref", kv_layout="contiguous"),
], ids=["flash-paged", "flash-paged-deferred", "ref-contiguous"])
def test_serve_matches_reference(options):
    opts = dict(steps=24, s_max=32, prompt_len=8, requests=4, max_new=6, quiet=True,
                **options)
    got, want = _serve_both(opts)
    for name in EQUAL_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.admitted == 4 and got.completed >= 3 and got.decoded_tokens > 0
    if options.get("pool_pages") == 1:
        assert got.deferred_admissions == 3 and got.kv_demotions == 1
    assert got.packed_vs_f32 == pytest.approx(want.packed_vs_f32)
    assert {f.name for f in dataclasses.fields(want)} <= {
        f.name for f in dataclasses.fields(got)}


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = RunSpec("yi-6b", workload="serve", precision=PrecisionPolicy.lazy_int8(7))
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(spec)                       # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(spec, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "yi-6b", "--smoke", "--steps", "2"])


def test_pod_dryrun_runs_and_one_process_tp_raises():
    # a dry run on a pod mesh (model axis > 1) traces one device of it, with
    # no process group (tests/test_torch_dryrun_pod.py)
    spec = RunSpec("yi-6b", workload="dryrun", mesh="16x16", smoke=False,
                   options={"shape": "decode_32k"})
    d = Session(spec, device="cpu").run()
    assert d["status"] == "ok" and d["n_devices"] == 256
    # tp > 1 serves one rank a model shard (tests/test_torch_serve_tp.py): in
    # one process it raises
    with pytest.raises(ValueError, match="torchrun"):
        Session(RunSpec("yi-6b", workload="serve", mesh="1x2"), device="cpu").serve()
