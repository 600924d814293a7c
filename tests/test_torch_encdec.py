"""Parity of the port's enc-dec family (seamless-m4t) with the JAX reference
on the CPU.

seamless-m4t-large-v2 at its smoke size (``configs.smoke_variant``: 2
encoder + 2 decoder layers, d_model 64, 4 heads of 16, frames of width 32,
vocab 512, f32 compute), weights drawn by the reference and carried across
with ``convert.params_from_jax``, and seeded non-zero frames handed to both
packages.  The reference runs its Pallas kernels in interpret mode, the port
the kernels' plain versions (CPU tensors).  Tolerance ``TOL`` (rtol = atol
= 1e-4).

* Parameter paths and shapes, use-paths, and the training forward's logits
  (``encode`` then ``decode_train``); packing bit-exact.
* A prefill (the encoder, non-causal, through the flash-attention kernel's
  plain version, then the cross K/V; ``None`` logits) into paged and
  contiguous caches with ragged ``prompt_lens`` (ignored, as in the
  reference), and a decode step with self-attention on the flash-decode
  path, packed (``lazy_int8(7)``) and unpacked: logits and every cache leaf,
  ``cross_k``/``cross_v`` included, also from the reference's caches
  carried across with ``caches_from_jax``.
* The cached prefill seeds BOS; the slot merge and fresh copy on the
  enc-dec tree; ``kv_cache_bytes`` excludes the cross caches.
* ``Session.serve`` at smoke size, paged, flash: K3, K4 (non-causal) and K5.
* One 2x1 train step with the SR wire on against the reference in a
  subprocess fed the reference's SR draws; K1's inline calls a step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_tree_close, check_train_step, close, count_serving_kernels,
                           ctxs, k1_inline_calls, reference_step, serve_smoke,
                           start_reference_step)

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.quantization import default_exempt as jexempt
from repro.launch import paging as jpaging
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api import PrecisionPolicy
from repro_torch.api.session import BOS_ID
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.quantization import default_exempt
from repro_torch.dist.collectives import AxisCtx
from repro_torch.launch import paging
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.common import QTensor, pack_params_for_serving
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.model import build_model

ARCH = "seamless-m4t-large-v2"
B, S_MAX, PAGE = 3, 16, 4
PLENS = np.array([8, 5, 3], np.int32)
TABLE = np.array([[5, 1, 7, -1], [0, 3, -1, -1], [2, -1, 6, 9]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """The reference's train step, started when the module's first test
    starts, so that its compiles overlap the tests before the train-step
    test (which waits for it)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    proc = start_reference_step(ARCH, path)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def cfgs():
    return jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jed.init_encdec(cfgs[0], jax.random.PRNGKey(0), 1)


@pytest.fixture(scope="module")
def packed(jparams):
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


def _frames(cfg, n=B, s=S_MAX, seed=2):
    return np.random.default_rng(seed).standard_normal((n, s, cfg.d_frontend)).astype(np.float32)


def test_params_uses_and_forward_match_reference(cfgs, jparams, packed):
    jc, tc = cfgs
    tp = params_from_jax(jparams)
    mine = ted.init_encdec(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["encoder/attn/wq"].shape == (2, 64, 64)
    assert tp["decoder/cross/wk"].shape == (2, 64, 64) and tp["adapter"].shape == (32, 64)
    # packing: the port's of the same f32 weights is the reference's, bit for bit
    mine_q = pack_params_for_serving(tp, 7, exempt=default_exempt)
    for path, q in packed[1].items():
        if isinstance(q, QTensor):
            assert torch.equal(mine_q[path].codes, q.codes), path
            assert torch.equal(mine_q[path].scale, q.scale), path
        else:
            assert not isinstance(mine_q[path], QTensor) and torch.equal(mine_q[path], q)
    seen = {"jax": [], "torch": []}
    jpc, tpc = ctxs(False, (lambda p, w: seen["jax"].append(p) or w,
                             lambda p, w: seen["torch"].append(p) or w))
    toks = np.random.default_rng(0).integers(2, 512, (B, 8)).astype(np.int32)
    frames = _frames(jc)
    jmem = jed.encode(jc, jpc, jparams, jnp.asarray(frames))
    tmem = ted.encode(tc, tpc, tp, torch.from_numpy(frames))
    close(tmem, jmem)
    jl = jed.decode_train(jc, jpc, jparams, jmem, jnp.asarray(toks))
    tl = ted.decode_train(tc, tpc, tp, tmem, torch.from_numpy(toks))
    close(tl, jl)
    # the reference's scans trace each layer body once: the port's use-paths,
    # once each, are the reference's
    assert sorted(set(seen["torch"])) == sorted(set(seen["jax"]))
    assert {"adapter", "enc/attn/wq", "enc/mlp/w_gate", "dec/self/wo", "dec/cross/wk",
            "dec/ln_x", "enc_norm"} <= set(seen["torch"])


@pytest.mark.parametrize("layout, weights", [("paged", "packed"), ("paged", "f32"),
                                            ("contiguous", "f32")])
def test_prefill_and_decode_match_reference(cfgs, jparams, packed, weights, layout,
                                            monkeypatch):
    jc, tc = cfgs
    jp, tp = packed if weights == "packed" else (jparams, params_from_jax(jparams))
    jpc, tpc = ctxs(weights == "packed")
    calls = count_serving_kernels(monkeypatch)
    kw = {"page_size": PAGE, "pool_pages": 10} if layout == "paged" else {}
    jcache = jed.init_decoder_caches(jc, B, S_MAX, 1, jnp.float32, **kw)
    tcache = ted.init_decoder_caches(tc, B, S_MAX, 1, torch.float32, **kw)
    if layout == "paged":
        jcache = jpaging.set_page_tables(jcache, TABLE)
        tcache = paging.set_page_tables(tcache, TABLE)
    frames = _frames(jc)
    jl, jcache = jed.prefill(jc, jpc, jp, jnp.asarray(frames), jcache,
                             prompt_lens=jnp.asarray(PLENS))
    tl, tcache = ted.prefill(tc, tpc, tp, torch.from_numpy(frames), tcache,
                             attn_impl="flash", prompt_lens=torch.from_numpy(PLENS))
    assert jl is None and tl is None
    assert_tree_close(tcache, jcache)
    assert tcache["cross_k"].shape == (2, B, S_MAX, 4, 16) and tcache["cross_k"].abs().min() > 0
    # the encoder: one non-causal K4 launch a layer; K3: the adapter, 7 a
    # layer, and each decoder layer's cross K/V (packed)
    assert calls["k4"] == [False] * tc.n_encoder_layers
    assert calls["k3"] == ((1 + 7 * tc.n_encoder_layers + 2 * tc.n_layers)
                           if weights == "packed" else 0)
    tok = np.array([[BOS_ID], [7], [300]], np.int32)
    jd, jc2 = jed.decode_step(jc, jpc, jp, jnp.asarray(tok), jcache, attn_impl="flash")
    calls.update(k3=0, k5=0)
    td, tc2 = ted.decode_step(tc, tpc, tp, torch.from_numpy(tok), tcache, attn_impl="flash")
    close(td, jd)
    assert_tree_close(tc2, jc2)
    # a decode step: self 4, cross q and o, the MLP's 3 a layer, and the head
    assert calls["k3"] == ((9 * tc.n_layers + 1) if weights == "packed" else 0)
    assert calls["k5"] == (tc.n_layers if layout == "paged" else 0)
    # from the reference's caches carried across (the cross K/V bare arrays)
    td2, _ = ted.decode_step(tc, tpc, tp, torch.from_numpy(tok), caches_from_jax(jcache),
                             attn_impl="flash")
    close(td2, jd)


def test_cached_prefill_seeds_bos_and_merges_only_admitted_slots(cfgs, jparams):
    _jc, tc = cfgs
    model = build_model(tc)
    tp = params_from_jax(jparams)
    caches = model.init_caches(B, S_MAX, 1, torch.float32, page_size=PAGE, pool_pages=10)
    caches = paging.set_page_tables(caches, TABLE)
    pf = tsteps.build_cached_prefill(model, AxisCtx(), attn_impl="flash",
                                     policy=PrecisionPolicy(), bos_id=BOS_ID)
    assert set(model.prefill_batch_spec(B, 8, S_MAX)) == {"frames"}
    mask = torch.tensor([True, False, True])
    tok, merged = pf.fn(tp, {"frames": torch.from_numpy(_frames(tc))}, caches, mask,
                        torch.from_numpy(PLENS))
    assert tok.dtype == torch.int32 and torch.equal(tok, torch.full((B, 1), BOS_ID,
                                                                    dtype=torch.int32))
    for name in ("cross_k", "cross_v"):
        assert merged[name][:, 1].abs().max() == 0 and merged[name][:, 0].abs().min() > 0
    assert merged["self"].length.abs().max() == 0     # nothing of a prompt is cached


def test_slot_merge_fresh_copy_page_tables_and_kv_bytes_on_the_tree(cfgs):
    jc, tc = cfgs
    kw = {"page_size": PAGE, "pool_pages": 10}
    rng = np.random.default_rng(4)

    def tree():
        j = jpaging.set_page_tables(jed.init_decoder_caches(jc, B, S_MAX, 1, jnp.float32,
                                                            **kw), TABLE)
        j = jax.tree_util.tree_map(
            lambda x: x if x.dtype == jnp.int32 else
            jnp.asarray(rng.standard_normal(x.shape), x.dtype), j)
        return j, caches_from_jax(j)

    (jold, told), (jnew, tnew) = tree(), tree()
    keep = np.array([True, False, True])
    want = jattn.merge_slot_caches(jold, jnew, jnp.asarray(keep))
    got = tattn.merge_slot_caches(told, tnew, torch.from_numpy(keep))
    assert_tree_close(got, want)
    assert_tree_close(tattn.fresh_slot_caches(told), jattn.fresh_slot_caches(jold))
    # the cross caches pass through the page-table push; their bytes are not K/V
    t = ted.init_decoder_caches(tc, B, S_MAX, 1, torch.float32, **kw)
    pushed = paging.set_page_tables(t, TABLE)
    assert pushed["cross_k"] is t["cross_k"]
    for layout in (kw, {}):
        j = jed.init_decoder_caches(jc, B, S_MAX, 1, jnp.float32, **layout)
        t = ted.init_decoder_caches(tc, B, S_MAX, 1, torch.float32, **layout)
        assert paging.kv_cache_bytes(t) == jpaging.kv_cache_bytes(j) \
            == paging.kv_cache_bytes(t["self"]) > 0


def test_session_serves_smoke_through_k3_k4_and_k5(monkeypatch):
    calls = count_serving_kernels(monkeypatch)
    sess, _stats = serve_smoke(ARCH)
    assert sess.last_tokens.count(BOS_ID) >= 3          # each sequence starts at BOS
    cfg = sess.cfg
    assert calls["k4"] and set(calls["k4"]) == {False}  # the encoder, non-causal
    prefills = len(calls["k4"]) // cfg.n_encoder_layers
    decode = calls["k3"] - prefills * (1 + 7 * cfg.n_encoder_layers + 2 * cfg.n_layers)
    assert decode > 0 and decode % (9 * cfg.n_layers + 1) == 0, calls
    assert calls["k5"] == decode // (9 * cfg.n_layers + 1) * cfg.n_layers


# ---------------------------------------------------------------------------
# The train step on a 2x1 mesh, SR wire on
# ---------------------------------------------------------------------------


def test_train_step_matches_reference(_reference_run, monkeypatch):
    """Seeded non-zero frames, the reference's params and SR draws: the
    step's loss, parameters and ``comm_report()`` (``check_train_step``);
    at smoke width every leaf but the vocab tables is too small to shard,
    so the wire carries 26 leaves."""
    _params, _p1, wire = check_train_step(ARCH, reference_step(*_reference_run), monkeypatch)
    assert len(wire) == 26 and "decoder/cross/wk" in wire and "unembed/w" not in wire


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_k1_inline_calls(remat, monkeypatch):
    """Each weight use is one call of K1's inline entry: the embed, the
    adapter and the unembed once, 7 an encoder layer and 11 a decoder layer
    (self, cross, MLP), the layers twice under remat; the norms never."""
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), remat=remat)
    per_client = 3 + (7 * cfg.n_encoder_layers + 11 * cfg.n_layers) * (2 if remat else 1)
    assert k1_inline_calls(cfg, monkeypatch) == per_client
