"""Kernel-level parity of the PyTorch port against the JAX reference.

The same inputs, drawn with numpy from a seed, go through the reference's
Pallas kernels (interpret mode on the CPU, as ``tests/test_kernels.py`` runs
them) and through the port's kernel entry points, which take their plain
PyTorch versions for CPU tensors.  The CUDA kernels themselves are held to
the same plain versions on the card by ``chip_smoke.py``.

Also here: the guards that keep the port free of JAX and of the reference
package, and that keep CUDA requests from quietly running on the CPU.
"""

import inspect
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and the suite runs
    several workers on few cores: keep this module's PyTorch to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_dtype(a: np.ndarray, bf16: bool):
    """The same values for both frameworks (bf16 rounds f32 to nearest even)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


class TestQuantMatmul:
    @pytest.mark.parametrize("mnk", [(4, 128, 256), (37, 200, 300), (64, 256, 128),
                                     (256, 128, 256), (512, 256, 128)])
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("bits", [7, 12])
    def test_matches_reference(self, mnk, bf16, bits):
        M, K, N = mnk
        rng = np.random.default_rng(M * 7 + K + bits)
        lim = 2**bits - 1
        codes = rng.integers(-lim, lim + 1, size=(K, N)).astype(
            np.int8 if bits <= 7 else np.int16)
        scale = np.float32(1.0 / np.sqrt(K) / lim)
        jx, tx = _as_dtype(rng.standard_normal((M, K)).astype(np.float32), bf16)
        want = np.asarray(jops.quant_matmul(jx, jnp.asarray(codes), jnp.asarray(scale)))
        got = tops.quant_matmul(tx, torch.from_numpy(codes), torch.tensor(scale))
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=2e-2 if bf16 else 1e-5,
                                   atol=1e-2 if bf16 else 1e-5)


#: yi-6b's projections (K, N): q/o, k/v, gate/up, down, head.
_YI6B_KN = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)]
#: their decode plans (tile_m, tile_n, split) at M <= 4 and M 16, bf16 x and
#: int8 codes, as the cluster path has taken them since its redesign
_YI6B_CLUSTER_PLANS = {
    (4, 4096, 4096): (4, 64, 3), (4, 4096, 512): (4, 16, 6), (4, 4096, 11008): (4, 256, 5),
    (4, 11008, 4096): (4, 64, 3), (4, 4096, 64000): (4, 256, 1),
    (16, 4096, 4096): (16, 64, 3), (16, 4096, 512): (16, 16, 6),
    (16, 4096, 11008): (16, 64, 1), (16, 11008, 4096): (16, 64, 3),
    (16, 4096, 64000): (16, 128, 1)}
#: int8 code rows TMA cannot address (no multiple of 16 bytes): a jamba
#: smoke shard's and a mamba2 shard's w_dt, a 300-wide check shape, a mamba2
#: unembed shard, mamba2's and seamless-m4t's unembeds
_RAGGED_INT8_N = (2, 12, 300, 12570, 50280, 256206)


def _cdiv(a, b):
    return -(-a // b)


class TestQuantMatmulPlan:
    """The path and tile each shape takes on the card (kernels/quant_matmul.plan)."""

    @pytest.mark.parametrize("M", [1, 4, 16])
    @pytest.mark.parametrize("kn", _YI6B_KN)
    def test_decode_takes_a_cluster_that_fills_the_card(self, kn, M):
        K, N = kn
        for x_dtype, code_dtype in ((torch.bfloat16, torch.int8), (torch.float32, torch.int16)):
            p = tqm.plan(M, K, N, x_dtype, code_dtype)
            assert p.path == "cluster" and M <= p.tile_m <= 16
            assert 1 <= p.split <= tqm.MAX_CLUSTER
            assert p.blocks(M, N) >= tqm.H100_SMS, p

    @pytest.mark.parametrize("M", [17, 37, 64, 65, 256, 512])
    @pytest.mark.parametrize("kn", _YI6B_KN)
    def test_prefill_bf16_int8_takes_wgmma(self, kn, M):
        K, N = kn
        p = tqm.plan(M, K, N, torch.bfloat16, torch.int8)
        assert p.path == "wgmma" and p.split == 1
        assert (p.tile_m, p.tile_n) in tqm.WGMMA_TILES
        assert p.tile_m == 64 if M <= 64 else p.tile_m in (64, 128)

    @pytest.mark.parametrize("case", [
        dict(x_dtype=torch.float32, code_dtype=torch.int8),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int16),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int8, K=4100),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int8, N=300),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int8, aligned=False),
        # the shapes that take the ragged path at decode
        *(dict(x_dtype=torch.bfloat16, code_dtype=torch.int8, K=1536, N=n)
          for n in _RAGGED_INT8_N),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int16, K=1536, N=301),
        dict(x_dtype=torch.bfloat16, code_dtype=torch.int8, K=1001)])
    def test_other_large_m_takes_tiled(self, case):
        kw = {**dict(M=512, K=4096, N=11008, aligned=True), **case}
        p = tqm.plan(kw["M"], kw["K"], kw["N"], kw["x_dtype"], kw["code_dtype"],
                     aligned=kw["aligned"])
        assert p == tqm.Plan("tiled", 128, 128, 1)

    @pytest.mark.parametrize("M", [4, 16, 512])
    def test_shapes_tma_cannot_address_take_tiled(self, M):
        # a row of 300 int8 codes is no multiple of 16 bytes; nor is a
        # misaligned base (TMA's two rules): ragged at decode, tiled above
        want = "ragged" if M <= 16 else "tiled"
        assert tqm.plan(M, 1000, 300, torch.bfloat16, torch.int8).path == want
        assert tqm.plan(M, 4096, 4096, torch.bfloat16, torch.int8,
                        aligned=False).path == want

    @pytest.mark.parametrize("M", [1, 4, 16])
    @pytest.mark.parametrize("case", [
        *(dict(N=n) for n in _RAGGED_INT8_N),
        dict(N=301, code_dtype=torch.int16),           # odd: rows 2 bytes off
        dict(N=12570, code_dtype=torch.int16),
        dict(K=1001),                                  # bf16 x rows 2,002 bytes
        dict(K=1001, x_dtype=torch.float32),
        dict(N=4096, aligned=False)],                  # a sliced operand's base
        ids=lambda c: "-".join(f"{k}={str(v).replace('torch.', '')}" for k, v in c.items()))
    def test_decode_tma_cannot_address_takes_ragged(self, case, M):
        kw = {**dict(K=1536, N=4096, x_dtype=torch.bfloat16, code_dtype=torch.int8,
                     aligned=True), **case}
        K, N = kw["K"], kw["N"]
        p = tqm.plan(M, K, N, kw["x_dtype"], kw["code_dtype"], aligned=kw["aligned"])
        maxm = 4 if M <= 4 else 8 if M <= 8 else 16
        assert p.path == "ragged" and p.tile_m == maxm, p
        # the launcher's conditions: lanes a power of two up to 32 a tile
        # (CPL = 64 / MAXM columns each), a cluster of at most 8, a grid's y
        lanes = p.tile_n // (64 // maxm)
        assert p.tile_n % (64 // maxm) == 0 and lanes in (1, 2, 4, 8, 16, 32), p
        assert 1 <= p.split <= tqm.MAX_CLUSTER and _cdiv(N, p.tile_n) <= 65535
        # every block of the cluster keeps rows (at least 64 where K has them)
        assert _cdiv(K, p.split) >= min(K, 64) and (p.split - 1) * _cdiv(K, p.split) < K
        # the least column tile that covers a narrow shape; K split over blocks
        if N * (2 if kw["code_dtype"] == torch.int16 else 1) <= 16:
            assert p.tile_n == 64 // maxm and p.split == min(8, K // 64), p
        assert p.blocks(M, N) >= min(tqm.H100_SMS // 2, _cdiv(N, 64 // maxm) * 8), p

    @pytest.mark.parametrize("M", [1, 4, 16])
    @pytest.mark.parametrize("kn", _YI6B_KN)
    def test_yi6b_decode_keeps_its_cluster_plan(self, kn, M):
        K, N = kn
        want = _YI6B_CLUSTER_PLANS[(4 if M <= 4 else 16, K, N)]
        assert tuple(tqm.plan(M, K, N, torch.bfloat16, torch.int8)) == ("cluster", *want)
        if (M, K, N) == (16, 4096, 512):
            want = (16, 8, 3)           # int16 rows: the 16-byte row is 8 codes
        assert tuple(tqm.plan(M, K, N, torch.float32, torch.int16)) == ("cluster", *want)

    def test_kernel_lines_name_each_paths_kernel(self):
        with open(os.path.join(ROOT, "src", "repro_torch", "csrc", "quant_matmul.cu")) as f:
            lines = f.read().splitlines()
        for path, line in tqm.KERNEL_LINES.items():
            assert lines[line - 1].startswith("__global__"), (path, lines[line - 1])
            assert lines[line].startswith(f"qmm_{path}("), (path, lines[line])
        assert set(tqm.KERNEL_LINES) == set(tqm.PATHS)

    def test_cuda_wrapper_refuses_a_strided_operand(self):
        x = torch.zeros(4, 64)
        codes = torch.zeros(12, 64, dtype=torch.int8)
        with pytest.raises(ValueError, match="contiguous"):
            tqm.quant_matmul_cuda(x, codes.t(), torch.ones(()))
        with pytest.raises(ValueError, match="contiguous"):
            tqm.quant_matmul_cuda(torch.zeros(64, 4).t(), codes.t().contiguous(),
                                  torch.ones(()))


class TestQuantMatmulRaggedWidths:
    """The widths whose code rows TMA cannot address (2, 12, 300, 12,570,
    50,280 and 256,206 bytes of int8; odd int16 widths; x rows of 1,001 bf16
    or f32; an x or code base one element off a 16-byte boundary), K cut
    small, through ``ops.quant_matmul`` (on the CPU the plain version)
    against the reference's ``ops.quant_matmul``."""

    @pytest.mark.parametrize("case", [
        *((4, 24, n, np.int8) for n in _RAGGED_INT8_N), (4, 24, 301, np.int16),
        (1, 1001, 12, np.int8), (16, 24, 301, np.int16), (3, 40, 301, np.int8)],
        ids=lambda c: f"M{c[0]}-K{c[1]}-N{c[2]}-{c[3].__name__}")
    @pytest.mark.parametrize("bf16", [False, True])
    def test_matches_reference(self, case, bf16):
        M, K, N, code_dtype = case
        rng = np.random.default_rng(M + K + N)
        lim = 127 if code_dtype == np.int8 else 2047
        codes = rng.integers(-lim, lim + 1, size=(K, N)).astype(code_dtype)
        scale = np.float32(1.0 / np.sqrt(K) / lim)
        jx, tx = _as_dtype(rng.standard_normal((M, K)).astype(np.float32), bf16)
        want = np.asarray(jops.quant_matmul(jx, jnp.asarray(codes), jnp.asarray(scale)))
        # the port's operands one element into flat buffers, as a sliced
        # activation and a packed leaf's view lie
        flat_x = torch.zeros(M * K + 1, dtype=tx.dtype)
        flat_x[1:] = tx.reshape(-1)
        flat_c = torch.zeros(K * N + 1, dtype=torch.from_numpy(codes).dtype)
        flat_c[1:] = torch.from_numpy(codes).reshape(-1)
        x_v, c_v = flat_x[1:].view(M, K), flat_c[1:].view(K, N)
        got = tops.quant_matmul(x_v, c_v, torch.tensor(scale))
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2 if bf16 else 1e-5,
                                   atol=1e-2 if bf16 else 1e-5)


class TestFlashAttention:
    @pytest.mark.parametrize("S", [37, 128, 150])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("bf16", [False, True])
    def test_matches_reference(self, S, causal, bf16):
        rng = np.random.default_rng(S + int(causal))
        qkv = [rng.standard_normal((2, 3, S, 16)).astype(np.float32) for _ in range(3)]
        j = [_as_dtype(a, bf16)[0] for a in qkv]
        t = [_as_dtype(a, bf16)[1] for a in qkv]
        want = np.asarray(jops.flash_attention(*j, causal=causal).astype(jnp.float32))
        got = tops.flash_attention(*t, causal=causal)
        assert got.dtype == t[0].dtype and got.shape == t[0].shape
        tol = 3e-2 if bf16 else 2e-4
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("bf16", [False, True])
    def test_head_dim_256(self, causal, bf16):
        """gemma-7b's head dim (BH 2, ragged S)."""
        rng = np.random.default_rng(256 + int(causal))
        qkv = [rng.standard_normal((1, 2, 37, 256)).astype(np.float32) for _ in range(3)]
        j = [_as_dtype(a, bf16)[0] for a in qkv]
        t = [_as_dtype(a, bf16)[1] for a in qkv]
        want = np.asarray(jops.flash_attention(*j, causal=causal).astype(jnp.float32))
        got = tops.flash_attention(*t, causal=causal)
        assert got.dtype == t[0].dtype and got.shape == t[0].shape
        tol = 3e-2 if bf16 else 2e-4
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)

    @pytest.mark.parametrize("S", [37, 130])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("bf16", [False, True])
    def test_wgmma_head_dims(self, D, S, causal, bf16):
        """The head dims the card's tensor-core path takes (BH 2, ragged S),
        through the CPU route."""
        rng = np.random.default_rng(D + S + int(causal))
        qkv = [rng.standard_normal((1, 2, S, D)).astype(np.float32) for _ in range(3)]
        j = [_as_dtype(a, bf16)[0] for a in qkv]
        t = [_as_dtype(a, bf16)[1] for a in qkv]
        want = np.asarray(jops.flash_attention(*j, causal=causal).astype(jnp.float32))
        got = tops.flash_attention(*t, causal=causal)
        assert got.dtype == t[0].dtype and got.shape == t[0].shape
        tol = 3e-2 if bf16 else 2e-4
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


class TestAttentionPlan:
    """K4's path and tiles (kernels/flash_attention.plan_attention)."""

    def test_plan_reads_shapes_only(self):
        # a pure function of shapes and type: a prefill plans without
        # waiting for the card
        names = list(inspect.signature(tfa.plan_attention).parameters)
        assert names == ["BH", "S", "D", "dtype", "causal", "num_sms"]
        a = tfa.plan_attention(128, 128, 128, torch.bfloat16, True)
        assert a == tfa.plan_attention(128, 128, 128, torch.bfloat16, True)

    @pytest.mark.parametrize("D", [64, 128, 256])
    def test_bf16_takes_wgmma(self, D):
        for BH, S, causal in ((128, 128, True), (64, 513, False), (2, 37, True)):
            p = tfa.plan_attention(BH, S, D, torch.bfloat16, causal)
            assert p.path == "wgmma" and (p.block_q, p.block_k) in tfa.ATTN_TILES[D], p
            assert p.blocks == BH * -(-S // p.block_q), p

    @pytest.mark.parametrize("D", tfa.HEAD_DIMS)
    def test_f32_and_narrow_bf16_take_simt(self, D):
        """The inputs the FP32-pipe (simt) kernel once took, every f32 input
        and bf16 at head dims 16 and 32, now take the tensor-core paths:
        f32 the split path (a tile of its head dim), bf16 the wgmma path,
        at every head dim."""
        for BH, S, causal in ((128, 128, True), (64, 513, False), (2, 37, True)):
            p = tfa.plan_attention(BH, S, D, torch.float32, causal)
            assert p.path == "wgmma_split", p
            assert (p.block_q, p.block_k) in tfa.ATTN_SPLIT_TILES[D], p
            assert p.blocks == BH * -(-S // p.block_q), p
            b = tfa.plan_attention(BH, S, D, torch.bfloat16, causal)
            assert b.path == "wgmma" and (b.block_q, b.block_k) in tfa.ATTN_TILES[D], b

    @pytest.mark.parametrize("D", tfa.HEAD_DIMS)
    def test_shared_memory_fits(self, D):
        for dtype in (torch.float32, torch.bfloat16):
            p = tfa.plan_attention(128, 513, D, dtype, False)
            assert p.smem == tfa.attention_smem_bytes(p.path, D, p.block_q, p.block_k)
            assert p.smem <= tfa.MAX_SMEM, (dtype, p)
        # every tile the wgmma path takes, one warpgroup (block_q 64) or two
        for bq, bk in tfa.ATTN_TILES[D]:
            assert tfa.attention_smem_bytes("wgmma", D, bq, bk) <= tfa.MAX_SMEM, (bq, bk)
        # every tile of the split path: q hi and lo, the split K and V tiles
        # (or the f32 q tile), one f32 K and V tile, three mbarriers
        for bq, bk in tfa.ATTN_SPLIT_TILES[D]:
            smem = tfa.attention_smem_bytes("wgmma_split", D, bq, bk)
            assert smem == 4 * bq * D + max(8 * bk * D, 4 * bq * D) + 8 * bk * D + 24 + 1024
            assert smem <= tfa.MAX_SMEM, (bq, bk)

    def test_other_types_have_no_path(self):
        with pytest.raises(ValueError, match="no K4 path"):
            tfa.plan_attention(2, 16, 64, torch.float16, True)

    def test_plans_mirror_the_c_dispatch(self):
        """ATTN_PATHS in the order of the C enum, and the split tiles the
        C dispatcher takes (csrc/flash_attention.cu)."""
        src = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                                "flash_attention.cu")).read()
        enum = re.search(r"enum AttnPath : int \{([^}]*)\}", src)[1]
        assert [n.split("=")[0].strip() for n in enum.split(",")] == ["ATTN_WGMMA", "ATTN_SPLIT"]
        assert len(tfa.ATTN_PATHS) == 2 and tfa.ATTN_PATHS[1] == "wgmma_split"
        body = src[src.index("cudaError_t dispatch_fs_tile("):src.index("cudaError_t dispatch_fs(")]
        taken = {tuple(map(int, t)) for t in re.findall(r"REPRO_FS_TILE\((\d+), (\d+)\);", body)}
        assert taken == {t for tiles in tfa.ATTN_SPLIT_TILES.values() for t in tiles}

    def test_main_path_fills_the_card(self):
        # yi-6b's prefill: 32 heads x 4 slots, a 128-token bucket
        p = tfa.plan_attention(128, 128, 128, torch.bfloat16, True)
        assert p.path == "wgmma" and p.blocks >= 128, p


def _split_bf16(x: torch.Tensor):
    """x as hi = bf16(x) and lo = bf16(x - hi), both widened back to f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_attention(q, k, v, causal: bool, split_p: bool = True, block_k: int = 64):
    """The split path's arithmetic (csrc/flash_attention.cu:
    flash_attention_split) in plain f32 PyTorch: per key tile S = Q_hi K_hi^T
    + Q_hi K_lo^T + Q_lo K_hi^T, the online softmax, and O += P_hi V_hi +
    P_hi V_lo + P_lo V_hi; with ``split_p=False`` P stays one bf16
    (O += P V_hi + P V_lo)."""
    S, D = q.shape[-2:]
    (qh, ql), (kh, kl), (vh, vl) = (_split_bf16(t) for t in (q, k, v))
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        ks = slice(k0, min(S, k0 + block_k))
        s = (qh @ kh[..., ks, :].mT + qh @ kl[..., ks, :].mT + ql @ kh[..., ks, :].mT) * D ** -0.5
        if causal:
            s = s.masked_fill(torch.arange(k0, ks.stop)[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, corr = torch.exp(s - m_new), torch.exp(m - m_new)
        l, m = l * corr + p.sum(-1, keepdim=True), m_new
        if split_p:
            ph, pl = _split_bf16(p)
            pv = ph @ vh[..., ks, :] + ph @ vl[..., ks, :] + pl @ vh[..., ks, :]
        else:
            pb = p.to(torch.bfloat16).float()
            pv = pb @ vh[..., ks, :] + pb @ vl[..., ks, :]
        o = o * corr + pv
    return o / l.clamp_min(1e-30)


class TestSplitProducts:
    """The numerics of K4's f32 path on bf16 tensor cores, pinned on the CPU:
    three split products keep the f32 tolerance of the reference's tests
    (2e-4); P kept as one bf16 does not."""

    @staticmethod
    def _inputs(D: int, S: int, seed: int):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal((2, S, D)).astype(np.float32))
                for _ in range(3)]

    @pytest.mark.parametrize("S", [37, 130])
    @pytest.mark.parametrize("D", [16, 128])
    @pytest.mark.parametrize("causal", [True, False])
    def test_three_products_keep_f32_tolerance(self, D, S, causal):
        q, k, v = self._inputs(D, S, D + S + int(causal))
        got = _split_attention(q, k, v, causal)
        torch.testing.assert_close(got, tfa.flash_attention_plain(q, k, v, causal),
                                   rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("D", [16, 128])
    def test_single_bf16_p_misses_it(self, D):
        q, k, v = self._inputs(D, 130, D)
        want = tfa.flash_attention_plain(q, k, v, True)
        err = float((_split_attention(q, k, v, True, split_p=False) - want).abs().max())
        assert err > 2e-4, err


def _decode_inputs(seed: int, KV: int = 2, G: int = 3, hd: int = 16):
    """Paged decode inputs with -1 holes, an empty slot and ragged lengths."""
    rng = np.random.default_rng(seed)
    B, page, n_pmax, n_pool = 4, 4, 5, 16
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pool, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pool, page, KV, hd)).astype(np.float32)
    rows = rng.permutation(n_pool).astype(np.int32)
    pt = np.full((B, n_pmax), -1, np.int32)
    pt[0] = rows[:5]                 # full slot
    pt[1, :4] = rows[5:9]
    pt[1, 2] = -1                    # hole inside the length
    pt[2, :3] = rows[9:12]           # length off the page grid
    pt[3, :2] = rows[12:14]          # owns pages, holds no token
    lengths = np.array([19, 14, 9, 0], np.int32)
    return q, kp, vp, pt, lengths


class TestFlashDecode:
    @staticmethod
    def _check(bf16_pool, **shape):
        q, kp, vp, pt, lengths = _decode_inputs(3, **shape)
        jk, tk = _as_dtype(kp, bf16_pool)
        jv, tv = _as_dtype(vp, bf16_pool)
        want = jops.flash_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(pt),
                                       jnp.asarray(lengths))
        got = tops.flash_paged_decode(torch.from_numpy(q), tk, tv,
                                      torch.from_numpy(pt), torch.from_numpy(lengths))
        acc, m, l = (np.asarray(w) for w in want)
        tacc, tm, tl = (g.numpy() for g in got)
        assert tacc.shape == acc.shape and tm.shape == m.shape == tl.shape
        np.testing.assert_allclose(tacc, acc, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(tl, l, rtol=2e-5, atol=0)
        # m is a max of q.k scores: bit-equal only if both sides sum each
        # dot product over hd in the same order, which XLA's dot and
        # PyTorch's matmul do not; they differ by at most one f32 ulp.
        np.testing.assert_allclose(tm, m, rtol=1e-6, atol=0)
        # the empty slot: m = -1e30, l = 0, acc = 0, as the reference
        assert (tm[3] == np.float32(-1e30)).all() and (tl[3] == 0).all()
        assert (tacc[3] == 0).all()

    @pytest.mark.parametrize("bf16_pool", [False, True])
    def test_matches_reference(self, bf16_pool):
        self._check(bf16_pool)

    @pytest.mark.parametrize("bf16_pool", [False, True])
    def test_gemma_shape(self, bf16_pool):
        """gemma-7b's decode grouping: one query a KV head, head dim 256."""
        self._check(bf16_pool, KV=2, G=1, hd=256)


#: yi-6b's serve shape (B, KV, G, hd, page, n_pmax): 4 slots, s_max 256.
_YI6B_DECODE = (4, 4, 8, 128, 16, 16)


class TestDecodePlan:
    """K5's split of the page axis (kernels/flash_attention.plan_decode)."""

    @pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16])
    def test_yi6b_serve_shape_fills_the_card(self, pool):
        p = tfa.plan_decode(*_YI6B_DECODE, torch.bfloat16, pool)
        assert p.blocks >= 128 and p.group == 8, p

    @pytest.mark.parametrize("shape", [
        _YI6B_DECODE, (4, 16, 1, 256, 16, 16), (4, 2, 16, 128, 16, 16),
        (4, 4, 8, 128, 16, 256), (1, 1, 1, 64, 16, 1000), (64, 8, 4, 128, 16, 8),
        (4, 2, 3, 16, 4, 5), (2, 2, 1, 16, 16, 0)])
    def test_cluster_within_limit_and_ranges_cover_once(self, shape):
        B, KV, G, hd, page, n_pmax = shape
        p = tfa.plan_decode(*shape, torch.float32, torch.float32)
        assert 1 <= p.split <= tfa.MAX_DECODE_SPLIT <= tfa.MAX_CLUSTER, p
        assert 1 <= p.pages_per_block <= tfa.MAX_DECODE_PAGES, p
        # block r of a cluster takes pages [r * per, (r + 1) * per), the last
        # range cut at n_pmax (csrc/flash_attention.cu: flash_decode_split)
        per = p.pages_per_block
        ranges = [(r * per, min(n_pmax, (r + 1) * per)) for r in range(p.split)]
        assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(n_pmax)), p
        if n_pmax:       # every block of the cluster has pages to walk
            assert all(lo < hi for lo, hi in ranges), p

    @pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
    def test_shared_memory_fits_every_group(self, hd):
        for G in range(1, tfa.DECODE_MAX_G + 1):
            for pool in (torch.float32, torch.bfloat16):
                p = tfa.plan_decode(4, 4, G, hd, 16, 16, torch.bfloat16, pool)
                # a block takes G padded to a power of two, at most 8
                assert p.group >= min(G, 8) and p.group & (p.group - 1) == 0, (G, p)
                assert p.group <= tfa.DECODE_GROUP, (G, p)
                assert p.blocks == p.split * 4 * 4 * -(-G // p.group), (G, p)
                assert p.smem == tfa.decode_smem_bytes(p.group, hd, pool), (G, p)
                assert p.smem <= tfa.MAX_SMEM, (G, p)

    def test_plan_reads_shapes_only(self):
        # a pure function of shapes and types: no lengths or page table, so a
        # decode step plans without waiting for the card
        names = list(inspect.signature(tfa.plan_decode).parameters)
        assert names == ["B", "KV", "G", "hd", "page", "n_pmax", "q_dtype", "pool_dtype",
                         "num_sms"]
        a = tfa.plan_decode(*_YI6B_DECODE, torch.bfloat16, torch.float32)
        assert a == tfa.plan_decode(*_YI6B_DECODE, torch.bfloat16, torch.float32)


class TestDispatchGuards:
    def test_head_dim_256_reaches_the_cuda_refusal(self):
        q = torch.zeros((2, 8, 256))
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_cuda(q, q, q)
        qd = torch.zeros((2, 2, 1, 256))
        pool = torch.zeros((4, 16, 2, 256))
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_decode_cuda(qd, pool, pool, torch.zeros((2, 2), dtype=torch.int32),
                                  torch.zeros((2,), dtype=torch.int32))

    _REFUSAL_CASES = ([(D, torch.bfloat16) for D in (16, 32, 64, 128)]
                      + [(D, torch.float32) for D in tfa.HEAD_DIMS])

    @pytest.mark.parametrize("D, dtype", _REFUSAL_CASES,
                             ids=[str(D) if dt == torch.bfloat16 else f"f32-{D}"
                                  for D, dt in _REFUSAL_CASES])
    def test_wgmma_head_dims_reach_the_cuda_refusal(self, D, dtype):
        # bf16 (the wgmma path) and f32 (the split path) at the head dims
        # each takes: a CPU tensor is refused, never run on a plain version
        q = torch.zeros((2, 8, D), dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_cuda(q, q, q)

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        x = torch.zeros((2, 8))
        codes = torch.zeros((8, 4), dtype=torch.int8)
        with pytest.raises(ValueError, match="CUDA"):
            tqm.quant_matmul_cuda(x, codes, torch.tensor(1.0))
        q = torch.zeros((2, 8, 16))
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_cuda(q, q, q)

    def test_unknown_device_raises(self):
        x = torch.zeros((2, 8), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tops.quant_matmul(x, torch.zeros((8, 4), dtype=torch.int8, device="meta"),
                              torch.zeros((), device="meta"))


_FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b(?!_)|"
                        r"from repro(\.| import))", re.M)


def test_port_sources_name_no_jax_or_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if _FORBIDDEN.search(open(f).read())]
    assert not bad, bad


def test_port_imports_no_jax_or_reference():
    """Import every module of the port (and chip_smoke) in a fresh process."""
    script = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print('LOADED', ' '.join(m for m in sys.modules if m.startswith('repro_torch')))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    loaded = set(out.stdout.split("LOADED")[1].split())
    assert len(loaded) >= 60
    fl_slice = {f"repro_torch.{m}" for m in (
        "core.fwq", "core.gbd", "core.primal", "core.master", "core.baselines",
        "core.channel", "core.energy", "core.convergence", "data.synthetic",
        "data.partition", "data.pipeline", "faults.plan", "faults.executor",
        "dist.wire", "fed.simulation", "fed.orchestrator", "kernels.sr_quant",
        "models.cnn", "optim.optimizers", "optim.schedules", "launch.fl")}
    assert fl_slice <= loaded, sorted(fl_slice - loaded)
    ssm_slice = {f"repro_torch.models.{m}" for m in ("ssm", "ssm_lm", "hybrid")}
    assert ssm_slice <= loaded, sorted(ssm_slice - loaded)
    sweep_slice = {f"repro_torch.{m}" for m in (
        "sweep", "sweep.grid", "sweep.runner", "sweep.report", "sweep.cli", "analyze",
        "analyze.findings", "analyze.static_proofs")}
    assert sweep_slice <= loaded, sorted(sweep_slice - loaded)
    analyze_slice = {f"repro_torch.{m}" for m in (
        "__main__", "kernels.spec", "analyze.ranges", "analyze.precision_flow",
        "analyze.absint", "analyze.wire_lint", "analyze.kernel_check", "analyze.allowlist",
        "analyze.baseline", "analyze.runner", "analyze.cli")}
    assert analyze_slice <= loaded, sorted(analyze_slice - loaded)
