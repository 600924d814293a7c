"""Build and bind the port's CUDA kernels (nvcc by hand + ctypes).

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together (the log notes each file's compile time), and
the objects are linked into one shared library with a plain C interface.
The library lands in ``build/repro_torch_kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, and is built at first use,
never at import: this module imports on machines with no CUDA toolkit.  A
failed build raises with nvcc's output; nothing is downloaded and nothing
falls back.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

#: Element-type tags of the C launchers (csrc/common.cuh: enum DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3,
               torch.int32: 4}

#: Streaming multiprocessors of an H100 SXM (the plans' default).
H100_SMS = 132

#: Kernel launches by name since the last :func:`reset_launches`.
#: ``sr_quant`` counts K1's calls through any entry, ``sr_quant_inline`` and
#: ``sr_quant_keyed`` those of the trainer's inline entry and of the keyed
#: segment entry alone; ``sr_pack`` counts K2's calls through any entry (a
#: split call at its pass 2), ``sr_pack_keyed`` those of the keyed entry
#: alone, ``sr_pack_keyed_scales`` and ``sr_pack_keyed_scaled`` the keyed
#: entry's two passes split for a wire across ranks; ``philox`` is the
#: known-answer check's generator.
LAUNCHES = {"quant_matmul": 0, "flash_attention": 0, "flash_decode": 0, "sr_quant": 0,
            "sr_quant_inline": 0, "sr_quant_keyed": 0, "sr_pack": 0, "sr_pack_keyed": 0,
            "sr_pack_keyed_scales": 0, "sr_pack_keyed_scaled": 0, "philox": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint32
_SIGNATURES = {
    # x, x_dtype, codes, code_dtype, scale, out, M, K, N, stream,
    # then the plan (quant_matmul.plan): path, tile_m, tile_n, split
    "repro_quant_matmul": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I),
    # x_dtype, code_dtype, M, K, N, then the plan -> the shared memory a
    # block of that launch takes (quant_matmul.kernel_spec's smem_bytes)
    "repro_quant_matmul_smem": (_I,) * 9,
    # q, k, v, out, dtype, BH, S, D, causal, stream,
    # then the plan (flash_attention.plan_attention): path, block_q, block_k
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I),
    # q, q_dtype, k_pages, v_pages, pool_dtype, page_table, lengths,
    # acc, m, l, B, KV, G, hd, page, n_pmax, stream,
    # then the plan (flash_attention.plan_decode): split, pages_per_block, group
    "repro_flash_decode": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P, _I, _I, _I),
    # w, offsets, s, d, u, out, P, L, C, ste, stream
    "repro_sr_quant": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # w, n, nb, parts, delta, k0, k1, out, out_dtype, stream
    "repro_sr_quant_inline": (_P, _I, _I, _P, _P, _U, _U, _P, _I, _P),
    # ctr, key, out, n, stream
    "repro_philox4x32": (_P, _P, _P, _I, _P),
    # g, offsets, step, u, out, code_dtype, P, L, C, lim, stream
    "repro_sr_pack": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # off, blk, base (host arrays), L, parts, d, C, k0, k1, out, P (out's
    # columns), stream
    "repro_sr_quant_keyed": (_P, _P, _P, _I, _P, _P, _I, _U, _U, _P, _I, _P),
    # off, blk, base (host arrays), L, C, parts, k0, k1, lim, out, P (out's
    # columns), code_dtype, steps, bad, stream
    "repro_sr_pack_keyed": (_P, _P, _P, _I, _I, _P, _U, _U, _F, _P, _I, _I, _P, _P, _P),
    # K2's pass 1 alone: off, blk, base (host arrays), L, C, parts, fmax, bad,
    # stream
    "repro_sr_pack_keyed_scales": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    # K2's pass 2 given the scales: off, blk, base (host arrays), L, C, smax,
    # fmax, c0 (the first row's Philox stream), k0, k1, lim, out, P (out's
    # columns), code_dtype, steps, stream
    "repro_sr_pack_keyed_scaled": (_P, _P, _P, _I, _I, _P, _P, _I, _U, _U, _F, _P, _I, _I, _P,
                                   _P),
}

_lib = None
_build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels cannot be built on this machine")


def _source_hash(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source hash)."""
    sources = sorted(CSRC.glob("*.cu"))
    files = sources + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(files)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        _build_info.setdefault("seconds", 0.0)
        _build_info.setdefault("log", (out_dir / "build.log").read_text()
                               if (out_dir / "build.log").exists() else "")
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]

        def compile_one(src, obj):
            t = time.time()
            r = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                                str(obj)], capture_output=True, text=True)
            return r, time.time() - t

        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            runs = list(pool.map(compile_one, sources, objs))
        log, failed = [], []
        for src, (r, secs) in zip(sources, runs):
            log.append(f"== {src.name} (rc {r.returncode}, {secs:.1f} s)\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for obj in objs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib_path.exists():   # not a concurrent build that won
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    _build_info["seconds"] = time.time() - t0
    _build_info["log"] = (out_dir / "build.log").read_text()
    return lib_path


def build_info() -> dict:
    """``{"seconds": build wall time (0 if cached), "log": nvcc/ptxas output}``."""
    return dict(_build_info)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor a contiguous CUDA tensor on the current device."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensor on {t.device}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
