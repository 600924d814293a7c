"""Continuous-batching quantized serving CLI of the port — a thin shim over
:class:`repro_torch.api.Session`.

The model is packed once (:class:`QTensor` int8 codes + scale) and, with a
lazy :class:`~repro_torch.api.PrecisionPolicy`, every projection reads the
packed bytes through the ``quant_matmul`` kernel; prefill attention runs the
flash-attention kernel and paged decode the flash-decode kernel
(``--attn-impl flash``).  Runs on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --s-max 256 --prompt-len 128 --attn-impl flash --device cuda

``--mesh Dx1`` splits the batch into D data shards, each on its own slots,
caches and page pool; in one process they run one after another on the
device.  Launched by torchrun, each of the D processes is one shard: it
holds its FSDP slice of the packed weights, every rank runs the one host
scheduler, the sampled tokens are all-gathered, and rank 0 prints.
``--mesh DxT`` with T > 1 (tensor parallelism, every family) runs only
under torchrun, D*T processes, one model shard of one data shard each (in
one process it raises).  ``--backend`` is ``nccl`` on CUDA (one
card a rank) and ``gloo`` on the CPU; ``--share-device`` puts every rank on
``cuda:0`` and needs ``gloo``::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh 2x1 \
        --arch yi-6b --smoke --steps 24 --batch 4 --s-max 32 --attn-impl flash
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --backend gloo --mesh 2x1 \
        --arch yi-6b --smoke --steps 24 --batch 4 --s-max 32 --attn-impl flash
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --backend gloo --mesh 1x4 \
        --arch glm4-9b --smoke --steps 24 --batch 4 --s-max 32 --attn-impl flash
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --backend gloo --mesh 1x4 \
        --arch mamba2-780m --smoke --steps 24 --batch 4 --s-max 32
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --backend gloo --mesh 2x2 \
        --arch seamless-m4t-large-v2 --smoke --steps 24 --batch 4 --s-max 32 --attn-impl flash
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --backend gloo --share-device --mesh 1x4 \
        --arch yi-6b --batch 4 --s-max 256 --prompt-len 128 --attn-impl flash
"""

from __future__ import annotations

import argparse
import json

from repro_torch.api.session import BOS_ID, ServeStats  # noqa: F401  (re-export)


def run_serve(arch: str, *, smoke: bool = True, steps: int = 32, batch: int = 4,
              s_max: int = 64, prompt_len: int = 8, serve_bits: int = 7,
              attn_impl: str = "ref", mesh: str = "1x1", seed: int = 0,
              requests: int | None = None, max_new: int | None = None,
              kv_layout: str | None = None, page_size: int | None = None,
              pool_pages: int | None = None, vary_prompt: bool = False,
              precision_program=None, kv_bits: int = 32,
              quiet: bool = False, device=None) -> ServeStats:
    """Builds a RunSpec and drives ``Session.serve`` on ``device`` (CUDA by
    default) over ``mesh`` (``Dx1``: D data shards of ``batch // D`` slots).

    ``DxT`` with T > 1 runs one mesh device a rank under torchrun.
    ``serve_bits >= 32`` serves raw f32 weights; ``< 32`` maps to a lazy
    packed :class:`~repro_torch.api.PrecisionPolicy` (int8/int16 ``QTensor``
    storage, ``quant_matmul`` path).  ``precision_program`` plus
    ``kv_bits=32`` arms the paged-KV watermark (f32 pools demote to bf16
    when pool pressure crosses the program's ``kv_watermark``).
    """
    from repro_torch.api import PrecisionPolicy, RunSpec, Session

    precision = (PrecisionPolicy(weights=serve_bits, lazy=True, kv_cache=kv_bits)
                 if serve_bits < 32
                 else PrecisionPolicy.full_precision(kv_cache=kv_bits))
    options = {"steps": steps, "s_max": s_max, "prompt_len": prompt_len,
               "attn_impl": attn_impl, "requests": requests,
               "max_new": max_new, "quiet": quiet}
    if kv_layout is not None:
        options["kv_layout"] = kv_layout
    if page_size is not None:
        options["page_size"] = page_size
    if pool_pages is not None:
        options["pool_pages"] = pool_pages
    if vary_prompt:
        options["vary_prompt"] = True
    if precision_program is not None:
        options["precision_program"] = precision_program
    spec = RunSpec(arch=arch, workload="serve", mesh=mesh, smoke=smoke, seed=seed,
                   batch=batch, seq=s_max, precision=precision, options=options)
    return Session(spec, device=device).serve()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--serve-bits", "--bits", dest="serve_bits", type=int,
                    default=7, help="serving bit-width (<=7: int8, "
                    "8..15: int16, >=32: f32 baseline)")
    ap.add_argument("--attn-impl", choices=("ref", "flash"), default="ref",
                    help="attention: plain PyTorch reference or the flash kernels")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: the batch in D data shards (one a rank under "
                         "torchrun); MODEL > 1 splits the model over T ranks (torchrun only: "
                         "D*T ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=None,
                    help="queue size (default 2x batch)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="upper bound on per-request generation length")
    ap.add_argument("--kv-layout", choices=("paged", "contiguous"), default=None,
                    help="KV-cache layout (default: paged)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="shared page-pool size (default: the batch largest "
                    "queued requests)")
    ap.add_argument("--vary-prompt", action="store_true",
                    help="draw ragged prompt lengths (exercises the "
                    "prompt-length buckets)")
    ap.add_argument("--kv-bits", type=int, choices=(16, 32), default=32,
                    help="KV-cache storage: 32 = f32, 16 = bf16")
    ap.add_argument("--precision-program", default="",
                    help="adaptive precision controller (kind name or JSON "
                    "config), e.g. '{\"kind\": \"constant\", \"kv_watermark\": 0.9}'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card) or cpu; under "
                         "torchrun 'cpu' or the rank's card")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torchrun only: the process group's backend (default: nccl on "
                         "CUDA, gloo on the CPU)")
    ap.add_argument("--share-device", action="store_true",
                    help="torchrun only: every rank on cuda:0 (needs --backend gloo)")
    args = ap.parse_args(argv)
    program = None
    if args.precision_program:
        pp = args.precision_program
        program = json.loads(pp) if pp.lstrip().startswith("{") else pp
    from repro_torch.launch.mesh import cli_device

    with cli_device(args.backend, args.device, share_device=args.share_device) as device:
        return run_serve(
            args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
            s_max=args.s_max, prompt_len=args.prompt_len,
            serve_bits=args.serve_bits, attn_impl=args.attn_impl, mesh=args.mesh,
            seed=args.seed, requests=args.requests, max_new=args.max_new,
            kv_layout=args.kv_layout, page_size=args.page_size,
            pool_pages=args.pool_pages, vary_prompt=args.vary_prompt,
            precision_program=program, kv_bits=args.kv_bits, device=device)


if __name__ == "__main__":
    main()
