"""End-to-end FWQ-FL training CLI — a thin shim over :class:`repro_torch.api.Session`.

Maps the paper's loop onto a ``Dx1`` mesh on one device: each data-parallel
group is an FL client; every round the GBD co-design picks per-client
bit-widths from the simulated channel and device fleet (``--scheme fixed``
skips it and trains at ``--bits``); one train step quantizes each client's
weights (K1), takes the clients' gradients and reduces them, the replicated
leaves through the SR-quantized wire at ``--grad-compression-bits`` (K2).
Checkpoints land every 10 rounds in ``--ckpt-dir`` and a rerun resumes.  Runs on
CUDA unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch yi-6b \\
        --smoke --mesh 2x1 --rounds 3 --grad-compression-bits 8

Launched by torchrun, each of the D processes is one client of a ``Dx1`` mesh
(the process group's rendezvous from torchrun's environment): it holds its
FSDP shards, quantizes its gathered weights under its own keys, and the
gradients are reduced across the ranks (the SR wire through K2's two passes
and one integer all-reduce).  ``--backend`` is ``nccl`` on CUDA (one card a
rank, ``cuda:LOCAL_RANK``) and ``gloo`` on the CPU; ``--share-device`` puts
every rank on ``cuda:0`` and needs ``gloo``::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --device cpu --backend gloo --arch yi-6b --smoke \\
        --mesh 2x1 --rounds 3 --grad-compression-bits 8
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --share-device --backend gloo --arch yi-6b --smoke \\
        --mesh 4x1 --rounds 3 --grad-compression-bits 8

A ``1xT`` or ``DxT`` mesh (tensor parallelism) runs D*T ranks, one a mesh
device: rank r is client ``r // T`` and model shard ``r % T``, holding its
shard's slices of the weights (FSDP-sharded over its client's batch group
on ``DxT``), under Megatron sequence parallelism; in one process such a
mesh raises, naming torchrun::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --device cpu --backend gloo --arch yi-6b --smoke \\
        --mesh 1x2 --rounds 3
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --backend gloo --arch yi-6b --smoke \\
        --mesh 2x2 --rounds 3 --grad-compression-bits 8
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: Dx1 runs D clients on one device (or one a rank "
                         "under torchrun); a model axis above 1 needs D*T ranks")
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--scheme", default="fwq",
                    choices=["fwq", "full_precision", "unified_q", "rand_q",
                             "fixed"])
    ap.add_argument("--bits", type=int, default=32,
                    help="fixed weight bit-width (--scheme fixed only)")
    ap.add_argument("--grad-compression-bits", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card); under "
                         "torchrun 'cpu' or the rank's card")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torchrun only: the process group's backend (default: nccl on "
                         "CUDA, gloo on the CPU)")
    ap.add_argument("--share-device", action="store_true",
                    help="torchrun only: every rank on cuda:0 (needs --backend gloo)")
    args = ap.parse_args(argv)

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.launch.mesh import cli_device

    logging.basicConfig(level=logging.INFO)
    comm = args.grad_compression_bits or 32
    if args.scheme == "fixed":
        workload = "train"
        precision = PrecisionPolicy.uniform(args.bits, comm=comm)
    else:
        workload = "fl-orchestrate"
        precision = PrecisionPolicy(comm=comm)
    spec = RunSpec(
        arch=args.arch, workload=workload, mesh=args.mesh, smoke=args.smoke,
        seed=args.seed, batch=args.batch, seq=args.seq, rounds=args.rounds,
        precision=precision,
        options={"scheme": args.scheme, "lr": args.lr,
                 "ckpt_dir": args.ckpt_dir, "out": args.out})
    with cli_device(args.backend, args.device, share_device=args.share_device) as device:
        return Session(spec, device=device).run()


if __name__ == "__main__":
    main()
