"""Mesh-spec parsing, the process group and the axis context of a launch.

Counterpart of ``repro/launch/mesh.py``.  The port runs a ``Dx1`` mesh: ``D``
data-parallel groups (the FL clients) and a model axis of size 1, either in
one process (the clients run in a loop on one device) or as ``D`` processes
of a ``torch.distributed`` group, one client a rank (:func:`init_distributed`
reads torchrun's environment).  There is no device mesh object; the spec
string gives the axis sizes and :func:`axis_ctx_for` the :class:`AxisCtx`
that carries them and, under a group, its
:class:`~repro_torch.dist.collectives.Transport`.  A model axis larger than 1
raises (tensor parallelism is not ported).
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.dist.collectives import AxisCtx, Transport

BACKENDS = ("nccl", "gloo")

_AXES_FOR_RANK = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DATAxMODEL"`` / ``"PODxDATAxMODEL"`` -> (shape, axis names)."""
    shape = tuple(int(x) for x in str(spec).lower().split("x"))
    if len(shape) not in _AXES_FOR_RANK:
        raise ValueError(f"mesh spec {spec!r} must have 1-3 'x'-separated dims")
    return shape, _AXES_FOR_RANK[len(shape)]


def axis_ctx_for(spec: str, group=None) -> AxisCtx:
    """The :class:`AxisCtx` of a mesh spec: batch (and FSDP) axes ``("pod",
    "data")`` or ``("data",)``, the model axis if named, and their sizes.
    ``group``: a ``torch.distributed`` process group (``"default"`` for the
    initialized default group) whose ranks are the mesh's clients; its size
    must be the mesh's data-parallel size."""
    shape, names = parse_mesh(spec)
    batch = ("pod", "data") if "pod" in names else ("data",)
    model = "model" if "model" in names else None
    if dict(zip(names, shape)).get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {spec!r}: a model axis > 1 (tensor parallelism) is not ported; "
            "the port runs Dx1 meshes (ROADMAP queue 1, item 9)")
    sizes = tuple(zip(names, shape))
    if group is None:
        return AxisCtx(batch_axes=batch, model_axis=model, fsdp_axes=batch, sizes=sizes)
    transport = Transport(None if group == "default" else group)
    dp = 1
    for name, n in sizes:
        dp *= n if name in batch else 1
    if transport.size != dp:
        raise ValueError(f"mesh {spec!r} has {dp} data-parallel groups but the process group "
                         f"has {transport.size} ranks (WORLD_SIZE); a Dx1 mesh wants D ranks")
    return AxisCtx(batch_axes=batch, model_axis=model, fsdp_axes=batch, sizes=sizes,
                   client=transport.rank, transport=transport)


def launched_ranks() -> int | None:
    """``WORLD_SIZE`` of torchrun's environment, or None outside one."""
    n = os.environ.get("WORLD_SIZE")
    return int(n) if n else None


def rank_device(device: str | None, *, share_device: bool = False) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (``cuda:0`` for every rank
    with ``share_device``), or the CPU when ``device`` says ``"cpu"``."""
    if device is not None and torch.device(device).type == "cpu":
        if share_device:
            raise ValueError("--share-device puts every rank on one card; it does not "
                             "apply to --device cpu")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() is false; pass "
                           "--device cpu to run the ranks on the CPU")
    index = 0 if share_device else int(os.environ.get("LOCAL_RANK", "0"))
    if index >= torch.cuda.device_count():
        raise ValueError(f"LOCAL_RANK {index} has no card: {torch.cuda.device_count()} "
                         "visible (--share-device puts every rank on cuda:0, over gloo)")
    return torch.device("cuda", index)


def check_backend(backend: str, device: str | None, world: int, *,
                  share_device: bool = False) -> None:
    """Refuse what a backend cannot do, before any rendezvous: NCCL wants
    CUDA and one card a rank (it refuses two ranks on one GPU), gloo takes
    both.  Nothing falls back from one backend to the other."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if device is not None and torch.device(device).type == "cpu":
        raise ValueError("backend nccl runs on CUDA tensors only; use --backend gloo with "
                         "--device cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if share_device and world > 1:
        raise ValueError(f"backend nccl cannot put {world} ranks on one card (NCCL refuses a "
                         "duplicate GPU); use --backend gloo with --share-device")
    if world > cards:
        raise ValueError(f"backend nccl needs one card a rank: {world} ranks, {cards} "
                         "card(s); use --backend gloo")


def init_distributed(backend: str | None = None, device: str | None = None, *,
                     share_device: bool = False, init_method: str | None = None):
    """Join the process group torchrun's environment names (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, or
    ``init_method``) and return this rank's device.  ``backend`` defaults
    to ``nccl`` on CUDA and ``gloo`` on the CPU; :func:`check_backend`
    refuses what it cannot do."""
    import torch.distributed as dist

    world = launched_ranks()
    if world is None:
        raise RuntimeError("init_distributed: WORLD_SIZE is not set; launch the ranks with "
                           "torchrun (python -m torch.distributed.run)")
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    check_backend(backend, device, world, share_device=share_device)
    dev = rank_device(device, share_device=share_device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]), world_size=world, **kw)
    return dev


@contextlib.contextmanager
def cli_device(backend: str | None, device: str | None, *, share_device: bool = False):
    """The device a CLI runs on: ``device`` outside torchrun (where
    ``backend`` and ``share_device`` are refused), else this rank's, the
    process group joined for the block (:func:`init_distributed`) and
    destroyed after it."""
    if launched_ranks() is None:
        if backend or share_device:
            raise ValueError("--backend and --share-device apply to the ranks torchrun starts "
                             "(WORLD_SIZE is not set)")
        yield device
        return
    import torch.distributed as dist

    dev = init_distributed(backend, device, share_device=share_device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
