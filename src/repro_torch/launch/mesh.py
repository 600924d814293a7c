"""Mesh-spec parsing, the process group and the axis context of a launch.

Counterpart of ``repro/launch/mesh.py``.  A ``Dx1`` mesh has ``D``
data-parallel groups (the FL clients) and a model axis of size 1, run either
in one process (the clients in a loop on one device) or as ``D`` processes of
a ``torch.distributed`` group, one client a rank (:func:`init_distributed`
reads torchrun's environment).  A ``DxT`` mesh with ``T > 1`` (tensor
parallelism) runs only as ``D * T`` processes, one a mesh device: model
shards meet inside every layer, so they cannot run in a loop, and in one
process such a mesh raises; only its dry run traces one device of it in one
process (:func:`trace_axis_ctx`).  Rank ``r`` is data index ``r // T`` and model
index ``r % T``, ``jax.make_mesh((D, T))``'s device order (data-major).
There is no device mesh object; the spec string gives the axis sizes and
:func:`axis_ctx_for` the :class:`AxisCtx` that carries them and, under a
group, a :class:`~repro_torch.dist.collectives.Transport` over each of the
rank's groups: its model group (the T ranks of its data row) and its batch
group (the D ranks of its model column).
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.dist.collectives import (AxisCtx, TraceTransport, Transport,
                                          one_process_tp_message)

BACKENDS = ("nccl", "gloo")

_AXES_FOR_RANK = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DATAxMODEL"`` / ``"PODxDATAxMODEL"`` -> (shape, axis names)."""
    shape = tuple(int(x) for x in str(spec).lower().split("x"))
    if len(shape) not in _AXES_FOR_RANK:
        raise ValueError(f"mesh spec {spec!r} must have 1-3 'x'-separated dims")
    return shape, _AXES_FOR_RANK[len(shape)]


def mesh_ranks(D: int, T: int) -> tuple[list, list]:
    """``(model_groups, batch_groups)`` of a ``DxT`` mesh's ranks: data row
    ``d``'s model group ``[d*T, ..., d*T + T - 1]`` and model column ``t``'s
    batch group ``[t, T + t, ..., (D - 1)*T + t]`` (rank ``r`` is device
    ``r`` of ``jax.make_mesh((D, T))``: data index ``r // T``, model index
    ``r % T``)."""
    return ([[d * T + t for t in range(T)] for d in range(D)],
            [[d * T + t for d in range(D)] for t in range(T)])


def _axes_of(spec: str) -> tuple[dict, int, int]:
    """``(AxisCtx keywords, D, T)`` of a mesh spec: the batch (and FSDP)
    axes ``("pod", "data")`` or ``("data",)``, the model axis if named, and
    their sizes; ``D`` is the batch axes' product, ``T`` the model axis."""
    shape, names = parse_mesh(spec)
    batch = ("pod", "data") if "pod" in names else ("data",)
    sizes = tuple(zip(names, shape))
    D = 1
    for name, n in sizes:
        D *= n if name in batch else 1
    kw = dict(batch_axes=batch, model_axis="model" if "model" in names else None,
              fsdp_axes=batch, sizes=sizes)
    return kw, D, dict(sizes).get("model", 1)


def trace_axis_ctx(spec: str) -> AxisCtx:
    """The axis context of one traced device of a mesh: data index 0 and
    model index 0, with no process group.  A model axis of T > 1 is a
    :class:`~repro_torch.dist.collectives.TraceTransport` of T ranks, so the
    model collectives record what the device issues; the batch axes keep
    their sizes, and the step records its batch collectives itself
    (:mod:`repro_torch.roofline.count`).  Only a traced step (fake tensors)
    runs on it; :func:`axis_ctx_for` without a group still raises for
    T > 1."""
    kw, _D, T = _axes_of(spec)
    return AxisCtx(**kw, model_transport=TraceTransport(T) if T > 1 else None)


def axis_ctx_for(spec: str, group=None) -> AxisCtx:
    """The :class:`AxisCtx` of a mesh spec: batch (and FSDP) axes ``("pod",
    "data")`` or ``("data",)``, the model axis if named, and their sizes.
    ``group``: a ``torch.distributed`` process group (``"default"`` for the
    initialized default group) whose ranks are the mesh's devices, in
    :func:`mesh_ranks`' order; its size must be the mesh's ``D * T``.  A
    model axis larger than 1 needs the group (it raises without one).

    Under a ``DxT`` group with both axes above 1 every rank creates every
    model and batch subgroup, in the same order (``new_group`` is collective
    over the whole group: a rank that skipped one would hang the others),
    and keeps the two it belongs to."""
    kw, D, T = _axes_of(spec)
    if group is None:
        if T > 1:
            raise ValueError(one_process_tp_message(T, spec))
        return AxisCtx(**kw)
    import torch.distributed as dist

    whole = None if group == "default" else group
    world = dist.get_world_size(whole)
    if world != D * T:
        raise ValueError(f"mesh {spec!r} has {D}x{T} = {D * T} devices but the process group "
                         f"has {world} ranks (WORLD_SIZE); a DxT mesh wants D*T ranks, one a "
                         "device")
    if T == 1:
        transport = Transport(whole)
        return AxisCtx(**kw, client=transport.rank, transport=transport)
    rank = dist.get_rank(whole)
    if D == 1:
        return AxisCtx(**kw, model_rank=rank, model_transport=Transport(whole))
    members = (dist.get_process_group_ranks(whole) if whole is not None
               else list(range(world)))
    model_groups, batch_groups = mesh_ranks(D, T)
    mine: dict = {}
    for kind, groups in (("model", model_groups), ("batch", batch_groups)):
        for ranks in groups:
            g = dist.new_group([members[r] for r in ranks])
            if rank in ranks:
                mine[kind] = g
    return AxisCtx(**kw, client=rank // T, transport=Transport(mine["batch"]),
                   model_rank=rank % T, model_transport=Transport(mine["model"]))


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
