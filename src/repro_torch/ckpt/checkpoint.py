"""Fault-tolerant checkpointing: atomic, manifest-verified, resumable.

Counterpart of ``repro/ckpt/checkpoint.py``, in its format: one ``.npz`` per
checkpoint with flattened ``path -> array`` entries (packed weights as
``path@codes`` / ``path@scale``) plus a JSON manifest (step, time, extra,
and per leaf its shape, dtype name and a checksum).  dtypes numpy cannot
store (bfloat16, float8_e4m3fn) are written as a same-width unsigned integer
view under their own dtype name.  Writes go to a temp file and
``os.replace`` (atomic on POSIX): a crash mid-write never corrupts the
latest good checkpoint.

A state is a nested dict whose leaves are tensors or
:class:`~repro_torch.models.common.QTensor` — e.g. ``{"p": params, "o":
opt_state}``, with the port's flat parameter dicts keyed ``"blocks/attn/wq"``
— so the stored paths are the reference's.

Under a process group the state is sharded: :func:`gather_state` makes the
whole leaves (every rank takes part; rank 0 writes them: FSDP shards
gathered, model slices joined) and :func:`shard_state` slices a loaded state
to the rank's storage, so a checkpoint moves freely between a ``Dx1``,
``1xT`` or ``DxT`` run and the one-process loop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import QTensor

#: dtypes numpy's npz can't round-trip natively -> stored as a u16/u8 view
_VIEW_DTYPES = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
                torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8)}
_FROM_NAME = {name: (torch_dt, view) for torch_dt, (name, _np, view) in _VIEW_DTYPES.items()}


def _encode(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype in _VIEW_DTYPES:
        name, np_view, torch_view = _VIEW_DTYPES[t.dtype]
        return t.view(torch_view).numpy().view(np_view), name
    v = t.numpy()
    return v, str(v.dtype)


def _decode(v: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _FROM_NAME:
        torch_dt, torch_view = _FROM_NAME[dtype_name]
        signed = v.view(np.int16) if torch_view == torch.int16 else v
        return torch.from_numpy(np.array(signed, copy=True)).view(torch_dt)
    return torch.from_numpy(np.array(v, copy=True))


def _walk(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, keys sorted level by level."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: tuple(str(k).split("/"))):
            yield from _walk(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in _walk(tree):
        if isinstance(leaf, QTensor):
            flat[path + "@codes"] = leaf.codes
            flat[path + "@scale"] = leaf.scale
        else:
            flat[path] = torch.as_tensor(leaf)
    return flat


def save_checkpoint(directory: str, step: int, state: Any, *,
                    extra: dict | None = None, keep: int = 3) -> str:
    """Atomically write ``state`` (a nested dict of tensors) as checkpoint ``step``."""
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_{step:08d}"
    tmp = os.path.join(directory, f".{name}.tmp.npz")
    final = os.path.join(directory, f"{name}.npz")
    encoded, dtypes = {}, {}
    for k, v in _flatten(state).items():
        encoded[k], dtypes[k] = _encode(v)
    np.savez(tmp, **encoded)
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "leaves": {k: [list(v.shape), dtypes[k],
                       hashlib.sha1(v.tobytes()).hexdigest()[:16]]
                   for k, v in encoded.items()},
    }
    mtmp = os.path.join(directory, f".{name}.tmp.json")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)
    os.replace(mtmp, os.path.join(directory, f"{name}.json"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for f in ckpts[:-keep]:
        try:
            os.remove(os.path.join(directory, f))
            os.remove(os.path.join(directory, f.replace(".npz", ".json")))
        except OSError:
            pass


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any, *, step: int | None = None,
                    verify: bool = True):
    """Restore into the structure of ``template`` (each leaf on its
    template's device).  Returns ``(state, manifest)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    name = f"ckpt_{step:08d}"
    with np.load(os.path.join(directory, f"{name}.npz")) as zf:
        flat = {k: zf[k] for k in zf.files}
    with open(os.path.join(directory, f"{name}.json")) as f:
        manifest = json.load(f)
    if verify:
        for k, (shape, _dtype, sha) in manifest["leaves"].items():
            v = flat[k]
            if list(v.shape) != shape:
                raise ValueError(f"checkpoint leaf {k} shape mismatch")
            if hashlib.sha1(v.tobytes()).hexdigest()[:16] != sha:
                raise ValueError(f"checkpoint leaf {k} checksum mismatch")
    dtypes = {k: v[1] for k, v in manifest["leaves"].items()}

    def load(path: str, like: torch.Tensor) -> torch.Tensor:
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        return _decode(flat[path], dtypes[path]).to(like.device)

    def rebuild(node, prefix: str):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, QTensor):
            return QTensor(load(prefix + "@codes", node.codes),
                           load(prefix + "@scale", node.scale))
        return load(prefix, torch.as_tensor(node))

    return rebuild(template, ""), manifest


def _fsdp_dims(params: dict, axes) -> dict:
    from repro_torch.models.common import fsdp_plan

    paths, _leaves, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
    return dict(zip(paths, plan))


def _map_params(state, paths, fn):
    """``state`` with ``fn(leaf, path)`` applied to every leaf keyed by one
    of the parameters' ``paths`` (the parameters and any optimizer moments
    of them), at any depth."""
    if not isinstance(state, dict):
        return state
    return {k: (fn(v, k) if k in paths and not isinstance(v, dict)
                else _map_params(v, paths, fn)) for k, v in state.items()}


def _model_layout(params: dict, axes, cfg) -> tuple[dict, dict]:
    """``(specs, whole)``: each parameter's spec on the launch's layout and
    its ``tp = 1`` shape (the whole model's, without the vocabulary's
    padding to the model axis)."""
    import torch as _torch

    from repro_torch.dist.sharding import tree_param_specs
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import attn_dims

    whole = build_model(cfg).init(_torch.Generator().manual_seed(0), 1, device="meta")
    kv = attn_dims(cfg, axes.tp).kv_sharded if cfg.n_kv_heads else True
    return tree_param_specs(params, cfg, axes, 1, kv), {p: tuple(w.shape)
                                                         for p, w in whole.items()}


def gather_state(state, params: dict, axes, cfg=None):
    """The whole-leaf state from a rank's sharded one (``params``: the
    rank's parameters, which say which keys are FSDP leaves): the FSDP
    shards gathered over the batch group, then on a model axis above 1
    (``cfg`` the model's config) the model slices joined over the model
    group and trimmed to the ``tp = 1`` shapes, so the state is the
    one-process model's.  A collective: every rank calls it.  Without a
    group, ``state`` itself."""
    from repro_torch.dist.sharding import _model_dims
    from repro_torch.models.common import gather_leaf

    if axes.transport is not None:
        dims = _fsdp_dims(params, axes)
        state = _map_params(state, {p for p, d in dims.items() if d is not None},
                            lambda w, p: gather_leaf(w, dims[p], axes))
    if axes.model_transport is None:
        return state
    specs, whole = _model_layout(params, axes, cfg)

    def join(w, path):
        for d in _model_dims(specs[path], axes.model_axis):
            w = axes.model_transport.all_gather(w.movedim(d, 0).contiguous())
            w = w[:whole[path][d]].movedim(0, d).contiguous()
        return w
    return _map_params(state, {p for p, sp in specs.items()
                               if _model_dims(sp, axes.model_axis)}, join)


def shard_state(state, params: dict, axes, cfg=None):
    """A loaded whole-leaf state sliced to the rank's storage (the inverse
    of :func:`gather_state`): on a model axis above 1 each leaf cut to the
    rank's model slice (:func:`repro_torch.dist.sharding.cut_model`), then
    to its FSDP shard; without a group, ``state`` itself."""
    from repro_torch.dist.sharding import cut_model
    from repro_torch.models.common import shard_leaf

    if axes.model_transport is not None:
        specs, _whole = _model_layout(params, axes, cfg)
        state = _map_params(state, set(specs), lambda w, p: cut_model(
            {p: w}, {p: specs[p]}, axes, axes.tp_index())[p])
    if axes.transport is None:
        return state
    dims = _fsdp_dims(params, axes)
    return _map_params(state, {p for p, d in dims.items() if d is not None},
                       lambda w, p: shard_leaf(w, dims[p], axes))


@dataclasses.dataclass
class CheckpointManager:
    """Save-every-k with resume; the orchestrator's persistence handle."""

    directory: str
    every: int = 10
    keep: int = 3

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_save` writes at ``step``."""
        return bool(self.every) and step % self.every == 0

    def maybe_save(self, step: int, state: Any, extra: dict | None = None):
        if self.due(step):
            return save_checkpoint(self.directory, step, state,
                                   extra=extra, keep=self.keep)
        return None

    def restore_or(self, template: Any, default_extra: dict | None = None,
                   *, expect_extra: dict | None = None):
        """(state, step, extra) from the latest checkpoint, or the template.

        ``expect_extra``: keys that must match the saved manifest's extra
        (when present there), e.g. the fault plan a resumable FL run was
        started with.  A mismatch raises instead of splicing two different
        trajectories into one "resumed" run.
        """
        step = latest_step(self.directory)
        if step is None:
            return template, 0, dict(default_extra or {})
        state, manifest = load_checkpoint(self.directory, template, step=step)
        extra = manifest.get("extra", {})
        for k, v in (expect_extra or {}).items():
            if k in extra and extra[k] != v:
                raise ValueError(
                    f"checkpoint in {self.directory} was written with "
                    f"{k}={extra[k]!r} but this run expects {k}={v!r}; "
                    "refusing to resume a different trajectory")
        return state, manifest["step"], extra
