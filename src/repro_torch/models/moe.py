"""Mixture-of-Experts block: sort-based, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``, step for step:

  1. route every token with an f32 router (used through ``pc.use_small``:
     never quantized), softmax, top-k, gates renormalised;
  2. sort the flat (token, expert) assignments by expert id (stable), rank
     each within its expert, and keep the first ``capacity`` of each;
  3. scatter the kept tokens into an ``(e_local, capacity + 1, d)`` buffer
     whose last slot takes every dropped assignment and is discarded;
  4. run the expert FFN over the stacks through
     :func:`~repro_torch.kernels.ops.expert_dispatch` (one K3 launch an
     expert when the stacks are packed);
  5. gather each assignment's output back, weighted by its gate, and sum a
     token's k outputs.

The sum in step 5 is a gather, not a scatter-add: each token's k outputs
are added from zero in increasing expert id, the order in which the
reference's ``.at[tok].add`` applies them on the CPU.  ``index_add_`` on
CUDA adds with float atomics in no fixed order, so two runs would differ.

One device: ``tp = 1``, every expert is local, and ``sp_out`` is the
identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamCtx, init_dense
from repro_torch.models.layers import sp_out


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    k: int
    d_model: int
    d_ff: int                 # per-expert hidden
    tp: int
    capacity_factor: float = 1.25
    act: str = "swiglu"

    @property
    def e_local(self) -> int:
        if self.n_experts % self.tp:
            raise ValueError(f"{self.n_experts} experts do not divide over tp={self.tp}")
        return self.n_experts // self.tp

    def capacity(self, n_tokens: int) -> int:
        cap = int(n_tokens * self.k * self.capacity_factor / self.n_experts) + 1
        return max(cap, 4)


def init_moe(gen: torch.Generator, dims: MoEDims, *, lead=(), device=None,
             dtype=torch.float32) -> dict:
    """``{"router", "w_up", "w_down"[, "w_gate"]}``: the router ``lead + (d,
    n_experts)`` in f32, the expert stacks ``lead + (e_local, d, f)``."""
    e, d, f = dims.e_local, dims.d_model, dims.d_ff
    stack = tuple(lead) + (e,)
    kw = {"device": device, "dtype": dtype}
    p = {
        "router": init_dense(gen, d, dims.n_experts, lead=lead, device=device),
        "w_up": init_dense(gen, d, f, lead=stack, **kw),
        "w_down": init_dense(gen, f, d, lead=stack, **kw),
    }
    if dims.act in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(gen, d, f, lead=stack, **kw)
    return p


def moe_block(pc: ParamCtx, path: str, p, x, dims: MoEDims):
    """x: (B, S, D) -> (y (B, S, D), {"router_probs_mean": (n_experts,)})."""
    B, S, D = x.shape
    T = B * S
    k = dims.k
    xt = x.reshape(T, D)

    # --- routing (f32, not quantized) -------------------------------------
    router = pc.use_small(f"{path}/router", p["router"]).to(torch.float32)
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)                  # (T, k), descending
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # --- local assignment grouping ----------------------------------------
    e_lo = pc.ctx.tp_index() * dims.e_local
    flat_e = ids.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]                                         # sorted expert ids
    tok = order // k                                           # source token
    gw = gate.reshape(-1)[order]                               # gate weight
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=x.device) - first         # rank within expert
    cap = dims.capacity(T)
    local = se - e_lo
    valid = (local >= 0) & (local < dims.e_local) & (pos < cap)
    le = torch.where(valid, local, 0)
    lp = torch.where(valid, pos, cap)                          # the trash slot

    # Dropped assignments all land on the trash slot (duplicate indices);
    # their values are zeros and the slot is cut off, so no result and no
    # gradient reads them.
    buf = torch.zeros((dims.e_local, cap + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((le, lp), torch.where(valid[:, None], xt[tok], 0))
    buf = buf[:, :cap]                                         # (e_loc, cap, D)

    # --- expert FFN -------------------------------------------------------
    up = ops.expert_dispatch(buf, pc.use(f"{path}/w_up", p["w_up"]), x.dtype)
    if dims.act in ("swiglu", "geglu"):
        g = ops.expert_dispatch(buf, pc.use(f"{path}/w_gate", p["w_gate"]), x.dtype)
        h = (F.silu(g) if dims.act == "swiglu" else F.gelu(g, approximate="tanh")) * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = ops.expert_dispatch(h, pc.use(f"{path}/w_down", p["w_down"]), x.dtype)

    # --- un-dispatch + combine (a gather, in increasing expert id) ----------
    out = F.pad(out, (0, 0, 0, 1))                             # the trash row back
    ys = out[le, lp] * torch.where(valid, gw, 0.0)[:, None].to(x.dtype)
    inv = torch.argsort(order)                                 # flat slot -> sorted row
    rows = ys[inv.reshape(T, k).sort(dim=-1).values]           # (T, k, D), by expert id
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + rows[:, j]
    y = sp_out(pc, y.reshape(B, S, D))
    return y, {"router_probs_mean": probs.mean(dim=0)}
