"""CIFAR-class CNNs of the paper's own evaluation (§5.1), in PyTorch.

The reference's reduced-depth ResNet and MobileNet with the same parameter
paths, the same arithmetic and NHWC images at the public functions.  The
port stores conv kernels in PyTorch's ``(out, in/groups, kh, kw)`` layout
(the reference keeps HWIO; :func:`repro_torch.models.convert.cnn_params_from_jax`
converts) and runs the convolutions channels-first inside ``apply``.

* ``resnet(...)``  — post-activation residual blocks with GroupNorm (batch
  statistics do not cross FL client boundaries).
* ``mobilenet()``  — depthwise-separable stacks.

Parameters are flat dicts ``{"stem/w": Tensor, "s0b0/conv1": Tensor, ...}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``(before, after)``.  At
    stride 2 on an even size it pads 0 before and 1 after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1):
    """NCHW ``x`` with an OIHW kernel, "SAME" padding as the reference."""
    kh, kw = w.shape[2], w.shape[3]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride, groups=groups)


def _init_conv(gen, device, kh, kw, cin, cout, groups=1):
    """Truncated normal on [-2, 2] times ``sqrt(2 / fan_in)``, OIHW."""
    fan = kh * kw * cin // groups
    w = torch.empty((cout, cin // groups, kh, kw), device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * math.sqrt(2.0 / fan)


def _groupnorm(x, scale, bias, groups=8, eps=1e-5):
    """GroupNorm over NCHW ``x``: ``g = min(groups, C)``, lowered until it
    divides C; population variance, as the reference.

    The variance is the reference's ``mean((x - mu)^2)`` about the same ``mu``
    that centres ``x``, so no normalised value exceeds sqrt(group size).  A
    separate reduction (``torch.var``) gives 0 on a group of equal values
    while ``x - mu`` holds the mean's rounding error, which ``rsqrt(eps)``
    then scales by 316."""
    B, C, H, W = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(B, g, C // g, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    xc = xg - mu
    var = (xc * xc).mean(dim=(2, 3, 4), keepdim=True)
    xn = (xc * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    return xn * scale[None, :, None, None] + bias[None, :, None, None]


@dataclasses.dataclass(frozen=True)
class CNNModel:
    init: Callable        # (generator, device) -> params
    apply: Callable       # (params, images NHWC) -> logits
    name: str


def _head(gen, device, cin, n_classes):
    return {"head/w": torch.randn((cin, n_classes), generator=gen, device=device) * 0.01,
            "head/b": torch.zeros((n_classes,), device=device)}


def resnet(depth_blocks=(2, 2, 2, 2), width=32, n_classes=10) -> CNNModel:
    """Reduced ResNet (ResNet-34 uses (3,4,6,3) at width 64)."""

    widths = [width * (2**i) for i in range(len(depth_blocks))]

    def init(gen: torch.Generator, device=None):
        device = device if device is not None else gen.device
        p = {"stem/w": _init_conv(gen, device, 3, 3, 3, widths[0]),
             "stem/gn_s": torch.ones((widths[0],), device=device),
             "stem/gn_b": torch.zeros((widths[0],), device=device)}
        cin = widths[0]
        for si, (blocks, cout) in enumerate(zip(depth_blocks, widths)):
            for bi in range(blocks):
                b = f"s{si}b{bi}/"
                p[b + "conv1"] = _init_conv(gen, device, 3, 3, cin, cout)
                p[b + "gn1_s"] = torch.ones((cout,), device=device)
                p[b + "gn1_b"] = torch.zeros((cout,), device=device)
                p[b + "conv2"] = _init_conv(gen, device, 3, 3, cout, cout)
                p[b + "gn2_s"] = torch.ones((cout,), device=device)
                p[b + "gn2_b"] = torch.zeros((cout,), device=device)
                if cin != cout:
                    p[b + "proj"] = _init_conv(gen, device, 1, 1, cin, cout)
                cin = cout
        p.update(_head(gen, device, cin, n_classes))
        return p

    def apply(params, images):
        x = images.permute(0, 3, 1, 2)
        x = _conv(x, params["stem/w"])
        x = F.relu(_groupnorm(x, params["stem/gn_s"], params["stem/gn_b"]))
        for si, blocks in enumerate(depth_blocks):
            for bi in range(blocks):
                b = f"s{si}b{bi}/"
                stride = 2 if (bi == 0 and si > 0) else 1
                h = _conv(x, params[b + "conv1"], stride)
                h = F.relu(_groupnorm(h, params[b + "gn1_s"], params[b + "gn1_b"]))
                h = _conv(h, params[b + "conv2"])
                h = _groupnorm(h, params[b + "gn2_s"], params[b + "gn2_b"])
                sc = x
                if b + "proj" in params:
                    sc = _conv(x, params[b + "proj"], stride)
                elif stride != 1:
                    sc = x[:, :, ::stride, ::stride]
                x = F.relu(h + sc)
        x = x.mean(dim=(2, 3))
        return x @ params["head/w"] + params["head/b"]

    return CNNModel(init=init, apply=apply, name=f"resnet{sum(depth_blocks)*2+2}")


def mobilenet(width=24, n_stages=4, n_classes=10) -> CNNModel:
    """Depthwise-separable stack (MobileNetV1 style, reduced)."""

    def init(gen: torch.Generator, device=None):
        device = device if device is not None else gen.device
        p = {"stem/w": _init_conv(gen, device, 3, 3, 3, width),
             "stem/gn_s": torch.ones((width,), device=device),
             "stem/gn_b": torch.zeros((width,), device=device)}
        cin = width
        for i in range(n_stages):
            cout = width * (2 ** (i // 2 + 1))
            b = f"dw{i}/"
            p[b + "dw"] = _init_conv(gen, device, 3, 3, cin, cin, groups=cin)
            p[b + "gn1_s"] = torch.ones((cin,), device=device)
            p[b + "gn1_b"] = torch.zeros((cin,), device=device)
            p[b + "pw"] = _init_conv(gen, device, 1, 1, cin, cout)
            p[b + "gn2_s"] = torch.ones((cout,), device=device)
            p[b + "gn2_b"] = torch.zeros((cout,), device=device)
            cin = cout
        p.update(_head(gen, device, cin, n_classes))
        return p

    def apply(params, images):
        x = images.permute(0, 3, 1, 2)
        x = _conv(x, params["stem/w"])
        x = F.relu(_groupnorm(x, params["stem/gn_s"], params["stem/gn_b"]))
        i = 0
        while f"dw{i}/dw" in params:
            b = f"dw{i}/"
            stride = 2 if i % 2 == 1 else 1
            x = _conv(x, params[b + "dw"], stride, groups=x.shape[1])
            x = F.relu(_groupnorm(x, params[b + "gn1_s"], params[b + "gn1_b"]))
            x = _conv(x, params[b + "pw"])
            x = F.relu(_groupnorm(x, params[b + "gn2_s"], params[b + "gn2_b"]))
            i += 1
        x = x.mean(dim=(2, 3))
        return x @ params["head/w"] + params["head/b"]

    return CNNModel(init=init, apply=apply, name="mobilenet")


def xent_loss(model: CNNModel):
    """``loss_fn(params, batch, rng) -> (nll, {"acc": acc})``; ``rng`` is
    unused, as in the reference."""

    def loss_fn(params, batch, rng=None):
        logits = model.apply(params, batch["x"])
        ls = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(ls, -1, batch["y"].to(torch.long)[:, None]).mean()
        acc = (logits.argmax(-1) == batch["y"]).to(torch.float32).mean()
        return nll, {"acc": acc}

    return loss_fn
