"""The paper's Table I vision models in PyTorch (ResNet-50, EfficientNet-B0-ish,
FCN, YOLOv3, ViT), the port of the JAX package's ``models/vision.py`` with
the same parameter trees and layouts: NHWC activations, HWIO convolution
weights, (B, H, S, D) attention.

Convolutions can execute through the DSA path: im2col patches ->
``kernels.ops.matmul_padded`` (K1, the systolic kernel), and ViT attention
through ``kernels.ops.attention`` (K5).  Parameters are drawn from an
explicit ``torch.Generator`` (or converted from the JAX package's trees by
``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rms_norm

Params = Any


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the odd pixel goes last."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw: torch.Tensor, kh: int, kw: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x_nchw.shape[2], kh, stride)
    left, right = _same_pads(x_nchw.shape[3], kw, stride)
    return F.pad(x_nchw, (left, right, top, bottom), value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           use_kernel: bool = False, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,C); w (kh,kw,C/groups,O), SAME padding."""
    kh, kw, c, o = w.shape
    if not use_kernel:
        # HWIO -> OIHW for F.conv2d
        xc = _pad_same(x.permute(0, 3, 1, 2), kh, kw, stride)
        out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
        return out.permute(0, 2, 3, 1)
    if groups != 1:
        raise ValueError("the DSA path runs dense convolutions only")
    B = x.shape[0]
    H2, W2 = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
    if kh == kw == stride == 1:
        patches = x.reshape(B * H2 * W2, c)
    else:
        # F.unfold orders features (C, kh, kw), as conv_general_dilated_patches
        xc = _pad_same(x.permute(0, 3, 1, 2), kh, kw, stride)
        cols = F.unfold(xc, (kh, kw), stride=stride)          # (B, K, H'*W')
        patches = cols.transpose(1, 2).reshape(B * H2 * W2, c * kh * kw)
    if kh == kw == 1:
        w2 = w.reshape(c, o)                    # a view: no copy
    else:
        # (K, N) K-major, as K1 stores its operands: the reshape copies
        # either way, in F.unfold's (C, kh, kw) order
        w2 = w.permute(3, 2, 0, 1).reshape(o, c * kh * kw).t()
    out = ops.matmul_padded(patches, w2)
    return out.reshape(B, H2, W2, o)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max-pool with SAME padding (-inf), NHWC."""
    xc = _pad_same(x.permute(0, 3, 1, 2), 3, 3, 2, value=-math.inf)
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


def _randn(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _init_conv(gen, kh, kw, c, o):
    return _randn(gen, (kh, kw, c, o), math.sqrt(2.0 / (kh * kw * c)))


def _to(tree: Params, dev: torch.device) -> Params:
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


# --------------------------------------------------------------------------
# ResNet-50 (bottleneck), width-scalable
# --------------------------------------------------------------------------

def _resnet50_tree(gen, width: float, classes: int) -> Params:
    w = lambda c: max(8, int(c * width))
    p: Dict[str, Any] = {"stem": _init_conv(gen, 7, 7, 3, w(64))}
    spec = [(3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048)]
    cin = w(64)
    blocks = []
    for i, (n, mid, out) in enumerate(spec):
        for j in range(n):
            blk = {
                "c1": _init_conv(gen, 1, 1, cin, w(mid)),
                "c2": _init_conv(gen, 3, 3, w(mid), w(mid)),
                "c3": _init_conv(gen, 1, 1, w(mid), w(out)),
                "stride": 2 if (j == 0 and i > 0) else 1,
            }
            if j == 0:
                blk["proj"] = _init_conv(gen, 1, 1, cin, w(out))
            blocks.append(blk)
            cin = w(out)
    p["blocks"] = blocks
    p["head"] = _randn(gen, (cin, classes), 0.01)
    return p


def resnet50_init(gen: torch.Generator, *, width: float = 1.0,
                  classes: int = 1000, device=None) -> Params:
    dev = resolve(device)
    return _to(_resnet50_tree(gen, width, classes), dev)


def _resnet_trunk(bb: Params, x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    h = torch.relu(conv2d(x, bb["stem"], 2, use_kernel))
    h = _max_pool_same(h)
    for blk in bb["blocks"]:
        s = blk["stride"]
        r = conv2d(h, blk["proj"], s, use_kernel) if "proj" in blk else h
        h2 = torch.relu(conv2d(h, blk["c1"], 1, use_kernel))
        h2 = torch.relu(conv2d(h2, blk["c2"], s, use_kernel))
        h2 = conv2d(h2, blk["c3"], 1, use_kernel)
        h = torch.relu(h2 + r)
    return h


def resnet50_apply(p: Params, x: torch.Tensor,
                   use_kernel: bool = False) -> torch.Tensor:
    h = _resnet_trunk(p, x, use_kernel).mean(dim=(1, 2))
    return h @ p["head"]


# --------------------------------------------------------------------------
# EfficientNet-B0-style MBConv net
# --------------------------------------------------------------------------

def effnet_init(gen: torch.Generator, *, width: float = 1.0,
                classes: int = 1000, device=None) -> Params:
    dev = resolve(device)
    w = lambda c: max(8, int(c * width))
    p = {"stem": _init_conv(gen, 3, 3, 3, w(32))}
    stages = [(1, 32, 16, 1), (2, 16, 24, 6), (2, 24, 40, 6), (3, 40, 80, 6),
              (1, 80, 112, 6)]
    blocks = []
    for n, cin, cout, exp in stages:
        for j in range(n):
            ci = w(cin) if j == 0 else w(cout)
            mid = ci * exp
            blocks.append({
                "expand": _init_conv(gen, 1, 1, ci, mid),
                "dw": _randn(gen, (3, 3, 1, mid), 0.3),
                "project": _init_conv(gen, 1, 1, mid, w(cout)),
                "stride": 2 if j == 0 and cin != cout and cin > 16 else 1,
            })
    p["blocks"] = blocks
    p["head_conv"] = _init_conv(gen, 1, 1, w(112), w(320))
    p["head"] = _randn(gen, (w(320), classes), 0.01)
    return _to(p, dev)


def effnet_apply(p: Params, x: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    h = F.silu(conv2d(x, p["stem"], 2, use_kernel))
    for blk in p["blocks"]:
        inp = h
        h2 = F.silu(conv2d(h, blk["expand"], 1, use_kernel))
        # depthwise: plain grouped convolution on both paths, as in JAX
        h2 = F.silu(conv2d(h2, blk["dw"], blk["stride"], groups=h2.shape[-1]))
        h2 = conv2d(h2, blk["project"], 1, use_kernel)
        h = h2 + inp if h2.shape == inp.shape else h2
    h = F.silu(conv2d(h, p["head_conv"], 1, use_kernel))
    return h.mean(dim=(1, 2)) @ p["head"]


# --------------------------------------------------------------------------
# FCN (ResNet backbone + dense upsampling head)
# --------------------------------------------------------------------------

def fcn_init(gen: torch.Generator, *, width: float = 1.0, classes: int = 21,
             device=None) -> Params:
    dev = resolve(device)
    p = {"backbone": _resnet50_tree(gen, width, classes)}
    cin = max(8, int(2048 * width))
    p["score"] = _init_conv(gen, 3, 3, cin, classes)
    p["out"] = _init_conv(gen, 1, 1, classes, classes)
    return _to(p, dev)


def fcn_apply(p: Params, x: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    h = _resnet_trunk(p["backbone"], x, use_kernel)
    h = conv2d(h, p["score"], 1, use_kernel)
    # jax.image.resize(..., "linear") when upsampling
    H = x.shape[1]
    h = F.interpolate(h.permute(0, 3, 1, 2), size=(H, H), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    return conv2d(h, p["out"], 1, use_kernel)


# --------------------------------------------------------------------------
# YOLOv3 (darknet-53 trunk + 1 detection head; width-scalable)
# --------------------------------------------------------------------------

def yolov3_init(gen: torch.Generator, *, width: float = 1.0,
                device=None) -> Params:
    dev = resolve(device)
    w = lambda c: max(8, int(c * width))
    p = {"stem": _init_conv(gen, 3, 3, 3, w(32))}
    trunk = []
    cin = w(32)
    for n, cout in [(1, 64), (1, 128), (2, 256), (2, 512), (1, 1024)]:
        stage = {"down": _init_conv(gen, 3, 3, cin, w(cout)), "res": []}
        for _ in range(n):
            stage["res"].append((
                _init_conv(gen, 1, 1, w(cout), w(cout) // 2),
                _init_conv(gen, 3, 3, w(cout) // 2, w(cout))))
        trunk.append(stage)
        cin = w(cout)
    p["trunk"] = trunk
    p["head"] = _init_conv(gen, 1, 1, cin, 255)
    return _to(p, dev)


def yolov3_apply(p: Params, x: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    act = lambda v: F.leaky_relu(v, 0.1)
    h = act(conv2d(x, p["stem"], 1, use_kernel))
    for stage in p["trunk"]:
        h = act(conv2d(h, stage["down"], 2, use_kernel))
        for c1, c2 in stage["res"]:
            r = h
            h = act(conv2d(h, c1, 1, use_kernel))
            h = act(conv2d(h, c2, 1, use_kernel))
            h = h + r
    return conv2d(h, p["head"], 1, use_kernel)


# --------------------------------------------------------------------------
# ViT encoder on raw images
# --------------------------------------------------------------------------

def vit_init(gen: torch.Generator, *, layers=4, d=128, heads=4, d_ff=256,
             patch=16, classes=1000, device=None) -> Params:
    dev = resolve(device)
    p = {"patch": _randn(gen, (patch * patch * 3, d), 0.02),
         "pos": _randn(gen, (1024, d), 0.01),
         "cls": _randn(gen, (1, 1, d), 0.02),
         "head": _randn(gen, (d, classes), 0.02),
         "blocks": []}
    for _ in range(layers):
        p["blocks"].append({
            "qkv": _randn(gen, (d, 3 * d), 0.02),
            "o": _randn(gen, (d, d), 0.02),
            "w1": _randn(gen, (d, d_ff), 0.02),
            "w2": _randn(gen, (d_ff, d), 0.02),
            "ln1": torch.zeros((d,)), "ln2": torch.zeros((d,)),
        })
    p["meta"] = {"heads": heads, "patch": patch}
    return _to(p, dev)


def vit_apply(p: Params, x: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    """x (B, H, W, 3) image."""
    patch = p["meta"]["patch"]
    heads = p["meta"]["heads"]
    B, H, W, C = x.shape
    xp = x.reshape(B, H // patch, patch, W // patch, patch, C)
    xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, patch * patch * C)
    h = xp @ p["patch"] + p["pos"][None, :xp.shape[1]]
    h = torch.cat([p["cls"].expand(B, 1, h.shape[-1]), h], 1)
    d = h.shape[-1]
    hd = d // heads
    for blk in p["blocks"]:
        hn = rms_norm(h, blk["ln1"])
        qkv = (hn @ blk["qkv"]).reshape(B, -1, 3, heads, hd)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        if use_kernel:
            sq = q.shape[2]
            o = ops.attention(q, k, v, causal=False, bq=min(128, sq),
                              bk=min(128, sq))
        else:
            o = ref.attention_ref(q, k, v, causal=False)
        o = o.permute(0, 2, 1, 3).reshape(B, -1, d)
        h = h + o @ blk["o"]
        hn = rms_norm(h, blk["ln2"])
        h = h + F.gelu(hn @ blk["w1"], approximate="tanh") @ blk["w2"]
    return h[:, 0] @ p["head"]
