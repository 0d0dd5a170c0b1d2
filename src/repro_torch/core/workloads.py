"""Table I — the eight serverless applications and their DNN models.

Each workload is a 3-function pipeline (f1 pre-process, f2 ML inference,
f3 post/notify) with the paper's input/output payloads.  For the DSA tile
model every network is lowered to a GEMM list (convs via im2col; depthwise
convs and pre/post-processing count as vector-engine work).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

from repro_torch.core.dsa import GemmShape


def conv(b, h, w, cin, cout, k, stride=1) -> GemmShape:
    oh, ow = h // stride, w // stride
    return GemmShape(m=b * oh * ow, k=cin * k * k, n=cout)


def fc(m, k, n, vec=0) -> GemmShape:
    return GemmShape(m=m, k=k, n=n, vector_ops=vec)


def resnet50_gemms(b=1, res=224) -> List[GemmShape]:
    g = [conv(b, res, res, 3, 64, 7, 2)]
    h = res // 4
    spec = [(3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048)]
    cin = 64
    for i, (blocks, mid, out) in enumerate(spec):
        for j in range(blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            g += [conv(b, h, h, cin, mid, 1),
                  conv(b, h, h, mid, mid, 3, stride),
                  conv(b, h // stride, h // stride, mid, out, 1)]
            if j == 0:
                g.append(conv(b, h, h, cin, out, 1, stride))
            h //= stride
            cin = out
    g.append(fc(b, 2048, 1000, vec=2048))
    return g


def efficientnet_b0_gemms(b=1) -> List[GemmShape]:
    # MBConv stages; depthwise convs -> vector-engine work
    g = [conv(b, 224, 224, 3, 32, 3, 2)]
    stages = [(1, 32, 16, 1, 112), (2, 16, 24, 6, 112), (2, 24, 40, 6, 56),
              (3, 40, 80, 6, 28), (3, 80, 112, 6, 14), (4, 112, 192, 6, 14),
              (1, 192, 320, 6, 7)]
    for blocks, cin, cout, exp, h in stages:
        for j in range(blocks):
            ci = cin if j == 0 else cout
            mid = ci * exp
            dw = b * h * h * mid * 9
            g += [fc(b * h * h, ci, mid, vec=dw), fc(b * h * h, mid, cout)]
    g += [conv(b, 7, 7, 320, 1280, 1), fc(b, 1280, 1000)]
    return g


def yolov3_gemms(b=1, res=416) -> List[GemmShape]:
    g = [conv(b, res, res, 3, 32, 3)]
    h, cin = res, 32
    for blocks, cout in [(1, 64), (2, 128), (8, 256), (8, 512), (4, 1024)]:
        g.append(conv(b, h, h, cin, cout, 3, 2))
        h //= 2
        for _ in range(blocks):
            g += [conv(b, h, h, cout, cout // 2, 1),
                  conv(b, h, h, cout // 2, cout, 3)]
        cin = cout
    for hh, c in [(13, 1024), (26, 512), (52, 256)]:   # detection heads
        g += [conv(b, hh, hh, c, c // 2, 1), conv(b, hh, hh, c // 2, c, 3),
              conv(b, hh, hh, c, 255, 1)]
    return g


def fcn_gemms(b=1) -> List[GemmShape]:
    g = resnet50_gemms(b)[:-1]
    g += [conv(b, 7, 7, 2048, 512, 3), conv(b, 28, 28, 512, 21, 1),
          conv(b, 224, 224, 21, 3, 1)]                 # upsample head
    return g


def transformer_gemms(b, seq, layers, d, heads, d_ff, vocab=0) -> List[GemmShape]:
    g = []
    hd = d // heads
    for _ in range(layers):
        g += [fc(b * seq, d, 3 * d),                   # QKV
              GemmShape(m=b * heads * seq, k=hd, n=seq),
              GemmShape(m=b * heads * seq, k=seq, n=hd, vector_ops=b * heads * seq * seq),
              fc(b * seq, d, d),
              fc(b * seq, d, d_ff, vec=b * seq * d_ff),
              fc(b * seq, d_ff, d)]
    if vocab:
        g.append(fc(b, d, vocab))
    return g


@dataclass(frozen=True)
class Workload:
    name: str
    description: str
    model: str
    params: float                    # parameter count
    input_bytes: int                 # f2 input payload
    output_bytes: int                # f2 output payload
    request_bytes: int               # raw user payload (f1 input)
    gemms: Tuple[GemmShape, ...] = field(default_factory=tuple)

    @property
    def weight_bytes(self) -> int:
        return int(self.params)      # int8 deployment (vector-engine quant)

    @property
    def flops(self) -> float:
        return sum(2.0 * g.m * g.k * g.n for g in self.gemms)


def _mk(name, desc, model, params, inp, out, req, gemms) -> Workload:
    return Workload(name, desc, model, params, inp, out, req, tuple(gemms))


WORKLOADS = {w.name: w for w in [
    _mk("credit_risk", "Loan approval risk scoring", "LogReg", 200,
        800, 4, 800, [fc(1, 200, 1, vec=200)]),
    _mk("asset_damage", "CCTV damage detection", "ResNet-50", 25e6,
        602112, 4000, 230400, resnet50_gemms()),
    _mk("ppe_detection", "Factory protective-gear detection", "YOLOv3", 65e6,
        2076672, 2759520, 614400, yolov3_gemms()),
    _mk("clinical", "Medical scan segmentation", "FCN", 54e6,
        602112, 602112, 230400, fcn_gemms()),
    _mk("content_moderation", "Offensive-content detection", "EfficientNet",
        11.5e6, 602112, 4000, 230400, efficientnet_b0_gemms()),
    _mk("chatbot", "Question answering", "BERT-Base", 110e6,
        393216, 393216, 2048, transformer_gemms(1, 128, 12, 768, 12, 3072)),
    _mk("translation", "Document translation", "GPT-2", 1.5e9,
        512, 512, 2048, transformer_gemms(1, 128, 48, 1600, 25, 6400, vocab=50257)),
    _mk("remote_sensing", "UAV traffic monitoring", "ViT", 632e6,
        602112, 4000, 230400, transformer_gemms(1, 257, 32, 1280, 16, 5120, vocab=1000)),
]}
