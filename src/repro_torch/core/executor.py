"""End-to-end pipeline executor on PyTorch: runs Table I pipelines
numerically (the near-storage DSA path uses the hand-written CUDA kernels),
while the analytical models account latency/energy for the deployment being
simulated.  The port of the JAX package's ``core/executor.py``.

f1 pre-processing runs on the vector engine (K2), f2 inference on the
systolic kernel (K1) and, for ViT, flash attention (K5), f3 post-processing
on the host -- matching Fig. 2 / Fig. 3(b).  The LM workloads (chatbot,
translation) take int32 tokens with no f1, and run f2 as the reduced
qwen3-8b's forward, its attention on K5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.core.energy import pipeline_energy_j
from repro_torch.core.function import standard_pipeline
from repro_torch.core.latency import LatencyModel
from repro_torch.core.platforms import PLATFORMS
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models import vision


@dataclass
class ExecutionReport:
    result: Any
    latency_breakdown: Dict[str, float]
    energy_breakdown: Dict[str, float]
    platform: str
    accelerated: bool


def _preprocess_vector_engine(img: torch.Tensor,
                              use_kernel: bool) -> torch.Tensor:
    """f1: normalize + cast -- the DSA vector engine's job."""
    flat = img.reshape(img.shape[0], -1).float()
    n = flat.shape[1]
    scale = torch.full((n,), 1.0 / 127.5, device=img.device)
    bias = torch.full((n,), -1.0, device=img.device)
    if use_kernel:
        out = ops.affine_act(flat, scale, bias, act="none")
    else:
        out = flat * scale + bias
    return out.reshape(img.shape)


_MODEL_BUILDERS: Dict[str, Tuple[Callable, Callable, dict]] = {
    "asset_damage": (vision.resnet50_init, vision.resnet50_apply,
                     {"width": 0.125}),
    "content_moderation": (vision.effnet_init, vision.effnet_apply,
                           {"width": 0.25}),
    "clinical": (vision.fcn_init, vision.fcn_apply, {"width": 0.125}),
    "ppe_detection": (vision.yolov3_init, vision.yolov3_apply,
                      {"width": 0.125}),
    "remote_sensing": (vision.vit_init, vision.vit_apply, {}),
}

_LM_WORKLOADS = ("chatbot", "translation")


class DSCSExecutor:
    """Executes one Table I pipeline end-to-end in a chosen deployment."""

    def __init__(self, workload_name: str, *, platform: str = "DSCS-Serverless",
                 image_size: int = 64, seed: int = 0, device=None):
        self.pipeline = standard_pipeline(
            workload_name, accelerate=(platform == "DSCS-Serverless"))
        self.platform = PLATFORMS[platform]
        self.lm = LatencyModel(seed=seed)
        self.image_size = image_size
        self.device = resolve(device)
        gen = torch.Generator().manual_seed(seed)
        if workload_name in _MODEL_BUILDERS:
            init, apply, kw = _MODEL_BUILDERS[workload_name]
            self.params = init(gen, device=self.device, **kw)
            self._apply = apply
        elif workload_name in _LM_WORKLOADS:  # the reduced qwen3-8b
            self._cfg = get_arch("qwen3-8b").reduced()
            self.params = T.init_params(self._cfg, gen, device=self.device)
            self._apply = lambda p, x, use_kernel=False: T.forward(
                self._cfg, p, x)
        else:  # credit_risk
            self.params = (torch.randn((200, 1), generator=gen) * 0.1).to(
                self.device)
            self._apply = lambda p, x, use_kernel=False: torch.sigmoid(x @ p)

    def make_request(self, gen: torch.Generator) -> torch.Tensor:
        if self.pipeline.name == "credit_risk":
            x = torch.randn((1, 200), generator=gen)
        elif self.pipeline.name in _LM_WORKLOADS:
            x = torch.randint(0, self._cfg.vocab_size, (1, 32), generator=gen,
                              dtype=torch.int32)
        else:
            s = self.image_size
            x = torch.randint(0, 256, (1, s, s, 3), generator=gen,
                              dtype=torch.uint8)
        return x.to(self.device)

    def __call__(self, request: torch.Tensor) -> ExecutionReport:
        accel = self.platform.kind == "dsa"
        # f1 -- pre-process
        if request.dtype == torch.uint8:
            x = _preprocess_vector_engine(request, use_kernel=accel)
        else:
            x = request
        # f2 -- inference (systolic kernels on the DSA path)
        y = self._apply(self.params, x, use_kernel=accel)
        # f3 -- post/notify
        if y.ndim >= 2 and y.shape[-1] > 1:
            result = torch.argmax(y, dim=-1)
        else:
            result = y
        lat = self.lm.pipeline_breakdown(self.platform, self.pipeline.workload)
        en = pipeline_energy_j(self.lm, self.platform, self.pipeline.workload)
        return ExecutionReport(result=result, latency_breakdown=lat,
                               energy_breakdown=en,
                               platform=self.platform.name, accelerated=accel)
