"""Stand-ins for every model input: the JAX package's ``launch/specs.py``.

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device (shape
and dtype, no storage) in place of JAX's ShapeDtypeStructs; ``make_batch``
draws a batch of those shapes from an explicit ``torch.Generator``.
Frontends are stubs: audio and vision configs take precomputed frame or
patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve

Pytree = Any


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio_frames":
        return {"encoder_frames": _meta((batch, cfg.encoder_seq, cfg.d_model),
                                        dt)}
    if cfg.frontend == "vision_patches":
        return {"frontend_embeds": _meta(
            (batch, cfg.frontend_seq, cfg.d_model), dt)}
    return {}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": _meta((B, S), torch.int32),
               "labels": _meta((B, S), torch.int32)}
        out.update(_frontend_specs(cfg, B))
        return out
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), torch.int32)}
        out.update(_frontend_specs(cfg, B))
        return out
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator, device=None) -> Pytree:
    """A random batch matching ``input_specs``, drawn from ``generator`` on
    its own device in the specs' order and put on ``device`` (None: the
    card): token ids uniform in the vocabulary, embeddings normal x 0.02."""
    dev = resolve(device)
    gdev = generator.device
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            t = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                              device=gdev, dtype=torch.int32)
        else:
            t = (torch.randn(s.shape, generator=generator, device=gdev)
                 * 0.02).to(s.dtype)
        out[name] = t.to(dev)
    return out
