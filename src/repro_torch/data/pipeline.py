"""Deterministic, resumable synthetic data, as the JAX package's
``data/pipeline.py`` draws it.

Batches are a pure function of (seed, step), so restoring a checkpoint and
replaying from its step reproduces the exact stream — the property the
fault-tolerance test asserts.  ``TokenStream`` and ``RequestStream`` are
copies of that module's classes (numpy only), so the port and the JAX
package draw the same tokens from one seed; where the JAX ``TokenStream``
``device_put``s a batch with its sharding, the port's puts it on one
explicit device (None: the card) as int32 tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve


@dataclass
class TokenStream:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    device: Any = None

    def batch_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # zipf-ish token distribution (more realistic than uniform)
        ranks = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(ranks, self.cfg.vocab_size - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "audio_frames":
            out["encoder_frames"] = rng.normal(
                0, 0.02, (self.batch, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.frontend == "vision_patches":
            out["frontend_embeds"] = rng.normal(
                0, 0.02, (self.batch, self.cfg.frontend_seq, self.cfg.d_model)
            ).astype(np.float32)
        dev = resolve(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in out.items()}

    def iter_from(self, step: int) -> Iterator[Dict[str, Any]]:
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class RequestStream:
    """Poisson request arrivals for the serving driver."""
    cfg: ModelConfig
    batch: int
    prompt_len: int
    seed: int = 0

    def requests_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.batch, self.prompt_len)).astype(np.int32)
        return {"tokens": toks}
