"""Synthetic serving requests, as the JAX package's ``data/pipeline.py``
draws them.

``RequestStream`` is a copy of that module's class (numpy only), so the
port and the JAX package draw the same prompts from one seed.
``TokenStream`` comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


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
