"""The serving steps of the JAX package's ``launch/steps.py`` on one
card: ``make_prefill_step`` and ``make_decode_step``.

There is no mesh and no sharding rules: the port's serving slice runs on
one card.  ``make_train_step`` comes with the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as DE


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return DE.prefill(cfg, params, batch["tokens"])

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        return DE.decode_step(cfg, params, cache, batch["tokens"])

    return decode_step
