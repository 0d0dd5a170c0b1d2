"""Continuous batching for the serving path, the JAX package's
``serving/batcher.py`` on PyTorch.

The DSCS scheduler admits requests run-to-completion per drive; at pod
scale the decode engine instead keeps a fixed slot pool: finished sequences
free their slot, queued requests prefill into it, and every decode step
advances all live slots together (the paper's Fig. 13 batching argument,
made continuous).  A pure-Python slot manager around the caller's prefill
and decode callables; it hands ``decode_batch`` CPU tensors, which the
callable moves to its device, and reads its tokens back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int
    arrived_step: int = 0
    out: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


@dataclass
class SlotState:
    rid: Optional[int] = None       # None = free


class ContinuousBatcher:
    """Fixed-slot continuous batching around (prefill_one, decode_batch).

    prefill_one(slot_idx, prompt) -> first token
    decode_batch(tokens (B,1), active_mask (B,)) -> next tokens (B,)
    """

    def __init__(self, num_slots: int, prefill_one: Callable,
                 decode_batch: Callable):
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: List[Request] = []
        self.live: Dict[int, Request] = {}
        self.prefill_one = prefill_one
        self.decode_batch = decode_batch
        self.steps = 0
        self.stats = {"admitted": 0, "completed": 0, "decode_steps": 0,
                      "slot_busy_steps": 0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.rid is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            first = int(self.prefill_one(i, req.prompt))
            req.out.append(first)
            slot.rid = req.rid
            self.live[req.rid] = req
            self.stats["admitted"] += 1

    def step(self) -> None:
        """Admit into free slots, then advance every live slot one token."""
        self._admit()
        active = np.array([s.rid is not None for s in self.slots])
        if not active.any():
            return
        last = np.zeros((len(self.slots), 1), np.int32)
        for i, s in enumerate(self.slots):
            if s.rid is not None:
                last[i, 0] = self.live[s.rid].out[-1]
        nxt = torch.as_tensor(self.decode_batch(
            torch.as_tensor(last), torch.as_tensor(active))).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["slot_busy_steps"] += int(active.sum())
        for i, s in enumerate(self.slots):
            if s.rid is None:
                continue
            req = self.live[s.rid]
            req.out.append(int(nxt[i]))
            if req.done:
                self.stats["completed"] += 1
                del self.live[s.rid]
                s.rid = None
        self.steps += 1

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        while (self.queue or self.live) and self.steps < max_steps:
            self.step()

    @property
    def slot_utilization(self) -> float:
        d = self.stats["decode_steps"] * len(self.slots)
        return self.stats["slot_busy_steps"] / d if d else 0.0
