"""The port's continuous batcher (``repro_torch.serving.batcher``): the
invariants of ``tests/test_serving.py``'s batcher tests, and the JAX
package's batcher and the port's driven by the same toy engine."""
import numpy as np
import pytest
import torch

from repro.serving import batcher as jbatcher
from repro_torch.serving.batcher import ContinuousBatcher, Request


def _toy_engine():
    """Deterministic fake engine: next token = last + 1."""
    def prefill_one(slot, prompt):
        return int(prompt[-1]) + 1

    def decode_batch(last, active):
        return (torch.as_tensor(last)[:, 0] + 1) * torch.as_tensor(active)

    return prefill_one, decode_batch


def test_batcher_completes_all_and_preserves_order():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(4, pre, dec)
    reqs = [Request(rid=i, prompt=np.array([i * 10], np.int32), max_new=5)
            for i in range(10)]
    for r in reqs:
        b.submit(r)
    b.run_until_drained()
    assert b.stats["completed"] == 10
    for r in reqs:
        assert r.out == [r.prompt[-1] + 1 + j for j in range(5)]


def test_batcher_slot_utilization_reasonable():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(4, pre, dec)
    for i in range(16):
        b.submit(Request(rid=i, prompt=np.array([0], np.int32), max_new=8))
    b.run_until_drained()
    assert b.slot_utilization > 0.9


def test_batcher_mixed_lengths_free_slots_early():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(2, pre, dec)
    b.submit(Request(rid=0, prompt=np.array([0], np.int32), max_new=2))
    b.submit(Request(rid=1, prompt=np.array([0], np.int32), max_new=20))
    b.submit(Request(rid=2, prompt=np.array([0], np.int32), max_new=2))
    b.run_until_drained()
    assert b.stats["completed"] == 3
    assert b.steps < 25


def test_batcher_fifo_admission_order():
    pre, dec = _toy_engine()
    admitted = []

    def tracking_prefill(slot, prompt):
        admitted.append(int(prompt[-1]))
        return pre(slot, prompt)

    b = ContinuousBatcher(2, tracking_prefill, dec)
    for i in range(8):
        b.submit(Request(rid=i, prompt=np.array([i], np.int32), max_new=3))
    b.run_until_drained()
    assert admitted == sorted(admitted) == list(range(8))


def test_batcher_slot_reuse_after_completion():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(1, pre, dec)
    for i in range(5):
        b.submit(Request(rid=i, prompt=np.array([i], np.int32), max_new=2))
    while b.queue or b.live:
        assert len(b.live) <= 1
        b.step()
    assert b.stats["completed"] == 5
    assert b.stats["admitted"] == 5


def test_batcher_slot_utilization_bounds():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(4, pre, dec)
    assert b.slot_utilization == 0.0
    for i in range(3):
        b.submit(Request(rid=i, prompt=np.array([0], np.int32), max_new=4))
    b.run_until_drained()
    assert 0.0 <= b.slot_utilization <= 3.0 / 4.0 + 1e-9


def test_batcher_drain_terminates_under_max_steps():
    pre, dec = _toy_engine()
    b = ContinuousBatcher(1, pre, dec)
    b.submit(Request(rid=0, prompt=np.array([0], np.int32), max_new=10_000))
    b.run_until_drained(max_steps=7)
    assert b.steps == 7
    assert b.stats["completed"] == 0 and b.live


def test_decode_batch_gets_tensors():
    """decode_batch sees (slots, 1) int32 tokens and a (slots,) bool mask
    as tensors; a CUDA tensor back would be read to the host."""
    seen = []

    def dec(last, active):
        seen.append((last.dtype, tuple(last.shape), active.dtype))
        return last[:, 0] + 1

    b = ContinuousBatcher(3, lambda s, p: 0, dec)
    b.submit(Request(rid=0, prompt=np.array([4], np.int32), max_new=3))
    b.run_until_drained()
    assert seen and all(s == (torch.int32, (3, 1), torch.bool) for s in seen)


@pytest.mark.parametrize("slots,lengths", [(1, [2, 3]), (2, [2, 20, 2]),
                                           (4, [1, 5, 3, 8, 2, 7, 4, 6, 9])])
def test_batcher_matches_jax(slots, lengths):
    """The JAX package's batcher and the port's, the same requests through
    the same toy engine (numpy in, so both take it): the same tokens,
    stats, steps and slot utilisation."""
    def prefill_one(slot, prompt):
        return int(prompt[-1]) * 3 + slot

    def decode_batch(last, active):
        return (np.asarray(last)[:, 0] * 2 + 1) % 1000 * np.asarray(active)

    runs = []
    for mod in (jbatcher, None):
        cls, req = ((mod.ContinuousBatcher, mod.Request) if mod
                    else (ContinuousBatcher, Request))
        b = cls(slots, prefill_one, decode_batch)
        reqs = [req(rid=i, prompt=np.array([i + 1], np.int32), max_new=n)
                for i, n in enumerate(lengths)]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        runs.append(([r.out for r in reqs], b.stats, b.steps,
                     b.slot_utilization))
    assert runs[0] == runs[1]
