"""Collective traffic of a step: the role of the JAX package's
``analysis/hlo.py``, which parses it from the partitioned HLO text.

The port has no HLO.  Its collectives go through ``torch.distributed``
(``distributed/collectives.py``, ``distributed/moe_ep.py``), which issues
them as ``c10d`` operators; ``CollectiveCounter``, a ``TorchDispatchMode``,
records each as it is issued: its kind, the bytes of its result and the
size of its group.  ``collective_stats`` turns the records into estimated
per-rank link traffic by ``hlo.py``'s formulas:

  all-gather        : result bytes              (each rank receives ~result)
  all-reduce        : 2 x result bytes          (ring: reduce-scatter + all-gather)
  reduce-scatter    : result bytes x group size (input flows through the ring)
  all-to-all        : result bytes
  collective-permute: result bytes

the first three scaled by (group - 1) / group as ``hlo.py`` scales them.
An eager count sees every layer's collectives, so nothing needs the
JAX dry run's scan-trip correction.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# c10d operator -> HLO kind
_C10D_KIND = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}


class Collective(NamedTuple):
    kind: str
    result_bytes: int
    group: int


def traffic_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Estimated per-rank link traffic of one collective."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (group - 1) / max(group, 1)
    if kind == "all-gather":
        return result_bytes * (group - 1) / max(group, 1)
    if kind == "reduce-scatter":
        return result_bytes * (group - 1)
    return result_bytes


def collective_stats(records) -> Dict[str, Dict[str, float]]:
    """Per-kind {count, result_bytes, traffic_bytes}, as ``hlo.py``'s
    ``collective_stats`` gives them."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "traffic_bytes": 0.0})
    for r in records:
        d = out[r.kind]
        d["count"] += 1
        d["result_bytes"] += r.result_bytes
        d["traffic_bytes"] += traffic_bytes(r.kind, r.result_bytes, r.group)
    return dict(out)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_size(func, args) -> int:
    """The size of the process group among a c10d operator's arguments."""
    import torch.distributed as dist
    for arg, a in zip(func._schema.arguments, args):
        if arg.name == "process_group":
            return int(dist.ProcessGroup.unbox(a).size())
    return 1


class CollectiveCounter(TorchDispatchMode):
    """Records every c10d collective issued under it (``records``: one
    ``Collective`` each) and runs it."""

    def __init__(self):
        super().__init__()
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _C10D_KIND.get(name)
            if kind is not None:
                # the first argument is the result: the gathered outputs
                # of a gather, the output block of a reduce-scatter or
                # all-to-all, the tensors themselves of an all-reduce
                self.records.append(Collective(kind, _nbytes(args[0]),
                                               _group_size(func, args)))
        return func(*args, **kwargs)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return collective_stats(self.records)
