"""Serverless function & pipeline abstractions (§V programming model).

A ``FunctionSpec`` is the YAML-file analogue: metadata constraints plus the
``acceleratable`` hint DSCS adds.  A ``Pipeline`` is the DAG of functions
(Fig. 2 — a chain for the Table I suite, but arbitrary DAGs are supported).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.workloads import Workload, WORKLOADS


@dataclass(frozen=True)
class FunctionSpec:
    name: str
    role: str                       # preprocess | inference | postprocess
    acceleratable: bool             # the DSCS YAML hint
    timeout_s: float = 30.0
    memory_mb: int = 1024
    storage_class: str = "standard" # or "Acceleratable_Storage"
    image: str = "repro/runtime:latest"


@dataclass(frozen=True)
class Pipeline:
    name: str
    workload: Workload
    functions: Tuple[FunctionSpec, ...]
    edges: Tuple[Tuple[int, int], ...]   # DAG edges (i -> j)

    def validate(self) -> None:
        n = len(self.functions)
        seen = set()
        for a, b in self.edges:
            assert 0 <= a < n and 0 <= b < n and a < b, "edges must be a DAG"
            seen.add((a, b))
        assert len(seen) == len(self.edges), "duplicate edge"


def is_acceleratable(pipeline: Pipeline) -> bool:
    """True when the pipeline's offloadable prefix (f1 preprocess + f2
    inference — the functions DSCS executes in-storage, Fig. 2) carries
    the ``acceleratable`` hint; f3 notify always runs host-side.  This is
    THE dispatch predicate: the engine routes exactly these pipelines to
    drives, and capacity planners (``EWMAPolicy.for_pipelines``) must
    split traffic with the same rule."""
    return all(f.acceleratable for f in pipeline.functions[:2])


def standard_pipeline(workload_name: str, accelerate: bool = True) -> Pipeline:
    """The Fig. 2 three-function chain for a Table I workload."""
    wl = WORKLOADS[workload_name]
    sc = "Acceleratable_Storage" if accelerate else "standard"
    fns = (
        FunctionSpec(f"{wl.name}-f1-preprocess", "preprocess", accelerate,
                     storage_class=sc),
        FunctionSpec(f"{wl.name}-f2-inference", "inference", accelerate,
                     storage_class=sc),
        FunctionSpec(f"{wl.name}-f3-notify", "postprocess", False),
    )
    return Pipeline(wl.name, wl, fns, ((0, 1), (1, 2)))
