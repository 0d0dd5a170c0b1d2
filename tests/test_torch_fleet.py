"""The port's sharded fleet engine against the JAX package's, on the CPU.

The port's ``core`` modules of the fleet slice are copies of the JAX
package's numpy modules with ``repro.`` renamed to ``repro_torch.``; the
only other differences are the Lindley solver's backends (``torch`` and
``cuda`` in place of ``pallas``, ``cuda`` the default) and the fork rule
that comes with ``cuda``.  :data:`SEAMS` lists them, and the copies are
held to that list word for word.  Then whole runs: the port's
``run_sharded(n_shards=2, backend="torch")`` must give the JAX package's
``run_sharded(backend="segmented")`` trace byte for byte, with equal queue,
power and telemetry books, and the golden traces must replay through the
port's engine.
"""
import json
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from repro.core import arrivals as jarrivals
from repro.core import engine as jengine
from repro.core import function as jfunction
from repro_torch.core import arrivals, engine, function, lindley, sharding
from repro_torch.core import faults as pfaults

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
COLUMNS = ("arrival", "finish", "winner", "drive", "start", "service",
           "hedged", "dscs_finish", "cpu_finish")

# (text in the renamed original, text in the port), per module
SEAMS = {
    "lindley": [
        ('''``segmented`` (default, numpy)''', '''``segmented`` (numpy)'''),
        ('''``pallas``
    The same bucketed recurrence as a grid-blocked Pallas TPU kernel
    (:mod:`repro_torch.kernels.lindley`): rows ride the lane dimension, the
    depth axis is scanned sequentially with a grid-carried fp64 VMEM
    ``(cumsum, running-max)`` state — float64 via jax's x64 mode,
    ``interpret=True`` off-TPU like every other kernel in the repo.
    Because the kernel performs the same fp64 operations in the same
    order, its output is bit-identical to the numpy backend (pinned in
    ``tests/test_kernels.py``).''', '''``torch`` / ``cuda``
    The same bucketed recurrence through
    :func:`repro_torch.kernels.ops.lindley`, one call per bucket on
    float64 tensors.  ``cuda`` (the default,
    :data:`DEFAULT_BACKEND`) puts each bucket on the card and runs the
    hand-written fp64 scan of :mod:`repro_torch.kernels.lindley`, which
    walks each row in order with the same fp64 operations; it raises
    where CUDA is absent.  ``torch`` keeps the bucket on the CPU and runs
    the kernel's plain PyTorch version, the numpy op sequence.  Both are
    byte-equal to the numpy backend (pinned in
    ``tests/test_torch_lindley.py``).'''),
        ('''from typing import Dict, List

import numpy as np

__all__ = ["BACKENDS", "queue_depth_max", "segment_fenceposts",
           "solve_segments"]

BACKENDS = ("segmented", "pallas", "dense")''',
         '''from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops

__all__ = ["BACKENDS", "DEFAULT_BACKEND", "queue_depth_max",
           "segment_fenceposts", "solve_segments"]

BACKENDS = ("segmented", "torch", "cuda", "dense")
# The port's entry points run on the card unless the caller asks otherwise.
DEFAULT_BACKEND = "cuda"'''),
        ('''                     start: np.ndarray, pallas: bool = False)''',
         '''                     start: np.ndarray,
                     device: Optional[torch.device] = None)'''),
        ('''        if pallas:
            from repro_torch.kernels import ops
            st = np.asarray(ops.lindley(T, S))''',
         '''        if device is not None:
            # T/S are pooled scratch the next bucket overwrites: copy the
            # result back synchronously before moving on
            st = ops.lindley(torch.from_numpy(T).to(device),
                             torch.from_numpy(S).to(device)).cpu().numpy()'''),
        ('''backend: str = "segmented") -> None:''',
         '''backend: str = DEFAULT_BACKEND) -> None:'''),
        ('''All three backends''', '''All four backends'''),
        ('''                         f"got {backend!r}")
    if not t.size:''', '''                         f"got {backend!r}")
    dev = None
    if backend in ("torch", "cuda"):
        dev = _device.resolve("cpu" if backend == "torch" else "cuda")
    if not t.size:'''),
        ('''start, pallas=(backend == "pallas"))''', '''start, device=dev)'''),
    ],
    "sharding": [
        ('''backend: str = "segmented"''',
         '''backend: str = lindley.DEFAULT_BACKEND'''),
        ('''    segmented scan by default; ``backend`` selects the Pallas kernel or
    the legacy padded-dense layout — all bit-identical).''',
         '''    scan on the card's fp64 kernel by default; ``backend`` selects the
    numpy or plain-PyTorch scan or the legacy padded-dense layout — all
    bit-identical).'''),
        ('''BACKENDS`: ``segmented``/``pallas``/
    ``dense`` — all bit-identical); the shard-isolated fallback runs the
    classic event loop and ignores it — a non-default ``backend`` on a
    fallback run raises a ``UserWarning`` so the Pallas/segmented knob
    never silently does nothing.''', '''BACKENDS`: ``segmented``/``torch``/
    ``cuda``/``dense`` — all bit-identical; ``cuda``, the default, needs
    a card and runs the shards in this process, since the worker pool
    forks and CUDA cannot run in a child forked after it started); the
    shard-isolated fallback runs the classic event loop and ignores it —
    a non-default ``backend`` on a fallback run raises a ``UserWarning``
    so the solver knob never silently does nothing.'''),
        ('''        processes = min(n_shards, os.cpu_count() or 1)''',
         '''        processes = (1 if backend == "cuda"
                     else min(n_shards, os.cpu_count() or 1))'''),
        ('''if backend != "segmented":''',
         '''if backend != lindley.DEFAULT_BACKEND:'''),
        ('''    return _run_partitioned_pure(engine, pipelines, times, plan,''',
         '''    if backend == "cuda" and processes > 1:
        raise ValueError("backend='cuda' runs the shards in one process "
                         f"(processes=1), got processes={processes}: the "
                         "worker pool forks, and CUDA cannot run in a "
                         "forked child")
    return _run_partitioned_pure(engine, pipelines, times, plan,'''),
    ],
    "engine": [
        ('''from repro_torch.core.latency import LatencyModel, _erfinv
''', '''from repro_torch.core.latency import LatencyModel, _erfinv
from repro_torch.core.lindley import DEFAULT_BACKEND
'''),
        ('''backend: str = "segmented",''', '''backend: str = DEFAULT_BACKEND,'''),
        ('''        fast path's Lindley solver (``segmented``/``pallas``/``dense``,
        see :mod:`repro_torch.core.lindley` — all bit-identical; ``n_shards=1``
        and the shard-isolated fallback run the classic event loop and
        ignore it).''', '''        fast path's Lindley solver (``segmented``/``torch``/``cuda``/
        ``dense``, see :mod:`repro_torch.core.lindley` — all bit-identical;
        ``cuda``, the default, needs a card and ``processes=1``;
        ``n_shards=1`` and the shard-isolated fallback run the classic
        event loop and ignore it).'''),
    ],
}
VERBATIM = ("arrivals", "faults", "overload", "tenancy", "tiering",
            "function", "latency", "platforms", "workloads")


@pytest.mark.parametrize("name", sorted(SEAMS) + list(VERBATIM))
def test_core_modules_are_copies_with_only_the_listed_seams(name):
    want = re.sub(r"\brepro\.", "repro_torch.",
                  (ROOT / "src" / "repro" / "core" / f"{name}.py").read_text())
    for old, new in SEAMS.get(name, []):
        assert old in want, (name, old)
        want = want.replace(old, new)
    got = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_text()
    assert got == want


# -- whole runs --------------------------------------------------------------
def make_spec(seed: int) -> dict:
    """Seeded fleet configs as tests/test_sharding.py draws them, with
    tier, faults and deadlines off (the partitioned fast path)."""
    rng = np.random.default_rng(seed)
    n_dscs = int(rng.choice([4, 8, 12, 16]))
    return {
        "n_dscs": n_dscs,
        "n_cpu": int(rng.choice([n_dscs, n_dscs // 2 + 2, 2 * n_dscs])),
        "rate": float(rng.uniform(80.0, 400.0)),
        "kind": str(rng.choice(["poisson", "bursty", "diurnal"])),
        "duration_s": float(rng.uniform(1.0, 2.0)),
        "hedge": (None if rng.random() < 0.3
                  else float(rng.uniform(0.02, 0.15))),
        "mixed": bool(rng.random() < 0.5),
        "seed": int(rng.integers(1 << 16)),
    }


def build(spec: dict, arr_mod, fn_mod):
    """The spec's (arrival process, pipelines) from one package."""
    rate = spec["rate"]
    arr = {"poisson": lambda: arr_mod.PoissonProcess(rate=rate),
           "bursty": lambda: arr_mod.BurstyOnOff(rate=rate, burst_factor=3.0),
           "diurnal": lambda: arr_mod.DiurnalProcess(
               rate=rate, amplitude=0.6, period_s=4.0)}[spec["kind"]]()
    pipes = [fn_mod.standard_pipeline(n)
             for n in ("asset_damage", "content_moderation")]
    if spec["mixed"]:
        pipes.append(fn_mod.standard_pipeline("asset_damage",
                                              accelerate=False))
    return arr, pipes


def run(spec, eng_mod, arr_mod, fn_mod, *, n_shards=2, **kw):
    arr, pipes = build(spec, arr_mod, fn_mod)
    eng = eng_mod.ClusterEngine(n_dscs=spec["n_dscs"], n_cpu=spec["n_cpu"],
                                hedge_budget_s=spec["hedge"],
                                seed=spec["seed"])
    tr = eng.run_sharded(pipes, arrivals=arr, duration_s=spec["duration_s"],
                         n_shards=n_shards, **kw)
    return eng, tr


def run_port(spec, **kw):
    return run(spec, engine, arrivals, function, **kw)


def run_jax(spec, **kw):
    return run(spec, jengine, jarrivals, jfunction, **kw)


def assert_same_run(ea, ta, eb, tb):
    for col in COLUMNS:
        assert getattr(ta, col).tobytes() == getattr(tb, col).tobytes(), col
    assert ta.events == tb.events
    assert ea._qstate == eb._qstate
    assert ea._pstate == eb._pstate
    assert dict(ea.telemetry.counters) == dict(eb.telemetry.counters)


# seeds whose queues build up: poisson and diurnal with hedging, bursty
# with and without it, two of them with a non-accelerated pipeline
@pytest.mark.parametrize("seed", [1, 4, 5, 7])
def test_port_fleet_bytes_equal_jax_segmented(seed):
    spec = make_spec(seed)
    ej, tj = run_jax(spec, processes=1, backend="segmented")
    ep, tp = run_port(spec, processes=1, backend="torch")
    assert ep.last_shard_stats["path"] == "partitioned"
    assert tp.n > 300 and ep.queue_stats()["dscs"]["max_depth"] > 20
    assert_same_run(ej, tj, ep, tp)
    assert ep.queue_stats() == ej.queue_stats()


def test_port_fleet_is_shard_count_independent():
    spec = make_spec(7)
    e2, t2 = run_port(spec, n_shards=2, processes=1, backend="torch")
    e4, t4 = run_port(spec, n_shards=4, processes=1, backend="torch")
    assert_same_run(e2, t2, e4, t4)


def test_cuda_route_runs_the_shards_in_one_process(monkeypatch):
    """``cuda`` takes the bucket route of ``torch`` with the tensors on
    the card; here the card is stood in for by the CPU, which shows the
    route and its default of one process (the counters stay untouched:
    a CPU tensor takes the plain version)."""
    monkeypatch.setattr(lindley._device, "resolve",
                        lambda dev=None: torch.device("cpu"))
    spec = make_spec(1)
    ej, tj = run_jax(spec, processes=1, backend="segmented")
    ep, tp = run_port(spec)
    assert ep.last_shard_stats["processes"] == 1
    assert_same_run(ej, tj, ep, tp)


def _golden_replay(golden, eng_mod, arr_mod, fn_mod, runner):
    cfg = golden["config"]
    eng = eng_mod.ClusterEngine(n_dscs=cfg["n_dscs"], n_cpu=cfg["n_cpu"],
                                hedge_budget_s=cfg["hedge_budget_s"],
                                seed=cfg["seed"])
    pipes = [fn_mod.standard_pipeline(n) for n in cfg["pipelines"]]
    kw = dict(arrivals=arr_mod.PoissonProcess(rate=cfg["rate"]),
              duration_s=cfg["duration_s"])
    res = (eng.run(pipes, **kw) if runner == "run" else
           eng.run_sharded(pipes, n_shards=1, **kw).to_results())
    return [[r.arrival, r.finish, r.accelerated, r.hedged, r.winner, r.drive,
             r.start, r.service, r.dscs_finish, r.cpu_finish] for r in res]


@pytest.mark.parametrize("seed", [13, 21])
def test_golden_traces_replay_through_the_port_engine(seed):
    """The classic loop, through ``run`` and ``run_sharded(n_shards=1)``:
    field for field the JAX package's stream on this host, and the
    committed golden stream.  The golden floats were captured on another
    host, whose libm differs from some hosts' in the last bit (the JAX
    package's own golden tests see the same 1-ulp deltas there), so they
    are held to 1e-14 relative; every other field exactly."""
    golden = json.loads((GOLDEN / f"engine_trace_seed{seed}.json").read_text())
    want = _golden_replay(golden, jengine, jarrivals, jfunction, "run")
    assert len(want) == golden["n"]
    for runner in ("run", "run_sharded"):
        got = _golden_replay(golden, engine, arrivals, function, runner)
        assert got == want, runner
    for i, (row, pinned) in enumerate(zip(want, golden["results"])):
        for a, b in zip(row, pinned):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-14, abs=0.0) or (
                    a != a and b != b), (i, a, b)
            else:
                assert a == b, (i, a, b)


# -- no fallback -------------------------------------------------------------
def test_cuda_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = make_spec(0)
    for kw in ({"backend": "cuda"}, {}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_port(spec, processes=1, **kw)


def test_cuda_backend_refuses_forked_workers():
    with pytest.raises(ValueError, match="processes=1"):
        run_port(make_spec(0), processes=2, backend="cuda")


def test_unknown_backend_is_rejected():
    for backend in ("pallas", "flat"):
        with pytest.raises(ValueError, match="backend"):
            run_port(make_spec(0), processes=1, backend=backend)


def test_fallback_warns_only_for_a_non_default_backend():
    """Faults send a run to the shard-isolated classic loops, which never
    reach the solver; forked workers stay allowed there."""
    spec = make_spec(0)
    arr, pipes = build(spec, arrivals, function)

    def faulty_run(**kw):
        eng = engine.ClusterEngine(
            n_dscs=spec["n_dscs"], n_cpu=spec["n_cpu"], seed=spec["seed"],
            faults=pfaults.FaultPlan(drive_mtbf_s=4.0, drive_mttr_s=1.5))
        tr = eng.run_sharded(pipes, arrivals=arr, duration_s=1.0,
                             n_shards=2, **kw)
        assert eng.last_shard_stats["path"] == "shard-isolated"
        return tr

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        faulty_run(processes=1)
    with pytest.warns(UserWarning, match="no effect"):
        faulty_run(processes=1, backend="torch")


def test_sharding_default_is_the_card():
    assert lindley.DEFAULT_BACKEND == "cuda"
    import inspect
    for fn in (sharding.run_partitioned, sharding._run_partitioned_pure,
               sharding._grouped_fcfs, engine.ClusterEngine.run_sharded,
               lindley.solve_segments):
        assert inspect.signature(fn).parameters["backend"].default == "cuda"
