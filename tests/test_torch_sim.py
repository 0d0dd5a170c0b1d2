"""The port's fleet simulator façade against the JAX package's, on the CPU.

``core/{placement,cost,dse,autoscale,engine_ref,scheduler}.py`` are copies
of the JAX package's numpy modules with ``repro.`` renamed to
``repro_torch.``; ``tests/test_torch_fleet.py``'s ``SEAMS`` check holds
them to that word for word (``scheduler``'s one seam: ``run_sharded``
defaults to the port's ``lindley.DEFAULT_BACKEND``, ``cuda``).  Here whole
runs of both packages on the same seeds, at short durations, must agree
byte for byte: ``ClusterSim.run`` with hedging, ``run_sharded`` over two
shards (the port's ``torch`` solver against JAX's ``segmented``),
``run_tenants``, ``run_autoscaled`` under the reactive and EWMA policies,
``max_throughput``, the fault and overload books, the heap-based
``ReferenceClusterEngine``, and the cost, energy and DSE figures.
"""
import dataclasses

import pytest
import torch

from repro.core import arrivals as JA
from repro.core import cost as JC
from repro.core import dse as JD
from repro.core import energy as JE
from repro.core import engine_ref as JR
from repro.core import function as JF
from repro.core import latency as JL
from repro.core import platforms as JP
from repro.core import scheduler as JS
from repro.core import workloads as JW
from repro_torch.core import arrivals as PA
from repro_torch.core import cost as PC
from repro_torch.core import dse as PD
from repro_torch.core import energy as PE
from repro_torch.core import engine_ref as PR
from repro_torch.core import function as PF
from repro_torch.core import latency as PL
from repro_torch.core import lindley as PLin
from repro_torch.core import platforms as PP
from repro_torch.core import scheduler as PS
from repro_torch.core import workloads as PW

COLUMNS = ("arrival", "finish", "winner", "drive", "start", "service",
           "hedged", "dscs_finish", "cpu_finish")
SIDES = {"jax": (JS, JA, JF, JL), "port": (PS, PA, PF, PL)}


def pipes(side, mixed=False):
    fn = SIDES[side][2]
    out = [fn.standard_pipeline(n) for n in ("asset_damage",
                                             "content_moderation")]
    if mixed:
        out.append(fn.standard_pipeline("asset_damage", accelerate=False))
    return out


def plain(x):
    """A dataclass tree as plain data, class names dropped (the two
    packages' classes differ), compared by ``repr`` so that NaNs match."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return repr(dataclasses.astuple(x))
    return repr(x)


def same_trace(a, b):
    for col in COLUMNS:
        assert getattr(a, col).tobytes() == getattr(b, col).tobytes(), col
    assert a.events == b.events


def same_books(sa, sb):
    assert sa.queue_stats() == sb.queue_stats()
    assert plain(sa.engine.power_stats()) == plain(sb.engine.power_stats())
    assert dict(sa.telemetry.counters) == dict(sb.telemetry.counters)
    assert plain(sa.fault_stats()) == plain(sb.fault_stats())
    assert plain(sa.overload_stats()) == plain(sb.overload_stats())


def sims(**kw):
    """The same ``ClusterSim`` from each package (``kw`` by side where a
    value is a callable of the side)."""
    out = {}
    for side, (sched, *_rest) in SIDES.items():
        args = {k: (v(side) if callable(v) else v) for k, v in kw.items()}
        out[side] = sched.ClusterSim(**args)
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_run_with_hedging_gives_the_same_results(seed):
    s = sims(n_dscs=6, n_cpu=8, hedge_budget_s=0.05, seed=seed)
    got = {side: sim.run(pipes(side, mixed=True), rps=120.0, duration_s=6.0)
           for side, sim in s.items()}
    assert len(got["port"]) == len(got["jax"]) > 300
    assert [plain(r) for r in got["port"]] == [plain(r) for r in got["jax"]]
    assert sum(r.hedged for r in got["port"]) > 0
    same_books(s["port"], s["jax"])


def test_run_sharded_torch_equals_jax_segmented():
    s = sims(n_dscs=8, n_cpu=10, hedge_budget_s=0.08, seed=5)
    tj = s["jax"].run_sharded(pipes("jax"), rps=300.0, duration_s=2.0,
                              n_shards=2, processes=1, backend="segmented")
    tp = s["port"].run_sharded(pipes("port"), rps=300.0, duration_s=2.0,
                               n_shards=2, processes=1, backend="torch")
    assert s["port"].engine.last_shard_stats["path"] == "partitioned"
    assert tp.n > 300
    same_trace(tp, tj)
    same_books(s["port"], s["jax"])


def test_run_sharded_defaults_to_the_card(monkeypatch):
    assert PLin.DEFAULT_BACKEND == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = PS.ClusterSim(n_dscs=4, n_cpu=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.run_sharded(pipes("port"), rps=100.0, duration_s=1.0,
                        n_shards=2, processes=1)


def test_run_tenants_gives_the_same_trace_and_reports():
    got = {}
    for side, (sched, arr, fn, _) in SIDES.items():
        accel = tuple(fn.standard_pipeline(n)
                      for n in ("asset_damage", "content_moderation"))
        specs = [sched.TenantSpec("latency", accel,
                                  arr.PoissonProcess(rate=15.0), sla_s=0.15),
                 sched.TenantSpec("noisy", accel,
                                  arr.BurstyOnOff(rate=40.0, burst_factor=6.0,
                                                  mean_on_s=2.0,
                                                  mean_off_s=8.0),
                                  sla_s=1.0, weight=2.0)]
        sim = sched.ClusterSim(n_dscs=3, n_cpu=3, seed=4)
        for scheduler in (None, sched.WeightedTimeSlice(quantum_s=0.02)):
            trace, reports = sim.run_tenants(specs, duration_s=12.0,
                                             scheduler=scheduler)
            got.setdefault(side, []).append(
                (trace, [plain(r) for r in reports],
                 plain(sim.tenant_stats())))
    for (tp, rp, sp), (tj, rj, sj) in zip(got["port"], got["jax"]):
        same_trace(tp, tj)
        assert tp.tenant.tobytes() == tj.tenant.tobytes()
        assert rp == rj and sp == sj
        assert tp.n > 100


@pytest.mark.parametrize("policy", ["reactive", "ewma"])
def test_run_autoscaled_gives_the_same_report(policy):
    got = {}
    for side, (sched, arr, fn, lat) in SIDES.items():
        lm = lat.LatencyModel()
        ps = pipes(side)
        pol = (sched.ReactivePolicy() if policy == "reactive"
               else sched.EWMAPolicy.for_pipelines(lm, ps))
        sim = sched.ClusterSim(n_dscs=4, n_cpu=12, hedge_budget_s=0.08,
                               seed=3, latency_model=lm)
        got[side] = sim.run_autoscaled(
            ps, policy=pol, arrivals=arr.DiurnalProcess(
                rate=60.0, amplitude=0.6, period_s=10.0), duration_s=10)
    assert got["port"].n_requests > 0 and got["port"].epochs > 0
    assert plain(got["port"]) == plain(got["jax"])


def test_max_throughput_gives_the_same_float():
    s = sims(n_dscs=4, n_cpu=4, hedge_budget_s=0.08, seed=2)
    got = {side: sim.max_throughput(pipes(side), sla_s=0.6, duration_s=4.0,
                                    hi=1024.0)
           for side, sim in s.items()}
    assert got["port"] == got["jax"] > 1.0


def test_fault_and_overload_books_match():
    def faults(side):
        sched = SIDES[side][0]
        return sched.FaultPlan(
            drive_mtbf_s=3.0, drive_mttr_s=5.0, stall_mtbf_s=4.0,
            cpu_mtbf_s=6.0, cpu_mttr_s=4.0, backing_fail_p=0.1,
            repair=sched.RepairModel(), detect_timeout_s=0.2)

    def overload(side):
        sched = SIDES[side][0]
        return sched.OverloadControl(backpressure=sched.Backpressure(
            target_depth=1.0, min_factor=0.1))

    for kw in ({"faults": faults}, {"overload": overload}):
        s = sims(n_dscs=4, n_cpu=4, seed=21, **kw)
        tr = {side: sim.engine.run_soa(
            pipes(side), arrivals=SIDES[side][1].PoissonProcess(rate=300.0),
            duration_s=6.0) for side, sim in s.items()}
        same_trace(tr["port"], tr["jax"])
        same_books(s["port"], s["jax"])
        book = (s["port"].fault_stats() if "faults" in kw
                else s["port"].overload_stats())
        assert book
    assert s["port"].overload_stats()["rejected"] > 0


@pytest.mark.parametrize("seed", [13, 21])
def test_reference_engine_gives_the_same_results(seed):
    got = {}
    for side, eng in (("jax", JR), ("port", PR)):
        arr = SIDES[side][1]
        ref = eng.ReferenceClusterEngine(n_dscs=4, n_cpu=8,
                                         hedge_budget_s=0.05, seed=seed)
        res = ref.run(pipes(side), arrivals=arr.BurstyOnOff(
            rate=70.0, burst_factor=4.0), duration_s=8)
        got[side] = ([plain(r) for r in res], plain(ref.queue_stats()),
                     dict(ref.telemetry.counters))
    assert len(got["port"][0]) > 100
    assert got["port"] == got["jax"]


def test_cost_and_energy_figures_match():
    lms = (JL.LatencyModel(), PL.LatencyModel())
    for name in JW.WORKLOADS:
        for plat in JP.PLATFORMS:
            for batch in (1, 8):
                kw = {"batch": batch}
                j = (JC.cost_efficiency_vs_baseline(lms[0], JW.WORKLOADS[name],
                                                    plat, **kw),
                     JC.cost_efficiency(lms[0], JP.PLATFORMS[plat],
                                        JW.WORKLOADS[name], **kw),
                     JE.energy_reduction_vs_baseline(
                         lms[0], JW.WORKLOADS[name], plat, **kw),
                     JE.pipeline_energy_j(lms[0], JP.PLATFORMS[plat],
                                          JW.WORKLOADS[name], **kw),
                     JC.rental_rate_usd_per_s(JP.PLATFORMS[plat]))
                p = (PC.cost_efficiency_vs_baseline(lms[1], PW.WORKLOADS[name],
                                                    plat, **kw),
                     PC.cost_efficiency(lms[1], PP.PLATFORMS[plat],
                                        PW.WORKLOADS[name], **kw),
                     PE.energy_reduction_vs_baseline(
                         lms[1], PW.WORKLOADS[name], plat, **kw),
                     PE.pipeline_energy_j(lms[1], PP.PLATFORMS[plat],
                                          PW.WORKLOADS[name], **kw),
                     PC.rental_rate_usd_per_s(PP.PLATFORMS[plat]))
                assert repr(p) == repr(j), (name, plat, batch)
    assert PC.dsa_capex_usd() == JC.dsa_capex_usd()


def test_dse_sweep_and_optimal_designs_match():
    jp, pp = JD.sweep(), PD.sweep()
    assert len(pp) == len(jp) > 10
    assert [plain(p) for p in pp] == [plain(p) for p in jp]
    assert ([p.feasible for p in pp] == [p.feasible for p in jp])
    for fn in ("optimal_design", "optimal_square_design"):
        assert plain(getattr(PD, fn)(pp)) == plain(getattr(JD, fn)(jp))
    assert ([plain(p) for p in PD.pareto(pp, "power_w")]
            == [plain(p) for p in JD.pareto(jp, "power_w")])


def test_core_docstrings_name_what_exists():
    """Every ``repro_torch.core.<module>[.<name>]`` the port's core
    modules name resolves: the engine's and the fault layer's references
    to the reference engine, the placement and the autoscaler included."""
    import importlib
    import pathlib
    import re
    core = pathlib.Path(PS.__file__).parent
    seen = set()
    for f in sorted(core.glob("*.py")):
        for ref in re.findall(r"repro_torch\.core\.(\w+)(?:\.(\w+))?",
                              f.read_text()):
            mod = importlib.import_module(f"repro_torch.core.{ref[0]}")
            assert not ref[1] or hasattr(mod, ref[1]), (f.name, ref)
            seen.add(ref[0])
    assert {"engine_ref", "placement", "autoscale"} <= seen
