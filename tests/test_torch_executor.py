"""The port's DSCS executor against the JAX package's, on the CPU, and the
port's package rules.

For each Table I workload the JAX executor is built, its parameters move
to the port with ``params_from_jax``, and one numpy-made request goes
through both on the DSCS deployment (the JAX kernel path in Pallas
interpret mode): the latency and energy breakdowns must be equal (the port
copies the numpy models verbatim) and so must the result.  The LM
workloads (chatbot, translation) run the reduced qwen3-8b on a (1, 32)
int32 token request.  The JAX
executor's vision initialiser is handed the port's draws (a seeded
``torch.Generator``) because jax.random's eager draws take about a minute
on a CPU; the rest of its constructor and its request path run unchanged.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import latency as jlatency
from repro.core import executor as jexecutor
from repro.core.platforms import PLATFORMS as JPLATFORMS
from repro.core.workloads import WORKLOADS as JWORKLOADS
from repro_torch.convert import params_from_jax
from repro_torch.core import energy, latency
from repro_torch.core import executor
from repro_torch.core.executor import DSCSExecutor
from repro_torch.core.platforms import PLATFORMS
from repro_torch.core.workloads import WORKLOADS
from repro_torch.models import vision

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
VISION = ["asset_damage", "content_moderation", "clinical", "ppe_detection",
          "remote_sensing"]


def _request(workload: str, size: int = 32) -> np.ndarray:
    rng = np.random.default_rng(11)
    if workload == "credit_risk":
        return rng.standard_normal((1, 200), dtype=np.float32)
    return rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)


def _port_drawn(workload: str):
    """The port's initialiser for ``workload``, returning a JAX tree."""
    init = executor._MODEL_BUILDERS[workload][0]

    def jax_init(key, **kw):
        tree = init(torch.Generator().manual_seed(0), device="cpu", **kw)
        return jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor)
            else t, tree, is_leaf=lambda t: isinstance(t, torch.Tensor))
    return jax_init


@pytest.mark.parametrize("workload", VISION + ["credit_risk"])
def test_executor_matches_jax(workload, monkeypatch):
    if workload in VISION:
        _, apply, kw = jexecutor._MODEL_BUILDERS[workload]
        monkeypatch.setitem(jexecutor._MODEL_BUILDERS, workload,
                            (_port_drawn(workload), apply, kw))
    jex = jexecutor.DSCSExecutor(workload, image_size=32)
    ex = DSCSExecutor(workload, image_size=32, device="cpu")
    ex.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jex.params),
                                device="cpu")
    req = _request(workload)
    want = jex(jnp.asarray(req))
    got = ex(torch.from_numpy(req))
    assert got.latency_breakdown == want.latency_breakdown
    assert got.energy_breakdown == want.energy_breakdown
    assert (got.platform, got.accelerated) == (want.platform, want.accelerated)
    assert tuple(got.result.shape) == tuple(want.result.shape)
    if workload == "credit_risk":
        np.testing.assert_allclose(got.result.numpy(),
                                   np.asarray(want.result), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.result.numpy(),
                                      np.asarray(want.result))


@pytest.mark.parametrize("platform", sorted(JPLATFORMS))
def test_analytic_models_equal_jax_package(platform):
    """latency/energy/dsa/workloads/platforms are verbatim copies."""
    assert sorted(WORKLOADS) == sorted(JWORKLOADS)
    jlm, lm = jlatency.LatencyModel(seed=3), latency.LatencyModel(seed=3)
    for name in sorted(JWORKLOADS):
        assert (lm.pipeline_breakdown(PLATFORMS[platform], WORKLOADS[name])
                == jlm.pipeline_breakdown(JPLATFORMS[platform],
                                          JWORKLOADS[name]))
        assert (energy.pipeline_energy_j(lm, PLATFORMS[platform],
                                         WORKLOADS[name])
                == jenergy.pipeline_energy_j(jlm, JPLATFORMS[platform],
                                             JWORKLOADS[name]))


@pytest.mark.parametrize("platform", ["Baseline-CPU", "DSCS-Serverless"])
def test_executor_plain_and_dsa_paths_agree(platform):
    """The port's own parameters (torch.Generator), both deployments."""
    ex = DSCSExecutor("asset_damage", platform=platform, image_size=32,
                      device="cpu")
    rep = ex(ex.make_request(torch.Generator().manual_seed(0)))
    assert rep.accelerated == (platform == "DSCS-Serverless")
    assert rep.result.shape == (1,)
    assert rep.latency_breakdown["total"] > 0
    assert rep.energy_breakdown["total"] > 0


@pytest.mark.parametrize("workload", ["chatbot", "translation"])
def test_lm_workloads_match_jax(workload):
    jex = jexecutor.DSCSExecutor(workload)
    ex = DSCSExecutor(workload, device="cpu")
    ex.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jex.params),
                                device="cpu")
    req = np.random.default_rng(12).integers(0, 512, (1, 32)).astype(np.int32)
    want = jex(jnp.asarray(req))
    got = ex(torch.from_numpy(req))
    assert got.latency_breakdown == want.latency_breakdown
    assert got.energy_breakdown == want.energy_breakdown
    assert (got.platform, got.accelerated) == (want.platform, want.accelerated)
    assert tuple(got.result.shape) == tuple(want.result.shape) == (1, 32)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))


@pytest.mark.parametrize("workload", ["chatbot", "translation"])
def test_lm_request_is_32_int32_tokens(workload):
    ex = DSCSExecutor(workload, device="cpu")
    req = ex.make_request(torch.Generator().manual_seed(3))
    assert req.shape == (1, 32) and req.dtype == torch.int32
    assert req.device.type == "cpu"
    assert 0 <= int(req.min()) and int(req.max()) < 512
    rep = ex(req)
    assert rep.result.shape == (1, 32) and rep.accelerated


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DSCSExecutor("credit_risk")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vision.resnet50_init(gen, width=0.125)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    assert DSCSExecutor("credit_risk", device="cpu").device.type == "cpu"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
    code = ("import sys, repro_torch.convert, repro_torch.core.executor, "
            "repro_torch.kernels.ref, repro_torch.kernels.ops, "
            "repro_torch.core.sharding, repro_torch.core.engine, "
            "repro_torch.core.lindley, repro_torch.kernels.lindley, "
            "repro_torch.kernels.ssd, repro_torch.kernels.rglru, "
            "repro_torch.configs, "
            "repro_torch.data.pipeline, repro_torch.models.decode, "
            "repro_torch.launch.steps, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.optim.adamw, "
            "repro_torch.checkpoint.manager, repro_torch.serving.batcher, "
            "repro_torch.distributed.compression, "
            "repro_torch.core.placement, repro_torch.core.cost, "
            "repro_torch.core.dse, repro_torch.core.autoscale, "
            "repro_torch.core.engine_ref, repro_torch.core.scheduler, "
            "repro_torch.analysis.roofline, repro_torch.analysis.report, "
            "repro_torch.analysis.collectives, repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(PORT.parent)},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
