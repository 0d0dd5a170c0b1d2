"""The port's training slice against the JAX package, on the CPU.

``get_arch("mamba2-370m").reduced()`` (2 layers, d_model 128, 8 SSD heads
of 32, state 16, chunk 32, vocab 512, fp32): parameters from the JAX
package's ``init_params``, carried across by ``params_from_jax``, batches
from both packages' ``TokenStream`` (byte-equal), then the loss, its
gradient and whole AdamW train steps (with and without the int8 gradient
compression, with and without microbatches) through both packages.  Both
sides are fp32 on one CPU and differ in the order of fp32 sums (the SSD's
chunk-by-chunk carry against an associative scan, XLA's fusion against
PyTorch's kernels), so the loss is held at 1e-5 and each gradient leaf at
a relative Frobenius error of 1e-4; after three steps, where Adam's
normalised update amplifies small gradient differences, losses at 1e-4
and parameters at 1e-3.  The optimizer, the schedule, the loss, the data
stream and the checkpoints are held one by one; crash-and-resume is
checked exactly.  The JAX side runs on a local mesh, as
``tests/test_distributed.py`` builds it.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jget_arch
from repro.data.pipeline import TokenStream as JTokenStream
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import steps as ST
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ARCH = "mamba2-370m"
ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params) of the reduced model."""
    jcfg = jget_arch(ARCH).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return get_arch(ARCH).reduced(), jcfg, jparams, params


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def _leaf_pairs(tree, jtree):
    """(port leaf, JAX leaf) in ``jax.tree.leaves`` order."""
    jleaves = jax.tree.leaves(jtree)
    leaves = T.tree_leaves(tree)
    assert len(leaves) == len(jleaves)
    return list(zip(leaves, jleaves))


# ---- the loss, the optimizer, the data ---------------------------------------

@pytest.mark.parametrize("pad", [False, True])
def test_softmax_xent_and_its_gradient_match_jax(pad):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 37), dtype=np.float32) * 3.0
    if pad:          # the padded-vocab columns carry unembed's -1e30 bias
        logits[..., 30:] = -1e30
    labels = rng.integers(0, 30, (2, 5)).astype(np.int32)
    lg = torch.from_numpy(logits).requires_grad_()
    loss = T.softmax_xent(lg, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(loss, lg)
    jloss, jgrad = jax.value_and_grad(JT.softmax_xent)(jnp.asarray(logits),
                                                       jnp.asarray(labels))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    # bf16 logits are taken in fp32, as in JAX
    lb = T.softmax_xent(torch.from_numpy(logits).bfloat16(),
                        torch.from_numpy(labels))
    jb = JT.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                         jnp.asarray(labels))
    np.testing.assert_allclose(lb.item(), float(jb), rtol=1e-6)


def test_cosine_schedule_matches_jax():
    sched = adamw.cosine_schedule(3e-4, 3, 10)
    jsched = jadamw.cosine_schedule(3e-4, 3, 10)
    for step in range(14):
        got = sched(torch.tensor(step, dtype=torch.int32))
        want = jsched(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-12)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((7, 5), dtype=np.float32) * scale,
            "blocks": {"a": rng.standard_normal((2, 3, 4),
                                                dtype=np.float32) * scale},
            "rem": [rng.standard_normal(6, dtype=np.float32) * scale]}


def _torch_tree(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(1, scale=2.0)
    got, norm = adamw.clip_by_global_norm(_torch_tree(g), max_norm)
    jgot, jnorm = jadamw.clip_by_global_norm(g, max_norm)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(adamw.global_norm(_torch_tree(g)).item(),
                               float(jadamw.global_norm(g)), rtol=1e-6)
    for a, b in _leaf_pairs(got, jgot):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_steps_match_jax():
    params, jparams = _torch_tree(_tree(2)), _tree(2)
    state, jstate = adamw.init(params), jadamw.init(jparams)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    sched = adamw.cosine_schedule(1e-2, 2, 5)
    jsched = jadamw.cosine_schedule(1e-2, 2, 5)
    for step in range(4):
        g = _tree(10 + step, scale=0.5)
        params, state, m = adamw.apply(params, _torch_tree(g), state,
                                       sched=sched)
        jparams, jstate, jm = jadamw.apply(jparams, g, jstate, sched=jsched)
        assert int(state.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for tree, jtree in ((params, jparams), (state.mu, jstate.mu),
                            (state.nu, jstate.nu)):
            for a, b in _leaf_pairs(tree, jtree):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-7)


def test_adamw_keeps_a_bf16_parameter_in_bf16():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state.mu["w"].dtype == torch.float32
    new, state, _ = adamw.apply(params, {"w": torch.ones(4)}, state,
                                sched=adamw.cosine_schedule(1e-2, 1, 2))
    assert new["w"].dtype == torch.bfloat16 and (new["w"] < 1).all()


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 2)])
def test_token_stream_bytes_equal_jax(seed, step):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    got = TokenStream(cfg, 3, 17, seed, device="cpu").batch_at(step)
    want = JTokenStream(jcfg, 3, 17, seed).batch_at(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()
    it = TokenStream(cfg, 3, 17, seed, device="cpu").iter_from(step)
    assert torch.equal(next(it)["tokens"], got["tokens"])


# ---- the model's loss and gradient -------------------------------------------

def _batch(cfg, jcfg, seed=0, step=0, batch=B, seq=S):
    b = TokenStream(cfg, batch, seq, seed, device="cpu").batch_at(step)
    jb = JTokenStream(jcfg, batch, seq, seed).batch_at(step)
    return b, jb


def test_loss_and_gradients_match_jax(model):
    cfg, jcfg, jparams, params = model
    batch, jbatch = _batch(cfg, jcfg)
    mesh = make_local_mesh()
    shard = JSH.make_act_sharder(mesh, JSH.TRAIN_RULES)
    with mesh:
        jloss, jgrads = jax.value_and_grad(JST.loss_fn, argnums=1)(
            jcfg, jparams, jbatch, shard)
    loss, grads = ST.value_and_grad(cfg, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert loss.item() == ST.loss_fn(cfg, params, batch).item()
    pairs = _leaf_pairs(grads, jgrads)
    assert len(pairs) == 10
    for g, jg in pairs:
        assert g.shape == jg.shape and g.dtype == torch.float32
        assert _rel(g, jg) <= 1e-4


@pytest.mark.parametrize("compression,microbatches", [
    ("none", 1), ("int8", 1), ("none", 2)])
def test_train_steps_match_jax(model, compression, microbatches):
    cfg, jcfg, jparams, params = model
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=6,
              grad_compression=compression, microbatches=microbatches)
    step_fn = ST.make_train_step(cfg, TrainConfig(**kw))
    mesh = make_local_mesh()
    with mesh:
        jstep = jax.jit(JST.make_train_step(jcfg, mesh, JTrainConfig(**kw)))
        jp, jo = jparams, jadamw.init(jparams)
        # the step updates in place (JAX's donation): a copy of the
        # module's tree, which the other cases start from
        p = T.tree_map(torch.clone, params)
        o = adamw.init(p)
        for step in range(3):
            batch, jbatch = _batch(cfg, jcfg, seed=1, step=step, batch=4)
            p, o, m = step_fn(p, o, batch)
            jp, jo, jm = jstep(jp, jo, jbatch)
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                       rtol=1e-6)
    assert int(o.step) == int(jo.step) == 3
    for a, b in _leaf_pairs(p, jp):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= 1e-3


def test_the_embedding_gradient_sums_repeated_tokens_in_fp32():
    """A bf16 table's gradient over a Zipf stream (the frequent tokens
    seen hundreds of times) rounds once a row: within 4e-3 of the fp64
    sum, where indexing's own backward, accumulating in bf16, is 2.4e-2
    off; an fp32 table's, like indexing's, within 1e-6."""
    rng = np.random.default_rng(0)
    V, D = 1000, 64
    tok = torch.from_numpy(np.minimum(rng.zipf(1.3, (4, 1024)), V - 1))
    g = torch.from_numpy(rng.standard_normal((4, 1024, D)) * 1e-2 + 1e-3
                         ).float()
    truth = torch.zeros(V, D, dtype=torch.float64).index_add_(
        0, tok.reshape(-1), g.reshape(-1, D).double())
    cfg = get_arch(ARCH).reduced()
    rel = lambda a: ((a.double() - truth).norm() / truth.norm()).item()
    for dtype, bar in ((torch.bfloat16, 4e-3), (torch.float32, 1e-6)):
        table = torch.zeros(V, D, dtype=dtype, requires_grad=True)
        (got,) = torch.autograd.grad(
            T.embed_tokens(cfg, {"embed": table}, tok), table, g.to(dtype))
        (own,) = torch.autograd.grad(table[tok], table, g.to(dtype))
        assert got.dtype == dtype and rel(got) <= bar
        if dtype == torch.bfloat16:
            assert rel(own) > 5 * bar
        else:
            assert rel(own) <= bar


def test_microbatches_match_one_batch(model):
    """Two microbatches of 2 give the loss and the update of one batch of 4
    (equal halves: the mean of the half-batch means is the mean)."""
    cfg, _, _, params = model
    batch = TokenStream(cfg, 4, S, 2, device="cpu").batch_at(0)
    out = {}
    for n in (1, 2):
        fn = ST.make_train_step(cfg, TrainConfig(microbatches=n,
                                                 warmup_steps=1))
        p = T.tree_map(torch.clone, params)     # updated in place
        out[n] = fn(p, adamw.init(p), batch)
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(T.tree_leaves(p2), T.tree_leaves(p1)):
        assert _rel(a, b.numpy()) <= 1e-5


def test_params_from_jax_carries_an_adamw_state(model):
    """A NamedTuple (the JAX AdamWState) is rebuilt from positional
    arguments; its int32 step becomes an int, as every integer scalar."""
    cfg, jcfg, jparams, params = model
    jstate = jadamw.init(jparams)
    st = params_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert type(st) is type(jstate) and st._fields == ("step", "mu", "nu")
    assert st.step == 0
    want = adamw.init(params)
    for tree, ptree in ((st.mu, want.mu), (st.nu, want.nu)):
        for a, b in zip(T.tree_leaves(tree), T.tree_leaves(ptree)):
            assert a.dtype == torch.float32 and torch.equal(a, b)
    port = adamw.AdamWState(torch.tensor(st.step, dtype=torch.int32),
                            st.mu, st.nu)
    assert len(T.tree_leaves(port)) == 1 + 2 * len(T.tree_leaves(params))


# ---- checkpoints and the launcher --------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    """tests/test_distributed.py::test_checkpoint_roundtrip_and_retention,
    with a bf16 leaf and an AdamWState, restored byte for byte."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones(2), torch.zeros(5, dtype=torch.int32)],
            "h": (torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
                  .bfloat16()),
            "opt": adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                                    {"m": torch.full((2,), 0.5)},
                                    {"m": torch.full((2,), 0.25)})}
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, tree, extras={"step": step}, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step, extras = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 5 and extras["step"] == 5
    assert isinstance(restored["opt"], adamw.AdamWState)
    for g, w in zip(T.tree_leaves(restored), T.tree_leaves(tree)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    # retention: only 2 newest kept, no .tmp left behind
    kept = sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    import json
    meta = json.loads((tmp_path / "step_00000005" / "index.json").read_text())
    assert [m["dtype"] for m in meta["leaves"]] == [
        "float32", "float32", "int32", "bfloat16", "int32", "float32",
        "float32"]
    with pytest.raises(ValueError, match="tree structure changed"):
        ckpt.restore(str(tmp_path), {"a": tree["a"]}, device="cpu")


def _bf16_values():
    """(2, 3) values that bf16 holds exactly, with signs and a fraction."""
    return np.array([[-2.0, -0.62890625, 0.73828125],
                     [2.109375, 3.484375, 4.84375]], np.float32)


def test_checkpoint_layout_reads_as_the_jax_package_writes_it(tmp_path):
    """A tree saved by the JAX package's manager restores in the port, its
    bf16 leaf (a ``|V2`` ``.npy``) bit for bit."""
    from repro.checkpoint import manager as jckpt
    h = jnp.asarray(_bf16_values()).astype(jnp.bfloat16)
    jtree = {"a": jnp.arange(6.0).reshape(2, 3), "b": [jnp.ones(4)], "h": h}
    jckpt.save(str(tmp_path), 3, jtree)
    tmpl = {"a": torch.zeros(2, 3), "b": [torch.zeros(4)],
            "h": torch.zeros(2, 3, dtype=torch.bfloat16)}
    got, step, _ = ckpt.restore(str(tmp_path), tmpl, device="cpu")
    assert step == 3
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["b"][0], torch.ones(4))
    assert got["h"].dtype == torch.bfloat16
    jbits = np.asarray(h).view(np.int16)
    assert np.array_equal(got["h"].view(torch.int16).numpy(), jbits)


def test_checkpoint_bf16_leaf_is_written_as_the_jax_package_writes_it(
        tmp_path):
    """A bf16 leaf saved by the port is the JAX package's file, byte for
    byte: a ``|V2`` ``.npy`` of the bits, ``"bfloat16"`` in the index."""
    import json

    from repro.checkpoint import manager as jckpt
    vals = _bf16_values()
    jckpt.save(str(tmp_path / "jax"), 1,
               {"h": jnp.asarray(vals).astype(jnp.bfloat16)})
    ckpt.save(str(tmp_path / "port"), 1,
              {"h": torch.from_numpy(vals).bfloat16()})
    files = [tmp_path / side / "step_00000001" / "leaf_0.npy"
             for side in ("jax", "port")]
    jarr, parr = (np.load(f) for f in files)
    assert jarr.dtype == parr.dtype == np.dtype("V2")
    assert files[0].read_bytes() == files[1].read_bytes()
    for side in ("jax", "port"):
        meta = json.loads((tmp_path / side / "step_00000001" /
                           "index.json").read_text())
        assert meta["leaves"] == [{"shape": [2, 3], "dtype": "bfloat16"}]


def test_checkpoint_restores_a_bf16_leaf_stored_as_int16_bits(tmp_path):
    """The port's older layout, bf16 bits as an ``<i2`` ``.npy``, still
    restores."""
    bits = torch.from_numpy(_bf16_values()).bfloat16().view(torch.int16)
    ckpt.save(str(tmp_path), 1, {"h": bits})
    index = tmp_path / "step_00000001" / "index.json"
    index.write_text(index.read_text().replace('"int16"', '"bfloat16"'))
    got, _, _ = ckpt.restore(str(tmp_path),
                             {"h": torch.zeros(2, 3, dtype=torch.bfloat16)},
                             device="cpu")
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), bits)


def test_train_crash_restart_resumes_identically(tmp_path):
    """tests/test_distributed.py::test_train_crash_restart_resumes_identically
    on the port: 8 steps straight vs 4 + 'crash' + resume 4, exactly equal
    on the CPU (the stream and the checkpointed state are deterministic)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(smoke=True, steps=8, batch=2, seq=32, checkpoint_every=4,
              log_every=100, device="cpu")
    straight = train(ARCH, ckpt_dir=d1, **kw)
    part1 = train(ARCH, ckpt_dir=d2, stop_at=4, **kw)
    part2 = train(ARCH, ckpt_dir=d2, resume=True, **kw)
    assert len(straight) == 8 and len(part1) == 4 and len(part2) == 4
    assert part1 + part2 == straight
    assert ckpt.latest_step(d2) == ckpt.latest_step(d1) == 8
    tmpl = (T.init_params(get_arch(ARCH).reduced(),
                          torch.Generator().manual_seed(9), device="cpu"),)
    tmpl = (tmpl[0], adamw.init(tmpl[0]))
    (pa, oa), _, _ = ckpt.restore(d1, tmpl, device="cpu")
    (pb, ob), _, _ = ckpt.restore(d2, tmpl, device="cpu")
    for a, b in zip(T.tree_leaves((pa, oa)), T.tree_leaves((pb, ob))):
        assert torch.equal(a, b)
    assert np.isfinite(straight).all() and straight[-1] < straight[0]


def test_train_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(ARCH, steps=1, batch=1, seq=32, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenStream(get_arch(ARCH), 1, 8).batch_at(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(str(tmp_path), {}, device=None)
    # MLA's training, once refused naming its ROADMAP item, runs on the
    # CPU when asked; an architecture the registry lacks is refused
    losses = train("minicpm3-4b", steps=1, batch=1, seq=32,
                   ckpt_dir=str(tmp_path / "mla"), device="cpu")
    assert len(losses) == 1 and math.isfinite(losses[0])
    with pytest.raises(KeyError, match="unknown arch"):
        train("minicpm3-4b-typo", steps=1, batch=1, seq=32,
              ckpt_dir=str(tmp_path), device="cpu")


def test_train_cli_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] step 2/2 loss=" in out.stdout
    assert "[train] first loss" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 2
