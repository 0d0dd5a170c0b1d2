"""``cfg.remat`` on one card and the in-place AdamW update, on the CPU.

The JAX package wraps each layer group, each ``rem`` layer and each
encoder block in ``jax.checkpoint`` under ``cfg.remat``
(``src/repro/models/transformer.py:484``, ``:499``, ``:521``) and donates
the parameters and the optimizer state to its train step
(``src/repro/launch/train.py:64``, ``donate_argnums=(0, 1)``).  The port
runs the same three under ``torch.utils.checkpoint`` and updates the
parameters and both moments in their own storage (``adamw.apply_``).
Here, for every trained family (Mamba-2, RecurrentGemma with ``rem``
layers, qwen3, qwen3-moe, MLA's minicpm3, the ViT and Whisper), reduced:
the loss is the same with remat on and off and every gradient leaf within
1e-6 relative; under remat the only tensors autograd keeps inside the
layer stack are the inputs of its groups, ``rem`` layers and encoder
blocks; the in-place update keeps every leaf's storage and writes the
bytes ``adamw.apply`` returns, and stays within
``test_adamw_steps_match_jax``'s tolerances of the JAX package's
``adamw.apply``; on ``meta`` tensors, through the dry run's memory
tracker, the train step's outputs alias the parameters and the AdamW
state and its peak is below the functional update's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs.paper_suite import PAPER_LM_SUITE
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

B, S = 2, 32
# name: what each changes from ``reduced()`` (RecurrentGemma at 5 layers:
# one (R, R, A) group and two ``rem`` layers)
FAMILIES = {"mamba2-370m": {}, "recurrentgemma-2b": {"num_layers": 5,
                                                     "sliding_window": 16},
            "qwen3-8b": {}, "qwen3-moe-235b-a22b": {}, "minicpm3-4b": {},
            "vit-632m": {}, "whisper-medium": {}}


def _cfg(name, **kw):
    base = dict(PAPER_LM_SUITE).get(name) or get_arch(name)
    return dataclasses.replace(base.reduced(), **{**FAMILIES[name], **kw})


def _family(name):
    """(cfg, params, batch) of a reduced family, remat on."""
    cfg = _cfg(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = TokenStream(cfg, B, S, 1, device="cpu").batch_at(0)
    return cfg, params, batch


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_leaves_the_loss_and_gradients_unchanged(name):
    cfg, params, batch = _family(name)
    assert cfg.remat
    loss, grads = ST.value_and_grad(cfg, params, batch)
    loss0, grads0 = ST.value_and_grad(dataclasses.replace(cfg, remat=False),
                                      params, batch)
    assert torch.isfinite(loss) and loss.item() == loss0.item()
    pairs = list(zip(T.tree_leaves(grads), T.tree_leaves(grads0)))
    assert len(pairs) == len(T.tree_leaves(params))
    for g, g0 in pairs:
        assert torch.isfinite(g).all()
        assert _rel(g, g0) <= 1e-6


def _stack_saves(monkeypatch, cfg, params, batch):
    """The tensors autograd keeps for the backward (a
    ``saved_tensors_hooks`` outside any checkpoint) while the decoder's or
    the encoder's layer stack runs, and the input each stack was given."""
    saved, inputs, inside = [], [], []

    def flagged(real):
        def run(cfg_, blocks_or_params, x, ctx):
            inputs.append(x)
            inside.append(True)
            try:
                return real(cfg_, blocks_or_params, x, ctx)
            finally:
                inside.pop()
        return run

    for fn in ("run_decoder_blocks", "run_encoder_blocks"):
        monkeypatch.setattr(T, fn, flagged(getattr(T, fn)))

    def pack(t):
        if inside:
            saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ST.value_and_grad(cfg, params, batch)
    monkeypatch.undo()
    return saved, inputs


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_keeps_only_the_stack_inputs(monkeypatch, name):
    """Under remat the stack keeps one tensor a group, ``rem`` layer and
    encoder block: its input, of the residual stream's shape, the first of
    them the stack's own input; without remat every layer keeps its
    activations."""
    cfg, params, batch = _family(name)
    period = len(cfg.block_pattern)
    units = cfg.num_layers // period + cfg.num_layers % period
    units += cfg.encoder_layers
    saved, inputs = _stack_saves(monkeypatch, cfg, params, batch)
    assert len(saved) == units
    assert {t.shape for t in saved} == {x.shape for x in inputs}
    assert all(t.shape[-1] == cfg.d_model and t.dim() == 3 for t in saved)
    firsts = {x.data_ptr() for x in inputs}
    assert firsts <= {t.data_ptr() for t in saved}
    off, _ = _stack_saves(monkeypatch, dataclasses.replace(cfg, remat=False),
                          params, batch)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert len(off) > 3 * units and nbytes(off) > 3 * nbytes(saved)


def _tree(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (rng.standard_normal(shape, dtype=np.float32)
                           * scale).astype(dtype)
    return {"w": draw(7, 5), "blocks": {"a": draw(2, 3, 4)},
            "rem": [draw(6)]}


def _torch_tree(tree, dtype=torch.float32):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_update_keeps_storage_and_the_functional_bytes(dtype):
    """Four steps of ``apply_`` against ``apply`` on the same gradients:
    byte-equal parameters, moments, step and metrics; every leaf in the
    storage it started in; a bf16 parameter stays bf16."""
    params = _torch_tree(_tree(2), dtype)
    state = adamw.init(params)
    mine = T.tree_map(torch.clone, params)
    mstate = adamw.init(mine)
    ptrs = [t.data_ptr() for t in T.tree_leaves((mine, mstate))]
    sched = adamw.cosine_schedule(1e-2, 2, 5)
    for step in range(4):
        g = _torch_tree(_tree(10 + step, scale=0.5), dtype)
        params, state, m = adamw.apply(params, g, state, sched=sched)
        out, ostate, om = adamw.apply_(mine, g, mstate, sched=sched)
        assert out is mine and ostate is mstate
        for a, b in zip(T.tree_leaves((params, state)),
                        T.tree_leaves((mine, mstate))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(m["lr"], om["lr"])
        assert torch.equal(m["grad_norm"], om["grad_norm"])
    assert [t.data_ptr() for t in T.tree_leaves((mine, mstate))] == ptrs
    assert all(t.dtype == dtype for t in T.tree_leaves(mine))


def test_in_place_update_holds_two_leaf_temporaries():
    """On ``meta`` tensors under the dry run's memory tracker: beside the
    bf16 parameters and gradients and the fp32 state, ``apply_`` holds
    at most two fp32 temporaries of one leaf at a time (and scalars),
    where ``apply`` holds a second tree of each."""
    from torch.distributed._tools.mem_tracker import MemTracker
    shape = (64, 1024)
    meta = lambda dtype: torch.empty(shape, dtype=dtype, device="meta")
    params = {f"w{i}": meta(torch.bfloat16) for i in range(3)}
    grads = {k: meta(torch.bfloat16) for k in params}
    leaf32 = 64 * 1024 * 4
    peaks = {}
    for update in (adamw.apply_, adamw.apply):
        state = adamw.state_shapes(params)
        held = T.tree_leaves((params, grads, state))
        mem = MemTracker()
        mem.track_external(*held)
        with mem:
            update(params, grads, state,
                   sched=adamw.cosine_schedule(1e-2, 2, 5))
        peak = sum(v["Total"] for v in
                   mem.get_tracker_snapshot("peak").values())
        peaks[update] = peak - DR.tree_nbytes(held)
    assert leaf32 < peaks[adamw.apply_] <= 2 * leaf32 + 1024
    assert peaks[adamw.apply] >= 3 * 3 * leaf32      # new params, mu, nu


def test_in_place_update_matches_jax():
    """``test_adamw_steps_match_jax`` with the in-place update."""
    params, jparams = _torch_tree(_tree(2)), _tree(2)
    state, jstate = adamw.init(params), jadamw.init(jparams)
    sched = adamw.cosine_schedule(1e-2, 2, 5)
    jsched = jadamw.cosine_schedule(1e-2, 2, 5)
    for step in range(4):
        g = _tree(10 + step, scale=0.5)
        params, state, m = adamw.apply_(params, _torch_tree(g), state,
                                        sched=sched)
        jparams, jstate, jm = jadamw.apply(jparams, g, jstate, sched=jsched)
        assert int(state.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for tree, jtree in ((params, jparams), (state.mu, jstate.mu),
                            (state.nu, jstate.nu)):
            for a, b in zip(T.tree_leaves(tree), jax.tree.leaves(jtree)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, {"grad_compression": "int8"},
                                {"microbatches": 2}])
def test_the_train_step_updates_in_place(kw):
    """``make_train_step`` hands back the trees it was given, every
    parameter and moment in its own storage, with the bytes the functional
    update gives from the same gradient."""
    cfg, params, _ = _family("mamba2-370m")
    batch = TokenStream(cfg, 4, S, 1, device="cpu").batch_at(0)
    tcfg = TrainConfig(warmup_steps=1, **kw)
    want = T.tree_map(torch.clone, params)
    wstate = adamw.init(want)
    _, grads = ST.make_grad_fn(cfg, tcfg)(want, batch)
    want, wstate, _ = adamw.apply(want, grads, wstate,
                                  sched=adamw.cosine_schedule(
                                      tcfg.lr, 1, tcfg.total_steps))
    opt = adamw.init(params)
    ptrs = [t.data_ptr() for t in T.tree_leaves((params, opt))]
    out, ostate, m = ST.make_train_step(cfg, tcfg)(params, opt, batch)
    assert out is params and ostate is opt and int(opt.step) == 1
    assert [t.data_ptr() for t in T.tree_leaves((params, opt))] == ptrs
    for a, b in zip(T.tree_leaves((params, opt)),
                    T.tree_leaves((want, wstate))):
        assert torch.equal(a, b)


def _meta_step(cfg, update):
    """One train step of ``cfg`` on ``meta`` tensors (one card) under the
    dry run's tracker, with ``update`` as the train step's AdamW: the
    ``memory`` record of ``dryrun.count_step`` and the bytes of the
    parameters and the AdamW state."""
    from torch.distributed._tools.mem_tracker import MemTracker
    params = T.param_shapes(cfg)
    opt = adamw.state_shapes(params)
    batch = {k: torch.empty((4, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    args = (params, opt, batch)
    mem = MemTracker()
    mem.track_external(*T.tree_leaves(args))
    real = adamw.apply_
    adamw.apply_ = update
    try:
        with mem, DR.StepCounter():     # the data-dependent sizes
            out = ST.make_train_step(cfg, TrainConfig())(params, opt, batch)
    finally:
        adamw.apply_ = real
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    alias = DR.alias_nbytes(out, args)
    return ({"argument_bytes": DR.tree_nbytes(args),
             "output_bytes": DR.tree_nbytes(out), "alias_bytes": alias,
             "peak_bytes": peak},
            DR.tree_nbytes(params) + DR.tree_nbytes(opt))


@pytest.mark.parametrize("name", ["mamba2-370m", "qwen3-8b"])
def test_the_dry_run_counts_the_donated_update(name):
    """The in-place step's outputs alias every parameter and AdamW state
    byte (JAX's donated accounting); the functional update's alias none,
    and hold a second tree of each beside the arguments at its peak,
    which the in-place step's peak stays below."""
    cfg = _cfg(name)
    donated, held = _meta_step(cfg, adamw.apply_)
    functional, _ = _meta_step(cfg, adamw.apply)
    assert donated["alias_bytes"] == held > 0
    assert functional["alias_bytes"] == 0
    assert donated["argument_bytes"] == functional["argument_bytes"]
    assert functional["peak_bytes"] >= functional["argument_bytes"] + held
    assert donated["peak_bytes"] < functional["peak_bytes"]
