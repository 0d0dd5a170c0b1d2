"""Rank functions of the port's mesh tests (``tests/test_torch_moe_ep.py``,
``tests/test_torch_serve_mesh.py``, ``tests/test_torch_train_mesh.py``,
``tests/test_torch_train_decode2d.py`` and others):
``launch.mesh.run_ranks`` spawns each
rank, which imports this module by name (no JAX here), joins a gloo group
on the CPU, runs its cases and writes its results to ``rank<r>.npz``."""
import os

import numpy as np
import torch
import torch.distributed as dist

EP_SHAPES = ((2, 4), (1, 8))
EP_CAPACITY = (8.0, 1.25)


def ep_rank(rank, world, store_dir, inputs, out_dir):
    """``moe_ffn_ep`` on (2, 4) and (1, 8) meshes and
    ``moe_ffn_ep_resident`` on (2, 4), at each capacity factor, on this
    rank's blocks of ``inputs`` (x (B, S, D), wg, w1, w3, w2); and whether
    a mesh the world does not fill raises.  Then the same under autograd:
    the gradients of this rank's share of sum(out * c) (c from ``inputs``,
    each data block's share split evenly over the model axis) in x, the
    gate and the expert blocks."""
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    d = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    E = d["w1"].shape[0]
    res = {}
    try:
        M.make_mesh((3, 3), ("data", "model"), device="cpu")
        res["mismatch_raises"] = np.int32(0)
    except ValueError:
        res["mismatch_raises"] = np.int32(1)
    for shape in EP_SHAPES:
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        x = SH.local_block(d["x"], SH.P("data"), mesh)
        for name in ("ep", "resident"):
            if name == "resident" and shape[0] == 1:
                continue
            res_ = name == "resident"
            s1 = SH.P("model", None, "data") if res_ else SH.P("model")
            s2 = SH.P("model", "data") if res_ else SH.P("model")
            fn = moe_ep.moe_ffn_ep_resident if res_ else moe_ep.moe_ffn_ep
            blocks = [SH.local_block(d["w1"], s1, mesh),
                      SH.local_block(d["w3"], s1, mesh),
                      SH.local_block(d["w2"], s2, mesh)]
            kw = dict(num_experts=E, d_ff=d["w1"].shape[2], k=int(d["k"]),
                      act="silu", mesh=mesh, batch_axes=("data",))
            for cf in EP_CAPACITY:
                key = f"{shape[0]}x{shape[1]}_{name}_{cf}"
                with torch.no_grad():
                    out, aux = fn(x, d["wg"], *blocks, capacity_factor=cf,
                                  **kw)
                res[key] = out.numpy()
                res[key + "_aux"] = aux.numpy()
                args = [t.clone().requires_grad_()
                        for t in [x, d["wg"], *blocks]]
                out, _ = fn(*args, capacity_factor=cf, **kw)
                c = SH.local_block(d["c"], SH.P("data"), mesh)
                grads = torch.autograd.grad((out * c).sum() / shape[1], args)
                for n, g in zip(("x", "wg", "w1", "w3", "w2"), grads):
                    res[f"{key}_d{n}"] = g.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def serve_inputs(cfg, kw):
    """The whole batch's prompts of a ``serve_rank`` case, and Whisper's
    encoder frames (a seeded normal draw; None without an encoder)."""
    from repro_torch.data.pipeline import RequestStream
    B, S = kw["batch"], kw["prompt"]
    tok = torch.from_numpy(RequestStream(cfg, B, S, kw.get("seed", 0))
                           .requests_at(0)["tokens"])
    frames = None
    if cfg.frontend == "audio_frames":
        frames = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                             generator=torch.Generator().manual_seed(7))
    return tok, frames


def serve_rank(rank, world, store_dir, cases, out_dir):
    """For each case (arch, mesh shape, config overrides, serve keywords,
    the rules' name): ``serve`` over the mesh; then the prefill step on
    this rank's block of the served batch (the logits gathered over the
    batch's axes, and the rank's cache leaves), the cache grown to the
    capacity, and the decode steps fed the served tokens (the last
    logits gathered, the rank's cache leaves).  The rank's coordinates
    go with them."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    real = SV.get_arch
    res = {}
    for i, (arch, shape, over, kw, rname) in enumerate(cases):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        SV.get_arch = lambda name, cfg=cfg: cfg
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        coords = SH.mesh_coords(mesh)
        res[f"{i}_coords"] = np.array([coords["data"], coords["model"]])
        rules = getattr(SH, rname)
        gen = SV.serve(arch, device="cpu", mesh=mesh, rules=rules,
                       **kw)["generated"]
        res[f"{i}_generated"] = gen
        B, S, G = kw["batch"], kw["prompt"], kw["gen"]
        baxes = SH.batch_axes(B, rules, mesh)
        bspec = SH.batch_spec((B, S), rules, mesh)
        params = T.place_params(cfg, torch.Generator().manual_seed(
            kw.get("seed", 0)), mesh, rules=rules, device="cpu")
        tok, frames = serve_inputs(cfg, kw)
        batch = {"tokens": SH.local_block(tok, bspec, mesh)}
        if frames is not None:
            batch["encoder_frames"] = SH.local_block(frames, bspec, mesh)
        feed = SH.local_block(torch.from_numpy(gen), bspec, mesh)
        step = ST.make_prefill_step(cfg, mesh=mesh, batch_axes=baxes,
                                    rules=rules)
        decode = ST.make_decode_step(cfg, mesh=mesh, batch_axes=baxes,
                                     rules=rules, seq=S + G)
        with torch.no_grad():
            logits, cache = step(params, batch)
            res[f"{i}_logits"] = SV.gather_batch(logits, mesh, baxes).numpy()
            for j, t in enumerate(tree_leaves(cache)):
                res[f"{i}_prefill_c{j}"] = t.clone().numpy()
            cache = SV._grow_cache(cfg, cache, feed.shape[0], S + G,
                                   shard=SH.make_act_sharder(mesh, baxes,
                                                             rules), seq=S)
            for t in range(G - 1):
                logits, cache = decode(params, cache,
                                       {"tokens": feed[:, t:t + 1]})
        res[f"{i}_decode_logits"] = SV.gather_batch(logits, mesh,
                                                    baxes).numpy()
        for j, t in enumerate(tree_leaves(cache)):
            res[f"{i}_decode_c{j}"] = t.numpy()
    SV.get_arch = real
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def ep_card_rank(rank, world, store_dir, inputs, out_dir):
    """``moe_ffn_ep`` on a (1, world) mesh of ranks sharing the card (gloo
    on CUDA tensors), fp32 with TF32 off, at each capacity factor."""
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    M.init_group(store_dir, rank, world, "gloo")
    mesh = M.make_mesh((1, world), ("data", "model"), device="cuda")
    d = {k: torch.from_numpy(v).cuda() for k, v in np.load(inputs).items()}
    res = {}
    for cf in EP_CAPACITY:
        w = [SH.local_block(d[n], SH.P("model"), mesh).contiguous()
             for n in ("w1", "w3", "w2")]
        with torch.no_grad():
            out, aux = moe_ep.moe_ffn_ep(
                d["x"], d["wg"], *w, num_experts=d["w1"].shape[0],
                d_ff=d["w1"].shape[2], k=int(d["k"]), capacity_factor=cf,
                act="silu", mesh=mesh, batch_axes=())
        res[f"ep_{cf}"] = out.cpu().numpy()
        res[f"ep_{cf}_aux"] = aux.cpu().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


UNIT_MOE = "qwen3-moe-235b-a22b"
UNIT_TRAIN = dict(smoke=True, steps=4, batch=4, seq=32, checkpoint_every=2,
                  log_every=100, device="cpu")


# ``collectives.reshard`` on the (2, 2) mesh: (name, whole shape, the
# stored block's spec, the computed block's), the specs as tuples
RESHARD_CASES = [
    ("dense", (4, 6), ("data", "model"), ()),
    ("resident", (4, 6, 8), ("model", "data"), ("model", None, "data")),
    ("swap", (4, 6), (None, "model"), ("data",)),
    ("cut", (4, 6, 8), (), ("model", None, "data")),
]


def _reshard_cases(mesh, res):
    """Each of ``RESHARD_CASES`` on this rank: the whole tensor (seed 0,
    the same on every rank), its stored block resharded under autograd,
    the weights (the rank's seed) and the gradient of sum(y * w) in the
    block.  Then bf16: the gradient of a (2, 2) tensor gathered whole,
    where element (0, 0) takes the cotangents 1, 2^-8, 2^-8 and 0 of
    ranks 0-3 (``BF16_COTANGENTS``): summed in fp32 that is 1 + 2^-7,
    summed in bf16 pairwise (over model, then data) 1."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as SH
    rank = dist.get_rank()
    for name, shape, src, dst in RESHARD_CASES:
        src, dst = SH.P(*src), SH.P(*dst)
        whole = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        x = SH.local_block(whole, src, mesh).clone().requires_grad_()
        y = coll.reshard(x, src, dst, mesh)
        w = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            100 + rank))
        (dx,) = torch.autograd.grad((y * w).sum(), [x])
        res.update({f"rs_{name}_whole": whole.numpy(),
                    f"rs_{name}_y": y.detach().numpy(),
                    f"rs_{name}_w": w.numpy(), f"rs_{name}_dx": dx.numpy()})
    x = torch.ones((1, 1), dtype=torch.bfloat16, requires_grad=True)
    y = coll.reshard(x, SH.P("data", "model"), SH.P(), mesh)
    w = torch.zeros((2, 2), dtype=torch.bfloat16)
    w[0, 0] = BF16_COTANGENTS[rank]
    (dx,) = torch.autograd.grad((y * w).sum(), [x])
    res["rs_bf16_dx"] = dx.float().numpy()


BF16_COTANGENTS = (1.0, 2.0 ** -8, 2.0 ** -8, 0.0)
# (name, rows of a rank's block along dim 1, rows of its output)
SEQ_COLLECTIVES = (("gather_dim", 2, 4), ("psum_scatter", 4, 2))


def _seq_collectives(mesh, g, rank, res):
    """``collectives.all_gather_dim`` and ``psum_scatter`` along dim 1
    over each axis of the (2, 2) mesh under autograd (x and w drawn from
    ``g``, each rank differentiating sum(y * w)); then, over a (1, 4) mesh
    of the same ranks, bf16 inputs (``BF16_COTANGENTS``, one a rank)
    through ``psum_scatter`` and as the cotangent of ``all_gather_dim``'s
    output: both summed in fp32."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import mesh as M
    fns = {"gather_dim": coll.all_gather_dim, "psum_scatter": coll.psum_scatter}
    for axis in ("data", "model"):
        for name, rows, out in SEQ_COLLECTIVES:
            x = torch.randn(3, rows, 5, generator=g, requires_grad=True)
            w = torch.randn(3, out, 5, generator=g)
            y = fns[name](x, mesh, axis, 1)
            (dx,) = torch.autograd.grad((y * w).sum(), [x])
            key = f"{name}_{axis}"
            res.update({f"{key}_x": x.detach().numpy(), f"{key}_w": w.numpy(),
                        f"{key}_y": y.detach().numpy(),
                        f"{key}_dx": dx.numpy()})
    line = M.make_mesh((1, 4), ("data", "model"), device="cpu")
    v = torch.full((1, 4, 2), BF16_COTANGENTS[rank], dtype=torch.bfloat16)
    y = coll.psum_scatter(v, line, "model", 1)
    res["psum_scatter_bf16"] = np.array([str(y.dtype)])
    res["psum_scatter_bf16_y"] = y.float().numpy()
    x = torch.zeros((1, 1, 2), dtype=torch.bfloat16, requires_grad=True)
    y = coll.all_gather_dim(x, line, "model", 1)
    (dx,) = torch.autograd.grad(y, [x], torch.full_like(
        y, BF16_COTANGENTS[rank]))
    res["gather_dim_bf16_dx"] = dx.float().numpy()


def _remat_case(mesh, res):
    """The reduced qwen3-moe (``ep_resident``, fp32) placed on the mesh and
    its gradient (``make_grad_fn``) with ``remat`` on and off, under
    ``saved_tensors_hooks`` that record the shape of every tensor autograd
    keeps for the backward outside a checkpoint; and the whole per-layer
    shapes of the leaves a rank stores split."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    base = dataclasses.replace(get_arch(UNIT_MOE).reduced(),
                               moe_impl="ep_resident", moe_capacity_factor=8.0)
    specs = tree_leaves(T.param_block_specs(base, mesh), is_leaf=SH.is_spec)
    stacked = [len(pd.axes) and pd.axes[0] == "layer"
               for pd in tree_leaves(T.param_defs(base))]
    split = {tuple(pd.shape[1:] if st else pd.shape) for pd, sp, st in zip(
        tree_leaves(T.param_defs(base)), specs, stacked) if sp}
    res["remat_split_shapes"] = np.array(sorted(map(str, split)))
    batch = TokenStream(base, 4, 32, 1, device="cpu").batch_at(0)
    spec = SH.batch_spec((4, 32), SH.TRAIN_RULES, mesh)
    local = {k: SH.local_block(v, spec, mesh) for k, v in batch.items()}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = T.place_params(cfg, torch.Generator().manual_seed(0), mesh,
                                device="cpu")
        kept = []

        def pack(t):
            kept.append(str(tuple(t.shape)))
            return t

        fn = ST.make_grad_fn(cfg, TrainConfig(), mesh=mesh,
                             batch_axes=("data",))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, grads = fn(params, local)
        res[f"remat{int(remat)}_kept"] = np.array(sorted(set(kept)))
        res[f"remat{int(remat)}_loss"] = loss.numpy()
        for j, g in enumerate(tree_leaves(grads)):
            res[f"remat{int(remat)}_g{j}"] = g.numpy()


def units_rank(rank, world, store_dir, out_dir):
    """On a (2, 2) mesh of 4 ranks: ``collectives.psum``,
    ``all_gather_tiled`` and ``reshard`` under autograd (inputs and weights
    drawn from the rank's seed), the gradient with ``remat`` on and off
    (``_remat_case``), the mesh global norm of the reduced qwen3-moe's
    placed parameters (``ep`` and ``ep_resident``), and the launcher: the
    reduced qwen3-moe (``ep_resident``) over the mesh and the reduced
    Mamba-2 over a (2, 1) mesh of ranks 0 and 1, each straight and as a
    crash and a resume, with the final blocks."""
    import dataclasses
    import math

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)
    M.init_group(store_dir, rank, world, "gloo")
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    g = torch.Generator().manual_seed(rank)
    for axis in ("data", "model"):
        for name, fn, wrows in (("psum", coll.psum, 3),
                                ("gather", coll.all_gather_tiled, 6)):
            x = torch.randn(3, 5, generator=g, requires_grad=True)
            w = torch.randn(wrows, 5, generator=g)
            y = fn(x, mesh, axis)
            (dx,) = torch.autograd.grad((y * w).sum(), [x])
            key = f"{name}_{axis}"
            res.update({f"{key}_x": x.detach().numpy(), f"{key}_w": w.numpy(),
                        f"{key}_y": y.detach().numpy(),
                        f"{key}_dx": dx.numpy()})
    _seq_collectives(mesh, g, rank, res)
    _reshard_cases(mesh, res)
    _remat_case(mesh, res)
    for impl in ("ep", "ep_resident"):
        cfg = dataclasses.replace(get_arch(UNIT_MOE).reduced(),
                                  moe_impl=impl)
        params = T.place_params(cfg, torch.Generator().manual_seed(0), mesh,
                                device="cpu")
        res[f"norm_{impl}"] = adamw.global_norm(params, ST.norm_reduction(
            cfg, mesh)).numpy()

    real = TR.get_arch
    TR.get_arch = lambda name: dataclasses.replace(real(name),
                                                   moe_impl="ep_resident")
    for tag, arch, m, kw in (
            ("moe", UNIT_MOE, mesh, {}),
            ("mamba", "mamba2-370m", DeviceMesh(
                "cpu", torch.arange(2).view(2, 1),
                mesh_dim_names=("data", "model")), {})):
        if rank >= math.prod(SH.mesh_shape(m).values()):
            continue
        base = os.path.join(out_dir, tag)
        straight = TR.train(arch, ckpt_dir=base + "_a", mesh=m, **UNIT_TRAIN,
                            **kw)
        part1 = TR.train(arch, ckpt_dir=base + "_b", mesh=m, stop_at=2,
                         **UNIT_TRAIN, **kw)
        part2 = TR.train(arch, ckpt_dir=base + "_b", mesh=m, resume=True,
                         **UNIT_TRAIN, **kw)
        res[f"{tag}_straight"] = np.array(straight)
        res[f"{tag}_resumed"] = np.array(part1 + part2)
    TR.get_arch = real
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


TRAIN_B, TRAIN_S, TRAIN_SEED, TRAIN_STEPS = 4, 32, 1, 3
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=6)
MOE_MESHES = [((2, 4), "ep"), ((2, 4), "ep_resident"), ((1, 8), "ep")]
MOE_CF = (8.0, 1.25)
COMPRESSION = ("none", "int8")
# (arch, mesh, compression, microbatches), each held to JAX's one-device
# step with the same compression
DP_CASES = [("qwen3-8b", (2, 1), "none", 1), ("qwen3-8b", (4, 1), "none", 1),
            ("mamba2-370m", (2, 1), "int8", 1),
            ("mamba2-370m", (4, 1), "int8", 1),
            ("mamba2-370m", (2, 1), "int8", 2)]
# where the int8 codes of the split leaves are kept, step 1
CODES_CASES = [((2, 4), "ep_resident"), ((1, 8), "ep")]
# (arch, mesh, rules, compression): trained over the whole (2, 4) mesh and
# held to JAX's step on the same host mesh, every rank's parameter and
# moment blocks to JAX's addressable shards; the MoE's (2, 4) cases at
# capacity factor 8 without int8 keep their moments too (``SHARD_MOE``).
# Each records the sequence rows of every block's output on the rank
# (``_rows`` keys): under SEQPAR_RULES the rank's S / 4
SHARD_CASES = [("qwen3-8b", (2, 4), "TRAIN_RULES", "none"),
               ("mamba2-370m", (2, 4), "TRAIN_RULES", "none"),
               ("qwen3-8b", (2, 4), "TP_RULES", "none"),
               ("qwen3-8b", (2, 4), "SEQPAR_RULES", "none"),
               ("mamba2-370m", (2, 4), "SEQPAR_RULES", "none")]
SHARD_MOE = [((2, 4), "ep", 8.0, "none"), ((2, 4), "ep_resident", 8.0,
                                           "none")]


# (arch, config overrides, compression): trained over DECODE2D_SHAPE under
# DECODE_RULES (the weights resident, every rank the whole batch, the
# residual stream split over data along the hidden dim), held to JAX's
# jitted step on the same host mesh (tests/test_torch_train_decode2d.py)
DECODE2D_SHAPE = (2, 4)
DECODE2D_CASES = [
    ("qwen3-8b", {}, "none"), ("qwen3-8b", {}, "int8"),
    ("mamba2-370m", {}, "none"),
    ("qwen3-moe-235b-a22b", {"moe_impl": "ep", "moe_capacity_factor": 8.0},
     "none"),
    ("recurrentgemma-2b", {}, "none"), ("minicpm3-4b", {}, "none")]


def decode2d_key(arch, over, comp):
    return "_".join([arch, *(f"{k}-{v}" for k, v in sorted(over.items())),
                     comp])


def moe_key(shape, impl, cf, comp):
    return f"{shape[0]}x{shape[1]}_{impl}_{cf}_{comp}"


def dp_key(arch, shape, comp, mb):
    return f"{arch}_{shape[0]}x{shape[1]}_{comp}_{mb}"


def shard_key(arch, shape, rules, comp):
    return f"{arch}_{shape[0]}x{shape[1]}_{rules}_{comp}"


def _train_case(cfg, mesh, whole, comp, mb, key, res, first, rules=None,
                moments=False):
    """``TRAIN_STEPS`` steps of ``make_train_step`` over ``mesh`` under
    ``rules`` (None: ``TRAIN_RULES``) from the whole tree ``whole``, on
    this rank's blocks of ``TokenStream``'s batches: each step's loss and
    grad norm, the final blocks of the split leaves, the whole leaves on
    the first rank, and a digest of every leaf's bytes; with ``moments``
    every leaf's block and its AdamW moments' on every rank."""
    import hashlib

    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    rules = SH.resolve_rules(rules)
    baxes = SH.batch_axes(TRAIN_B, rules, mesh)
    # a copy: an unsplit leaf would be ``whole``'s own tensor, which the
    # step updates in place (JAX's donation) and the next case reads
    params = T.place_params(cfg, T.tree_map(torch.clone, whole), mesh,
                            rules=rules, device="cpu")
    step = ST.make_train_step(cfg, TrainConfig(
        grad_compression=comp, microbatches=mb, **TRAIN_KW), mesh=mesh,
        batch_axes=baxes, rules=rules)
    opt = adamw.init(params)
    spec = SH.batch_spec((TRAIN_B, TRAIN_S), rules, mesh)
    for i in range(TRAIN_STEPS):
        b = TokenStream(cfg, TRAIN_B, TRAIN_S, TRAIN_SEED,
                        device="cpu").batch_at(i)
        b = {k: SH.local_block(v, spec, mesh) for k, v in b.items()}
        params, opt, m = step(params, opt, b)
        res[f"{key}_loss{i}"] = m["loss"].numpy()
        res[f"{key}_gnorm{i}"] = m["grad_norm"].numpy()
    specs = tree_leaves(T.param_block_specs(cfg, mesh, rules),
                        is_leaf=SH.is_spec)
    for j, (leaf, sp) in enumerate(zip(tree_leaves(params), specs)):
        if sp or first or moments:
            res[f"{key}_p{j}"] = leaf.numpy()
        res[f"{key}_h{j}"] = np.array(
            hashlib.sha1(leaf.numpy().tobytes()).hexdigest())
    if moments:
        for j, (mu, nu) in enumerate(zip(tree_leaves(opt.mu),
                                         tree_leaves(opt.nu))):
            res[f"{key}_mu{j}"], res[f"{key}_nu{j}"] = mu.numpy(), nu.numpy()


def _codes_case(cfg, mesh, whole, key, res):
    """Step 1's reduced fp32 gradient blocks of the split leaves and their
    int8 codes against the whole leaf's absmax."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import compression as GC
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    rules = SH.TRAIN_RULES
    baxes = SH.batch_axes(TRAIN_B, rules, mesh)
    params = T.place_params(cfg, whole, mesh, device="cpu")
    grad_fn = ST.make_grad_fn(cfg, TrainConfig(**TRAIN_KW), mesh=mesh,
                              batch_axes=baxes)
    b = TokenStream(cfg, TRAIN_B, TRAIN_S, TRAIN_SEED,
                    device="cpu").batch_at(0)
    spec = SH.batch_spec((TRAIN_B, TRAIN_S), rules, mesh)
    _, grads = grad_fn(params, {k: SH.local_block(v, spec, mesh)
                                for k, v in b.items()})
    leaves = tree_leaves(grads)
    axes = ST.leaf_axes(cfg, mesh)
    absmax = ST._whole_absmax(leaves, axes, mesh)
    for j, g in enumerate(leaves):
        if absmax[j] is not None:
            q, _ = GC._quantize_leaf(g, absmax[j])
            res[f"{key}_g{j}"] = g.numpy()
            res[f"{key}_q{j}"] = q.reshape(g.shape).numpy()


def train_mesh_rank(rank, world, store_dir, inputs, out_dir):
    """The reduced qwen3-moe trained over ``MOE_MESHES`` at each capacity
    factor, with and without int8 (``_train_case``), its split leaves'
    step-1 codes (``_codes_case``), then ``SHARD_CASES`` over the whole
    mesh and ``DP_CASES`` over meshes of the first 2 or 4 ranks; ``inputs``
    holds each arch's whole tree, the JAX package's init carried over,
    leaf by leaf."""
    import dataclasses
    import math

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    d = np.load(inputs)

    def whole(arch, cfg):
        shapes = T.param_shapes(cfg)
        return tree_unflatten(shapes, [
            torch.from_numpy(d[f"{arch}_{j}"])
            for j in range(len(tree_leaves(shapes)))])

    res = {}
    moe = "qwen3-moe-235b-a22b"
    for shape, impl in MOE_MESHES:
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        for cf in MOE_CF:
            cfg = dataclasses.replace(get_arch(moe).reduced(), moe_impl=impl,
                                      moe_capacity_factor=cf)
            for comp in COMPRESSION:
                _train_case(cfg, mesh, whole(moe, cfg), comp, 1,
                            moe_key(shape, impl, cf, comp), res, rank == 0,
                            moments=(shape, impl, cf, comp) in SHARD_MOE)
            if (shape, impl) in CODES_CASES and cf == MOE_CF[0]:
                _codes_case(cfg, mesh, whole(moe, cfg),
                            moe_key(shape, impl, cf, "codes"), res)
    apply_block = T.apply_block
    for arch, shape, rname, comp in SHARD_CASES:
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        cfg = get_arch(arch).reduced()
        rows = []

        def recorded(*args, **kw):
            out = apply_block(*args, **kw)
            rows.append(out.shape[1])
            return out

        T.apply_block = recorded
        try:
            _train_case(cfg, mesh, whole(arch, cfg), comp, 1,
                        shard_key(arch, shape, rname, comp), res, rank == 0,
                        rules=getattr(SH, rname), moments=True)
        finally:
            T.apply_block = apply_block
        res[shard_key(arch, shape, rname, comp) + "_rows"] = np.array(rows)
    for arch, shape, comp, mb in DP_CASES:
        n = math.prod(shape)
        mesh = DeviceMesh("cpu", torch.arange(n).view(shape),
                          mesh_dim_names=("data", "model"))
        if rank < n:
            cfg = get_arch(arch).reduced()
            _train_case(cfg, mesh, whole(arch, cfg), comp, mb,
                        dp_key(arch, shape, comp, mb), res, rank == 0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def decode2d_train_rank(rank, world, store_dir, inputs, out_dir):
    """``DECODE2D_CASES`` over ``DECODE2D_SHAPE`` under ``DECODE_RULES``:
    for each, the reduced gradient blocks of the first batch where the
    step hands them to AdamW or to the int8 transform (``{key}_g{j}``),
    then ``_train_case``'s steps with every rank's parameter and moment
    blocks; ``inputs`` holds each arch's whole tree (``{arch}_{j}``)."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import compression as GC
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    d = np.load(inputs)
    mesh = M.make_mesh(DECODE2D_SHAPE, ("data", "model"), device="cpu")
    rules = SH.DECODE_RULES
    baxes = SH.batch_axes(TRAIN_B, rules, mesh)
    res = {}
    wire = GC.wire_transform
    for arch, over, comp in DECODE2D_CASES:
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        shapes = T.param_shapes(cfg)
        whole = tree_unflatten(shapes, [
            torch.from_numpy(d[f"{arch}_{j}"])
            for j in range(len(tree_leaves(shapes)))])
        key = decode2d_key(arch, over, comp)
        kept = {}

        def before_int8(leaves, absmax=None):
            kept["g"] = [g.clone() for g in leaves]
            wire(leaves, absmax)

        params = T.place_params(cfg, T.tree_map(torch.clone, whole), mesh,
                                rules=rules, device="cpu")
        b = TokenStream(cfg, TRAIN_B, TRAIN_S, TRAIN_SEED,
                        device="cpu").batch_at(0)
        GC.wire_transform = before_int8
        try:
            _, grads = ST.make_grad_fn(cfg, TrainConfig(
                grad_compression=comp, **TRAIN_KW), mesh=mesh,
                batch_axes=baxes, rules=rules)(params, b)
        finally:
            GC.wire_transform = wire
        for j, g in enumerate(kept.get("g", tree_leaves(grads))):
            res[f"{key}_g{j}"] = g.numpy()
        del params, grads, kept
        _train_case(cfg, mesh, whole, comp, 1, key, res, rank == 0,
                    rules=rules, moments=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def held_bytes_rank(rank, world, store_dir, cases, out_dir):
    """For each case (arch, mesh shape, config overrides, batch, seq): the
    bytes this rank holds for a train step under ``TRAIN_RULES`` (its
    placed parameter blocks, its block of a ``TokenStream`` batch and the
    AdamW state ``adamw.init`` gives them), its reduced gradient's bytes
    from ``make_grad_fn``, and the dry run's count of both
    (``launch.dryrun.cell_blocks`` on this mesh)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig, get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    res = {}
    for i, (arch, shape, over, B, S) in enumerate(cases):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        baxes = SH.batch_axes(B, SH.TRAIN_RULES, mesh)
        params = T.place_params(cfg, torch.Generator().manual_seed(0), mesh,
                                device="cpu")
        batch = {k: SH.local_block(v, SH.batch_spec(tuple(v.shape),
                                                    SH.TRAIN_RULES, mesh),
                                   mesh)
                 for k, v in TokenStream(cfg, B, S, 0,
                                         device="cpu").batch_at(0).items()}
        held = (params, adamw.init(params), batch)
        _, grads = ST.make_grad_fn(cfg, TrainConfig(), mesh=mesh,
                                   batch_axes=baxes)(params, batch)
        blocks = DR.cell_blocks(cfg, ShapeConfig("held", "train", S, B), mesh)
        res[f"{i}"] = np.array([DR.tree_nbytes(held),
                                DR.tree_nbytes(blocks),
                                DR.tree_nbytes(grads),
                                DR.tree_nbytes(blocks["opt"].mu)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def tp_rank(rank, world, store_dir, inputs, cases, out_dir):
    """For each case (arch, config overrides, mesh shape, the rules' name):
    the arch's whole tree from ``inputs`` (``{arch}_{j}``, leaf by leaf)
    placed on the mesh under the rules, and on this rank's block of the
    global batch (``{arch}_{key}``) the training step's loss and reduced
    gradient blocks (``make_grad_fn``) and the forward's logits, gathered
    over the vocabulary and the batch."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    d = np.load(inputs)
    res = {}
    for i, (arch, over, shape, rname) in enumerate(cases):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        shapes = T.param_shapes(cfg)
        whole = tree_unflatten(shapes, [
            torch.from_numpy(d[f"{arch}_{j}"])
            for j in range(len(tree_leaves(shapes)))])
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        rules = getattr(SH, rname)
        batch = {k[len(arch) + 1:]: torch.from_numpy(d[k]) for k in d.files
                 if k.startswith(arch + "_") and not k[len(arch) + 1:]
                 .isdigit()}
        B = batch["tokens"].shape[0]
        baxes = SH.batch_axes(B, rules, mesh)
        local = {k: SH.local_block(v, SH.batch_spec(tuple(v.shape), rules,
                                                    mesh), mesh)
                 for k, v in batch.items()}
        params = T.place_params(cfg, whole, mesh, rules=rules, device="cpu")
        loss, grads = ST.make_grad_fn(cfg, TrainConfig(), mesh=mesh,
                                      batch_axes=baxes, rules=rules)(
            params, local)
        res[f"{i}_loss"] = loss.numpy()
        for j, g in enumerate(tree_leaves(grads)):
            res[f"{i}_g{j}"] = g.numpy()
        shard = SH.make_act_sharder(mesh, baxes, rules)
        with torch.no_grad():
            logits = T.forward(cfg, params, local["tokens"],
                               frontend_embeds=local.get("frontend_embeds"),
                               encoder_frames=local.get("encoder_frames"),
                               shard=shard)
        res[f"{i}_logits"] = SV.gather_batch(
            T.gather_vocab(cfg, logits, shard), mesh, baxes).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
