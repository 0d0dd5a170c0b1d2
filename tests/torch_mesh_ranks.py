"""Rank functions of the port's mesh tests (``tests/test_torch_moe_ep.py``,
``tests/test_torch_serve_mesh.py``): ``launch.mesh.run_ranks`` spawns each
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
    a mesh the world does not fill raises."""
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
            for cf in EP_CAPACITY:
                with torch.no_grad():
                    out, aux = fn(
                        x, d["wg"], SH.local_block(d["w1"], s1, mesh),
                        SH.local_block(d["w3"], s1, mesh),
                        SH.local_block(d["w2"], s2, mesh), num_experts=E,
                        d_ff=d["w1"].shape[2], k=int(d["k"]),
                        capacity_factor=cf, act="silu", mesh=mesh,
                        batch_axes=("data",))
                key = f"{shape[0]}x{shape[1]}_{name}_{cf}"
                res[key] = out.numpy()
                res[key + "_aux"] = aux.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def serve_rank(rank, world, store_dir, cases, out_dir):
    """For each case (arch, mesh shape, config overrides, serve keywords):
    ``serve`` over the mesh, and the prefill step on this rank's block of
    the served batch (the logits gathered over the batch's axes)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import RequestStream
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    torch.set_num_threads(1)          # the ranks share the host's cores
    M.init_group(store_dir, rank, world, "gloo")
    real = SV.get_arch
    res = {}
    for i, (arch, shape, over, kw) in enumerate(cases):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        SV.get_arch = lambda name, cfg=cfg: cfg
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        res[f"{i}_generated"] = SV.serve(arch, device="cpu", mesh=mesh,
                                         **kw)["generated"]
        rules = SH.TRAIN_RULES
        B, S = kw["batch"], kw["prompt"]
        baxes = SH.batch_axes(B, rules, mesh)
        params = T.place_params(cfg, torch.Generator().manual_seed(
            kw.get("seed", 0)), mesh, batch_axes=baxes, device="cpu")
        tok = torch.from_numpy(RequestStream(cfg, B, S, kw.get("seed", 0))
                               .requests_at(0)["tokens"])
        tok = SH.local_block(tok, SH.batch_spec((B, S), rules, mesh), mesh)
        step = ST.make_prefill_step(cfg, mesh=mesh, batch_axes=baxes)
        with torch.no_grad():
            logits, _ = step(params, {"tokens": tok})
        res[f"{i}_logits"] = SV.gather_batch(logits, mesh, baxes).numpy()
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
