"""Serving launcher: batched prefill, then greedy decode with a cache.

``python -m repro_torch.launch.serve --arch mamba2-370m --batch 4 --prompt 1024 --gen 32``

The port of the JAX package's ``launch/serve.py`` on one card, for the
Mamba-2 (``ssm``), RecurrentGemma (``hybrid``), dense (``dense``: Qwen,
BERT-base, GPT-2 1.5B, MiniCPM3's MLA), MoE (``moe``), Whisper (``audio``)
and vision-language (``vlm``: qwen2-vl, ViT-632M) families.
Each phase's time is read from the host clock after
``torch.cuda.synchronize()`` (and, over a mesh, a barrier of every rank),
so it is the card's time for the phase, not the time to enqueue it.

``serve(..., mesh=mesh, rules=rules)`` serves over a mesh of ranks
(``launch.mesh``): every rank calls it with the same arguments, draws the
same whole batch, keeps its ``batch_spec`` block (under ``DECODE_RULES``
the batch splits over ``pod`` alone: a pod's ranks all keep the whole
of it, and their cache its ``data`` rows), holds its block of
every weight under ``rules`` (``transformer.place_params``, drawn leaf by
leaf from the seed's generator: the one-card run's weights), prefills and
decodes through the sharded steps, which compute on TP's blocks
(resharding only the leaves ``transformer.compute_defs`` keeps whole,
and under FSDP the data split; under ``DECODE_RULES`` nothing dense:
the weights stay resident) and hold the rank's block of the cache
under the JAX package's spec (``sharding.cache_specs``: the sequence
split over ``model``), re-cut at the capacity by ``_grow_cache``, and
gathers the greedy tokens of every block, so every rank returns the
whole batch's.
"""
from __future__ import annotations

import argparse
import itertools
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import RequestStream
from repro_torch.device import resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import decode as DE
from repro_torch.models import transformer as T


def _sync(dev: torch.device, mesh=None) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if mesh is not None:
        dist.barrier()


def gather_batch(local: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The whole batch from each rank's block along ``axes`` (a CPU tensor;
    the blocks in their order along the axes, the first rank of each),
    gathered on the blocks' own device (NCCL gathers no CPU tensor)."""
    if not axes:
        return local.cpu()
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    parts = [p.cpu() for p in parts]
    names = mesh.mesh_dim_names
    blocks = {}
    for coord in itertools.product(*map(range, mesh.shape)):
        rank = int(mesh.mesh[coord])
        i, _ = SH.block_index(tuple(axes), mesh, dict(zip(names, coord)))
        blocks.setdefault(i, parts[rank])
    return torch.cat([blocks[i] for i in sorted(blocks)], dim=0)


def serve(arch: str, *, smoke: bool = True, batch: int = 4, prompt: int = 64,
          gen: int = 16, seed: int = 0, greedy: bool = True, device=None,
          mesh=None, rules=None):
    """Random weights from ``seed``, ``batch`` prompts of ``prompt`` tokens
    from ``RequestStream``, then ``gen`` tokens each.  ``device=None``
    means the card (and raises without CUDA).  As in the JAX package, a
    Mamba-2 prompt longer than the config's ``ssm_chunk`` must be a
    multiple of it, a prompt within a sliding window that the
    generated tokens outgrow is refused (``_grow_cache``), and so is a
    prompt shorter than a patch frontend's ``frontend_seq``.  ``mesh``:
    serve over it (every rank the same call; ``rules`` the sharding rules,
    default ``TRAIN_RULES``, or ``TP_RULES``, ``SEQPAR_RULES`` (the
    prefill's residual stream split along the sequence) or
    ``DECODE_RULES``).  Returns ``generated``
    int32 (batch, gen), ``prefill_s`` and ``decode_s_per_token``."""
    dev = resolve(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    gen_w = torch.Generator(device=dev).manual_seed(seed)
    reqs = RequestStream(cfg, batch, prompt, seed).requests_at(0)
    tokens = torch.from_numpy(reqs["tokens"])
    baxes = ()
    rules = SH.resolve_rules(rules)
    if mesh is None:
        params = T.init_params(cfg, gen_w, device=dev)
    else:
        baxes = SH.batch_axes(batch, rules, mesh)
        params = T.place_params(cfg, gen_w, mesh, rules=rules, device=dev)
        tokens = SH.local_block(tokens, SH.batch_spec(tuple(tokens.shape),
                                                      rules, mesh), mesh)
        batch = tokens.shape[0]
    prefill_fn = ST.make_prefill_step(cfg, mesh=mesh, batch_axes=baxes,
                                      rules=rules)
    decode_fn = ST.make_decode_step(cfg, mesh=mesh, batch_axes=baxes,
                                    rules=rules, seq=prompt + gen)
    shard = None if mesh is None else SH.make_act_sharder(mesh, baxes, rules)
    batch_in = {"tokens": tokens.to(dev)}
    if cfg.frontend == "audio_frames":
        # the stub frontend, as the JAX package's: zero frame embeddings
        batch_in["encoder_frames"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=dev)
    if cfg.frontend == "vision_patches":
        # the stub frontend, as the JAX package's: zero patch embeddings in
        # the prompt's first frontend_seq positions
        batch_in["frontend_embeds"] = torch.zeros(
            (batch, cfg.frontend_seq, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=dev)

    _sync(dev, mesh)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch_in)
    # grow the cache to prompt+gen capacity for attention layers
    cache = _grow_cache(cfg, cache, batch, prompt + gen, shard=shard,
                        seq=prompt)
    _sync(dev, mesh)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_fn(params, cache, {"tokens": tokens})
        tokens = (torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
                  if greedy else tokens)
        out.append(tokens)
    _sync(dev, mesh)
    t_decode = time.perf_counter() - t0
    generated = torch.cat(out, dim=1)
    if mesh is not None:
        generated = gather_batch(generated, mesh, baxes)
    return {
        "generated": generated.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1),
    }


def _grow_cache(cfg, cache, batch: int, capacity: int, *, shard=None,
                seq=None):
    """Re-embed a prompt-sized cache into a ``capacity``-sized one (prefix
    copy along the seq dim; ring/state caches, ``kpos`` included, and the
    encoder's ``xk``/``xv`` are size-invariant).

    A prompt within the sliding window whose ``capacity`` outgrows it would
    turn a full K/V cache into a ring; the JAX package's version breaks
    there on the mismatched trees, and this one raises ``ValueError``.

    Over a mesh (``shard``, a ``sharding.ActSharder``; ``batch`` the
    rank's block, ``seq`` the prompt's length) the cache is the rank's
    blocks under ``sharding.cache_specs``: a leaf whose blocks change
    with the length (the sequence split over ``model``) is gathered whole
    over its non-batch axes, padded, and cut to the rank's block of the
    capacity-sized leaf."""
    old_specs = new_specs = axes = None
    B = batch
    if shard is not None:
        old_specs = ST.cache_specs_for(cfg, shard, batch, seq)
        new_specs = ST.cache_specs_for(cfg, shard, batch, capacity)
        B *= math.prod(SH.mesh_shape(shard.mesh)[a] for a in shard.batch_axes)
        axes = DE.cache_logical_axes(cfg, B, capacity)

    def grow(tmpl, src, so, sn, ax):
        if isinstance(tmpl, dict):
            if tmpl.keys() != src.keys():
                raise ValueError(
                    f"_grow_cache: a cache of {sorted(src)} cannot grow into "
                    f"{sorted(tmpl)}: the prompt fits the sliding window "
                    f"({cfg.sliding_window}) but prompt + gen = {capacity} "
                    f"outgrows it, which needs a ring cache the prefill did "
                    f"not build")
            return {k: grow(tmpl[k], src[k], so and so[k], sn and sn[k],
                            ax and ax[k]) for k in tmpl}
        if isinstance(tmpl, list):
            return [grow(*args) for args in zip(
                tmpl, src, so or [None] * len(tmpl), sn or [None] * len(tmpl),
                ax or [None] * len(tmpl))]
        if shard is None:
            if tmpl.shape == src.shape:
                return src
            dst = torch.zeros(tmpl.shape, dtype=tmpl.dtype, device=src.device)
            dst[tuple(slice(0, s) for s in src.shape)] = src
            return dst
        if so == sn and tuple(src.shape) == SH.block_shape(tmpl.shape, sn,
                                                           shard.mesh):
            return src
        # the non-batch splits gathered, the leaf padded, the new cut
        rest = lambda sp: SH.P(*(None if a == "cache_batch" else part
                                 for a, part in zip(ax, tuple(sp) + (None,) * (
                                     len(ax) - len(sp)))))
        whole = coll.gather_block(src, rest(so), shard.mesh)
        batch_only = SH.P(*(part if a == "cache_batch" else None for a, part
                            in zip(ax, tuple(sn) + (None,) * (
                                len(ax) - len(sn)))))
        dst = torch.zeros(SH.block_shape(tmpl.shape, batch_only, shard.mesh),
                          dtype=tmpl.dtype, device=src.device)
        dst[tuple(slice(0, s) for s in whole.shape)] = whole
        return SH.local_block(dst, rest(sn), shard.mesh).contiguous()

    new = grow(DE.cache_shapes(cfg, B, capacity, make=DE.LeafShape), cache,
               old_specs, new_specs, axes)
    new["pos"] = cache["pos"]
    return new


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config (default: full)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt=args.prompt, gen=args.gen, seed=args.seed,
                device=args.device)
    print(f"[serve] generated shape {out['generated'].shape} "
          f"prefill {out['prefill_s']*1e3:.1f}ms "
          f"decode {out['decode_s_per_token']*1e3:.2f}ms/token")


if __name__ == "__main__":
    main()
