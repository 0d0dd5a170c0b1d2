"""Training launcher: ``python -m repro_torch.launch.train --arch mamba2-370m``.

The port of the JAX package's ``launch/train.py``, on one card or over a
mesh of ranks (``mesh=``: every rank calls ``train``): init from a seed,
deterministic resumable data (``TokenStream``), AdamW train steps,
periodic atomic checkpoints, crash-restart resume (``--resume``) and step
timing logs.  Each step updates the parameters and the AdamW moments in
place (``adamw.apply_``: the JAX launcher's step donates both), under
``cfg.remat`` with each layer group, ``rem`` layer and encoder block
recomputed in the backward.  Over a mesh each rank takes its block of
the stream's global batch and places its block of every parameter under
``rules``
(``TRAIN_RULES`` where None, ``TP_RULES`` or ``SEQPAR_RULES``, which
splits the residual stream along the sequence) from the seed's generator
(``transformer.place_params``, which draws as ``init_params`` does); its
AdamW moments take the same blocks.  The step reshards each layer as it
runs it and reduces the gradient over the ranks (``launch.steps``), the
mesh's first rank logs and writes the whole tree, gathered from the
blocks, to the checkpoints, and ``restore`` gives each rank its blocks,
so a resumed run continues the exact trajectory, and a checkpoint written
over one mesh restores onto another or onto one card.  ``--smoke`` (the
default, as in the JAX launcher) takes the reduced config, ``--full`` the
published one; ``--device cpu`` runs the plain PyTorch path on the CPU,
and without it the run needs the card.
Each step's loss is read on the host, which waits for the card, so the
logged ms a step is the card's time.  Every family of the registry trains
(Mamba-2, RecurrentGemma, the dense and MoE GQA decoders, MLA's
minicpm3-4b, Whisper, qwen2-vl), its scans and attention differentiated
by K8b, K7b and K5b on the card; ``TokenStream``'s fp32 frames and patch
embeddings are cast to the model's dtype in the model
(``transformer.encoder_ctx``, ``splice_frontend``).  A model too deep for
one card trains cut in depth, and one outside the registry (the paper
suite's ViT-632M) trains too: pass ``train`` a config whose ``get_arch``
returns it (``chip_smoke.py`` does so).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

# checkpoints go inside the checkout unless the caller names a directory
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str = DEFAULT_CKPT_DIR,
          resume: bool = False, checkpoint_every: int = 20,
          log_every: int = 10, microbatches: int = 1, seed: int = 0,
          stop_at: int = 0, device=None, mesh=None, batch_axes=None,
          rules=None, grad_compression: str = "none"):
    """``stop_at`` simulates a crash: run ends early but the LR schedule
    and checkpoints are laid out for the full ``steps`` run, so a resumed
    run continues the exact trajectory.  ``device=None`` means the card
    (and raises without CUDA).  ``mesh``: train over it, the parameters
    and moments placed by ``rules`` (None: ``TRAIN_RULES``), ``batch`` the
    global batch split over ``batch_axes`` (None: ``sharding.batch_axes``
    under ``rules``).  ``grad_compression``: ``TrainConfig``'s
    (``"int8"``: the wire transform of the reduced gradient).  Returns the
    (global) loss of every step run."""
    dev = resolve(device)
    rules = SH.resolve_rules(rules)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    tcfg = TrainConfig(total_steps=steps, warmup_steps=max(2, steps // 10),
                       microbatches=microbatches,
                       checkpoint_every=checkpoint_every, checkpoint_dir=ckpt_dir,
                       grad_compression=grad_compression)

    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        baxes, on_mesh = (), {}
        params = T.init_params(cfg, gen, device=dev)
    else:
        baxes = (SH.batch_axes(batch, rules, mesh)
                 if batch_axes is None else tuple(batch_axes))
        pspecs = T.param_block_specs(cfg, mesh, rules)
        specs = (pspecs, adamw.AdamWState(SH.P(), pspecs, pspecs))
        on_mesh = {"mesh": mesh, "specs": specs}
        params = T.place_params(cfg, gen, mesh, rules=rules, device=dev)
    opt_state = adamw.init(params)
    logs = mesh is None or SH.is_first_rank(mesh)
    start_step = 0
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        (params, opt_state), start_step, _ = ckpt.restore(
            ckpt_dir, (params, opt_state), device=dev, **on_mesh)
        if logs:
            print(f"[train] resumed from step {start_step}")

    step_fn = ST.make_train_step(cfg, tcfg, mesh=mesh, batch_axes=baxes,
                                 rules=rules)
    stream = TokenStream(cfg, batch, seq, seed, device=dev)
    bspec = SH.P(baxes if len(baxes) > 1 else baxes[0]) if baxes else SH.P()

    losses = []
    t_last = time.time()
    end = min(steps, stop_at) if stop_at else steps
    for step in range(start_step, end):
        batch_data = stream.batch_at(step)
        if mesh is not None:
            batch_data = {k: SH.local_block(v, bspec, mesh)
                          for k, v in batch_data.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        losses.append(float(metrics["loss"]))
        if logs and ((step + 1) % log_every == 0 or step == end - 1):
            dt = (time.time() - t_last) / log_every
            print(f"[train] step {step + 1}/{steps} "
                  f"loss={losses[-1]:.4f} gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step",
                  flush=True)
            t_last = time.time()
        if (step + 1) % checkpoint_every == 0 or step == end - 1:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state),
                      extras={"arch": arch, "seed": seed}, **on_mesh)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path (default: the card)")
    args = ap.parse_args()
    losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                   batch=args.batch, seq=args.seq, resume=args.resume,
                   microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                   grad_compression=args.grad_compression,
                   device=args.device)
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
