"""End-to-end LM training driver: the port of ``repro/launch/train.py``.

Runs real optimisation steps of an architecture's ``reduced()`` variant or
an in-repo preset, with the same ``train_step`` the full-width runs call,
and saves or resumes a checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --preset lm10m --device cpu --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --steps 50 --checkpoint /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama4-scout-17b-a16e --full \
      --layers 1 --batch 1 --seq 1024 --steps 3 --lr 3e-4   # one MoE layer at full width
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --full --layers 8 \
      --batch 2 --seq 1024 --steps 3 --lr 3e-4   # one xLSTM unit (7 mLSTM, 1 sLSTM) at full width

The JAX driver's flags and printed lines; ``--device`` (default ``cuda``;
without a card it raises), ``--seed`` (the CPU ``torch.Generator`` the
initial weights are drawn from, so the card and the CPU start from the same
weights), ``--full`` (the published widths, not ``reduced()``) and
``--layers N`` (keep the first N layers, named in the printed line) are the
port's.  ``--arch`` takes gemma-2b, xlstm-1.3b, grok-1-314b and
llama4-scout-17b-a16e (an MoE architecture's loss carries its load-balance
term; xlstm-1.3b's ``--seq`` keeps the chunk rule: at most 128 or a
multiple of 128, else ``ValueError``).  The token stream is the JAX
launcher's (seed 1).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenStreamConfig, token_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.ssm import check_chunk_rule
from repro_torch.optim.optimizers import AdamWConfig

# A ~hundred-M-param dense preset that actually trains on one host.
PRESETS = {
    "lm100m": ArchConfig(
        name="lm100m", arch_type="dense", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab_size=8192, mlp_type="swiglu",
        layer_pattern="full", dtype="float32", source="in-repo preset",
    ),
    "lm10m": ArchConfig(
        name="lm10m", arch_type="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=1024, vocab_size=4096, mlp_type="swiglu",
        layer_pattern="full", dtype="float32", source="in-repo preset",
    ),
}


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", help="assigned architecture id (reduced variant is trained)")
    ap.add_argument("--preset", choices=sorted(PRESETS), help="in-repo trainable preset")
    ap.add_argument("--full", action="store_true",
                    help="train the published widths of --arch, not its reduced() variant")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="keep the first N layers (a depth cut; the widths stay)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="seed of the initial weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = get_arch(args.arch) if args.full else get_arch(args.arch).reduced()
    depth = cfg.n_layers
    if args.layers is not None:
        cfg = cfg.with_layers(args.layers)
    check_chunk_rule(cfg, args.seq)
    state = M.init_train_state(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    cut = f" layers={cfg.n_layers}/{depth} (depth cut)" if args.layers is not None else ""
    print(f"arch={cfg.name}{cut} params={n_params/1e6:.1f}M vocab={cfg.padded_vocab()}")

    if args.resume and args.checkpoint and Path(args.checkpoint + ".npz").exists():
        state = load_checkpoint(state, args.checkpoint)
        print("resumed from", args.checkpoint)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    stream = token_batches(TokenStreamConfig(cfg.vocab_size, args.seq, args.batch, seed=1), device=dev)

    losses = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = next(stream)
        state, metrics = M.train_step(cfg, state, batch, opt_cfg)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps:
            dt = (time.time() - t0) / step
            print(
                f"step {step:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f} ms/step",
                flush=True,
            )
    if args.checkpoint:
        save_checkpoint(state, args.checkpoint)
        print("saved", args.checkpoint)
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
