"""Batched LLM serving: prefill a batch of prompts, decode N tokens
greedily against the KV caches, report tokens/s.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu        # reduced gemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --full              # gemma-2b on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b --full --layers 4 \
      --batch 1 --prompt-len 8192                                       # grok-1, 4 of 64 layers
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b --full --prompt-len 2048
                                                                        # xlstm-1.3b, all 48 layers

The port of ``repro/launch/serve.py``, with its flags and its printed line.
``--full`` serves the published configuration instead of ``reduced()``;
``--layers N`` keeps its first N layers (a depth cut, named in the printed
line); the weights are random, drawn from ``--seed``, as the JAX
launcher's are.  ``--arch`` takes gemma-2b, xlstm-1.3b, grok-1-314b and
llama4-scout-17b-a16e.  An architecture with recurrent layers (xlstm-1.3b)
scans its prompt in chunks of 128 tokens: a prompt longer than 128 tokens
must be a multiple of 128 (the chunk rule), or the launcher raises
``ValueError`` before it builds the model.  A VLM architecture's batch
carries a patch-embedding ``prefix`` and an audio architecture's the
encoder's ``frames``, N(0, 1)·0.02 from the seeded generator, as the JAX
launcher draws them (:func:`front_end_inputs`); the caches then hold
prefix, prompt and decoded tokens.  Runs on the card unless ``--device
cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ArchConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.ssm import check_chunk_rule
from repro_torch.models.transformer import Transformer


def build(cfg: ArchConfig, seed: int, device: torch.device) -> Transformer:
    """The model of ``cfg`` with random weights from ``seed`` on ``device``."""
    return Transformer(cfg, torch.Generator(device=device).manual_seed(seed))


def front_end_inputs(cfg: ArchConfig, batch: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A batch's inputs besides its tokens, float32 on the generator's
    device: a VLM's ``prefix [B, prefix_tokens, d]`` or an audio
    architecture's ``frames [B, encoder_seq, d]``, N(0, 1)·0.02 (nothing for
    the others)."""
    shape = {"vlm": ("prefix", cfg.prefix_tokens), "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.randn((batch, n, cfg.d_model), generator=generator, device=generator.device) * 0.02}


def generate(model: Transformer, tokens: torch.Tensor, n_tokens: int,
             generator: Optional[torch.Generator] = None) -> Dict:
    """Prefill ``tokens [B, S]`` (with :func:`front_end_inputs` drawn from
    ``generator``, by default one on the tokens' device seeded 0), then
    ``n_tokens`` greedy decode steps.  Returns the tokens ``[B, n_tokens +
    1]`` (the prefill's and each step's argmax), the host seconds of the
    prefill and of the decode loop (each ended by a device sync), and
    whether every logit was finite."""
    dev = tokens.device
    B, S = tokens.shape
    batch = {"tokens": tokens, **front_end_inputs(
        model.cfg, B, generator or torch.Generator(device=dev).manual_seed(0))}
    P = batch["prefix"].shape[1] if "prefix" in batch else 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, state = M.prefill(model, batch, cache_len=S + P + n_tokens)
    sync()
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    token = torch.argmax(logits, dim=-1)[:, None]
    generated = [token]
    t0 = time.perf_counter()
    for _ in range(n_tokens):
        logits, state = M.serve_step(model, state, token)
        finite &= torch.isfinite(logits).all()
        token = torch.argmax(logits, dim=-1)[:, None]
        generated.append(token)
    sync()
    t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(generated, dim=1),
        "prefill_seconds": t_prefill,
        "decode_seconds": t_decode,
        "logits_finite": bool(finite),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="serve the published configuration, not its reduced() variant")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="keep the first N layers (a depth cut; the widths stay)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    depth = cfg.n_layers
    if args.layers is not None:
        cfg = cfg.with_layers(args.layers)
    B, S = args.batch, args.prompt_len
    check_chunk_rule(cfg, S)
    model = build(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    out = generate(model, prompts, args.tokens, generator=gen)

    toks = args.tokens * B
    t_prefill, t_decode = out["prefill_seconds"], out["decode_seconds"]
    cut = f" layers={cfg.n_layers}/{depth} (depth cut)" if args.layers is not None else ""
    print(
        f"arch={cfg.name}{cut} prefill {B}x{S} in {t_prefill:.2f}s; "
        f"decode {toks} tokens in {t_decode:.2f}s ({toks/t_decode:.1f} tok/s)"
    )
    tokens = out["tokens"]
    if tokens.shape != (B, args.tokens + 1):
        raise RuntimeError(f"generated {tuple(tokens.shape)}, not {(B, args.tokens + 1)}")
    if not bool(((tokens >= 0) & (tokens < cfg.padded_vocab())).all()):
        raise RuntimeError("a generated token lies outside the padded vocabulary")
    return {**out, "arch": cfg.name, "layers": cfg.n_layers, "tok_per_s": toks / t_decode}


if __name__ == "__main__":
    main()
