"""Serving example: batched greedy decoding over the arch's decode cache
(a ring-buffer KV cache, MLA's compressed c_kv, the SSM's constant
state, or the RG-LRU's state beside a ring KV cache), through the same
serve step the reference's ``examples/serve_decode.py`` drives.  A batch
of random prompts is fed one token at a time through the serve step,
then the model generates greedily; the tokens/s of the whole loop are
printed.  For the enc-dec arch (seamless) each request also has random
frames (B, n_frames, feat_dim) in bfloat16 as the reference's serving
specs have them; the encoder runs on them once, and every step's
cross-attention reads its output.

    python -m repro_torch.examples.serve_decode [--arch <any of the ten>]
        [--device cuda|cpu] [--reduced] [--batch 4] [--prompt-len 16]
        [--gen-len 32] [--cache-len 64] [--seed 0]

It runs on the card at the arch's full width by default; ``--device cpu
--reduced`` runs the reduced config on the CPU.  The weights are random,
drawn from ``--seed``; the prompts (and frames) from NumPy's generator
at ``--seed + 7``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import encdec
from repro_torch.models.model import Params, init_cache, init_model

#: the decode cache each family keeps, the reference's table
#: (``examples/serve_decode.py``); every other family keeps a ring-buffer
#: KV cache
CACHE_KINDS = {"ssm": "constant SSM state", "hybrid": "RG-LRU + ring KV",
               "moe": "compressed MLA c_kv"}


def serve(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
          gen_len: int, cache_len: int,
          frames: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, float]:
    """Feed ``prompt`` (B, P) through the serve step one token at a time,
    then generate ``gen_len`` tokens greedily (the first from the prompt's
    last step).  For an enc-dec arch, the encoder runs once on ``frames``
    (B, n_frames, feat_dim) first, inside the loop's time.  Returns
    (int32 (B, gen_len) tokens, seconds of the whole loop, ending in a
    synchronise on a card)."""
    B, P = prompt.shape
    device = prompt.device
    cache = init_cache(cfg, B, cache_len, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        memory = (None if cfg.encoder is None else
                  encdec.encoder_apply(params["encoder"], cfg, frames))
        serve_step = make_serve_step(cfg, memory)
        for t in range(P):
            batch = {"token": prompt[:, t],
                     "t": torch.full((B,), t, dtype=torch.int32,
                                     device=device)}
            tok, cache = serve_step(params, cache, batch)
        generated = [tok]
        for t in range(P, P + gen_len - 1):
            batch = {"token": tok,
                     "t": torch.full((B,), t, dtype=torch.int32,
                                     device=device)}
            tok, cache = serve_step(params, cache, batch)
            generated.append(tok)
        out = torch.stack(generated, dim=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced (smoke-test) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(gen, cfg, device)
    B = args.batch
    prompt = np.random.default_rng(args.seed + 7).integers(
        0, cfg.vocab, (B, args.prompt_len))
    prompt = torch.from_numpy(prompt).to(device)
    frames = None
    if cfg.encoder is not None:
        frames = torch.from_numpy(np.random.default_rng(args.seed + 7)
                                  .standard_normal((B, cfg.encoder.n_frames,
                                                    cfg.modality.feat_dim))
                                  .astype(np.float32)).to(device,
                                                          torch.bfloat16)
    tokens, seconds = serve(params, cfg, prompt, args.gen_len,
                            args.cache_len, frames)
    n_tok = B * (args.prompt_len + args.gen_len - 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'full'}, "
          f"{cfg.dtype})  batch={B}  device={name}")
    print(f"generated {tokens.shape[1]} tokens/request in {seconds:.3f} s "
          f"({n_tok / seconds:.1f} tok/s, prompt steps included)")
    for b in range(min(B, 2)):
        print(f"  request {b}: {tokens[b, :16].tolist()} ...")
    print(f"cache family: {CACHE_KINDS.get(cfg.family, 'ring-buffer KV')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
