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
        [--mesh D,M [--procs N] [--backend nccl|gloo]]
        [--moe-route dense|ep]

It runs on the card at the arch's full width by default; ``--device cpu
--reduced`` runs the reduced config on the CPU.  The weights are random,
drawn from ``--seed``; the prompts (and frames) from NumPy's generator
at ``--seed + 7``.  With ``--mesh D,M`` the model is served by D x M
ranks of a process group (``launch.procs.spawn``; ``--procs``, if
given, must be D x M), one site of a ``(1, D, M)`` mesh: each rank holds
its blocks of the weights (FSDP over ``data``, tensor and expert
parallelism over ``model``) and of the decode cache (the reference's
placement: the requests over ``data`` from a batch of 8, and for the SSM
and the RG-LRU hybrid from any batch, the attention caches' length over
``model``), and decodes its requests; every family, on any axes (a
width an axis does not divide whole on every rank of it); the enc-dec's
encoder runs on
the rank's requests (``make_encode_step``).
The ranks use NCCL on the card (one card a rank) and gloo on the CPU
unless ``--backend`` says otherwise.  ``--moe-route`` picks the MoE
layers' function (the reference's dense one, or its expert-parallel
one, which a prompt step of one token leaves to the dense route).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import procs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import local_params
from repro_torch.launch.steps import make_encode_step, make_serve_step
from repro_torch.models.model import Params, init_cache, init_model
from repro_torch.models.moe import ROUTES

#: the decode cache each family keeps, the reference's table
#: (``examples/serve_decode.py``); every other family keeps a ring-buffer
#: KV cache
CACHE_KINDS = {"ssm": "constant SSM state", "hybrid": "RG-LRU + ring KV",
               "moe": "compressed MLA c_kv"}


def serve(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
          gen_len: int, cache_len: int,
          frames: Optional[torch.Tensor] = None, *, mesh=None,
          moe_route: str = "dense") -> Tuple[torch.Tensor, float]:
    """Feed ``prompt`` (B, P) through the serve step one token at a time,
    then generate ``gen_len`` tokens greedily (the first from the prompt's
    last step).  For an enc-dec arch, the encoder runs once on ``frames``
    (B, n_frames, feat_dim) first, inside the loop's time.  On an
    intra-pod ``mesh`` ``params`` are the rank's blocks, the cache the
    rank's block and the encoder's output the rank's requests'; every
    rank returns the whole batch's tokens.  Returns
    (int32 (B, gen_len) tokens, seconds of the whole loop, ending in a
    synchronise on a card)."""
    B, P = prompt.shape
    device = prompt.device
    cache = init_cache(cfg, B, cache_len, device=device, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        memory = (None if cfg.encoder is None else
                  make_encode_step(cfg, mesh=mesh)(params,
                                                   {"frames": frames}))
        serve_step = make_serve_step(cfg, memory, mesh=mesh,
                                     moe_route=moe_route)
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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
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
    ap.add_argument("--mesh", default=None,
                    help="D,M: serve on a (1, D, M) mesh of D x M ranks")
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks (D x M of --mesh)")
    ap.add_argument("--backend", default=None, choices=list(procs.BACKENDS))
    ap.add_argument("--moe-route", default="dense", choices=list(ROUTES))
    return ap.parse_args(argv)


def mesh_shape(args: argparse.Namespace):
    """The ranks' (1, D, M) from ``--mesh`` and ``--procs``, None for one
    process; ``ValueError`` where they disagree."""
    if args.mesh is None:
        if args.procs:
            raise ValueError("--procs needs --mesh D,M")
        return None
    dm = tuple(int(x) for x in args.mesh.split(","))
    if len(dm) != 2 or min(dm) < 1:
        raise ValueError(f"--mesh {args.mesh}: want D,M, each >= 1")
    if args.procs and args.procs != dm[0] * dm[1]:
        raise ValueError(f"--procs {args.procs} but --mesh {args.mesh} holds "
                         f"{dm[0] * dm[1]} ranks")
    return (1,) + dm


def run(args: argparse.Namespace) -> Dict:
    """The serving run: {"tokens" (B, gen_len) int32 on the host,
    "seconds" (the slowest rank's), "ranks", "cfg"}."""
    device = resolve_device(args.device)
    shape = mesh_shape(args)
    if shape is None:
        return {**_run(args, device), "ranks": 1}
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    out = procs.spawn(_rank, int(np.prod(shape)), backend=backend,
                      device=device, args=(args, shape))
    return {**out[0], "seconds": max(r["seconds"] for r in out),
            "ranks": len(out)}


def _rank(rank: int, device: torch.device, args: argparse.Namespace,
          shape) -> Dict:
    mesh = make_mesh(shape, device=device)
    return _run(args, device, mesh)


def _config(args: argparse.Namespace) -> ModelConfig:
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def _run(args: argparse.Namespace, device: torch.device, mesh=None) -> Dict:
    cfg = _config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(gen, cfg, device)
    if mesh is not None:
        # the rank keeps copies of its blocks; the whole draw is freed
        params = pytree.tree_map(lambda t: t.clone(),
                                 local_params(params, mesh))
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
                            args.cache_len, frames, mesh=mesh,
                            moe_route=args.moe_route)
    return {"tokens": tokens.cpu(), "seconds": seconds, "cfg": cfg}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = run(args)
    cfg, tokens, seconds = out["cfg"], out["tokens"], out["seconds"]
    B = args.batch
    n_tok = B * (args.prompt_len + args.gen_len - 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'full'}, "
          f"{cfg.dtype})  batch={B}  device={name}  ranks={out['ranks']}")
    print(f"generated {tokens.shape[1]} tokens/request in {seconds:.3f} s "
          f"({n_tok / seconds:.1f} tok/s, prompt steps included)")
    for b in range(min(B, 2)):
        print(f"  request {b}: {tokens[b, :16].tolist()} ...")
    print(f"cache family: {CACHE_KINDS.get(cfg.family, 'ring-buffer KV')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
