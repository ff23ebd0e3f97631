"""End-to-end example: decentralized training of a transformer LM with the
port's train step (``repro_torch.launch.steps``), the twin of the
reference's ``examples/train_lm_decentralized.py``.

Two pods: stacked on one device, or with ``--procs P`` held by P ranks
of a process group (``launch.procs.spawn``, one pod a rank at P = 2:
the reference example's two-pod mesh), whose exchanges are collectives;
with ``--mesh P,D,M`` each of the P pod ranks is split further over a
``data`` axis of D ranks (FSDP: each holds its block of every weight and
its share of the pod's sequences) and a ``model`` axis of M (tensor
parallelism: heads, FFN columns and vocabulary), P x D x M ranks in all;
the configured strategy controls the cross-pod exchange: Gaia's
significance filter, FedAvg, DGC, BSP, or the D-PSGD/AD-PSGD gossip over
a topology fabric (the round's operands built on the host, so a step
reads nothing back).  Trains a qwen3-family model cut to d_model 256, 4
layers, vocab 512 (~10M parameters, float32) on synthetic Markov token
streams for a few hundred steps and asserts that the loss falls below
5.5 (ln 512 = 6.24 at random).

    python -m repro_torch.examples.train_lm_decentralized [--steps 200]
        [--strategy gaia|bsp|fedavg|dgc|dpsgd|adpsgd] [--topology ring]
        [--staleness 1] [--d-model 256] [--layers 4] [--ckpt DIR]
        [--device cuda|cpu] [--procs P [--backend nccl|gloo]]
        [--mesh P,D,M]

The default device is CUDA; ``--device cpu`` runs on the CPU.  With
``--procs`` the ranks use NCCL on the card (one card a rank) and gloo on
the CPU unless ``--backend`` says otherwise.  With ``--ckpt`` the pods'
params are saved at the end in the reference's format
(``repro_torch.checkpointing``; from the ranks, gathered to the first).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpointing import save
from repro_torch.configs.base import (CommConfig, FabricConfig, InputShape,
                                      ModelConfig)
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import synth_tokens
from repro_torch.device import resolve_device
from repro_torch.launch import procs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import train_state_shardings
from repro_torch.launch.specs import train_batch_specs
from repro_torch.launch.steps import (GOSSIP_STRATEGIES, STRATEGIES,
                                      gossip_operands, make_train_state,
                                      make_train_step, train_state_shape)
from repro_torch.models.model import init_model
from repro_torch.topology.graphs import build_demo_schedule

N_PODS = 2
#: the loss the run must reach (ln 512 = 6.24 at random)
TARGET_LOSS = 5.5


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--strategy", default="gaia", choices=list(STRATEGIES))
    ap.add_argument("--topology", default="ring",
                    help="gossip fabric across the two pods")
    ap.add_argument("--staleness", type=int, default=1,
                    help="adpsgd staleness rung (<= max_staleness=2)")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-pod", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--procs", type=int, default=None,
                    help=f"ranks holding the {N_PODS} pods (default: one "
                         "process, the pods stacked)")
    ap.add_argument("--mesh", default=None,
                    help="P,D,M: pod, data and model axes of the ranks "
                         "(P divides the pods; --procs, if given, must be "
                         "P x D x M; default: P = --procs, D = M = 1)")
    ap.add_argument("--backend", default=None, choices=list(procs.BACKENDS),
                    help="the ranks' backend: nccl on the card, gloo on the "
                         "CPU by default")
    return ap.parse_args(argv)


def model_config(d_model: int, layers: int) -> ModelConfig:
    """The reference example's model: the reduced qwen3-0.6b at
    ``d_model``, ``layers`` layers, d_ff 3 d_model, vocab 512, 4 query
    heads over 2 KV heads of d_model / 4."""
    base = get_config("qwen3-0.6b").reduced()
    return dataclasses.replace(
        base, n_layers=layers, d_model=d_model, d_ff=d_model * 3, vocab=512,
        attention=dataclasses.replace(base.attention, n_heads=4,
                                      n_kv_heads=2, head_dim=d_model // 4))


def train(args: argparse.Namespace) -> Dict:
    """The run: returns {"state" (None from ``--procs`` ranks), "losses"
    (host floats, every 20th step and the last), "final_loss",
    "seconds", "cfg", "comm"}."""
    device = resolve_device(args.device)
    shape = mesh_shape(args)
    if shape is None:
        return _run(args, device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    return procs.spawn(_rank, int(np.prod(shape)), backend=backend,
                       device=device, args=(args, shape))[0]


def mesh_shape(args: argparse.Namespace):
    """The ranks' (pod, data, model) shape from ``--mesh`` and ``--procs``,
    None for one process; ``ValueError`` where they disagree."""
    if args.mesh is None:
        return None if not args.procs else (args.procs, 1, 1)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh {args.mesh}: want P,D,M, each >= 1")
    if args.procs and args.procs != int(np.prod(shape)):
        raise ValueError(f"--procs {args.procs} but --mesh {args.mesh} holds "
                         f"{int(np.prod(shape))} ranks")
    return shape


def _rank(rank: int, device: torch.device, args: argparse.Namespace,
          shape) -> Dict:
    mesh = make_mesh(shape, device=device)
    return {**_run(args, device, mesh), "state": None}


def _run(args: argparse.Namespace, device: torch.device, mesh=None) -> Dict:
    cfg = model_config(args.d_model, args.layers)
    comm = CommConfig(strategy=args.strategy,
                      fabric=FabricConfig(topology=args.topology),
                      gaia_t0=0.05, iter_local=10, dgc_sparsity=0.95)
    params = init_model(torch.Generator().manual_seed(0), cfg, device)
    state = make_train_state(params, comm, N_PODS, mesh=mesh)
    # the global batch (every rank draws it; the step takes its rows)
    (pods, b, T), _ = train_batch_specs(
        cfg, InputShape("example", args.seq, N_PODS * args.batch_per_pod,
                        "train"), n_pods=N_PODS)["tokens"]
    data = synth_tokens(512, T + 1, vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(0)

    def next_batch():
        idx = rng.integers(0, data.tokens.shape[0], size=(pods, b))
        seqs = torch.from_numpy(data.tokens[idx]).to(device).long()
        return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}

    step_fn = make_train_step(cfg, comm, mesh=mesh, lr=args.lr, remat=False,
                              chunk=64)
    gossip = args.strategy in GOSSIP_STRATEGIES
    sched = build_demo_schedule(args.topology, N_PODS) if gossip else None
    rounds = {}                 # the period's operands, uploaded once each

    def operands(t: int):
        key = t % sched.period
        if key not in rounds:
            rounds[key] = gossip_operands(
                sched, t, staleness=args.staleness
                if args.strategy == "adpsgd" else None,
                max_staleness=comm.max_staleness, device=device, mesh=mesh)
        return rounds[key]

    talk = mesh is None or mesh.coords == {a: 0 for a in mesh.coords}
    losses = []
    t0 = time.perf_counter()
    for t in range(args.steps):
        extra = {"mix": operands(t)} if gossip else {}
        state, metrics = step_fn(state, next_batch(), t, **extra)
        if t % 20 == 0 or t == args.steps - 1:
            losses.append((t, float(metrics["loss"])))
            if talk:
                print(f"step {t:4d}  loss={losses[-1][1]:.4f}  "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0
    if args.ckpt:
        specs = None if mesh is None else train_state_shardings(
            train_state_shape(cfg, comm, N_PODS), mesh)["params"]
        save(args.ckpt, state["params"], step=args.steps, mesh=mesh,
             specs=specs)
    return {"state": state, "losses": losses, "final_loss": losses[-1][1],
            "seconds": seconds, "cfg": cfg, "comm": comm}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = model_config(args.d_model, args.layers)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch=qwen3-family reduced  params~{cfg.n_params() / 1e6:.1f}M  "
          f"strategy={args.strategy}  device={name}  "
          f"ranks={int(np.prod(mesh_shape(args) or (1,)))}")
    run = train(args)
    final = run["final_loss"]
    print(f"done: loss {final:.4f} (random = ln(512) = 6.24)")
    if args.ckpt:
        print(f"checkpoint written to {args.ckpt}")
    if not final < TARGET_LOSS:
        raise AssertionError(f"LM failed to learn Markov structure: loss "
                             f"{final:.4f} >= {TARGET_LOSS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
