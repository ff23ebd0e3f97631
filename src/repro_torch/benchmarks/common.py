"""Shared experiment setup for the port's paper-figure benches, the twin
of the reference's ``benchmarks/common.py``.

The synthetic-CIFAR stand-in is tuned so BSP/IID reaches ~1.0 accuracy
(the paper's methodology: validate the IID baseline first, then
attribute any drop to the decentralized algorithm / data skew).

Two differences from the reference: rows land in the port's own
``experiments/results_torch/``, so a port run never overwrites the
reference's results, and nothing here reads an environment variable:
the commit comes from git and ``save_bench_json`` writes only where its
caller says (``run.py --json DIR``).
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.core.partition import partition_label_skew
from repro_torch.data.synthetic import synth_images
from repro_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[3]
RESULTS_DIR = str(REPO / "experiments" / "results_torch")

# data difficulty: class_sep/noise chosen so BN pathology and algorithm
# accuracy gaps are visible at CPU scale (see EXPERIMENTS.md §Setup)
DATA = dict(noise=0.8, class_sep=0.35)
TRAIN = dict(batch=20, lr=0.02, eval_every=200)
# norm-free nets destabilize at 0.02 under label skew (logit collapse);
# the paper likewise tunes lr per model (App. C: AlexNet 10x lower)
MODEL_LR = {"lenet": 0.005, "alexnet-s": 0.005}
K = 5


def train_args(model: str):
    args = dict(TRAIN)
    args["lr"] = MODEL_LR.get(model, args["lr"])
    return args


def make_data(n_train: int = 4000, n_val: int = 1000):
    ds = synth_images(n_train, seed=0, **DATA)
    val = synth_images(n_val, seed=99, **DATA)
    return ds, val


def make_parts(ds, skew: float, n_nodes: int = K, seed: int = 1):
    idx = partition_label_skew(ds.y, n_nodes, skew, seed=seed)
    return [(ds.x[i], ds.y[i]) for i in idx]


def save_rows(name: str, rows: List[Dict]) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return path


def load_rows(name: str):
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def git_commit() -> str:
    """The checkout's commit by ``git rev-parse HEAD``; an empty string
    outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=REPO, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def card(device) -> Dict[str, Optional[str]]:
    """Where a bench ran: ``{"device": "cpu", "power_limit": None}`` on
    the CPU; on a card its name (``torch.cuda.get_device_name``) and the
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit": smi[index].rsplit(",", 1)[1].strip()}


def save_bench_json(name: str, rows: List[Dict], *, out_dir: str,
                    device, derived: str = "",
                    us_per_call: float = 0.0) -> str:
    """Machine-readable per-bench artifact, ``<out_dir>/BENCH_<name>.json``:
    the commit, the time, where it ran (``card``), the wall time, the
    headline and the rows."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{name}.json")
    with open(path, "w") as f:
        json.dump(dict(name=name, commit=git_commit(),
                       timestamp=time.time(), **card(device),
                       us_per_call=us_per_call, derived=derived, rows=rows),
                  f, indent=1)
    return path


def timed(fn, *args, n_warmup: int = 2, n_iter: int = 10, **kw) -> float:
    """us per call on the host's clock: host-side work only, since a
    call that queues work on a card returns before the card is done."""
    for _ in range(n_warmup):
        fn(*args, **kw)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn(*args, **kw)
    return (time.perf_counter() - t0) / n_iter * 1e6
