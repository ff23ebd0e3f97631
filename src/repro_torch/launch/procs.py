"""Start the ranks of a process group on one host: PyTorch's counterpart of
JAX's single controller, which has no module in the reference.

``spawn(fn, n, device=, backend=)`` starts ``n`` processes with
``torch.multiprocessing`` (start method ``spawn``), each joining one
process group through a ``FileStore`` in a temporary directory (no TCP
port is picked, so runs side by side cannot collide), and calls ``fn(rank,
device, *args)`` there.  Rank r's device is ``cuda:{r % device_count}``,
or the CPU when asked.  The backend is the caller's: NCCL takes one card a
rank, gloo any number of ranks a card and the CPU.

Every wait has a deadline: the process group's collectives time out after
``timeout`` seconds, and the parent stops waiting for the ranks then,
kills them and raises ``TimeoutError``.  A rank that raises makes the
parent raise ``RuntimeError`` with the traceback of the rank that raised
first (the other ranks are stopped).  On the card the parent
builds the kernels first and each rank only loads them
(``kernels.build.load_built``).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device
from repro_torch.kernels import build

BACKENDS = ("gloo", "nccl")


def spawn(fn: Callable, n_procs: int, *, backend: str, device=None,
          timeout: float = 600.0, args: Sequence[Any] = ()) -> List[Any]:
    """Runs ``fn(rank, device, *args)`` in ``n_procs`` ranks of one process
    group on ``backend``, and returns their return values by rank (each
    saved by ``torch.save`` and loaded here: return host values).
    ``fn`` must be importable by name (a module-level function).
    ``device``: CUDA (the default) or ``"cpu"``.  Each rank gets an equal
    share of the host's cores (``torch.set_num_threads``).  Raises
    ``ValueError`` for an unknown backend, or NCCL without a card a
    rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; known: {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and (dev.type != "cuda"
                              or n_procs > torch.cuda.device_count()):
        raise ValueError(
            f"NCCL takes one card a rank: {n_procs} ranks on "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "cards; choose gloo to share a card or run on the CPU")
    if dev.type == "cuda":
        build.build()
    threads = max(1, (os.cpu_count() or 1) // n_procs)
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_procs_")
    ctx = None
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n_procs, dev.type, backend, timeout,
                              tmpdir, tuple(args), threads),
            nprocs=n_procs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n_procs} ranks did not finish within "
                                   f"{timeout} s")
        return [torch.load(os.path.join(tmpdir, f"result_{r}.pt"),
                           weights_only=False) for r in range(n_procs)]
    except mp.ProcessRaisedException as e:
        first = _first_error(tmpdir)
        if first is None:
            raise
        # the rank that failed first, not one whose collective broke
        # because it left
        raise RuntimeError(first) from e
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        shutil.rmtree(tmpdir, ignore_errors=True)


def _rank_main(rank: int, fn: Callable, world: int, device_type: str,
               backend: str, timeout: float, tmpdir: str, args: tuple,
               threads: int) -> None:
    torch.set_num_threads(threads)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        build.load_built()
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmpdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(tmpdir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmpdir, f"error_{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\nrank {rank} of {world} raised:\n"
                    f"{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_error(tmpdir: str) -> Optional[str]:
    """The traceback of the rank that raised first, None if none wrote
    one."""
    errors = []
    for name in os.listdir(tmpdir):
        if name.startswith("error_"):
            with open(os.path.join(tmpdir, name)) as f:
                when, text = f.read().split("\n", 1)
            errors.append((float(when), text))
    return min(errors)[1] if errors else None
