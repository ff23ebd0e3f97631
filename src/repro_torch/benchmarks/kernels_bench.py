"""Kernel microbenchmarks of the port, the twin of the reference's
``benchmarks/kernels_bench.py`` at its shapes:

    python -m repro_torch.benchmarks.kernels_bench [--device cuda|cpu]
                                                   [--json PATH]

Rows, printed as ``name,us_per_call,``:

* ``kernel/<op>``  -- the port's op (``repro_torch.kernels.ops``): on the
  card its hand-written kernel, with the op's checks and allocations;
* ``oracle/<op>``  -- the op's plain PyTorch version (``kernels/ref.py``)
  on the same device;
* ``library/<op>`` -- one PyTorch call that computes the same function,
  where there is one (``F.scaled_dot_product_attention``,
  ``torch.quantile``, ``W @ X``, ``F.group_norm``); timed here only,
  never called by the port;
* ``prod/chunked_attention`` -- the LM's attention as its model path
  calls it (``models.attention.chunked_attention`` on (B, T, H, D)
  views): on the card the ``flash_attention`` kernel reading them in
  place.

Then a ``kernel/<op>`` and ``oracle/<op>`` pair for each public op of
the port that the reference has no twin of, on the same operands: the
list ops as the training path calls them (``gaia_select_many`` and
``rand_k_sparsify_many`` over the 1M elements as 16 tensors,
``neighbor_mix_many``, ``neighbor_mix_push_many`` (a 3-slot snapshot
buffer read at staleness 2) and ``neighbor_mix_src_many`` over the ring's
(8, 128k) as 16 leaves), DGC's parts (``abs_histogram``,
``abs_histogram_fused``, ``dgc_select`` at the 0.999 quantile) and
``flash_attention_bthd`` on (B, T, H, D) views, so the gate
(``repro_torch.benchmarks.report --gate``) sees every op.

The attention rows run at the reference's shape, B, H, T, D = 1, 4, 256,
64, float32, causal.  The reference's ``interp/<op>`` rows (Pallas in
interpret mode) have no counterpart.

A call's time is the median of 50 calls after 3 warm-up calls.  On the
card each call lies between two CUDA events, queued behind a spin kernel
(``SPIN_CYCLES``, ~0.6 ms) that holds the device while the host enqueues
the call, so a row reads the device's time; only a call whose enqueue
outlasts the spin (the plain list ops' Python loops) also reads some of
the host's.  On the CPU (``--device cpu``, for tests at small sizes) the host clock
times them, and the numbers are CPU numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import chunked_attention
from repro_torch.topology import ring


#: GPU clock cycles of the spin kernel queued ahead of each timed call
SPIN_CYCLES = 1_000_000


def time_us(fn: Callable[[], object], device: torch.device,
            reps: int = 50, warmup: int = 3) -> float:
    """Median time of one ``fn()`` in microseconds over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def inputs(device: str = "cuda", *, n: int = 1 << 20,
           mix_cols: int = 1 << 17,
           gn_shape: Sequence[int] = (128, 8, 8, 64),
           attn_shape: Sequence[int] = (1, 4, 256, 64)
           ) -> Dict[str, object]:
    """The bench's operands on ``device``, drawn on the host from seed 0
    and then moved, so every device gets the same numbers: ``v``, ``w``
    (n,) for the select rows, ``xs`` (8, mix_cols) with the ``ring(8)``
    neighbour operands ``mix_ops`` and dense ``W``, the NHWC ``x`` with
    float32 ``scale``/``bias`` for GroupNorm, and ``q``, ``k``, ``v_attn``
    (B, H, T, D) for attention.  ``chip_smoke.py`` holds each kernel
    against its plain version on these."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    v = randn(n)
    w = randn(n, scale=0.3)
    topo = ring(8)
    idx, nw, sw = topo.neighbor_arrays()
    mix_ops = (torch.from_numpy(idx.astype(np.int32)).to(dev),
               torch.from_numpy(nw.astype(np.float32)).to(dev),
               torch.from_numpy(sw.astype(np.float32)).to(dev))
    xs = randn(8, mix_cols)                        # 8 nodes x 128k params
    W = torch.from_numpy(topo.mixing.astype(np.float32)).to(dev)
    # per-node CIFAR batch at a late ResNet stage: many samples, small
    # feature maps
    x = randn(*gn_shape)
    C = gn_shape[-1]
    q, k, v_attn = (randn(*attn_shape) for _ in range(3))
    return {"v": v, "w": w, "xs": xs, "mix_ops": mix_ops, "W": W, "x": x,
            "scale": torch.ones(C, device=dev),
            "bias": torch.zeros(C, device=dev),
            "q": q, "k": k, "v_attn": v_attn}


def run(device: str = "cuda", *, n: int = 1 << 20, mix_cols: int = 1 << 17,
        gn_shape: Sequence[int] = (128, 8, 8, 64),
        attn_shape: Sequence[int] = (1, 4, 256, 64), reps: int = 50
        ) -> List[Tuple[str, float]]:
    """Every row of the reference's kernel bench but the interpret-mode
    ones, and the library rows, as (name, microseconds a call).
    ``device`` is where the tensors live: ``"cuda"`` (the default) raises
    without a card; the sizes default to the reference's."""
    dev = resolve_device(device)
    a = inputs(device, n=n, mix_cols=mix_cols, gn_shape=gn_shape,
               attn_shape=attn_shape)
    vv, ww, xs, mix_ops, W = a["v"], a["w"], a["xs"], a["mix_ops"], a["W"]
    x, sc, bi = a["x"], a["scale"], a["bias"]
    q, k, va = a["q"], a["k"], a["v_attn"]
    rows: List[Tuple[str, float]] = []

    def bench(name: str, fn: Callable[[], object]) -> None:
        rows.append((name, time_us(fn, dev, reps)))

    bench("kernel/flash_attention", lambda: ops.flash_attention(q, k, va))
    bench("oracle/flash_attention",
          lambda: ref.flash_attention_ref(q, k, va))
    bench("library/flash_attention",
          lambda: F.scaled_dot_product_attention(q, k, va, is_causal=True))
    qb, kb, vb = (t.transpose(1, 2) for t in (q, k, va))
    bench("prod/chunked_attention",
          lambda: chunked_attention(qb, kb, vb, chunk=64))

    bench("kernel/gaia_select_1M", lambda: ops.gaia_select(vv, ww, 0.5))
    bench("oracle/gaia_select_1M", lambda: ref.gaia_select_ref(vv, ww, 0.5))

    bench("kernel/dgc_sparsify_1M", lambda: ops.dgc_sparsify(vv, 0.999))
    bench("oracle/dgc_sparsify_1M", lambda: ref.dgc_sparsify_ref(vv, 0.999))
    bench("oracle/dgc_quantile_1M", lambda: ref.dgc_threshold_ref(vv, 0.999))
    bench("library/dgc_quantile_1M",
          lambda: torch.quantile(vv.abs(), 0.999))

    bench("kernel/rand_k_1M", lambda: ops.rand_k_sparsify(vv, 0.001, 7))
    bench("oracle/rand_k_1M", lambda: ref.rand_k_select_ref(vv, 0.001, 7))

    bench("kernel/neighbor_mix_ring8_128k",
          lambda: ops.neighbor_mix(xs, *mix_ops))
    bench("oracle/neighbor_mix_ring8_128k",
          lambda: ref.neighbor_mix_padded_ref(xs, *mix_ops))
    bench("oracle/neighbor_mix_dense", lambda: ref.neighbor_mix_ref(xs, W))
    bench("library/neighbor_mix_dense", lambda: torch.matmul(W, xs))

    C = x.shape[-1]
    bench("kernel/group_norm",
          lambda: ops.group_norm(x, sc, bi, group_size=2))
    bench("oracle/group_norm",
          lambda: ref.group_norm_ref(x, sc, bi, group_size=2))
    bench("library/group_norm",
          lambda: F.group_norm(x.permute(0, 3, 1, 2), C // 2, sc, bi))

    # the port's own ops, on the same operands
    vs, ws = list(vv.chunk(16)), list(ww.chunk(16))
    bench("kernel/gaia_select_many_1M",
          lambda: ops.gaia_select_many(vs, ws, 0.5))
    bench("oracle/gaia_select_many_1M",
          lambda: ref.gaia_select_many_ref(vs, ws, 0.5))
    keep, seeds, perms = float(np.float32(0.001)), range(16), [None] * 16
    bench("kernel/rand_k_sparsify_many_1M",
          lambda: ops.rand_k_sparsify_many(vs, ws, keep, seeds, perms))
    bench("oracle/rand_k_sparsify_many_1M",
          lambda: ref.rand_k_sparsify_many_ref(vs, ws, keep, seeds, perms))
    vmax = vv.abs().amax()
    thresh = ref.dgc_threshold_ref(vv, 0.999)
    bench("kernel/abs_histogram_1M", lambda: ops.abs_histogram(vv, vmax))
    bench("oracle/abs_histogram_1M",
          lambda: ref.abs_histogram_ref(vv, 256, vmax))
    bench("kernel/abs_histogram_fused_1M",
          lambda: ops.abs_histogram_fused(vv))
    bench("oracle/abs_histogram_fused_1M",
          lambda: ref.abs_histogram_ref(vv, 256, vv.abs().amax()))
    bench("kernel/dgc_select_1M", lambda: ops.dgc_select(vv, thresh))
    bench("oracle/dgc_select_1M", lambda: ref.dgc_select_ref(vv, thresh))

    K = xs.shape[0]
    leaves = [c.contiguous() for c in xs.chunk(16, dim=1)]
    idx, nw, sw = (t.cpu().numpy() for t in mix_ops)
    mix = ops.mix_operands(idx, nw, sw, K, dev)
    bench("kernel/neighbor_mix_many_ring8_128k",
          lambda: ops.neighbor_mix_many(leaves, mix))
    bench("oracle/neighbor_mix_many_ring8_128k",
          lambda: ref.neighbor_mix_many_ref(leaves, *mix_ops))
    snaps = xs.unsqueeze(0).repeat(3, 1, 1)
    stale = ops.mix_operands(idx + 2 * K, nw, sw, 3 * K, dev)
    bench("kernel/neighbor_mix_push_many_ring8_128k",
          lambda: ops.neighbor_mix_push_many(leaves, snaps, stale))
    bench("oracle/neighbor_mix_push_many_ring8_128k",
          lambda: ref.neighbor_mix_push_many_ref(
              leaves, snaps, stale.idx, stale.w, stale.self_w))
    bench("kernel/neighbor_mix_src_many_ring8_128k",
          lambda: ops.neighbor_mix_src_many(leaves, xs, mix))
    bench("oracle/neighbor_mix_src_many_ring8_128k",
          lambda: ref.neighbor_mix_src_many_ref(leaves, xs, *mix_ops))

    bench("kernel/flash_attention_bthd",
          lambda: ops.flash_attention_bthd(qb, kb, vb))
    bench("oracle/flash_attention_bthd",
          lambda: ref.flash_attention_bthd_ref(qb, kb, vb))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rows = run(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# device: {name}")
    for row, us in rows:
        print(f"{row},{us:.3f},", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": name, "rows": [
                {"name": row, "us_per_call": us} for row, us in rows]},
                f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
