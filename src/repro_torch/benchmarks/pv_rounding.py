"""How rounding the softmax probabilities before the p·v product moves
attention's bf16 output, against the reference's float32 p·v:

    python -m repro_torch.benchmarks.pv_rounding [--heads 4] [--seq 2048]
                                                 [--dim 128] [--seed 0]

The reference's kernel (``repro/kernels/flash_attention.py``
``_attn_kernel``) multiplies the float32 probabilities p by v, and the
port's attention is held to that function (``chip_smoke.py``: max |err|
8e-3 and mean |err| 1e-6 at the LM's prefill shape in bfloat16).  A
tensor-core kernel takes bf16 operands.  On bf16-valued normal q, k, v,
causal, this rounds the bf16 output of four ways to compute p·v and
compares each with the rounded reference:

* ``p bf16``: p rounded to bf16, one product (FlashAttention-2/3, SDPA);
* ``p tf32``: p rounded to TF32's 10-bit mantissa, one product;
* ``p hi/lo bf16``: hi = bf16(p), lo = bf16(p - hi), two bf16 products
  (the port's kernel, ``kernels/csrc/flash_attention.cu``);
* ``p f32, f64 sum``: p in float32, the product summed in float64 (the
  same function in another summation order).

Rows print as ``name,max_abs_err,mean_abs_err,share_differing,``.  The
softmax uses the final row max, not a running one; a running max rounds
p to the same number of bits.  Plain PyTorch on the CPU: the numbers are
properties of the arithmetic, not of a device.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def rounding_table(heads: int = 4, seq: int = 2048, dim: int = 128,
                   seed: int = 0) -> List[Tuple[str, float, float, float]]:
    """(name, max |err|, mean |err|, share of outputs that differ) of the
    bf16 output of each way to compute p·v against bf16 of the float32
    reference, causal, over ``heads`` heads of ``seq`` tokens."""
    rs = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rs.standard_normal(
        (heads, seq, dim), dtype=np.float32))) for _ in range(3))
    s = (q @ k.transpose(1, 2)) * dim ** -0.5
    causal = torch.ones(seq, seq, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.full((), -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    expect = _bf16((p @ v) / l)
    hi = _bf16(p)
    ways = (("p bf16", lambda: (hi @ v) / l),
            ("p tf32", lambda: (_tf32(p) @ v) / l),
            ("p hi/lo bf16", lambda: (hi @ v + _bf16(p - hi) @ v) / l),
            ("p f32, f64 sum",
             lambda: ((p.double() @ v.double()) / l.double()).float()))
    rows = []
    for name, way in ways:
        diff = (_bf16(way()) - expect).abs()
        rows.append((name, float(diff.max()), float(diff.mean()),
                     float((diff > 0).float().mean())))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(f"# {args.heads} heads x {args.seq} tokens x {args.dim}, causal, "
          f"seed {args.seed}: name,max_abs_err,mean_abs_err,share_differing,")
    for name, mx, mean, share in rounding_table(args.heads, args.seq,
                                                args.dim, args.seed):
        print(f"{name},{mx:.3g},{mean:.3g},{share:.4g},", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
