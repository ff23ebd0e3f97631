"""Plain PyTorch versions of the hand-written kernels.

``ops.py`` takes them for tensors on the CPU, the CPU tests hold them
against ``repro.kernels.ref`` and the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  They run on any
device."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import rng


def gaia_select_ref(v: torch.Tensor, w: torch.Tensor, threshold
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Significance filter ``|v| > T*|w|``, compared in float32 whatever
    the dtype of ``v`` and ``w``.  Returns (v where selected else 0,
    int32 count of selected entries)."""
    t = torch.as_tensor(threshold, dtype=torch.float32, device=v.device)
    mask = v.float().abs() > t * w.float().abs()
    return (torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device)),
            mask.sum(dtype=torch.int32))


def rand_k_select_ref(v: torch.Tensor, keep_prob, seed: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded rand-k with the uniforms materialised: element i (flat
    index) is kept where ``uniform01(seed, i) < keep_prob``, compared in
    float32, with ``seed`` taken modulo 2**32.  Returns (v where kept
    else 0, int32 count of kept entries)."""
    p = torch.as_tensor(keep_prob, dtype=torch.float32, device=v.device)
    u = rng.uniform01(int(seed), torch.arange(v.numel(), device=v.device))
    mask = (u < p).reshape(v.shape)
    return (torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device)),
            mask.sum(dtype=torch.int32))


def neighbor_mix_padded_ref(x: torch.Tensor, nbr_idx: torch.Tensor,
                            nbr_w: torch.Tensor, self_w: torch.Tensor,
                            src: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Dense version over the kernel's own padded-neighbor operands: the
    (K, D) index/weight lists are scattered into a dense (K, M) mixing
    matrix and applied as one float32 matmul (padding entries carry
    weight 0, so they scatter nothing).  Neighbour rows come from ``src``
    (M, N) when it is given, else from ``x`` (M = K); the self term is
    always on ``x``."""
    rows = x if src is None else src
    W = torch.zeros((x.shape[0], rows.shape[0]), dtype=torch.float32,
                    device=x.device)
    W.scatter_add_(1, nbr_idx.long(), nbr_w.float())
    out = W @ rows.float() + self_w.float()[:, None] * x.float()
    return out.to(x.dtype)


def neighbor_mix_ref(x: torch.Tensor, mixing: torch.Tensor) -> torch.Tensor:
    """Dense gossip averaging ``W @ X`` with the full (K, K) mixing
    matrix.  x: (K, N) stacked per-node vectors."""
    return (mixing.float() @ x.float()).to(x.dtype)
