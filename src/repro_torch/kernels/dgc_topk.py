"""DGC's magnitude thresholds: from a histogram of |v|, and exact.

On the card one kernel (``csrc/dgc_topk.cu``) bins, picks the threshold
and selects; these are the threshold's plain versions:
``threshold_from_histogram`` as the reference writes it, and
``threshold_by_count``, the kernel's search, which lands on the same bin.
DGC top-k in training takes the exact threshold, ``quantile_rows``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bin_threshold(b: torch.Tensor, n_bins: int, v_max) -> torch.Tensor:
    """The upper edge of bin ``b`` over [0, v_max] in float32:
    ``(b + 1) * float32(1 / n_bins) * v_max``.  The reference writes
    ``(b + 1.0) / n_bins * v_max``; XLA rewrites a division by a constant
    as a multiply by its float32 reciprocal, so this is what the
    reference computes, bit for bit at every ``n_bins`` (at a power of
    two the two forms are the same number)."""
    inv = float(np.float32(1) / np.float32(n_bins))
    vmax = torch.as_tensor(v_max, dtype=torch.float32, device=b.device)
    return (b.float() + 1.0) * inv * vmax.reshape(())


def threshold_from_histogram(hist: torch.Tensor, v_max, sparsity
                             ) -> torch.Tensor:
    """The DGC threshold (float32, 0-d): the upper edge of the first bin
    whose cumulative count, as float32, reaches ``sparsity * total``
    (``jnp.searchsorted``'s left side, which is ``torch.searchsorted``'s
    default), clipped to the last bin.  ``hist`` is the (n_bins,) int32
    histogram of |v| over [0, v_max]; ``sparsity``, a host number, is
    rounded to float32 before the multiply, as JAX's weak type rounds a
    Python float.  It reaches the device as a kernel argument, not as a
    copy, so nothing here waits for the device.

    ``torch.cumsum`` of int32 counts gives int64 where ``jnp.cumsum``
    gives int32; every cumulative count is below 2**31, so the two
    integers are equal and round to the same float32."""
    n_bins = hist.shape[0]
    cum, target = _cumulative(hist, sparsity)
    b = torch.searchsorted(cum, target.reshape(1)).clamp_(0, n_bins - 1)[0]
    return bin_threshold(b, n_bins, v_max)


def threshold_by_count(hist: torch.Tensor, v_max, sparsity) -> torch.Tensor:
    """``threshold_from_histogram`` as ``csrc/dgc_topk.cu`` searches: the
    bin is the number of bins whose float32 cumulative count lies below
    ``float32(sparsity) * float32(total)``, clipped to the last bin.  The
    cumulative counts rise, so that number is ``searchsorted``'s left
    index, and the two give one threshold bit for bit."""
    n_bins = hist.shape[0]
    cum, target = _cumulative(hist, sparsity)
    b = (cum < target).sum().clamp_(max=n_bins - 1)
    return bin_threshold(b, n_bins, v_max)


def _cumulative(hist: torch.Tensor, sparsity
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 cumulative counts of ``hist`` and the count to reach,
    ``float32(sparsity) * total``."""
    cum = torch.cumsum(hist, 0).float()
    return cum, cum[-1] * float(np.float32(sparsity))


def quantile_rows(a: torch.Tensor, q) -> torch.Tensor:
    """Row-wise ``jnp.quantile(a, q, axis=1)`` (linear interpolation) of a
    (K, n) float32 tensor: the rank ``q * (n - 1)``, its floor and ceil
    and the two weights in float32 on the host, the two order statistics
    from ``kthvalue`` (no size limit, unlike ``torch.quantile``), and
    ``low * w_low + high * w_high`` in float32, each operation rounded as
    ``jnp.quantile``'s source writes it.  (XLA's CPU backend may fuse a
    multiply and an add of it into one fused multiply-add, which moves
    its result by an ulp; that is code generation, not the function.)"""
    n = a.shape[1]
    rank = np.float32(q) * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(rank), np.ceil(rank)
    w_hi = np.float32(rank - lo)
    w_lo = np.float32(1) - w_hi
    lo, hi = (int(np.clip(r, 0, n - 1)) for r in (lo, hi))
    low = a.kthvalue(lo + 1, dim=1).values
    high = low if hi == lo else a.kthvalue(hi + 1, dim=1).values
    return low * float(w_lo) + high * float(w_hi)
