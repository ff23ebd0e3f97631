"""Plain PyTorch versions of the hand-written kernels.

``ops.py`` takes them for tensors on the CPU, the CPU tests hold them
against ``repro.kernels.ref`` and the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  They run on any
device.  ``flash_attention_bthd_bwd_ref`` is the attention's backward,
the one ``ops``' autograd route runs on both devices (the reference has
no backward kernel)."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import dgc_topk, rng


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        logit_softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Materialised-softmax attention.  q: (B, H, Tq, Dk); k: (B, H, Tk,
    Dk); v: (B, H, Tk, Dv).  float32 scores ``q.k * scale`` (by default
    ``Dk ** -0.5``), softcapped as ``cap *
    tanh(s / cap)``, then masked to -1e30 (not -inf, so a row with no
    valid key averages every key, as the reference's oracle does): the
    query at row i sits at position ``i + (Tk - Tq)``; a key is valid if
    it is at or before it (``causal``) and later than ``q_pos - window``
    (``window``).  Softmax and the product with v in float32, the result
    (B, H, Tq, Dv) in q's dtype."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = torch.arange(Tq, device=q.device) + (Tk - Tq)
    k_pos = torch.arange(Tk, device=q.device)
    valid = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(valid, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def flash_attention_bthd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             logit_softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention_ref`` on the model's layout: q (B, Tq, H, Dk), k
    (B, Tk, Hkv, Dk) and v (B, Tk, Hkv, Dv) with H % Hkv == 0.  The KV
    heads are expanded (query head h reads KV head ``h // (H // Hkv)``);
    the result is (B, Tq, H, Dv), contiguous."""
    g = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, logit_softcap=logit_softcap,
                              scale=scale)
    return out.transpose(1, 2).contiguous()


#: float32 elements of one (B, H, query chunk, Tk) score tensor in
#: ``flash_attention_bthd_bwd_ref``: 64 MB, so no (B, H, Tq, Tk) tensor is
#: held whole
BWD_SCORE_ELEMS = 1 << 24


def flash_attention_bthd_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 logit_softcap: Optional[float] = None,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The exact gradient (dq, dk, dv) of ``flash_attention_bthd_ref``'s
    function at q (B, Tq, H, Dk), k (B, Tk, Hkv, Dk) and v (B, Tk, Hkv,
    Dv) for the output's gradient ``dout`` (B, Tq, H, Dv), each in its
    input's dtype.  Everything in float32: the scores are recomputed from
    q and k a chunk of queries at a time (``BWD_SCORE_ELEMS`` bounds a
    chunk's scores), then the softmax, ``ds = p (dp - rowsum(dp p))``
    with ``dp = dout v^T``, the softcap's chain rule ``1 - tanh^2``, and
    no gradient through a masked score (query row i at position ``i + Tk
    - Tq``, as in the forward).  A query head's dk and dv are summed into
    its KV head (h reads ``h // (H // Hkv)``)."""
    B, Tq, H, Dk = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    scale = Dk ** -0.5 if scale is None else scale
    # query head h = kv * g + j: (B, Hkv, g, Tq, D), float32
    qf = q.float().transpose(1, 2).reshape(B, Hkv, g, Tq, Dk)
    dof = dout.float().transpose(1, 2).reshape(B, Hkv, g, Tq, Dv)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    kt, vt = kf.transpose(-1, -2), vf.transpose(-1, -2)
    dq = torch.empty(B, Hkv, g, Tq, Dk, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, Hkv, Tk, Dk, dtype=torch.float32, device=q.device)
    dv = torch.zeros(B, Hkv, Tk, Dv, dtype=torch.float32, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    neg = torch.full((), -1e30, device=q.device)
    step = max(1, BWD_SCORE_ELEMS // (B * H * Tk))
    for lo in range(0, Tq, step):
        hi = min(Tq, lo + step)
        c = hi - lo
        qc = qf[:, :, :, lo:hi].reshape(B, Hkv, g * c, Dk)
        doc = dof[:, :, :, lo:hi].reshape(B, Hkv, g * c, Dv)
        s = (qc @ kt) * scale                            # (B,Hkv,g*c,Tk)
        if logit_softcap is not None:
            th = torch.tanh(s / logit_softcap)
            s = logit_softcap * th
        q_pos = torch.arange(lo, hi, device=q.device) + (Tk - Tq)
        valid = torch.ones(c, Tk, dtype=torch.bool, device=q.device)
        if causal:
            valid &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            valid &= k_pos[None, :] > q_pos[:, None] - window
        valid = valid.repeat(g, 1)                       # (g*c, Tk)
        p = torch.softmax(torch.where(valid, s, neg), dim=-1)
        dp = doc @ vt
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        ds = torch.where(valid, ds, torch.zeros((), device=q.device))
        if logit_softcap is not None:
            ds = ds * (1.0 - th * th)
        ds = ds * scale
        dq[:, :, :, lo:hi] = (ds @ kf).view(B, Hkv, g, c, Dk)
        dk += ds.transpose(-1, -2) @ qc
        dv += p.transpose(-1, -2) @ doc
    return (dq.reshape(B, H, Tq, Dk).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


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


def gaia_select_many_ref(vs: Sequence[torch.Tensor],
                         ws: Sequence[torch.Tensor], threshold
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``gaia_select_ref`` on each pair of ``vs`` and ``ws``: (the
    selections, int32 (len(vs),) counts)."""
    picked = [gaia_select_ref(v, w, threshold) for v, w in zip(vs, ws)]
    return [sel for sel, _ in picked], torch.stack([c for _, c in picked])


def reference_layout(perm: Optional[Tuple[int, ...]], dim: int
                     ) -> Tuple[Callable, Callable]:
    """(to, from) the reference's layout for a stacked (K, ...) tensor of
    ``dim`` dims whose per-node dims the reference permutes by ``perm``
    (its dim i is this layout's per-node dim ``perm[i]``; None: no
    change), each returning a contiguous tensor."""
    if perm is None:
        return (lambda t: t), (lambda t: t)
    fwd = (0,) + tuple(p + 1 for p in perm)
    inv = (0,) + tuple(perm.index(d) + 1 for d in range(dim - 1))
    return ((lambda t: t.permute(fwd).contiguous()),
            (lambda t: t.permute(inv).contiguous()))


def rand_k_sparsify_many_ref(accs: Sequence[torch.Tensor],
                             vels: Sequence[torch.Tensor], keep_prob,
                             seeds: Sequence[int],
                             perms: Sequence[Optional[Tuple[int, ...]]]
                             ) -> Tuple[List[torch.Tensor],
                                        List[torch.Tensor], torch.Tensor]:
    """DGC's rand-k on each (acc, vel) pair by ``rand_k_select_ref``: both
    permuted into the reference's layout (``reference_layout(perm)``),
    masked with the pair's seed, and permuted back.  Returns (the selected
    accs, each vel less its selection, int32 (len(accs),) counts of the
    accs' kept entries)."""
    shared, new_vels, counts = [], [], []
    for acc, vel, seed, perm in zip(accs, vels, seeds, perms):
        to_ref, from_ref = reference_layout(perm, acc.dim())
        sv, cnt = rand_k_select_ref(to_ref(acc), keep_prob, seed)
        su, _ = rand_k_select_ref(to_ref(vel), keep_prob, seed)
        shared.append(from_ref(sv))
        new_vels.append(vel - from_ref(su))
        counts.append(cnt)
    return shared, new_vels, torch.stack(counts)


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
    always on ``x``; an empty ``src`` (M = 0, every weight 0) adds
    nothing."""
    rows = x if src is None else src
    W = torch.zeros((x.shape[0], rows.shape[0]), dtype=torch.float32,
                    device=x.device)
    if rows.shape[0]:
        W.scatter_add_(1, nbr_idx.long(), nbr_w.float())
    out = W @ rows.float() + self_w.float()[:, None] * x.float()
    return out.to(x.dtype)


def neighbor_mix_many_ref(xs: Sequence[torch.Tensor], nbr_idx: torch.Tensor,
                          nbr_w: torch.Tensor, self_w: torch.Tensor
                          ) -> List[torch.Tensor]:
    """``neighbor_mix_padded_ref`` on each stacked (K, ...) leaf, its
    per-node entries as a row, the result shaped like the leaf."""
    K = nbr_idx.shape[0]
    return [neighbor_mix_padded_ref(x.reshape(K, -1), nbr_idx, nbr_w,
                                    self_w).reshape(x.shape) for x in xs]


def neighbor_mix_push_many_ref(xs: Sequence[torch.Tensor],
                               snaps: torch.Tensor, nbr_idx: torch.Tensor,
                               nbr_w: torch.Tensor, self_w: torch.Tensor
                               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """AD-PSGD's round: the leaves, flattened and side by side, pushed
    into slot 0 of the (S + 1, K, N) buffer ``snaps`` (its last slot
    dropped), then ``neighbor_mix_padded_ref`` on each leaf with its
    neighbour rows from its own columns of the pushed buffer viewed as
    ((S + 1) K, N).  Returns (the mixed leaves, the pushed buffer)."""
    K = nbr_idx.shape[0]
    flat = torch.cat([x.reshape(K, -1) for x in xs], dim=1)
    new_snaps = torch.cat([flat[None], snaps[:-1]])
    return (neighbor_mix_src_many_ref(xs, new_snaps.reshape(-1, flat.shape[1]),
                                      nbr_idx, nbr_w, self_w), new_snaps)


def neighbor_mix_src_many_ref(xs: Sequence[torch.Tensor], src: torch.Tensor,
                              nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                              self_w: torch.Tensor) -> List[torch.Tensor]:
    """``neighbor_mix_padded_ref`` on each stacked (K, ...) leaf with its
    neighbour rows from its own columns of ``src`` (M, N), the leaves'
    per-node entries side by side in list order."""
    K = nbr_idx.shape[0]
    outs, off = [], 0
    for x in xs:
        n = x[0].numel()
        outs.append(neighbor_mix_padded_ref(
            x.reshape(K, -1), nbr_idx, nbr_w, self_w,
            src[:, off:off + n]).reshape(x.shape))
        off += n
    return outs


def neighbor_mix_ref(x: torch.Tensor, mixing: torch.Tensor) -> torch.Tensor:
    """Dense gossip averaging ``W @ X`` with the full (K, K) mixing
    matrix.  x: (K, N) stacked per-node vectors."""
    return (mixing.float() @ x.float()).to(x.dtype)


def dgc_threshold_ref(v: torch.Tensor, sparsity) -> torch.Tensor:
    """Exact top-(1 - sparsity) magnitude threshold: the ``sparsity``
    quantile of |v| in float32, as ``jnp.quantile`` computes it."""
    return dgc_topk.quantile_rows(v.float().abs().reshape(1, -1),
                                  sparsity)[0]


def dgc_select_ref(v: torch.Tensor, threshold
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute-magnitude select ``|v| > t``, compared in float32 whatever
    the dtype of ``v``.  Returns (v where selected else 0, int32 count).

    The reference's oracle multiplies by the mask, which gives -0.0 for a
    negative entry that is not selected; this version and the kernels
    (the Pallas one's ``jnp.where`` and ``csrc/dgc_topk.cu``) give +0.0.
    The two are equal as numbers, so compare values with ``==`` or
    ``torch.equal``, not bit patterns."""
    t = torch.as_tensor(threshold, dtype=torch.float32, device=v.device)
    mask = v.float().abs() > t
    return (torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device)),
            mask.sum(dtype=torch.int32))


def _abs_bins(a: torch.Tensor, v_max: torch.Tensor, n_bins: int
              ) -> torch.Tensor:
    """The bin of each float32 |v|: ``clip(int32(a / max(v_max, 1e-30) *
    n_bins), 0, n_bins - 1)``, the quotient divided and multiplied in
    float32.  The float is clamped to ``n_bins - 1`` before the cast:
    XLA's float-to-int conversion saturates, a plain cast of a float past
    the int32 range does not (an external ``v_max`` far below max|v|)."""
    vmax = torch.clamp(v_max, min=1e-30)
    q = a / vmax * n_bins
    return torch.clamp(q, max=float(n_bins - 1)).to(torch.int32).clamp_(
        0, n_bins - 1)


def abs_histogram_ref(v: torch.Tensor, n_bins: int, v_max
                      ) -> torch.Tensor:
    """int32 (n_bins,) histogram of |v| over [0, v_max] with ``n_bins``
    linear bins, the bins clamped (an element at or past ``v_max`` goes
    to the last bin)."""
    a = v.reshape(-1).float().abs()
    vmax = torch.as_tensor(v_max, dtype=torch.float32, device=v.device)
    idx = _abs_bins(a, vmax, n_bins)
    return torch.bincount(idx, minlength=n_bins).to(torch.int32)


def dgc_sparsify_ref(v: torch.Tensor, sparsity, *, n_bins: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Histogram-thresholded DGC without the histogram: (selected, int32
    count, float32 threshold).  The threshold's bin is the first ``b``
    whose count of elements in bins ``<= b``, as float32, reaches
    ``sparsity * float32(n)``, found by bisection over [0, n_bins - 1];
    the threshold is that bin's upper edge over [0, max|v|]
    (``dgc_topk.bin_threshold``).  That is the bin
    ``dgc_topk.threshold_from_histogram`` picks from the histogram, so
    the two routes of ``ops.dgc_sparsify`` give one threshold bit for
    bit.

    The bisection takes ``(n_bins - 1).bit_length()`` steps, which is
    ceil(log2(n_bins)), enough to narrow n_bins candidates to one.  The
    reference's oracle (``repro/kernels/ref.py``) takes
    ``n_bins.bit_length() - 1``, one step short when ``n_bins`` is not a
    power of two; at powers of two the two counts are equal."""
    a = v.reshape(-1).float().abs()
    v_max = a.max()
    idx = _abs_bins(a, v_max, n_bins)
    target = (torch.as_tensor(sparsity, dtype=torch.float32, device=v.device)
              * float(np.float32(a.numel())))
    lo = torch.zeros((), dtype=torch.int64, device=v.device)
    hi = torch.full((), n_bins - 1, dtype=torch.int64, device=v.device)
    for _ in range((n_bins - 1).bit_length()):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        reached = (idx <= mid).sum().float() >= target
        hi = torch.where(reached, mid, hi)
        lo = torch.where(reached, lo, mid + 1)
    t = dgc_topk.bin_threshold(hi, n_bins, v_max)
    sel, cnt = dgc_select_ref(v, t)
    return sel, cnt, t


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   *, group_size: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of an NHWC (B, H, W, C) tensor over groups of
    ``group_size`` adjacent channels, per sample: float32 mean and biased
    variance (the mean of squared deviations), ``(x - mu) * rsqrt(var +
    eps) * scale + bias``, returned in x's dtype."""
    B, H, W, C = x.shape
    xg = x.float().reshape(B, H * W, C // group_size, group_size)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mu).square().mean(dim=(1, 3), keepdim=True)
    y = (xg - mu) * torch.rsqrt(var + eps)
    y = y.reshape(B, H, W, C) * scale.float() + bias.float()
    return y.to(x.dtype)
