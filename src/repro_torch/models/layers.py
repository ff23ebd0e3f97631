"""Core layers: the normalization layers of the CNNs (the paper's §5
study, in NCHW), and the LM's per-token norms, linear layers, gated MLP,
embedding and softcap (``(..., d)`` tensors, linear weights ``(d_in,
d_out)`` applied as ``x @ w``).

Pure functions on tensors, as in ``repro.models.layers``: ``init_*``
build parameter dicts, ``*_apply`` return new tensors and never mutate
their inputs, so they run under ``torch.func.vmap`` over the node axis.
Random initialisers take an explicit ``torch.Generator`` and draw on its
device, then move the result to ``device``.  The LM initialisers place
every leaf on ``device``, which defaults to CUDA as the port's entry
points do (``repro_torch.device.resolve_device``).

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps on a mesh with a ``data`` or ``model`` axis) the LM layers take the
rank's blocks of their weights, as ``launch.sharding``'s rules place
them: a weight is
gathered over ``data`` before use (``collectives.gather_data``); an
in-projection is column-parallel (the rank's output columns), an
out-projection row-parallel (its input rows, the partial products summed
over ``model``), the embedding vocabulary-parallel (the rank's rows of
the table, looked up in its block without a gather; the tied
unembedding gathers the block over ``data``).  The caller of a
column-parallel group applies ``collectives.copy_to_model`` to its input
once.

BatchNorm carries its running statistics explicitly (returned as the new
state) and updates them with the *biased* minibatch variance as
``0.9 * old + 0.1 * batch`` — the reference's convention, which
``nn.BatchNorm2d`` (unbiased running variance, reversed momentum,
in-place buffers) does not follow.  Each node's minibatch statistics
(mu_B, sigma_B) diverge under label skew while the merged model's
running estimates match none of them: the paper's non-IID pathology.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import block_split, split
from repro_torch.models.shard_hints import current_mesh

Params = Dict[str, torch.Tensor]


def _channel_view(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) per-channel tensor shaped to broadcast over x (B, C, ...)."""
    return t.reshape((1, -1) + (1,) * (x.dim() - 2))


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over every axis but 1."""
    axes = (0,) + tuple(range(2, x.dim()))
    mu = x.mean(dim=axes)
    var = (x - _channel_view(mu, x)).square().mean(dim=axes)
    return mu, var


def init_batchnorm(channels: int) -> Tuple[Params, Params]:
    """Returns (params, state).  State = running mean/var, updated in
    train."""
    params = {"scale": torch.ones(channels), "bias": torch.zeros(channels)}
    state = {"mean": torch.zeros(channels), "var": torch.ones(channels),
             "count": torch.zeros(())}
    return params, state


def batchnorm_apply(p: Params, state: Params, x: torch.Tensor, *,
                    train: bool, momentum: float = 0.9,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """x: (B, C, H, W) or (B, C).  Training normalizes with minibatch
    statistics; eval with the running estimates."""
    xf = x.float()
    if train:
        mu, var = _moments(xf)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mu,
            "var": momentum * state["var"] + (1 - momentum) * var,
            "count": state["count"] + 1.0,
        }
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    y = (xf - _channel_view(mu, xf)) * _channel_view(torch.rsqrt(var + eps),
                                                    xf)
    y = y * _channel_view(p["scale"], xf) + _channel_view(p["bias"], xf)
    return y.to(x.dtype), new_state


def batchrenorm_apply(p: Params, state: Params, x: torch.Tensor, *,
                      train: bool, momentum: float = 0.9, eps: float = 1e-5,
                      r_max: float = 3.0, d_max: float = 5.0
                      ) -> Tuple[torch.Tensor, Params]:
    """Batch Renormalization (Ioffe 2017), the Appendix I alternative:
    minibatch statistics corrected toward the running estimates by the
    clipped, gradient-free r and d."""
    xf = x.float()
    cv = lambda t: _channel_view(t, xf)
    if not train:
        y = (xf - cv(state["mean"])) * cv(torch.rsqrt(state["var"] + eps))
        return (y * cv(p["scale"]) + cv(p["bias"])).to(x.dtype), state
    mu_b, var_b = _moments(xf)
    sigma_b = torch.sqrt(var_b + eps)
    sigma = torch.sqrt(state["var"] + eps)
    r = torch.clamp(sigma_b / sigma, 1 / r_max, r_max).detach()
    d = torch.clamp((mu_b - state["mean"]) / sigma, -d_max, d_max).detach()
    y = (xf - cv(mu_b)) / cv(sigma_b) * cv(r) + cv(d)
    y = y * cv(p["scale"]) + cv(p["bias"])
    new_state = {
        "mean": momentum * state["mean"] + (1 - momentum) * mu_b,
        "var": momentum * state["var"] + (1 - momentum) * var_b,
        "count": state["count"] + 1.0,
    }
    return y.to(x.dtype), new_state


def init_groupnorm(channels: int, group_size: int = 2) -> Params:
    if channels % group_size:
        raise ValueError(f"{channels} channels do not split into groups of "
                         f"{group_size}")
    return {"scale": torch.ones(channels), "bias": torch.zeros(channels)}


def groupnorm_apply(p: Params, x: torch.Tensor, *, group_size: int = 2,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm (Wu & He 2018) with groups of ``group_size`` adjacent
    channels — per-sample statistics, hence minibatch-independent (the
    paper's §5.2 fix).  x: (B, C, H, W) or (B, C)."""
    xf = x.float()
    B, C = xf.shape[:2]
    xg = xf.reshape(B, C // group_size, group_size, -1)
    mu = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mu).square().mean(dim=(2, 3), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(xf.shape)
    return (y * _channel_view(p["scale"], xf)
            + _channel_view(p["bias"], xf)).to(x.dtype)


# ---------------------------------------------------------------------------
# LM layers: per-token norms, linear, gated MLP, embedding
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6, *,
                  total: Optional[Callable] = None,
                  width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last axis with float32 statistics, the scale
    applied as ``1 + scale`` (zero-initialised scales are the identity).
    Where ``x`` holds a part of the normalised axis (a rank's channels)
    and ``p`` the scale of that part, ``total`` sums the part's float32
    sum of squares over the parts and ``width`` is the whole axis's
    length."""
    xf = x.float()
    if total is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = total((xf * xf).sum(dim=-1, keepdim=True)) / width
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device=None) -> Params:
    device = resolve_device(device)
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


#: the per-token norms' apply functions by ``ModelConfig.norm``
NORM_APPLY = {"rms": rmsnorm_apply, "layer": layernorm_apply}


def make_norm(kind: str, dim: int, device=None):
    """Returns (init_fn() -> params, apply_fn(params, x) -> y) for the
    per-token norms of the transformer blocks."""
    if kind == "rms":
        return (lambda: init_rmsnorm(dim, device=device)), rmsnorm_apply
    if kind == "layer":
        return (lambda: init_layernorm(dim, device=device)), layernorm_apply
    raise ValueError(kind)


def init_normal(gen: torch.Generator, shape, std: float, dtype, device
                ) -> torch.Tensor:
    """float32 normals of ``std`` drawn on the generator's device, then
    cast to ``dtype`` on ``device``; on the ``meta`` device, the shape
    and dtype alone, nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, device=gen.device) * std
    return w.to(device=resolve_device(device), dtype=dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.bfloat16, bias: bool = False,
                scale: Optional[float] = None, device=None) -> Params:
    s = scale if scale is not None else d_in ** -0.5
    device = resolve_device(device)
    p = {"w": init_normal(gen, (d_in, d_out), s, dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def block_whole(n_rows: int) -> bool:
    """Whether a block whose row-parallel exit has ``n_rows`` whole rows
    runs whole over the active mesh's ``model`` axis: the axis does not
    split those rows (``sharding.block_split``, which the gradient sums
    read too), so every ``model`` rank computes the whole block, with no
    *f* before it and no *g* after it.  False without a mesh."""
    mesh = current_mesh()
    return mesh is not None and not block_split(mesh, n_rows)


def linear_apply(p: Params, x: torch.Tensor, tp: Optional[str] = None,
                 shape: Optional[Tuple[int, int]] = None,
                 whole: bool = False) -> torch.Tensor:
    """``x @ w (+ b)``.  Under a mesh (``current_mesh()``), ``tp`` names the
    weight's rule (``sharding.rule_spec``) and ``shape`` its whole (d_in,
    d_out), which place it (``sharding.split`` asks the clamp of each
    dimension): ``"col"``, an in-projection (d_in over ``data``, d_out
    over ``model``); ``"row"``, an out-projection (d_in over ``model``,
    d_out over ``data``).  The rank's block is gathered over ``data``
    along a dimension split there.  Inside a block that runs split over
    ``model`` (*f* applied to ``x`` by the caller): ``"col"`` gives the
    rank's output columns and its slice of a bias where the columns are
    split, and every column where they are whole (the weight through
    *f*, since each rank's use of it gives a part of its gradient);
    ``"row"`` sums the partial products over ``model`` (*g*) where the
    rows are split, then adds the whole bias.  With ``whole`` (a block
    that runs whole over ``model``: ``block_whole``) the weight is
    gathered whole over ``model`` too where it lies split there (its
    gradient's block comes back) and every rank computes the whole
    product.  Without a mesh (or ``tp``) the weight is whole."""
    mesh = current_mesh() if tp else None
    if mesh is None:
        y = x @ p["w"].to(x.dtype)
        if "b" in p:
            y = y + p["b"].to(x.dtype)
        return y
    if tp not in ("col", "row"):
        raise ValueError(f"linear_apply: tp={tp!r}; want 'col' or 'row'")
    if shape is None:
        raise ValueError("linear_apply: under a mesh the weight's whole "
                         "(d_in, d_out) places it")
    d_ax, m_ax = (0, 1) if tp == "col" else (1, 0)
    w = coll.gather_data(p["w"], d_ax, mesh,
                         split(mesh, "data", shape[d_ax]))
    m_split = split(mesh, "model", shape[m_ax])
    if whole:
        w = coll.gather_from_model(w, m_ax, mesh, m_split)
        y = x @ w.to(x.dtype)
    elif tp == "col":
        y = x @ coll.copy_to_model(w, mesh, not m_split).to(x.dtype)
    else:
        y = coll.reduce_from_model(x @ w.to(x.dtype), mesh, m_split)
    if "b" in p:
        b = p["b"]
        if tp == "col" and m_split and not whole:
            n = y.shape[-1]
            i = mesh.coords.get("model", 0)
            b = b[i * n:(i + 1) * n]
        y = y + b.to(x.dtype)
    return y


def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.bfloat16, device=None) -> Params:
    return {
        "gate": init_linear(gen, d_model, d_ff, dtype, device=device),
        "up": init_linear(gen, d_model, d_ff, dtype, device=device),
        "down": init_linear(gen, d_ff, d_model, dtype, device=device),
    }


def gated_mlp_apply(p: Params, x: torch.Tensor,
                    d_ff: Optional[int] = None) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))``; under a mesh (``d_ff`` its whole
    hidden width) the rank's d_ff columns (gate and up column-parallel,
    down row-parallel), or every column on every ``model`` rank where
    the axis does not split d_ff (``block_whole``)."""
    mesh = current_mesh()
    if mesh is None:
        return linear_apply(p["down"], F.silu(linear_apply(p["gate"], x))
                            * linear_apply(p["up"], x))
    d = x.shape[-1]
    whole = block_whole(d_ff)
    x = coll.copy_to_model(x, mesh, not whole)
    g = F.silu(linear_apply(p["gate"], x, "col", (d, d_ff), whole))
    u = linear_apply(p["up"], x, "col", (d, d_ff), whole)
    return linear_apply(p["down"], g * u, "row", (d_ff, d), whole)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16, device=None) -> Params:
    # unit-variance activations after the sqrt(d_model) embed scaling
    return {"table": init_normal(gen, (vocab, d_model), d_model ** -0.5, dtype,
                             device)}


def embedding_apply(p: Params, tokens: torch.Tensor,
                    compute_dtype=None, whole_vocab: bool = False,
                    d_model: Optional[int] = None) -> torch.Tensor:
    """The table's rows at ``tokens``.  Under a mesh, vocabulary-parallel,
    on the rank's block of the table (vocab over ``model``, ``d_model``,
    its whole width, over ``data``), never gathered: every ``data``
    rank's tokens are gathered (integers), the rank looks up its d / D
    columns of each token's row in its vocabulary rows (zeros for the
    rest) and sends each ``data`` rank its tokens' lookups
    (``all_to_all_data``: the rank receives its tokens' rows, every
    rank's columns), and the rows are summed over ``model`` (one nonzero
    term each: the one-device rows, bit for bit).  With ``whole_vocab``
    (a vocabulary the ``model`` axis does not divide: every rank's block
    holds every row) the rows are looked up whole and not summed over
    ``model``.  Where the ``data`` axis does not split d_model (every
    rank's block holds every column), or where every ``data`` rank holds
    every token (``Mesh.with_rows_whole``: the table's columns gathered
    first), the rank looks up its own tokens alone and sends nothing.  The backward sends each lookup's gradient
    back to the rank whose columns it read, which adds it to its block's
    rows."""
    mesh = current_mesh()
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    if mesh is None:
        return t[tokens]
    n, c = t.shape
    D = mesh.size_of("data")
    cols = split(mesh, "data", c if d_model is None else d_model)
    if cols and mesh.rows_whole:
        # every data rank holds every token: the table's columns gathered
        # (its gradient's block kept), the rank's tokens looked up whole
        t, cols = coll.gather_data(t, 1, mesh), False
        c = t.shape[1]
    every = (mesh.all_gather_dim(tokens.contiguous(), 0, "data") if cols
             else tokens)
    if whole_vocab:
        rows = t[every]
    else:
        local = every - mesh.coords.get("model", 0) * n
        mine = (local >= 0) & (local < n)
        rows = t[local.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
    if cols:
        # rows (D B, T, c), data rank j's tokens in block j: to their
        # rank, then the D column blocks received side by side
        got = coll.all_to_all_data(rows.reshape(-1, c), mesh)
        rows = got.reshape(D, -1, c).transpose(0, 1).reshape(
            tuple(tokens.shape) + (D * c,))
    return coll.reduce_from_model(rows, mesh, not whole_vocab)


def unembed_apply(p: Params, x: torch.Tensor, whole_vocab: bool = False
                  ) -> torch.Tensor:
    """``x @ table.T``; under a mesh the rank's vocabulary columns of the
    logits (the table gathered over ``data`` where it lies split there,
    ``x``'s gradient summed over ``model``), or, with ``whole_vocab``,
    every column (``x``'s gradient whole on every ``model`` rank: no
    sum)."""
    mesh = current_mesh()
    if mesh is None:
        return x @ p["table"].to(x.dtype).T
    x = coll.copy_to_model(x, mesh, not whole_vocab)
    return x @ coll.gather_data(p["table"], 1, mesh, split(
        mesh, "data", x.shape[-1])).to(x.dtype).T


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """The SSM's and the RG-LRU's depthwise causal conv over time, before
    any activation, in float32: x (B, T, Ch), w (K, Ch), ``w[0]``
    multiplying the newest sample, as in the reference.  A sum of the K
    taps, oldest first (``F.conv1d`` in its usual orientation would flip
    them)."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pad[:, i:i + T].float() * w[K - 1 - i].float()
    return out + b.float()


def causal_conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """``causal_conv``'s output at the newest of the K samples ``hist``
    (B, K, Ch), oldest first: the decode step's conv, (B, Ch) float32."""
    K = w.shape[0]
    out = torch.zeros(hist[:, 0].shape, dtype=torch.float32,
                      device=hist.device)
    for i in range(K):
        out = out + hist[:, i].float() * w[K - 1 - i].float()
    return out + b.float()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(exp(x) + 1)`` as ``logaddexp(x, 0)``
    everywhere (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
