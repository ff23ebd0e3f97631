"""Normalization layers of the CNNs (the paper's §5 study), in NCHW.

Pure functions on tensors, as in ``repro.models.layers``: ``init_*``
build parameter dicts, ``*_apply`` return new tensors and never mutate
their inputs, so they run under ``torch.func.vmap`` over the node axis.

BatchNorm carries its running statistics explicitly (returned as the new
state) and updates them with the *biased* minibatch variance as
``0.9 * old + 0.1 * batch`` — the reference's convention, which
``nn.BatchNorm2d`` (unbiased running variance, reversed momentum,
in-place buffers) does not follow.  Each node's minibatch statistics
(mu_B, sigma_B) diverge under label skew while the merged model's
running estimates match none of them: the paper's non-IID pathology.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

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
