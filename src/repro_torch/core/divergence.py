"""Divergence probes behind the paper's diagnostic figures.

- Figure 4:  BatchNorm minibatch-mean divergence across partitions.
- Figure 22: DGC residual update delta ||v/w||.
- Figure 23: FedAvg local weight update delta at sync points.
- §4.3 / Fig 21: per-partition model specialization (accuracy on own vs
  other partitions' label subsets).

The port of ``repro.core.divergence``: inputs are NumPy arrays, models
are the port's parameter dicts, and the probes run on the device the
parameters lie on.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.cnn_zoo import CNNConfig
from repro_torch.models.cnn import cnn_batch_stats


@torch.no_grad()
def bn_divergence(params, cfg: CNNConfig, node_batches: Sequence[np.ndarray],
                  layer: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel divergence of minibatch means/vars between partitions:
    ||mu_{B,P0} - mu_{B,P1}|| / ||avg(mu)||  (paper's Figure 4 metric,
    generalized to K nodes as max pairwise over the node axis)."""
    device = next(iter(params.values())).device
    stats = [cnn_batch_stats(params, cfg,
                             torch.from_numpy(np.asarray(b)).to(device),
                             layer)
             for b in node_batches]
    mus = np.stack([m.cpu().numpy() for m, _ in stats])      # (K, C)
    vars_ = np.stack([v.cpu().numpy() for _, v in stats])
    K = mus.shape[0]

    def div(x):
        num = 0.0 * x[0]
        for i in range(K):
            for j in range(i + 1, K):
                num = np.maximum(num, np.abs(x[i] - x[j]))
        den = np.abs(x.mean(axis=0)) + 1e-8
        return num / den
    return div(mus), div(vars_)


@torch.no_grad()
def model_l2_distance(params_a, params_b) -> float:
    num = sum(float(((params_a[n] - params_b[n]) ** 2).sum())
              for n in params_a)
    den = sum(float((a ** 2).sum()) for a in params_a.values())
    return (num / max(den, 1e-12)) ** 0.5


def per_class_accuracy(predict_fn, x: np.ndarray, y: np.ndarray,
                       n_classes: int) -> np.ndarray:
    """Accuracy per class — exposes Gaia's per-partition specialization
    (Fig 21): a node's model is accurate on its own classes only.
    ``predict_fn`` takes a CPU tensor of images and returns class ids."""
    preds = torch.as_tensor(predict_fn(torch.from_numpy(np.asarray(x))))
    preds = preds.cpu().numpy()
    acc = np.zeros(n_classes)
    for c in range(n_classes):
        m = y == c
        acc[c] = (preds[m] == c).mean() if m.any() else np.nan
    return acc
