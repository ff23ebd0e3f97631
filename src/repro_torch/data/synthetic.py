"""Deterministic synthetic datasets.

Real CIFAR-10 / ImageNet / Flickr are unavailable offline, so we use
generative stand-ins with controllable label geometry:

- ``synth_images``: each class is a random smooth prototype; samples are the
  prototype under random shift + per-pixel noise + brightness jitter.  CNNs
  reach high accuracy on it centrally, so any accuracy drop under
  decentralized training is attributable to the algorithm (matching the
  paper's methodology of validating the IID baseline first).
- ``synth_geo_images``: the Flickr-Mammal analogue — classes have a
  *home region*; region r's empirical label distribution concentrates on its
  home classes (Table 1's 32-92% shares).
- ``synth_tokens``: order-2 Markov token streams for LM-scale examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ImageDataset:
    x: np.ndarray          # (N, H, W, C) float32
    y: np.ndarray          # (N,) int32
    n_classes: int


def _prototypes(rng: np.random.Generator, n_classes: int, side: int,
                channels: int) -> np.ndarray:
    """Smooth class prototypes: low-frequency random fields."""
    coarse = rng.normal(size=(n_classes, 4, 4, channels))
    protos = np.empty((n_classes, side, side, channels), np.float32)
    for c in range(n_classes):
        for ch in range(channels):
            g = coarse[c, :, :, ch]
            # bilinear upsample 4x4 -> side x side
            xs = np.linspace(0, 3, side)
            xi = np.floor(xs).astype(int).clip(0, 2)
            xf = xs - xi
            rows = (g[xi] * (1 - xf)[:, None] + g[xi + 1] * xf[:, None])
            cols = (rows[:, xi] * (1 - xf)[None, :]
                    + rows[:, xi + 1] * xf[None, :])
            protos[c, :, :, ch] = cols
    return protos * 1.5


def synth_images(n_samples: int, *, n_classes: int = 10, side: int = 16,
                 channels: int = 3, noise: float = 0.35,
                 class_sep: float = 1.0,
                 seed: int = 0, class_seed: int = 1234) -> ImageDataset:
    """``class_seed`` fixes the class prototypes (the "world"); ``seed``
    drives sampling.  Train/val splits share class_seed, differ in seed.
    ``class_sep`` < 1 makes prototypes = shared_base + sep * class_delta,
    so the class-discriminative signal shrinks relative to feature scale —
    the regime where normalization mismatch (paper §5) moves decision
    boundaries."""
    rng = np.random.default_rng(seed)
    crng = np.random.default_rng(class_seed)
    protos = _prototypes(crng, n_classes, side, channels)
    if class_sep != 1.0:
        base = _prototypes(crng, 1, side, channels)[0]
        protos = base[None] + class_sep * protos
    # per-class channel-mean offsets: classes differ in global statistics
    # (as real object categories do), so a label-skewed partition shifts
    # each node's minibatch mean mu_B — the paper's §5.1 BN mechanism
    chan_offset = crng.normal(scale=0.6, size=(n_classes, 1, 1, channels))
    protos = protos + chan_offset
    y = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    x = protos[y].copy()
    # random circular shifts (translation invariance pressure)
    sh = rng.integers(-2, 3, size=(n_samples, 2))
    for i in range(n_samples):
        x[i] = np.roll(x[i], (sh[i, 0], sh[i, 1]), axis=(0, 1))
    x += rng.normal(scale=noise, size=x.shape).astype(np.float32)
    x *= rng.uniform(0.8, 1.2, size=(n_samples, 1, 1, 1)).astype(np.float32)
    return ImageDataset(x.astype(np.float32), y, n_classes)


def synth_geo_images(n_samples: int, *, n_regions: int = 5,
                     n_classes: int = 15, side: int = 16,
                     home_share: float = 0.7, seed: int = 0
                     ) -> Tuple[ImageDataset, np.ndarray]:
    """Flickr-Mammal analogue.  Returns (dataset, region (N,) int32).

    Each class has a home region; with prob ``home_share`` a sample of that
    class lands in its home region, else uniformly elsewhere — reproducing
    Table 1's skewed-but-overlapping real-world label distribution.
    """
    rng = np.random.default_rng(seed)
    ds = synth_images(n_samples, n_classes=n_classes, side=side, seed=seed)
    home = rng.integers(0, n_regions, size=n_classes)
    region = np.empty(n_samples, np.int32)
    for i, cls in enumerate(ds.y):
        if rng.random() < home_share:
            region[i] = home[cls]
        else:
            region[i] = rng.integers(0, n_regions)
    return ds, region


@dataclass
class TokenDataset:
    tokens: np.ndarray     # (N, T) int32
    vocab: int


def synth_tokens(n_seqs: int, seq_len: int, *, vocab: int = 512,
                 seed: int = 0) -> TokenDataset:
    """Order-2 Markov streams with a sparse transition structure, so a small
    LM gets visible loss reduction within a few hundred steps."""
    rng = np.random.default_rng(seed)
    branch = 8
    nxt = rng.integers(0, vocab, size=(vocab, branch))
    out = np.empty((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        pick = rng.integers(0, branch, size=n_seqs)
        state = nxt[state, pick]
        out[:, t] = state
    return TokenDataset(out, vocab)
