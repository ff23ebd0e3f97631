"""Learning-rate schedules from the paper's training tables (App. C), the
twins of ``repro.optim.schedules``.

Each returns ``lr(step)``: ``step`` a Python int or an integer 0-d tensor
(read on the host with ``int``), the rate a float32 0-d tensor on the CPU.
It is computed in float32 scalars as the reference's XLA program computes
it (``powf`` for a float power, squaring for an integer one), so the rates
are the reference's bit for bit."""
from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

Step = Union[int, torch.Tensor]

f32 = np.float32


def _int_pow(base: np.float32, n: int) -> np.float32:
    """``base ** n`` for an integer n >= 0 by squaring, each product
    rounded to float32."""
    out = f32(1.0)
    while n:
        if n & 1:
            out = f32(out * base)
        base = f32(base * base)
        n >>= 1
    return out


def step_decay(eta0: float, boundaries: Sequence[int], factor: float = 0.1
               ) -> Callable[[Step], torch.Tensor]:
    """'divides by 10 at epoch 64 and 96': ``eta0 * factor ** n``, n the
    boundaries (in steps) at or below ``step``."""
    bounds = [int(b) for b in boundaries]

    def lr(step: Step) -> torch.Tensor:
        n = sum(int(step) >= b for b in bounds)
        return torch.tensor(f32(f32(eta0) * _int_pow(f32(factor), n)))
    return lr


def polynomial_decay(eta0: float, max_steps: int, power: float = 0.5
                     ) -> Callable[[Step], torch.Tensor]:
    """``eta0 * (1 - clip(step / max_steps, 0, 1)) ** power``."""
    def lr(step: Step) -> torch.Tensor:
        frac = min(max(f32(f32(int(step)) / f32(max_steps)), f32(0.0)),
                   f32(1.0))
        return torch.tensor(f32(f32(eta0)
                                * f32(f32(1.0) - frac) ** f32(power)))
    return lr


def constant(eta0: float) -> Callable[[Step], torch.Tensor]:
    def lr(step: Step) -> torch.Tensor:
        return torch.tensor(eta0, dtype=torch.float32)
    return lr
