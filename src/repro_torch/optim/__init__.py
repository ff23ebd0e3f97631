"""``repro_torch.optim``: the learning-rate schedules and the momentum SGD
the paper's algorithms are written against (``repro.optim``)."""
from repro_torch.optim.schedules import constant, polynomial_decay, step_decay
from repro_torch.optim.sgd import (clip_by_global_norm, global_norm,
                                   init_momentum, momentum_update)

__all__ = ["constant", "polynomial_decay", "step_decay",
           "clip_by_global_norm", "global_norm", "init_momentum",
           "momentum_update"]
