"""Figure 4 analogue: minibatch-mean divergence of the first BN layer of
BN-LeNet between partitions, IID vs non-IID.

Paper claim reproduced: mu_B divergence is several-fold larger in the
non-IID setting — the mechanism behind BN's failure under BSP.

The twin of the reference's ``benchmarks/fig4_bn_divergence.py``; BN-LeNet
is drawn from ``torch.Generator().manual_seed(0)`` where the reference
uses ``PRNGKey(0)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import make_data, make_parts, save_rows
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.divergence import bn_divergence
from repro_torch.data.pipeline import DecentralizedLoader
from repro_torch.device import resolve_device
from repro_torch.models.cnn import init_cnn


def run(quick: bool = False, device=None):
    device = resolve_device(device)
    ds, _ = make_data()
    cfg = CNN_ZOO["bn-lenet"]
    params, _ = init_cnn(torch.Generator().manual_seed(0), cfg)
    params = {n: t.to(device) for n, t in params.items()}
    rows = []
    n_batches = 20 if quick else 100   # paper averages over 100 minibatches
    for skew, name in ((0.0, "iid"), (1.0, "noniid")):
        parts = make_parts(ds, skew, n_nodes=2)      # paper uses two P_k
        loader = DecentralizedLoader(parts, batch=20, seed=0)
        mu_acc = None
        for _ in range(n_batches):
            xs, _ = loader.next_stacked()
            mu_d, var_d = bn_divergence(params, cfg, list(xs), layer=0)
            mu_acc = mu_d if mu_acc is None else mu_acc + mu_d
        mu_avg = mu_acc / n_batches
        for ch, v in enumerate(mu_avg):
            rows.append(dict(setting=name, channel=ch,
                             mu_divergence=float(v)))
        print(f"[fig4] {name}: mean mu_B divergence "
              f"{float(np.mean(mu_avg)):.3f} "
              f"(range {mu_avg.min():.3f}-{mu_avg.max():.3f})", flush=True)
    save_rows("fig4", rows)
    return rows


if __name__ == "__main__":
    run()
