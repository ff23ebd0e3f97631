"""Figure 5 + Table 9 analogue: BatchNorm vs GroupNorm vs BatchReNorm for
(BN/GN/BRN)-LeNet across all four algorithms, non-IID setting.

Paper claims reproduced: GroupNorm recovers BSP's non-IID loss and helps
every decentralized algorithm; BatchReNorm sits in between.

The twin of the reference's ``benchmarks/fig5_groupnorm.py``."""
from __future__ import annotations

from repro_torch.benchmarks.common import (make_data, make_parts, save_rows,
                                           train_args)
from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.trainer import train_decentralized

COMM = CommConfig(gaia_t0=0.10, iter_local=20, dgc_sparsity=0.999,
                  dgc_warmup_epochs=1)


def run(quick: bool = False, device=None):
    steps = 200 if quick else 350
    ds, val = make_data(2000 if quick else 4000)
    models = ("bn-lenet", "gn-lenet") if quick else \
        ("bn-lenet", "gn-lenet", "brn-lenet")
    algos = ("bsp", "gaia") if quick else ("bsp", "gaia", "fedavg", "dgc")
    rows = []
    for model in models:
        for algo in algos:
            for skew in (0.0, 1.0):
                parts = make_parts(ds, skew)
                r = train_decentralized(
                    CNN_ZOO[model], algo, parts, (val.x, val.y), comm=COMM,
                    steps=steps, device=device, **train_args(model))
                rows.append(dict(model=model, algo=algo, skew=skew,
                                 val_acc=r.val_acc))
                print(f"[fig5] {model} {algo} skew={skew}: "
                      f"acc={r.val_acc:.3f}", flush=True)
    save_rows("fig5", rows)
    return rows


if __name__ == "__main__":
    run()
