"""Tables 6-8 analogue: hyper-parameter sensitivity of the non-IID problem.

Paper claim reproduced: even conservative theta (high communication) loses
accuracy in the non-IID setting while matching BSP in the IID setting;
relaxed theta degrades further.

The twin of the reference's ``benchmarks/tab678_hparams.py``."""
from __future__ import annotations

from repro_torch.benchmarks.common import (TRAIN, make_data, make_parts,
                                           save_rows)
from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.trainer import train_decentralized

SWEEPS = {
    "gaia": ("gaia_t0", (0.02, 0.10, 0.30)),
    "fedavg": ("iter_local", (5, 20, 100)),
    "dgc": ("dgc_sparsity", (0.9375, 0.996, 0.999)),
}


def run(quick: bool = False, device=None):
    steps = 200 if quick else 350
    ds, val = make_data(2000 if quick else 4000)
    rows = []
    for algo, (field, values) in SWEEPS.items():
        for v in (values[:2] if quick else values):
            for skew in (0.0, 1.0):
                comm = CommConfig(**{field: v}, dgc_warmup_epochs=10**6)
                parts = make_parts(ds, skew)
                r = train_decentralized(
                    CNN_ZOO["gn-lenet"], algo, parts, (val.x, val.y),
                    comm=comm, steps=steps, device=device, **TRAIN)
                rows.append(dict(algo=algo, theta=v, skew=skew,
                                 val_acc=r.val_acc,
                                 comm_savings=r.comm_savings))
                print(f"[tab678] {algo} {field}={v} skew={skew}: "
                      f"acc={r.val_acc:.3f} savings={r.comm_savings:.1f}x",
                      flush=True)
    save_rows("tab678", rows)
    return rows


if __name__ == "__main__":
    run()
