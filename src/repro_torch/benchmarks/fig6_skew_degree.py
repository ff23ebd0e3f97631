"""Figure 6 analogue: GN-LeNet accuracy vs degree of skew (20-100%) for the
three decentralized algorithms.

Paper claims reproduced: partial skew already costs accuracy, and the loss
grows monotonically (noisily) with the skew fraction.

The twin of the reference's ``benchmarks/fig6_skew_degree.py``."""
from __future__ import annotations

from repro_torch.benchmarks.common import (TRAIN, make_data, make_parts,
                                           save_rows)
from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.trainer import train_decentralized

COMM = CommConfig(gaia_t0=0.10, iter_local=20, dgc_sparsity=0.999,
                  dgc_warmup_epochs=1)


def run(quick: bool = False, device=None):
    steps = 200 if quick else 350
    ds, val = make_data(2000 if quick else 4000)
    skews = (0.0, 0.4, 0.8, 1.0) if quick else (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    rows = []
    for algo in ("gaia", "fedavg", "dgc"):
        for skew in skews:
            parts = make_parts(ds, skew)
            r = train_decentralized(
                CNN_ZOO["gn-lenet"], algo, parts, (val.x, val.y), comm=COMM,
                steps=steps, device=device, **TRAIN)
            rows.append(dict(algo=algo, skew=skew, val_acc=r.val_acc))
            print(f"[fig6] {algo} skew={skew}: acc={r.val_acc:.3f}",
                  flush=True)
    save_rows("fig6", rows)
    return rows


if __name__ == "__main__":
    run()
