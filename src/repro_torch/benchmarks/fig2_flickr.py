"""Figure 2/20 analogue: real-world geo-skew (Flickr-Mammal stand-in).

Classes have home regions (Table 1's 32-92%% share pattern); node k holds
region k's images.  Claim reproduced: the real-world skew costs accuracy vs
the artificial IID split, but less than 100% label skew (most labels exist
in all regions); subcontinent-level partitioning (K=13) hurts more.

The twin of the reference's ``benchmarks/fig2_flickr.py``, with a
15-way GN-LeNet for the 15 classes (``CFG``)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.benchmarks.common import TRAIN, save_rows
from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.partition import (partition_by_region,
                                        partition_label_skew)
from repro_torch.core.trainer import train_decentralized
from repro_torch.data.synthetic import synth_geo_images

COMM = CommConfig(gaia_t0=0.10, iter_local=20)
# the data has 15 classes; the reference trains the zoo's 10-way GN-LeNet
# on it, where labels 10-14 index past the logits (its gather gives them a
# NaN loss and no gradient, and no prediction can hit them).  The port's
# trainer refuses such labels, so the twin gives GN-LeNet 15 outputs
CFG = dataclasses.replace(CNN_ZOO["gn-lenet"], n_classes=15)


def run(quick: bool = False, device=None):
    steps = 200 if quick else 350
    n = 3000 if quick else 6000
    rows = []
    for n_regions, tag in (((5, "continent"),) if quick
                           else ((5, "continent"), (13, "subcontinent"))):
        ds, region = synth_geo_images(n, n_regions=n_regions, n_classes=15,
                                      home_share=0.7, seed=0)
        val_mask = np.arange(n) % 20 == 0            # 5% validation
        tr_mask = ~val_mask
        val = (ds.x[val_mask], ds.y[val_mask])
        for algo in ("bsp", "gaia", "fedavg"):
            for setting in ("noniid", "iid"):
                if setting == "noniid":
                    idx = partition_by_region(region, n_regions)
                    idx = [i[tr_mask[i]] for i in idx]
                else:
                    idx = partition_label_skew(ds.y[tr_mask], n_regions, 0.0,
                                               seed=2)
                    base = np.where(tr_mask)[0]
                    idx = [base[i] for i in idx]
                parts = [(ds.x[i], ds.y[i]) for i in idx]
                r = train_decentralized(
                    CFG, algo, parts, val, comm=COMM,
                    steps=steps, device=device, **TRAIN)
                rows.append(dict(level=tag, algo=algo, setting=setting,
                                 val_acc=r.val_acc,
                                 comm_savings=r.comm_savings))
                print(f"[fig2] {tag} {algo} {setting}: acc={r.val_acc:.3f}",
                      flush=True)
    save_rows("fig2", rows)
    return rows


if __name__ == "__main__":
    run()
