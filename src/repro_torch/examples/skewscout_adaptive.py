"""SkewScout in action: the same training job under mild and heavy skew.

Watch the controller probe remote partitions (model traveling), measure
accuracy loss, and walk Gaia's significance threshold up (mild skew: save
communication) or down (heavy skew: protect accuracy) — Eq. 1 of §7.2.
The twin of the reference's ``examples/skewscout_adaptive.py``; it runs
on the card unless ``--device cpu``.

    python -m repro_torch.examples.skewscout_adaptive [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core import partition_label_skew, train_decentralized
from repro_torch.data.synthetic import synth_images


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ds = synth_images(3000, seed=0, noise=0.8, class_sep=0.35)
    val = synth_images(800, seed=99, noise=0.8, class_sep=0.35)
    cfg = CNN_ZOO["gn-lenet"]

    for skew, tag in ((0.2, "mild skew (20%)"), (1.0, "full label skew")):
        idx = partition_label_skew(ds.y, 5, skew, seed=1)
        parts = [(ds.x[i], ds.y[i]) for i in idx]
        comm = CommConfig(skewscout=True, travel_every=40, sigma_al=0.05,
                          lambda_al=50.0, lambda_c=1.0, tuner="hill")
        r = train_decentralized(cfg, "gaia", parts, (val.x, val.y),
                                comm=comm, steps=400, batch=20, lr=0.02,
                                eval_every=200, theta_start_index=3,
                                device=args.device)
        print(f"\n=== {tag} ===")
        print(f"final val_acc={r.val_acc:.3f}  "
              f"comm_savings={r.comm_savings:.1f}x vs BSP")
        print("travel log (step: theta -> new_theta, measured AL):")
        for h in r.skewscout_history:
            print(f"  step {h.step:4d}: T0={h.theta:<5} "
                  f"AL={h.accuracy_loss:.3f} C/CM={h.comm_ratio:.4f} "
                  f"J={h.objective:.3f} -> T0={h.new_theta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
