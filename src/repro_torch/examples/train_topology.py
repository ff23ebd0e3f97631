"""Geo-WAN scenario end-to-end: gossip (D-PSGD) training over a
hierarchical topology — datacenters of LAN-connected nodes joined by
scarce WAN links — with link-level cost accounting.

Compares three fabrics on the same skewed partitions:
  full     all-to-all gossip (BSP-quality, every pair is a link)
  ring     minimal bandwidth, slowest consensus
  geo-wan  LAN cliques + WAN gateway mesh (the paper's Gaia deployment)

and prints each run's accuracy next to its LAN/WAN traffic split and the
simulated wall-clock time under the geo-wan link profile (10 Gb/s LAN,
100 Mb/s + 50 ms WAN).  The twin of the reference's
``examples/train_topology.py``; it runs on the card unless ``--device
cpu``.

    python -m repro_torch.examples.train_topology [--steps 200]
        [--skew 1.0] [--nodes 6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.partition import partition_label_skew
from repro_torch.core.trainer import train_decentralized
from repro_torch.data.synthetic import synth_images
from repro_torch.topology import LINK_PROFILES, build_topology


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--skew", type=float, default=1.0)
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ds = synth_images(2400, seed=0, noise=0.8, class_sep=0.35, n_classes=6)
    val = synth_images(600, seed=99, noise=0.8, class_sep=0.35, n_classes=6)
    idx = partition_label_skew(ds.y, args.nodes, args.skew, seed=1)
    parts = [(ds.x[i], ds.y[i]) for i in idx]

    print(f"K={args.nodes} nodes, skew={args.skew}, "
          f"link profile: {LINK_PROFILES['geo-wan']}, device={args.device}")
    for name in ("full", "ring", "geo-wan"):
        topo = build_topology(name, args.nodes)
        print(f"\n== {name}: {len(topo.edges)} edges "
              f"({len(topo.wan_edge_indices())} WAN), "
              f"spectral gap {topo.spectral_gap():.3f}")
        comm = CommConfig(strategy="dpsgd",
                          fabric=FabricConfig(topology=name,
                                              profile="geo-wan"))
        r = train_decentralized(
            CNN_ZOO["gn-lenet"], "dpsgd", parts, (val.x, val.y),
            comm=comm, steps=args.steps, batch=20, lr=0.02,
            eval_every=max(args.steps // 2, 1), device=args.device)
        led = r.extras["ledger"]
        print(f"   val_acc={r.val_acc:.3f}")
        print(f"   traffic: LAN {led['lan_floats']/1e6:.1f}M floats, "
              f"WAN {led['wan_floats']/1e6:.1f}M floats")
        print(f"   simulated wall-clock: {led['sim_time_s']:.2f}s "
              f"({led['sim_time_s']/args.steps*1e3:.1f} ms/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
