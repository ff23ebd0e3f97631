"""Roofline table from the dry-run stand-in's rows (the twin of the
reference's ``benchmarks/roofline.py``).

Reads ``experiments/dryrun_torch/combos/*.json``, what
``python -m repro_torch.launch.dryrun --outdir experiments/dryrun_torch/
combos`` writes, and prints each (arch x shape x mesh) row's three
roofline terms at the H100 SXM data-sheet rates (``launch.analysis``),
its bottleneck and its useful-compute ratio.  The terms are predictions
of one rank's step, not measurements."""
from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import REPO

COMBO_DIR = str(REPO / "experiments" / "dryrun_torch" / "combos")


def load_reports(combo_dir: str = COMBO_DIR):
    reports = []
    for f in sorted(glob.glob(os.path.join(combo_dir, "*.json"))):
        with open(f) as fh:
            reports.append(json.load(fh))
    return reports


def run(quick: bool = False, device=None, combo_dir: str = COMBO_DIR):
    """The rows of the stand-in's reports in ``combo_dir``; ``quick`` and
    ``device`` are the bench runner's arguments, unused: the rows are
    read, not run."""
    rows = []
    for r in load_reports(combo_dir):
        if not r.get("ok"):
            rows.append(dict(arch=r["arch"], shape=r["shape"], ok=False,
                             error=r.get("error", "?")))
            continue
        ro = r["roofline"]
        rows.append(dict(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], ok=True,
            t_compute_ms=ro["t_compute_ms"], t_memory_ms=ro["t_memory_ms"],
            t_collective_ms=ro["t_collective_ms"],
            bottleneck=ro["bottleneck"], useful_ratio=ro["useful_ratio"],
            coll_gb=ro["coll_gbytes_per_dev"]))
    return rows


def print_table(rows):
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':9s} {'t_comp':>9s} "
           f"{'t_mem':>9s} {'t_coll':>9s} {'bound':>10s} {'useful':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if not r.get("ok"):
            print(f"{r['arch']:24s} {r['shape']:12s} FAILED: "
                  f"{r['error'][:60]}")
            continue
        print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:9s} "
              f"{r['t_compute_ms']:8.1f}m {r['t_memory_ms']:8.1f}m "
              f"{r['t_collective_ms']:8.1f}m {r['bottleneck']:>10s} "
              f"{r['useful_ratio']:7.2f}")


if __name__ == "__main__":
    print_table(run())
