"""The port's bench entry point, the twin of the reference's
``benchmarks/run.py``: one function per paper table/figure.

    python -m repro_torch.benchmarks.run            # quick pass (default)
    python -m repro_torch.benchmarks.run --full     # full paper-scale runs
    python -m repro_torch.benchmarks.run --only fig1,fig8
    python -m repro_torch.benchmarks.run --json out # + BENCH_*.json per
                                                    # bench
    python -m repro_torch.benchmarks.run --device cpu

Prints the card's name and power limit (``# device: ...``), then a
``name,us_per_call,derived`` CSV.  For the kernel bench us_per_call is
the measured call time; for experiment benches us_per_call is the total
wall time of the run and ``derived`` carries the headline metric
(accuracy / savings / divergence); full rows land in
``experiments/results_torch/``.  Every bench runs on ``--device``, CUDA by
default.

``roofline`` reads the dry-run stand-in's rows
(``repro_torch.launch.dryrun --outdir experiments/dryrun_torch/combos``)
and prints nothing it measures: its terms are predictions at the H100
data-sheet rates, so it runs on the CPU as well
(``--only roofline --device cpu``).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.benchmarks import (common, fig1_accuracy, fig2_flickr,
                                    fig4_bn_divergence, fig5_groupnorm,
                                    fig6_skew_degree, fig8_skewscout,
                                    fig_topology, kernels_bench, roofline,
                                    tab678_hparams)


def kernel_rows(quick: bool = False, device=None):
    """``kernels_bench.run``'s (name, us) rows as the reference's row
    dicts; the kernel bench has one size, so ``quick`` changes nothing."""
    return [{"name": name, "us_per_call": us}
            for name, us in kernels_bench.run(device or "cuda")]


BENCHES = {  # priority order: cheap + headline results first
    "kernels": (kernel_rows, "hand-written kernels vs plain versions"),
    "fig4": (fig4_bn_divergence.run, "BN minibatch-mean divergence"),
    "fig8": (fig8_skewscout.run, "SkewScout vs BSP vs Oracle"),
    "fig1": (fig1_accuracy.run, "4 CNN x 4 algo x IID/non-IID accuracy"),
    "fig5": (fig5_groupnorm.run, "GroupNorm vs BatchNorm rescue"),
    "fig6": (fig6_skew_degree.run, "degree-of-skew sweep"),
    "fig2": (fig2_flickr.run, "geo-skew (Flickr-Mammal analogue)"),
    "fig_topology": (fig_topology.run, "D-PSGD topology x skew sweep"),
    "tab678": (tab678_hparams.run, "theta sensitivity"),
    "roofline": (roofline.run, "dry-run roofline table"),
}


def _headline(name, rows):
    """The reference's headline of a bench's rows."""
    if not rows:
        return ""
    if name == "kernels":
        return ""
    if name == "roofline":
        ok = [r for r in rows if r.get("ok")]
        fail = len(rows) - len(ok)
        from collections import Counter
        c = Counter(r["bottleneck"] for r in ok)
        return f"ok={len(ok)};fail={fail};" + \
            ";".join(f"{k}={v}" for k, v in sorted(c.items()))
    if name == "fig4":
        import numpy as np
        by = {}
        for r in rows:
            by.setdefault(r["setting"], []).append(r["mu_divergence"])
        return ";".join(f"{k}:mean_div={np.mean(v):.3f}"
                        for k, v in by.items())
    if name == "fig8":
        return ";".join(
            f"skew{r['skew']}:ss={r['skewscout_savings']:.1f}x,"
            f"oracle={r['oracle_savings']:.1f}x" for r in rows)
    if "val_acc" in rows[0]:
        worst = min(rows, key=lambda r: r["val_acc"])
        keys = [k for k in ("model", "algo", "skew", "setting", "theta")
                if k in worst]
        tag = "/".join(str(worst[k]) for k in keys)
        return f"n={len(rows)};worst_acc={worst['val_acc']:.3f}@{tag}"
    return f"n={len(rows)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="emit a machine-readable BENCH_<name>.json per "
                         "bench into DIR (commit, timestamp, device and "
                         "power limit, wall time, headline, full rows)")
    ap.add_argument("--use-cache", action="store_true",
                    help="reuse experiments/results_torch/*.json if "
                         "present")
    ap.add_argument("--cache-only", action="store_true",
                    help="with --use-cache: skip experiment benches whose "
                         "results are missing instead of re-running")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = list(BENCHES) if not args.only else args.only.split(",")
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown bench {unknown}; choose from {list(BENCHES)}")

    where = common.card(args.device)
    print(f"# device: {where['device']}"
          + (f", {where['power_limit']}" if where["power_limit"] else ""))
    print("name,us_per_call,derived")
    for name in names:
        run, _desc = BENCHES[name]
        t0 = time.perf_counter()
        if args.use_cache and name not in ("kernels", "roofline"):
            rows = common.load_rows(name)
            if rows is None:
                if args.cache_only:
                    print(f"{name},0,SKIPPED(no cached result)")
                    continue
                rows = run(quick=not args.full, device=args.device)
        else:
            rows = run(quick=not args.full, device=args.device)
        dt_us = (time.perf_counter() - t0) * 1e6
        if name == "kernels":
            for r in rows:
                print(f"{r['name']},{r['us_per_call']:.1f},")
        else:
            print(f"{name},{dt_us:.0f},{_headline(name, rows)}")
        if args.json:
            common.save_bench_json(name, rows, out_dir=args.json,
                                   device=args.device,
                                   derived=_headline(name, rows),
                                   us_per_call=dt_us)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
