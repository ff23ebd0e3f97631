"""Assemble the port's experiment report (the twin of the reference's
``benchmarks/report.py``) from the port's own artifacts:

- ``experiments/results_torch/*.json`` (the port's paper benches,
  ``repro_torch.benchmarks.run``)           -> the paper-figure tables
- ``experiments/dryrun_torch/combos/*.json`` (the dry-run stand-in,
  ``repro_torch.launch.dryrun --all [--multi-pod] --outdir ...``)
                                            -> §Dry-run and §Roofline

  PYTHONPATH=src python -m repro_torch.benchmarks.report [--stdout]

It writes ``out/EXPERIMENTS_TORCH.md`` (or prints it with ``--stdout``):
``EXPERIMENTS.md`` is the reference's report and stays the reference's.
The reference's §Perf log reads its TPU hillclimbing log, which the port
has none of.

Bench-trajectory modes, over ``BENCH_*.json`` (``run.py --json DIR``):

  # cross-commit trend table over any set of BENCH_*.json files
  python -m repro_torch.benchmarks.report --trend 'dir/*/BENCH_*.json'

  # the gate: fail when the kernel bench regresses
  python -m repro_torch.benchmarks.report --gate out/BENCH_kernels.json \\
      [--baseline prev/BENCH_kernels.json] [--noise-band 0.5]

The gate holds every ``kernel/<op>`` row (the op on its kernel) to at
most its ``oracle/<op>`` row (the plain version) times (1 + noise band),
and with ``--baseline`` no kernel row may be slower than the earlier
file's beyond the band.  ``--gate`` also takes a file of the kernel
bench's own ``--json`` (``python -m repro_torch.benchmarks.kernels_bench
--json PATH``), whatever its name.  The reference's two other legs have
no port rows: ``--min-speedup`` holds a kernel against its ``interp/<op>``
row, the Pallas kernel in interpret mode, and a CUDA kernel has no
interpret mode; the scale leg reads a ``BENCH_scale.json``, which the
port's fabric scale smoke does not write (``fig_topology``'s docstring).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.benchmarks.common import REPO, RESULTS_DIR
from repro_torch.launch import analysis

COMBOS = str(REPO / "experiments" / "dryrun_torch" / "combos")
OUT = str(REPO / "out" / "EXPERIMENTS_TORCH.md")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_combos(kind: str, base: str = COMBOS) -> Dict[Tuple[str, str], Dict]:
    """The stand-in's reports of ``--all`` (``kind`` "single") or ``--all
    --multi-pod`` ("multi") in ``base``, by (arch, shape)."""
    out = {}
    for f in glob.glob(os.path.join(base, f"*__{kind}.json")):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"])] = r
    return out


def _rows(name: str, results_dir: str = RESULTS_DIR):
    p = os.path.join(results_dir, f"{name}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def dryrun_section(single: Dict, multi: Dict) -> str:
    lines = ["## §Dry-run", ""]
    n_ok_s = sum(1 for r in single.values() if r.get("ok"))
    n_ok_m = sum(1 for r in multi.values() if r.get("ok"))
    failed = [k for k, r in {**single, **multi}.items() if not r.get("ok")]
    lines.append(
        f"Every (architecture × input shape) pair traced by the stand-in "
        f"(one rank's step on `meta` tensors, `launch.dryrun`): "
        f"**{n_ok_s}/40** on the single-pod 16×16 mesh and "
        f"**{n_ok_m}/40** on the multi-pod 2×16×16 mesh, with the Gaia "
        f"exchange as the training strategy.  Failures: "
        f"{failed or 'none'}.")
    lines.append("")
    lines.append("Per-rank memory (multi-pod mesh, training state incl. "
                 "fp32 velocity + Gaia residuals; the rank's argument "
                 "blocks and the step's peak live storage, traced):")
    lines.append("")
    lines.append("| arch | args MB/dev | temp MB/dev |")
    lines.append("|---|---|---|")
    for arch in sorted({a for a, _ in multi}):
        r = multi.get((arch, "train_4k"))
        if not r or not r.get("ok"):
            continue
        mem = r["memory"]
        lines.append(
            f"| {arch} | {mem.get('argument_size_in_bytes', 0)/1e6:.0f} "
            f"| {mem.get('temp_size_in_bytes', 0)/1e6:.0f} |")
    lines.append("")
    lines.append("Collective schedule (multi-pod train_4k, GB a rank a step "
                 "by kind, from the stand-in's collective records):")
    lines.append("")
    lines.append("| arch | all-gather | all-reduce | reduce-scatter | "
                 "all-to-all | collective-permute |")
    lines.append("|---|---|---|---|---|---|")
    for arch in sorted({a for a, _ in multi}):
        r = multi.get((arch, "train_4k"))
        if not r or not r.get("ok"):
            continue
        cb = r["roofline"]["coll_breakdown_gb"]
        lines.append("| " + arch + " | " + " | ".join(
            f"{cb.get(k, 0):.2f}" for k in
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")) + " |")
    lines.append("")
    return "\n".join(lines)


def roofline_section(single: Dict) -> str:
    lines = ["## §Roofline", ""]
    lines.append(
        "Per (arch × shape) on the single-pod 16×16 mesh.  Terms in ms a "
        "step a rank, predicted at one H100 SXM's data-sheet rates "
        f"(`launch.analysis`): compute = flops/"
        f"({analysis.BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s), memory = "
        f"bytes/({analysis.HBM_BYTES_PER_S / 1e12:.2f} TB/s), collective "
        f"= collective bytes/({analysis.LINK_BYTES_PER_S / 1e9:.0f} GB/s "
        "link).  Flops and bytes are the stand-in's counts of one rank's "
        "traced step (bytes unfused: an upper bound).  `useful` = "
        "MODEL_FLOPS (6·N_active·D train / 2·N_active·D serve) ÷ traced "
        "flops.  Predictions, not measurements.")
    lines.append("")
    lines.append("| arch | shape | t_comp | t_mem | t_coll | bottleneck | "
                 "useful |")
    lines.append("|---|---|---|---|---|---|---|")
    for arch in sorted({a for a, _ in single}):
        for shape in SHAPE_ORDER:
            r = single.get((arch, shape))
            if not r:
                continue
            if not r.get("ok"):
                lines.append(f"| {arch} | {shape} | FAILED | | | | |")
                continue
            ro = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {ro['t_compute_ms']:.1f} | "
                f"{ro['t_memory_ms']:.1f} | {ro['t_collective_ms']:.1f} | "
                f"{ro['bottleneck']} | {ro['useful_ratio']:.2f} |")
    lines.append("")
    return "\n".join(lines)


def figure_sections(results_dir: str = RESULTS_DIR) -> str:
    parts = []
    fig1 = _rows("fig1", results_dir)
    if fig1:
        parts.append("### Fig. 1 — algorithms × models, IID vs non-IID "
                     "(synthetic-CIFAR, K=5)\n")
        parts.append("| model | algo | IID acc | non-IID acc | Δ | "
                     "comm savings |")
        parts.append("|---|---|---|---|---|---|")
        by = {}
        for r in fig1:
            by.setdefault((r["model"], r["algo"]), {})[r["skew"]] = r
        for (mdl, algo), d in sorted(by.items()):
            if 0.0 in d and 1.0 in d:
                parts.append(
                    f"| {mdl} | {algo} | {d[0.0]['val_acc']:.3f} | "
                    f"{d[1.0]['val_acc']:.3f} | "
                    f"{d[1.0]['val_acc']-d[0.0]['val_acc']:+.3f} | "
                    f"{d[1.0]['comm_savings']:.1f}× |")
        parts.append("")
    fig2 = _rows("fig2", results_dir)
    if fig2:
        parts.append("### Fig. 2/20 — real-world geo skew (Flickr-Mammal "
                     "analogue)\n")
        parts.append("| level | algo | IID acc | geo-non-IID acc |")
        parts.append("|---|---|---|---|")
        by = {}
        for r in fig2:
            by.setdefault((r["level"], r["algo"]), {})[r["setting"]] = r
        for (lvl, algo), d in sorted(by.items()):
            if "iid" in d and "noniid" in d:
                parts.append(f"| {lvl} | {algo} | {d['iid']['val_acc']:.3f} "
                             f"| {d['noniid']['val_acc']:.3f} |")
        parts.append("")
    fig4 = _rows("fig4", results_dir)
    if fig4:
        by = {}
        for r in fig4:
            by.setdefault(r["setting"], []).append(r["mu_divergence"])
        parts.append("### Fig. 4 — BatchNorm minibatch-mean divergence\n")
        parts.append("| setting | mean μ_B divergence | max channel |")
        parts.append("|---|---|---|")
        for k, v in by.items():
            parts.append(f"| {k} | {np.mean(v):.3f} | {np.max(v):.3f} |")
        parts.append("")
    fig5 = _rows("fig5", results_dir)
    if fig5:
        parts.append("### Fig. 5 / Table 9 — GroupNorm & BatchReNorm vs "
                     "BatchNorm (non-IID)\n")
        parts.append("| model | algo | IID acc | non-IID acc |")
        parts.append("|---|---|---|---|")
        by = {}
        for r in fig5:
            by.setdefault((r["model"], r["algo"]), {})[r["skew"]] = r
        for (mdl, algo), d in sorted(by.items()):
            if 0.0 in d and 1.0 in d:
                parts.append(f"| {mdl} | {algo} | {d[0.0]['val_acc']:.3f} | "
                             f"{d[1.0]['val_acc']:.3f} |")
        parts.append("")
    fig6 = _rows("fig6", results_dir)
    if fig6:
        parts.append("### Fig. 6 — degree of skew (GN-LeNet)\n")
        skews = sorted({r["skew"] for r in fig6})
        parts.append("| algo | " + " | ".join(f"{int(s*100)}%" for s in skews)
                     + " |")
        parts.append("|---|" + "---|" * len(skews))
        by = {}
        for r in fig6:
            by.setdefault(r["algo"], {})[r["skew"]] = r["val_acc"]
        for algo, d in sorted(by.items()):
            parts.append(f"| {algo} | " + " | ".join(
                f"{d.get(s, float('nan')):.3f}" for s in skews) + " |")
        parts.append("")
    fig8 = _rows("fig8", results_dir)
    if fig8:
        parts.append("### Fig. 8 — SkewScout vs BSP vs Oracle "
                     "(Gaia, GN-LeNet)\n")
        parts.append("| skew | BSP acc | SkewScout acc | SkewScout savings | "
                     "Oracle savings | θ path |")
        parts.append("|---|---|---|---|---|---|")
        for r in fig8:
            parts.append(
                f"| {int(r['skew']*100)}% | {r['bsp_acc']:.3f} | "
                f"{r['skewscout_acc']:.3f} | {r['skewscout_savings']:.1f}× | "
                f"{r['oracle_savings']:.1f}× | "
                f"{'→'.join(str(t) for t in r['thetas'][:6])} |")
        parts.append("")
    tab = _rows("tab678", results_dir)
    if tab:
        parts.append("### Tables 6-8 — θ sensitivity\n")
        parts.append("| algo | θ | IID acc | non-IID acc | savings |")
        parts.append("|---|---|---|---|---|")
        by = {}
        for r in tab:
            by.setdefault((r["algo"], r["theta"]), {})[r["skew"]] = r
        for (algo, th), d in sorted(by.items(), key=lambda kv: str(kv[0])):
            if 0.0 in d and 1.0 in d:
                parts.append(f"| {algo} | {th} | {d[0.0]['val_acc']:.3f} | "
                             f"{d[1.0]['val_acc']:.3f} | "
                             f"{d[1.0]['comm_savings']:.1f}× |")
        parts.append("")
    return "\n".join(parts)


HEADER = """# EXPERIMENTS (PyTorch/CUDA port)

The port's run of the experiments of *The Non-IID Data Quagmire of
Decentralized Machine Learning* (Hsieh et al., ICML 2020), built by
`python -m repro_torch.benchmarks.report` from the port's own artifacts:
the paper benches' rows (`python -m repro_torch.benchmarks.run --json DIR`
on the card writes them to `experiments/results_torch/`) and the dry-run
stand-in's reports (`python -m repro_torch.launch.dryrun --all
[--multi-pod] --outdir experiments/dryrun_torch/combos`).  A table appears
only where its rows exist.  The datasets are the reference's
deterministic synthetic stand-ins; the claims are directional.

"""


def build(results_dir: str = RESULTS_DIR, combo_dir: str = COMBOS) -> str:
    """The whole report as Markdown."""
    single = load_combos("single", combo_dir)
    multi = load_combos("multi", combo_dir)
    return "\n".join([HEADER, figure_sections(results_dir),
                      dryrun_section(single, multi),
                      roofline_section(single)])


# ---------------------------------------------------- bench trajectory

def _load_bench(path: str) -> Dict[str, float]:
    with open(path) as f:
        data = json.load(f)
    return {r["name"]: float(r["us_per_call"]) for r in data.get("rows", [])
            if "us_per_call" in r}


def _bench_files(spec: str) -> List[str]:
    """A --trend/--gate spec: a file, a directory (its BENCH_*.json
    members), or a glob."""
    if os.path.isdir(spec):
        return sorted(glob.glob(os.path.join(spec, "BENCH_*.json")))
    return sorted(glob.glob(spec))


def trend(spec: str) -> int:
    """Cross-commit trend table: a section a bench name, a row a (commit,
    timestamp), the columns that bench's kernel rows (kernels) or its wall
    time and headline (the other benches)."""
    files = _bench_files(spec)
    if not files:
        print(f"no BENCH_*.json matched {spec!r}", file=sys.stderr)
        return 1
    by_bench: Dict[str, List[Dict]] = {}
    for p in files:
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        by_bench.setdefault(data.get("name", "?"), []).append(data)
    for name, records in sorted(by_bench.items()):
        records.sort(key=lambda d: d.get("timestamp", 0.0))
        print(f"## bench trend: {name}\n")
        if name == "kernels":
            cols = sorted({r["name"] for d in records
                           for r in d.get("rows", [])
                           if r["name"].startswith("kernel/")})
            print("| commit | " + " | ".join(
                c.split("/", 1)[1] + " us" for c in cols) + " |")
            print("|---|" + "---|" * len(cols))
            for d in records:
                rows = {r["name"]: r.get("us_per_call") for r in d["rows"]}
                print("| " + (d.get("commit", "")[:8] or "?") + " | " +
                      " | ".join(f"{rows[c]:.0f}" if c in rows else ""
                                 for c in cols) + " |")
        else:
            print("| commit | wall ms | headline |")
            print("|---|---|---|")
            for d in records:
                print(f"| {(d.get('commit', '')[:8] or '?')} | "
                      f"{d.get('us_per_call', 0.0) / 1e3:.0f} | "
                      f"{d.get('derived', '')} |")
        print()
    return 0


def gate_rows(rows: Dict[str, float], noise_band: float = 0.5
              ) -> List[Dict]:
    """The gate's verdict on each ``kernel/<op>`` row that has an
    ``oracle/<op>`` twin, in name order: ``{"op", "kernel_us",
    "oracle_us", "ratio", "ok"}``, ok where kernel <= oracle x (1 +
    noise_band)."""
    out = []
    for name, us in sorted(rows.items()):
        if not name.startswith("kernel/"):
            continue
        op = name.split("/", 1)[1]
        oracle = rows.get(f"oracle/{op}")
        if oracle is None:
            continue
        out.append({"op": op, "kernel_us": us, "oracle_us": oracle,
                    "ratio": us / oracle,
                    "ok": us <= oracle * (1.0 + noise_band)})
    return out


def gate(path: str, baseline: Optional[str] = None,
         noise_band: float = 0.5) -> int:
    """Exit 1 when the kernel bench regresses (the module docstring's two
    rules); prints one verdict line a ``kernel/`` row with an oracle."""
    kern = [p for p in _bench_files(path) if p.endswith("BENCH_kernels.json")]
    if not kern and os.path.isfile(path):
        kern = [path]
    if not kern:
        print(f"gate: no BENCH_kernels.json under {path!r}",
              file=sys.stderr)
        return 1
    rows = _load_bench(kern[0])
    failures = []
    verdicts = gate_rows(rows, noise_band)
    for v in verdicts:
        print(f"gate: kernel/{v['op']} {v['kernel_us']:.3f} us, oracle "
              f"{v['oracle_us']:.3f} us, ratio {v['ratio']:.3f}: "
              f"{'ok' if v['ok'] else 'FAIL'} (<= 1 + {noise_band})")
        if not v["ok"]:
            failures.append(
                f"kernel/{v['op']}: kernel {v['kernel_us']:.0f}us > oracle "
                f"{v['oracle_us']:.0f}us x (1 + {noise_band})")
    if baseline:
        prev_files = [p for p in _bench_files(baseline)
                      if p.endswith("BENCH_kernels.json")]
        if not prev_files and os.path.isfile(baseline):
            prev_files = [baseline]
        if prev_files:
            prev = _load_bench(prev_files[0])
            for name, us in sorted(rows.items()):
                if not name.startswith("kernel/") or name not in prev:
                    continue
                if us > prev[name] * (1.0 + noise_band):
                    failures.append(
                        f"{name}: {us:.0f}us regressed beyond "
                        f"{prev[name]:.0f}us x (1 + {noise_band}) "
                        f"vs baseline")
        else:
            print(f"gate: baseline {baseline!r} has no "
                  f"BENCH_kernels.json; skipping cross-commit check")
    if failures:
        print("\n".join("GATE FAIL: " + f for f in failures),
              file=sys.stderr)
        return 1
    print(f"gate: OK ({len(verdicts)} kernel rows <= oracle x "
          f"(1 + {noise_band}))")
    return 0


def cli(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trend", metavar="GLOB_OR_DIR",
                    help="print a cross-commit trend table over "
                         "BENCH_*.json files")
    ap.add_argument("--gate", metavar="FILE_OR_DIR",
                    help="hold the kernel bench's rows to their oracles "
                         "(and --baseline); exit 1 on a regression")
    ap.add_argument("--baseline", metavar="FILE_OR_DIR", default=None,
                    help="an earlier bench file for the cross-commit "
                         "check (with --gate)")
    ap.add_argument("--noise-band", type=float, default=0.5,
                    help="allowed fractional slack on every ratio check "
                         "(default 0.5)")
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="the paper benches' rows (default: "
                         "experiments/results_torch)")
    ap.add_argument("--combos", default=COMBOS,
                    help="the stand-in's reports (default: "
                         "experiments/dryrun_torch/combos)")
    ap.add_argument("--out", default=OUT,
                    help="where the report goes (default: "
                         "out/EXPERIMENTS_TORCH.md)")
    ap.add_argument("--stdout", action="store_true",
                    help="print the report instead of writing it")
    args = ap.parse_args(argv)
    if args.trend:
        return trend(args.trend)
    if args.gate:
        return gate(args.gate, baseline=args.baseline,
                    noise_band=args.noise_band)
    doc = build(args.results, args.combos)
    if args.stdout:
        print(doc)
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
