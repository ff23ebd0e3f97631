"""The port's ``optim`` and its report builder on the CPU, against the
reference's: the learning-rate schedules bit for bit, momentum SGD and
the global-norm clip on the same NumPy trees, the report's figure,
dry-run and trend sections and its gate's verdicts on the same fixture
rows (each package's format, in ``tmp_path``); and the analysis CLI's
AST + parity gate on the tree, with JAX absent."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import report as jax_report
from repro.optim import schedules as jax_schedules
from repro.optim import sgd as jax_sgd
from repro_torch import pytree
from repro_torch.benchmarks import report
from repro_torch.optim import (clip_by_global_norm, constant, global_norm,
                               init_momentum, momentum_update,
                               polynomial_decay, step_decay)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 400


# ------------------------------------------------------------- schedules

SCHEDULES = [
    ("step_decay", (0.1, [64, 96]), {}),
    ("step_decay", (0.05, list(range(10, 400, 30))), {"factor": 0.7}),
    ("step_decay", (0.02, [5, 5, 9]), {"factor": 0.5}),
    ("polynomial_decay", (0.1, 300), {}),
    ("polynomial_decay", (0.02, 37), {"power": 2.0}),
    ("polynomial_decay", (0.3, 1000), {"power": 0.9}),
    ("constant", (0.01,), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(SCHEDULES)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_schedule_bit_for_bit(name, args, kw, as_tensor):
    ours = {"step_decay": step_decay, "polynomial_decay": polynomial_decay,
            "constant": constant}[name](*args, **kw)
    theirs = getattr(jax_schedules, name)(*args, **kw)
    got = np.array([ours(torch.tensor(s) if as_tensor else s).numpy()
                    for s in range(N_STEPS)])
    want = np.array([np.asarray(theirs(jnp.int32(s) if as_tensor else s))
                     for s in range(N_STEPS)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------- the SGD

def np_tree(seed):
    rs = np.random.default_rng(seed)
    return {"conv": {"w": rs.standard_normal((3, 3, 4, 8)).astype(np.float32),
                     "b": rs.standard_normal(8).astype(np.float32)},
            "fc": [rs.standard_normal((16, 10)).astype(np.float32),
                   rs.standard_normal(10).astype(np.float32)]}


def to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def close(ours, theirs, tol=2e-5):
    """Every leaf of ``ours`` (a torch tree, in the reference's leaf order:
    ``pytree.leaves``) within ``tol`` of ``theirs``, shapes and dtypes
    equal."""
    a = [t.numpy() for t in pytree.leaves(ours)]
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(theirs)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(x, y, rtol=tol, atol=tol)


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_momentum_update_matches(weight_decay):
    p, g, v = np_tree(0), np_tree(1), np_tree(2)
    ours = momentum_update(to_torch(p), to_torch(g), to_torch(v),
                           lr=torch.tensor(0.05), momentum=0.9,
                           weight_decay=weight_decay)
    theirs = jax_sgd.momentum_update(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (p, g, v)),
        lr=jnp.float32(0.05), momentum=0.9, weight_decay=weight_decay)
    for o, t in zip(ours, theirs):
        close(o, t)
    assert ours[1] is ours[2]
    zeros = init_momentum(to_torch(p))
    close(zeros, jax_sgd.init_momentum(p))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match(max_norm):
    tree = np_tree(3)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    close(global_norm(to_torch(tree)), jax_sgd.global_norm(jtree))
    assert global_norm(to_torch(tree)).dtype == torch.float32
    close(clip_by_global_norm(to_torch(tree), max_norm),
          jax_sgd.clip_by_global_norm(jtree, max_norm))


# ------------------------------------------------------------ the report

def figure_rows():
    rs = np.random.default_rng(0)
    acc = lambda: round(float(rs.uniform(0.3, 1.0)), 4)
    return {
        "fig1": [{"model": m, "algo": a, "skew": s, "val_acc": acc(),
                  "comm_savings": float(rs.uniform(1, 20))}
                 for m in ("gn-lenet", "resnet-s") for a in ("bsp", "gaia")
                 for s in (0.0, 1.0)],
        "fig2": [{"level": lv, "algo": a, "setting": st, "val_acc": acc()}
                 for lv in ("continent", "country") for a in ("bsp", "gaia")
                 for st in ("iid", "noniid")],
        "fig4": [{"setting": st, "mu_divergence": float(rs.uniform(0, 20))}
                 for st in ("iid", "noniid") for _ in range(3)],
        "fig5": [{"model": m, "algo": a, "skew": s, "val_acc": acc()}
                 for m in ("bn-lenet", "gn-lenet") for a in ("bsp", "gaia")
                 for s in (0.0, 1.0)],
        "fig6": [{"algo": a, "skew": s, "val_acc": acc()}
                 for a in ("bsp", "gaia", "dgc") for s in (0.2, 0.6, 1.0)],
        "fig8": [{"skew": s, "bsp_acc": acc(), "skewscout_acc": acc(),
                  "skewscout_savings": 9.9, "oracle_savings": 16.0,
                  "thetas": [0.1, 0.05, 0.02, 0.01]} for s in (0.0, 1.0)],
        "tab678": [{"algo": a, "theta": th, "skew": s, "val_acc": acc(),
                    "comm_savings": float(rs.uniform(1, 9))}
                   for a in ("gaia", "fedavg") for th in (0.1, 0.05)
                   for s in (0.0, 1.0)],
    }


def test_figure_sections_match(tmp_path, monkeypatch):
    for name, rows in figure_rows().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rows))
    monkeypatch.setattr(jax_report, "RESULTS", str(tmp_path))
    ours = report.figure_sections(str(tmp_path))
    assert ours == jax_report.figure_sections()
    assert ours.count("### ") == 7


def dryrun_reports():
    """Reports in the stand-in's format (its keys; the reference's reports
    carry the same ones the report reads), a failed row among them."""
    rs = np.random.default_rng(1)
    out = []
    for arch in ("qwen3-0.6b", "gemma2-9b", "mamba2-780m"):
        for shape in report.SHAPE_ORDER:
            if arch == "gemma2-9b" and shape == "long_500k":
                out.append({"arch": arch, "shape": shape, "ok": False,
                            "error": "ValueError: refused"})
                continue
            out.append({
                "arch": arch, "shape": shape, "mesh": "2x16x16",
                "mode": "train" if shape == "train_4k" else "prefill",
                "ok": True,
                "memory": {"argument_size_in_bytes": int(rs.integers(1e9)),
                           "temp_size_in_bytes": int(rs.integers(1e9)),
                           "output_size_in_bytes": 0},
                "cost": {"launches": {"flash_attention": 28}},
                "roofline": {
                    "t_compute_ms": float(rs.uniform(0, 500)),
                    "t_memory_ms": float(rs.uniform(0, 500)),
                    "t_collective_ms": float(rs.uniform(0, 500)),
                    "bottleneck": str(rs.choice(["compute", "memory"])),
                    "useful_ratio": float(rs.uniform()),
                    "coll_breakdown_gb": {
                        "all-gather": float(rs.uniform()),
                        "all-reduce": float(rs.uniform()),
                        "all-to-all": float(rs.uniform())}}})
    return out


def write_combos(reports, base, kind, strategy_tag):
    os.makedirs(base, exist_ok=True)
    for r in reports:
        tag = "gaia" if r["shape"] == "train_4k" else "serve"
        name = f"{r['arch']}__{r['shape']}__{tag}__{kind}.json" \
            if strategy_tag else f"{r['arch']}__{r['shape']}__{kind}.json"
        with open(os.path.join(base, name), "w") as f:
            json.dump(r, f)


def table_lines(text):
    return [line for line in text.splitlines() if line.startswith("|")]


def test_dryrun_and_roofline_tables_match(tmp_path):
    reps = dryrun_reports()
    ours_dir = str(tmp_path / "dryrun_torch")
    write_combos(reps, ours_dir, "single", True)
    write_combos(reps, ours_dir, "multi", True)
    write_combos(reps, str(tmp_path / "combos2"), "single", True)
    write_combos(reps, str(tmp_path / "combos"), "multi", True)
    single = report.load_combos("single", ours_dir)
    multi = report.load_combos("multi", ours_dir)
    j_single = jax_report._load_combos("single", str(tmp_path / "combos2"))
    j_multi = jax_report._load_combos("multi", str(tmp_path / "combos"))
    assert single == j_single and len(single) == 12
    ours = report.dryrun_section(single, multi)
    theirs = jax_report.dryrun_section(j_single, j_multi)
    assert table_lines(ours) == table_lines(theirs)
    assert "**11/40**" in ours and "**11/40**" in theirs
    ours = report.roofline_section(single)
    assert table_lines(ours) == table_lines(
        jax_report.roofline_section(j_single))
    assert "FAILED" in ours and "989 TFLOP/s" in ours


def bench_file(path, commit, ts, rows, name="kernels"):
    with open(path, "w") as f:
        json.dump({"name": name, "commit": commit, "timestamp": ts,
                   "device": "NVIDIA H100 80GB HBM3", "power_limit": "700 W",
                   "us_per_call": 1234.0, "derived": "n=3",
                   "rows": [{"name": k, "us_per_call": v}
                            for k, v in rows.items()]}, f)


KERNEL_ROWS = {"kernel/a": 10.0, "oracle/a": 20.0, "kernel/b": 40.0,
               "oracle/b": 20.0, "kernel/c": 29.0, "oracle/c": 20.0,
               "library/a": 5.0, "kernel/d": 3.0}


def test_trend_matches(tmp_path, capsys):
    for i, (commit, scale) in enumerate((("aaaa1111bbbb", 1.0),
                                         ("cccc2222dddd", 1.3))):
        d = tmp_path / f"art{i}"
        d.mkdir()
        bench_file(d / "BENCH_kernels.json", commit, 100.0 + i,
                   {k: v * scale for k, v in KERNEL_ROWS.items()})
        bench_file(d / "BENCH_fig4.json", commit, 100.0 + i, {},
                   name="fig4")
    spec = str(tmp_path / "art*" / "BENCH_*.json")
    assert report.trend(spec) == 0
    ours = capsys.readouterr().out
    assert jax_report.trend(spec) == 0
    assert ours == capsys.readouterr().out
    assert "## bench trend: kernels" in ours


@pytest.mark.parametrize("band,baseline_scale", [
    (0.5, None), (0.0, None), (1.0, None), (0.5, 0.5), (0.5, 1.0)])
def test_gate_verdicts_match(tmp_path, capsys, band, baseline_scale):
    path = tmp_path / "BENCH_kernels.json"
    bench_file(path, "aaaa", 1.0, KERNEL_ROWS)
    base = None
    if baseline_scale is not None:
        prev = tmp_path / "prev"
        prev.mkdir()
        bench_file(prev / "BENCH_kernels.json", "bbbb", 0.0,
                   {k: v * baseline_scale for k, v in KERNEL_ROWS.items()})
        base = str(prev)

    def failures(err):
        """(row, the rule it broke) of each GATE FAIL line."""
        out = []
        for line in err.splitlines():
            if "GATE FAIL: " in line:
                row, why = line.split("GATE FAIL: ", 1)[1].split(":", 1)
                out.append((row, "baseline" if "baseline" in why
                            else "oracle"))
        return sorted(out)
    rc = report.gate(str(path), baseline=base, noise_band=band)
    ours = failures(capsys.readouterr().err)
    jrc = jax_report.gate(str(path), baseline=base, noise_band=band)
    theirs = failures(capsys.readouterr().err)
    assert (rc, ours) == (jrc, theirs)
    verdicts = report.gate_rows(KERNEL_ROWS, band)
    assert [v["op"] for v in verdicts] == ["a", "b", "c"]   # d: no oracle
    assert [f"kernel/{v['op']}" for v in verdicts if not v["ok"]] == \
        [row for row, why in theirs if why == "oracle"]


def test_gate_reads_the_kernel_bench_json(tmp_path, capsys):
    """The bench's own ``--json`` file, whatever its name."""
    path = tmp_path / "kernels_bench.json"
    path.write_text(json.dumps({"device": "cpu", "rows": [
        {"name": k, "us_per_call": v} for k, v in KERNEL_ROWS.items()]}))
    assert report.gate(str(path)) == 1
    out = capsys.readouterr()
    assert out.out.count("gate: kernel/") == 3
    assert "GATE FAIL: kernel/b" in out.err


def test_report_writes_its_own_file(tmp_path, monkeypatch):
    for name, rows in figure_rows().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rows))
    out = tmp_path / "EXPERIMENTS_TORCH.md"
    assert report.cli(["--results", str(tmp_path), "--combos",
                       str(tmp_path / "none"), "--out", str(out)]) == 0
    text = out.read_text()
    assert text.startswith("# EXPERIMENTS (PyTorch/CUDA port)")
    assert "### Fig. 8" in text and "## §Roofline" in text
    assert report.OUT.endswith(os.path.join("out", "EXPERIMENTS_TORCH.md"))


# ----------------------------------------------------------- the CLI gate

def test_analysis_cli_skip_graph_exits_zero(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--skip-graph",
         "--json", str(tmp_path / "a.json")], capture_output=True,
        text=True, cwd=REPO_ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[analysis] OK" in r.stdout
    audit = json.loads((tmp_path / "a.json").read_text())
    assert audit["ok"] and audit["coverage"] is None


def test_analysis_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.analysis as a; "
            "from repro_torch.analysis import __main__; "
            "import repro_torch.optim, repro_torch.benchmarks.report; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print(len(a.ALL_RULES))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO_ROOT, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO_ROOT, "src")))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "21"
