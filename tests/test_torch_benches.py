"""The port's paper benches, entry point and CNN examples against the
reference's (``benchmarks/`` and ``examples/``), on the CPU.

No bench trains at its own size here.  ``train_decentralized`` (and
``save_rows``) in each reference module and in its port twin is replaced
by a recorder that returns a fixed result carrying every field the bench
reads; ``run(quick=True)`` and ``run(quick=False)`` (``main`` for the
examples) must then make the same training calls in the same order: the
model config, strategy and K, every ``CommConfig`` / ``FabricConfig`` /
``LinkConfig`` field, steps, batch, lr, ``eval_every``,
``theta_start_index`` and the rest of the signature, and the partitions'
and validation arrays bit for bit (by SHA-256 of dtype, shape and bytes).
Beside that: the shared setup bit for bit, both ``_headline``s, fig4's
divergences on weights carried over from the reference, the entry point
end to end and ``train_topology`` as a subprocess, all on ``--device
cpu``.
"""
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import benchmarks.common as jax_common  # noqa: E402
import benchmarks.run as jax_run  # noqa: E402
from benchmarks import (fig1_accuracy as jax_fig1,  # noqa: E402
                        fig2_flickr as jax_fig2,
                        fig4_bn_divergence as jax_fig4,
                        fig5_groupnorm as jax_fig5,
                        fig6_skew_degree as jax_fig6,
                        fig8_skewscout as jax_fig8,
                        fig_topology as jax_fig_topology,
                        tab678_hparams as jax_tab678)
from repro.core.algorithms.dgc import \
    warmup_sparsity as jax_warmup_sparsity  # noqa: E402
from repro.core.trainer import \
    train_decentralized as jax_train_decentralized  # noqa: E402
from repro.data.pipeline import DecentralizedLoader as JaxLoader  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.benchmarks import (common, fig1_accuracy,  # noqa: E402
                                    fig2_flickr, fig4_bn_divergence,
                                    fig5_groupnorm, fig6_skew_degree,
                                    fig8_skewscout, fig_topology, run,
                                    tab678_hparams)
from repro_torch.configs.cnn_zoo import CNN_ZOO  # noqa: E402
from repro_torch.core.algorithms.dgc import warmup_sparsity  # noqa: E402
from repro_torch.core.trainer import train_decentralized  # noqa: E402
from repro_torch.data.pipeline import DecentralizedLoader  # noqa: E402
from repro_torch.examples import (quickstart, skewscout_adaptive,  # noqa
                                  train_topology)
from repro_torch.models.cnn import cnn_params_from_jax  # noqa: E402

#: (name, reference module, port module) of every bench that trains
BENCHES = (("fig1", jax_fig1, fig1_accuracy), ("fig2", jax_fig2, fig2_flickr),
           ("fig5", jax_fig5, fig5_groupnorm),
           ("fig6", jax_fig6, fig6_skew_degree),
           ("fig8", jax_fig8, fig8_skewscout),
           ("tab678", jax_tab678, tab678_hparams),
           ("fig_topology", jax_fig_topology, fig_topology))


def _load_example(name: str):
    """The reference's ``examples/<name>.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLES = {name: (_load_example(name), port) for name, port in (
    ("quickstart", quickstart), ("skewscout_adaptive", skewscout_adaptive),
    ("train_topology", train_topology))}


def _digest(a) -> str:
    a = np.asarray(a)
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + np.ascontiguousarray(a).tobytes()).hexdigest()


def _plain(v):
    """A recorded argument in a form both packages' values compare in."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, dataclasses.asdict(v))
    if isinstance(v, np.ndarray):
        return ("array", _digest(v))
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _fake_result(algo_name, comm):
    """A fixed result with every field a bench or example reads; the
    asynchronous runs come out faster, as the smokes assert."""
    history = [SimpleNamespace(step=10, theta=0.1, accuracy_loss=0.01,
                               comm_ratio=0.5, objective=0.5, new_theta=0.2)]
    return SimpleNamespace(
        val_acc=0.5, comm_savings=2.0, comm_wan_floats=3e6,
        comm_lan_floats=4e6, topology="ring",
        sim_time_s=1.0 if comm.async_gossip else 2.0,
        skewscout_history=history if comm.skewscout else [],
        extras={"spectral_gap": 0.25, "schedule_period": 3,
                "ledger": {"rewire_floats": 64.0, "clock_skew_s": 0.1,
                           "idle_s_mean": 0.2, "lan_floats": 4e6,
                           "wan_floats": 3e6, "sim_time_s": 2.0},
                "link_model": {"slow_fraction": 0.1}})


class Recorder:
    """Stands in for ``train_decentralized``: binds each call to the
    signature of the function it replaces (so defaults count), records
    it, and returns ``_fake_result``."""

    def __init__(self, real):
        self.sig = inspect.signature(real)
        self.calls, self.devices = [], []

    def __call__(self, *args, **kwargs):
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        call = dict(bound.arguments)
        self.devices.append(call.pop("device", None))
        call["K"] = len(call["parts"])
        self.calls.append({k: _plain(v) for k, v in call.items()})
        return _fake_result(call["algo_name"], call["comm"])


def _record(monkeypatch, module, real):
    rec = Recorder(real)
    monkeypatch.setattr(module, "train_decentralized", rec)
    if hasattr(module, "save_rows"):
        monkeypatch.setattr(module, "save_rows", lambda *a: "")
    return rec


@pytest.fixture(autouse=True)
def _no_bench_json(monkeypatch):
    """The reference's smokes write ``BENCH_*.json`` only where this
    variable names a directory."""
    monkeypatch.delenv("BENCH_JSON_DIR", raising=False)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name,jax_mod,mod", BENCHES,
                         ids=[b[0] for b in BENCHES])
def test_bench_makes_the_reference_calls(name, jax_mod, mod, quick,
                                         monkeypatch):
    theirs = _record(monkeypatch, jax_mod, jax_train_decentralized)
    mine = _record(monkeypatch, mod, train_decentralized)
    jax_rows = jax_mod.run(quick=quick)
    rows = mod.run(quick=quick, device="cpu")
    assert theirs.calls, name
    assert len(mine.calls) == len(theirs.calls)
    for i, (a, b) in enumerate(zip(mine.calls, theirs.calls)):
        if name == "fig2":
            # the one difference: a 15-way head for the 15 classes
            assert a["cnn_cfg"][1]["n_classes"] == 15
            assert b["cnn_cfg"][1]["n_classes"] == 10
            b = {**b, "cnn_cfg": a["cnn_cfg"]}
        assert a == b, (name, i)
    assert set(mine.devices) == {"cpu"}
    assert rows == jax_rows


@pytest.mark.parametrize("smoke", ["smoke_async", "smoke_links"])
def test_topology_smokes_make_the_reference_calls(smoke, monkeypatch):
    theirs = _record(monkeypatch, jax_fig_topology, jax_train_decentralized)
    mine = _record(monkeypatch, fig_topology, train_decentralized)
    jax_rows = getattr(jax_fig_topology, smoke)()
    rows = getattr(fig_topology, smoke)(device="cpu")
    assert mine.calls == theirs.calls and len(mine.calls) == 2
    assert rows == jax_rows


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_makes_the_reference_calls(name, monkeypatch, capsys):
    jax_mod, mod = EXAMPLES[name]
    theirs = _record(monkeypatch, jax_mod, jax_train_decentralized)
    mine = _record(monkeypatch, mod, train_decentralized)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    jax_mod.main()
    jax_out = capsys.readouterr().out
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert theirs.calls and mine.calls == theirs.calls
    assert set(mine.devices) == {"cpu"}
    # the same report, but for the device the port names
    strip = lambda s: [ln.split("  device=")[0].split(", device=")[0]
                       for ln in s.splitlines()]
    assert strip(out) == strip(jax_out)


def test_train_topology_arguments_reach_the_calls(monkeypatch):
    jax_mod, mod = EXAMPLES["train_topology"]
    theirs = _record(monkeypatch, jax_mod, jax_train_decentralized)
    mine = _record(monkeypatch, mod, train_decentralized)
    args = ["--steps", "7", "--skew", "0.4", "--nodes", "5"]
    monkeypatch.setattr(sys, "argv", ["train_topology.py", *args])
    jax_mod.main()
    mod.main([*args, "--device", "cpu"])
    assert mine.calls == theirs.calls
    assert {c["steps"] for c in mine.calls} == {7}
    assert {c["K"] for c in mine.calls} == {5}


# ---------------------------------------------------------------------------
# the shared setup, the headlines, DGC's warm-up
# ---------------------------------------------------------------------------

def test_common_constants_equal():
    for name in ("DATA", "TRAIN", "MODEL_LR", "K"):
        assert getattr(common, name) == getattr(jax_common, name), name
    for model in CNN_ZOO:
        assert common.train_args(model) == jax_common.train_args(model)
    calls = []
    assert common.timed(calls.append, 1, n_warmup=2, n_iter=3) > 0
    assert calls == [1] * 5
    assert Path(common.RESULTS_DIR).name == "results_torch"
    assert Path(common.RESULTS_DIR).resolve() != \
        Path(jax_common.RESULTS_DIR).resolve()


@pytest.mark.parametrize("n_train,n_val", [(4000, 1000), (2000, 1000)])
@pytest.mark.parametrize("skew", [0.0, 0.4, 1.0])
def test_make_data_and_parts_bit_equal(n_train, n_val, skew):
    ds, val = common.make_data(n_train, n_val)
    jds, jval = jax_common.make_data(n_train, n_val)
    for a, b in ((ds.x, jds.x), (ds.y, jds.y), (val.x, jval.x),
                 (val.y, jval.y)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for n_nodes in (2, 5):
        parts = common.make_parts(ds, skew, n_nodes=n_nodes)
        jparts = jax_common.make_parts(jds, skew, n_nodes=n_nodes)
        assert [_plain(list(p)) for p in parts] == \
            [_plain(list(p)) for p in jparts]


@pytest.mark.parametrize("e_warm", [1, 4, 10**6])
@pytest.mark.parametrize("skew", [0.0, 1.0])
def test_dgc_warmup_schedule_equal(e_warm, skew):
    """fig1, fig5 and fig6 warm DGC up over 1 epoch a level and tab678
    over 10**6 (no warm-up past the first rung): the port's loader
    counts the same epochs and its schedule gives the same sparsity at
    every step of the full pass."""
    ds, _ = common.make_data(4000)
    parts = common.make_parts(ds, skew)
    spe = DecentralizedLoader(parts, 20, seed=0).steps_per_epoch
    assert spe == JaxLoader(parts, 20, seed=0).steps_per_epoch
    assert [warmup_sparsity(t // spe, e_warm) for t in range(350)] == \
        [jax_warmup_sparsity(t // spe, e_warm) for t in range(350)]


HEADLINE_ROWS = {
    "kernels": [{"name": "kernel/x", "us_per_call": 1.0}],
    "fig4": [{"setting": "iid", "channel": 0, "mu_divergence": 1.5},
             {"setting": "iid", "channel": 1, "mu_divergence": 2.5},
             {"setting": "noniid", "channel": 0, "mu_divergence": 9.0}],
    "fig8": [{"skew": 0.2, "skewscout_savings": 9.9, "oracle_savings": 12.0},
             {"skew": 1.0, "skewscout_savings": 16.0,
              "oracle_savings": 20.0}],
    "fig1": [{"model": "lenet", "algo": "gaia", "skew": 1.0,
              "val_acc": 0.4},
             {"model": "bn-lenet", "algo": "bsp", "skew": 0.0,
              "val_acc": 0.9}],
    "fig2": [{"level": "continent", "algo": "bsp", "setting": "iid",
              "val_acc": 0.7}],
    "tab678": [{"algo": "dgc", "theta": 0.999, "skew": 1.0, "val_acc": 0.3}],
    "fig_topology": [{"schedule": "constant", "topology": "ring",
                      "sim_time_s": 1.0}],
    "roofline": [{"arch": "a", "shape": "s", "ok": True,
                  "bottleneck": "memory"},
                 {"arch": "b", "shape": "s", "ok": True,
                  "bottleneck": "compute"},
                 {"arch": "c", "shape": "s", "ok": False, "error": "x"}],
}


@pytest.mark.parametrize("name", sorted(HEADLINE_ROWS))
def test_headline_equal(name):
    rows = HEADLINE_ROWS[name]
    assert run._headline(name, rows) == jax_run._headline(name, rows)
    assert run._headline(name, []) == jax_run._headline(name, []) == ""


def test_benches_are_the_references_but_roofline(tmp_path, monkeypatch,
                                                 capsys):
    """Every bench of the reference, ``roofline`` included since the port
    has the dry-run stand-in: its rows are the stand-in's JSON, read (none
    here: an empty table on the CPU)."""
    from repro_torch.benchmarks import roofline
    assert list(run.BENCHES) == list(jax_run.BENCHES)
    monkeypatch.setitem(run.BENCHES, "roofline", (
        lambda quick, device: roofline.run(combo_dir=str(tmp_path)), ""))
    assert run.main(["--only", "roofline", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("roofline,")


def test_kernels_entry_adapts_kernels_bench(monkeypatch):
    from repro_torch.benchmarks import kernels_bench
    seen = []
    monkeypatch.setattr(kernels_bench, "run", lambda device: seen.append(
        device) or [("kernel/a", 1.5), ("oracle/a", 2.5)])
    assert run.kernel_rows(quick=True, device="cpu") == [
        {"name": "kernel/a", "us_per_call": 1.5},
        {"name": "oracle/a", "us_per_call": 2.5}]
    assert seen == ["cpu"]


# ---------------------------------------------------------------------------
# fig4 on carried weights, the entry point, the default device
# ---------------------------------------------------------------------------

def test_fig4_divergence_matches_jax(monkeypatch):
    """fig4's quick pass on BN-LeNet's reference weights (``PRNGKey(0)``,
    carried over by ``cnn_params_from_jax``): every channel's mean μ_B
    divergence within 1e-3 relative and 1e-5 absolute of the reference's.
    The batch means are float32 and the ratio divides their spread by
    |mean μ|, so a channel whose means nearly cancel (ratio 43 here)
    carries the rounding up to 2.3e-4 relative; the rest agree to 1e-4."""
    cfg = CNN_ZOO["bn-lenet"]
    p, s = jax_init_cnn(jax.random.PRNGKey(0), cfg)
    p_np, s_np = jax.tree.map(np.asarray, (p, s))
    monkeypatch.setattr(fig4_bn_divergence, "init_cnn",
                        lambda gen, cfg_: cnn_params_from_jax(p_np, s_np,
                                                              cfg_))
    for mod in (fig4_bn_divergence, jax_fig4):
        monkeypatch.setattr(mod, "save_rows", lambda *a: "")
    rows = fig4_bn_divergence.run(quick=True, device="cpu")
    jax_rows = jax_fig4.run(quick=True)
    assert [(r["setting"], r["channel"]) for r in rows] == \
        [(r["setting"], r["channel"]) for r in jax_rows]
    np.testing.assert_allclose([r["mu_divergence"] for r in rows],
                               [r["mu_divergence"] for r in jax_rows],
                               rtol=1e-3, atol=1e-5)
    mean = lambda rs, k: np.mean([r["mu_divergence"] for r in rs
                                  if r["setting"] == k])
    assert mean(rows, "noniid") > mean(rows, "iid")


def test_run_main_fig4_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "results"))
    out_dir = tmp_path / "json"
    assert run.main(["--only", "fig4", "--device", "cpu",
                     "--json", str(out_dir)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    assert "name,us_per_call,derived" in lines
    row = next(ln for ln in lines if ln.startswith("fig4,"))
    _, us, derived = row.split(",", 2)
    assert float(us) > 0 and derived.startswith("iid:mean_div=")
    bench = json.loads((out_dir / "BENCH_fig4.json").read_text())
    assert bench["device"] == "cpu" and bench["power_limit"] is None
    assert bench["derived"] == derived
    assert {r["setting"] for r in bench["rows"]} == {"iid", "noniid"}
    assert bench["rows"] == json.loads(
        (tmp_path / "results" / "fig4.json").read_text())
    # the cached rows replay without a run
    capsys.readouterr()
    run.main(["--only", "fig4", "--device", "cpu", "--use-cache",
              "--cache-only"])
    assert "fig4," in capsys.readouterr().out


def test_cache_only_skips_a_missing_bench(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    run.main(["--only", "fig1", "--device", "cpu", "--use-cache",
              "--cache-only"])
    assert "fig1,0,SKIPPED(no cached result)" in capsys.readouterr().out


#: every entry point of this slice, called with its default device
DEFAULT_DEVICE_CALLS = (
    [(f"{name}.run", lambda m=mod: m.run(quick=True))
     for name, _, mod in BENCHES]
    + [("fig4.run", lambda: fig4_bn_divergence.run(quick=True)),
       ("fig_topology.smoke_async", fig_topology.smoke_async),
       ("run.main", lambda: run.main(["--only", "fig4"]))]
    + [(f"{name}.main", lambda m=mod: m.main([]))
       for name, (_, mod) in EXAMPLES.items()])


@pytest.mark.parametrize("call", [c for _, c in DEFAULT_DEVICE_CALLS],
                         ids=[n for n, _ in DEFAULT_DEVICE_CALLS])
def test_entry_points_default_to_cuda(call, monkeypatch):
    """With no device named, every bench and example runs on CUDA, and
    raises where there is none rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_trainer_refuses_labels_past_the_classes():
    """The reference's fig2 data (15 classes) into the zoo's 10-way
    GN-LeNet: the port's trainer refuses it before any step; fig2's own
    15-way head trains on it."""
    from repro_torch.data.synthetic import synth_geo_images
    ds, region = synth_geo_images(300, n_regions=5, n_classes=15,
                                  home_share=0.7, seed=0)
    parts = [(ds.x[i], ds.y[i]) for i in
             fig2_flickr.partition_by_region(region, 5)]
    with pytest.raises(ValueError, match="labels reach 14"):
        train_decentralized(CNN_ZOO["gn-lenet"], "bsp", parts, (ds.x, ds.y),
                            steps=1, device="cpu")
    r = train_decentralized(fig2_flickr.CFG, "bsp", parts, (ds.x, ds.y),
                            steps=2, eval_every=2, device="cpu")
    assert np.isfinite([loss for _, loss in r.loss_curve]).all()


def test_train_topology_subprocess():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_topology",
         "--steps", "2", "--device", "cpu"], check=True, env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300).stdout
    for name in ("full", "ring", "geo-wan"):
        assert f"== {name}:" in out
    assert out.count("val_acc=") == 3
