"""The port's analysis passes (``repro_torch.analysis``) on the CPU: the
AST lints against the reference's ``repro.analysis.astlint`` on its own
planted NumPy snippets, the torch plants of RA101–RA104 (RA100 a syntax
error), registry parity (PA301–PA305) on a planted tree beside the
reference's ``check_parity`` on its own, each step-audit rule
(JA400–JA405) on a planted step, and the real tree clean under every
pass, through the CLI, over the reference's combo matrix."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.analysis import astlint as jax_astlint
from repro.analysis import check_parity as jax_check_parity
from repro_torch.analysis import (ALL_RULES, apply_baseline, astlint,
                                  audit_combos, audit_step, check_parity,
                                  graph_audit, lint_file, load_baseline,
                                  parity, step_audit, write_baseline)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.base import Finding, is_suppressed
from repro_torch.launch.meta import MetaMesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(tmp_path, code, name="planted.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(code))
    return str(p)


def lint_snippet(tmp_path, code, name="planted.py"):
    return lint_file(plant(tmp_path, code, name), str(tmp_path))


def rules_of(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------- RA10x

#: the NumPy snippets of ``tests/test_analysis.py`` for RA100, RA101,
#: RA104 and suppression: (name, code, the reference's rules)
SHARED_SNIPPETS = [
    ("unkeyed_draw", """
        import numpy as np
        x = np.random.uniform(size=8)
    """, ["RA101"]),
    ("np_seed", """
        import numpy as np
        np.random.seed(0)
    """, ["RA101"]),
    ("argless_default_rng", """
        import numpy as np
        from numpy.random import default_rng
        a = np.random.default_rng()
        b = default_rng()
    """, ["RA101", "RA101"]),
    ("keyed_constructions", """
        import numpy as np
        rng = np.random.default_rng(7)
        gen = np.random.Generator(np.random.PCG64(3))
        x = rng.uniform(size=8)
    """, []),
    ("host_cast_outside_step", """
        def setup(x):
            return float(x)
    """, []),
    ("broad_excepts", """
        try:
            x = 1
        except Exception:
            pass
        try:
            y = 2
        except (ValueError, BaseException):
            pass
        try:
            z = 3
        except:
            pass
    """, ["RA104", "RA104", "RA104"]),
    ("concrete_except", """
        try:
            x = 1
        except (OSError, ValueError):
            pass
    """, []),
    ("syntax_error", "def broken(:\n", ["RA100"]),
    ("inline_allow", """
        try:
            x = 1
        except Exception:  # repro-allow: RA104 — trial sweep
            pass
    """, []),
    ("allow_is_per_rule", """
        import numpy as np
        x = np.random.uniform()  # repro-allow: RA104
    """, ["RA101"]),
]


@pytest.mark.parametrize("name,code,want", SHARED_SNIPPETS,
                         ids=[s[0] for s in SHARED_SNIPPETS])
def test_lint_matches_the_reference(tmp_path, name, code, want):
    path = plant(tmp_path, code)
    ours = lint_file(path, str(tmp_path))
    theirs = jax_astlint.lint_file(path, str(tmp_path))
    assert rules_of(theirs) == want
    assert [(f.rule, f.line, f.fingerprint) for f in ours] == \
        [(f.rule, f.line, f.fingerprint) for f in theirs]


#: torch plants: (name, code, the rules that fire)
TORCH_PLANTS = [
    ("randn_without_generator_is_RA101", """
        import torch
        x = torch.randn(3)
    """, ["RA101"]),
    ("keyed_torch_draws_pass", """
        import torch
        g = torch.Generator().manual_seed(0)
        x = torch.randn(3, generator=g)
        y = torch.randint(0, 5, (3,), generator=g)
        torch.nn.init.normal_(x, generator=g)
    """, []),
    ("global_reseeds_are_RA101", """
        import torch
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        torch.random.manual_seed(1)
    """, ["RA101", "RA101", "RA101"]),
    ("inplace_and_like_draws_are_RA101", """
        import torch
        w = torch.empty(3)
        w.normal_()
        torch.nn.init.uniform_(w)
        z = torch.rand_like(w)
        b = torch.bernoulli(w)
    """, ["RA101", "RA101", "RA101", "RA101"]),
    ("item_in_step_is_RA102", """
        def step(x):
            return x.sum().item()
    """, ["RA102"]),
    ("host_reads_in_a_built_closure_are_RA102", """
        import torch

        def make_decode_step(cfg):
            def decode(x):
                torch.cuda.synchronize()
                return x.cpu(), x.tolist(), x.numpy()
            return decode
    """, ["RA102", "RA102", "RA102", "RA102"]),
    ("int_of_step_index_in_step_passes", """
        def train_step(state, batch, step_idx):
            if int(step_idx) % 5 == 4:
                return state
            return batch
    """, []),
    ("item_outside_a_step_passes", """
        def report(x):
            return x.item()

        def make_train_step(cfg):
            n = cfg.item()
            def helper(x):
                return x.item()
            def train_step(x):
                return x
            return train_step
    """, []),
    ("compile_in_loop_is_RA103", """
        import torch
        for lr in (0.1, 0.2):
            f = torch.compile(lambda x: x * lr)
    """, ["RA103"]),
    ("compiled_def_and_kernel_build_in_loop_are_RA103", """
        import torch
        from repro_torch.kernels import build
        while True:
            @torch.compile
            def f(x):
                return x
            lib = build.load("gaia_select")
    """, ["RA103", "RA103"]),
    ("compile_outside_loop_passes", """
        import torch
        from repro_torch.kernels import build
        f = torch.compile(lambda x: x)
        build.build()
        for _ in range(3):
            def make():
                return torch.compile(lambda x: x)
    """, []),
    ("reraising_broad_except_passes", """
        def run(proc):
            try:
                proc.start()
            except BaseException:
                proc.kill()
                raise
    """, []),
    ("swallowing_broad_except_is_RA104", """
        def run(proc):
            try:
                proc.start()
            except Exception as e:
                raise RuntimeError("wrapped") from e
            try:
                proc.join()
            except Exception:
                proc.kill()
    """, ["RA104", "RA104"]),
]


@pytest.mark.parametrize("name,code,want", TORCH_PLANTS,
                         ids=[s[0] for s in TORCH_PLANTS])
def test_torch_plants_fire_their_rule(tmp_path, name, code, want):
    assert rules_of(lint_snippet(tmp_path, code)) == want


def test_rng_module_is_exempt_from_RA101(tmp_path):
    k = tmp_path / "src" / "repro_torch" / "kernels"
    k.mkdir(parents=True)
    (k / "rng.py").write_text("import torch\nx = torch.rand(3)\n")
    (k / "other.py").write_text("import torch\nx = torch.rand(3)\n")
    fs = astlint.lint_paths(str(tmp_path))
    assert [(f.rule, f.path) for f in fs] == [
        ("RA101", "src/repro_torch/kernels/other.py")]


def test_suppression_family_wildcard():
    assert is_suppressed("RA104", "pass  # repro-allow: RA*")
    assert not is_suppressed("GA201", "pass  # repro-allow: RA*")


def test_baseline_grandfathers_and_expires(tmp_path):
    f1 = Finding(rule="RA104", path="a.py", line=3, message="m",
                 source="except Exception:")
    f2 = Finding(rule="RA101", path="b.py", line=9, message="m",
                 source="torch.manual_seed(0)")
    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), [f1, f2])
    fps = load_baseline(str(bl))
    moved = Finding(rule="RA104", path="a.py", line=77, message="m",
                    source="except Exception:")
    assert apply_baseline([moved], fps) == [f2.fingerprint]   # f2 stale
    assert moved.baselined
    edited = Finding(rule="RA104", path="a.py", line=3, message="m",
                     source="except ValueError:")
    apply_baseline([edited], fps)
    assert not edited.baselined


# ---------------------------------------------------------------- PA30x

OPS_TEMPLATE = '''
import torch
from repro_torch.kernels import build, ref

launches = {}


def _launched(kernel, op, err):
    launches[kernel] = launches.get(kernel, 0) + 1


def launch_wired(x, out):
    _launched("wired", "wired_op", 0)


def wired_op(x):
    if x.device.type == "cpu":
        return ref.wired_op_ref(x)
    out = torch.empty_like(x)
    launch_wired(x, out)
    return out


def half_op(x):
    out = torch.empty_like(x)
    _launched("half", "half_op", 0)
    return out


def op_info(x):
    return x.shape
'''

REF_TEMPLATE = '''
def wired_op_ref(x):
    return x
'''

JAX_OPS_TEMPLATE = '''
import jax.numpy as jnp
from repro.kernels import ref as _ref


def _decide(op, *a, **k):
    return "oracle"


def wired_op(x):
    if _decide("wired_op", x.size) == "oracle":
        return _ref.wired_op_ref(x)
    return x


def half_op(x):
    return jnp.tanh(x)
'''


def plant_tree(tmp_path, *, bench="ops.wired_op", test_body="wired_op"):
    """The port's layout with one wired op and one half-wired op, and the
    reference's beside it (``tests/test_analysis.py``'s plant)."""
    k = tmp_path / "src" / "repro_torch" / "kernels"
    k.mkdir(parents=True)
    (k / "ops.py").write_text(OPS_TEMPLATE)
    (k / "ref.py").write_text(REF_TEMPLATE)
    b = tmp_path / "src" / "repro_torch" / "benchmarks"
    b.mkdir()
    (b / "kernels_bench.py").write_text(f"ROWS = ['{bench}']\n")
    (tmp_path / "chip_smoke.py").write_text("ops.wired_op(x)\n")
    jk = tmp_path / "src" / "repro" / "kernels"
    jk.mkdir(parents=True)
    (jk / "ops.py").write_text(JAX_OPS_TEMPLATE)
    (jk / "ref.py").write_text(REF_TEMPLATE)
    jb = tmp_path / "benchmarks"
    jb.mkdir()
    (jb / "kernels_bench.py").write_text(f"ROWS = ['{bench}']\n")
    t = tmp_path / "tests"
    t.mkdir()
    (t / "test_planted.py").write_text(f"# exercises {test_body}\n")
    return str(tmp_path)


def by_op(findings):
    out = {}
    for f in findings:
        out.setdefault(f.source, []).append(f.rule)
    return {k: sorted(v) for k, v in out.items()}


def test_public_ops_are_the_launching_functions():
    assert [w.name for w in parity.op_wirings(OPS_TEMPLATE)] == [
        "wired_op", "half_op"]


def test_half_wired_op_fails_every_leg_as_the_reference(tmp_path):
    root = plant_tree(tmp_path)
    ours, theirs = by_op(check_parity(root)), by_op(jax_check_parity(root))
    assert ours == theirs == {"half_op": ["PA301", "PA302", "PA303",
                                          "PA304"]}


def test_bench_row_and_test_reference_as_the_reference(tmp_path):
    root = plant_tree(tmp_path, bench="nothing", test_body="half_op only")
    ours, theirs = by_op(check_parity(root)), by_op(jax_check_parity(root))
    assert ours["wired_op"] == theirs["wired_op"] == ["PA303", "PA304"]


def test_missing_ops_module_is_one_PA301(tmp_path):
    fs = check_parity(str(tmp_path))
    assert rules_of(fs) == ["PA301"] and "not found" in fs[0].message


def test_untested_analysis_rule_is_PA305(tmp_path):
    root = plant_tree(tmp_path)
    (tmp_path / "tests" / "test_torch_analysis.py").write_text(
        "# this planted gate only ever mentions RA101\n")
    pa305 = {f.source for f in check_parity(root) if f.rule == "PA305"}
    assert pa305 == set(ALL_RULES) - {"RA101"}


# ---------------------------------------------------------------- JA40x

def audit_rules(rep):
    return sorted(f.rule for f in rep.findings)


def test_host_read_on_meta_is_JA401():
    def step(x):
        y = x * 2
        return y.sum().item()
    rep = audit_step(step, (torch.empty(4, device="meta"),))
    assert audit_rules(rep) == ["JA401"]
    assert rep.output is None and "_local_scalar_dense" in rep.host_sync


def test_host_read_ends_the_stand_in_trace_as_GA203_too():
    mesh = MetaMesh((2, 1, 1))

    def step(x):
        return x.cpu()
    trace, rep = step_audit.trace_and_audit(
        step, (torch.empty(4, device="meta"),), mesh)
    assert audit_rules(rep) == ["JA401"]
    ga = graph_audit.audit_trace(trace)
    assert [f.rule for f in ga.findings] == ["GA203"]


def test_widened_payload_on_the_wire_is_JA402():
    mesh = MetaMesh((2, 1, 1))
    x = torch.empty(3, 8, dtype=torch.bfloat16, device="meta")

    def widened(x):
        return mesh.all_gather(x.float().reshape(1, -1))

    def narrowed(x):                # accumulate in float32, ship bf16
        return mesh.all_gather((x.float() * 2).to(torch.bfloat16)
                               .reshape(1, -1))

    def computed(x):                # a float32 value the width carries
        return mesh.all_gather((x.float() * 2).reshape(1, -1))

    def reduced(x):                 # sums in float32 by design
        return mesh.all_reduce(x.float().reshape(1, -1))
    assert audit_rules(audit_step(widened, (x,), mesh=mesh)) == ["JA402"]
    for step in (narrowed, computed, reduced):
        rep = audit_step(step, (x,), mesh=mesh)
        assert rep.ok and rep.n_collectives == 1, step.__name__


def test_gossip_exchange_off_the_pod_axis_is_JA403():
    mesh = MetaMesh((2, 2, 1))

    def exchange(x):
        return mesh.all_reduce(x, "data")

    def step(x):
        y = mesh.all_reduce(x * 1, "data")      # the step's own: fine
        return step.exchange(y)
    step.exchange = exchange
    x = torch.empty(4, device="meta")
    rep = audit_step(step, (x,), mesh=mesh, gossip=True)
    assert audit_rules(rep) == ["JA403"]
    assert rep.collective_axes == ["data"] and step.exchange is exchange
    assert audit_step(step, (x,), mesh=mesh, gossip=False).ok


def test_large_closed_over_tensor_is_JA404():
    table = torch.ones(1 << 18)             # 1 MiB of float32
    small = torch.ones(16)

    def closed(x):
        return x + table

    def small_closed(x):
        return x + small
    x = torch.ones(1 << 18)
    assert audit_rules(audit_step(closed, (x,))) == ["JA404"]
    assert audit_step(small_closed, (torch.ones(16),)).ok
    assert audit_step(lambda x, t: x + t, (x, table)).ok     # an argument
    rep = audit_step(lambda x: x + torch.ones(1 << 18), (x,))  # made inside
    assert rep.ok and rep.max_const_bytes == 0
    # on meta, a tensor off meta enters from outside, whatever made it
    rep = audit_step(lambda x: x + table.to(x.device),
                     (torch.empty(1 << 18, device="meta"),))
    assert audit_rules(rep) == ["JA404"]


def test_draw_without_the_steps_generator_is_JA405():
    own = torch.Generator().manual_seed(1)

    def unkeyed(x):
        return x + torch.randn(x.shape)

    def keyed(x, gen):
        return x + torch.randn(x.shape, generator=gen)

    def foreign(x):
        return x + torch.randn(x.shape, generator=own)
    x = torch.ones(4)
    assert audit_rules(audit_step(unkeyed, (x,))) == ["JA405"]
    rep = audit_step(keyed, (x, torch.Generator().manual_seed(0)))
    assert rep.ok and rep.n_rng_prims == 1
    assert audit_rules(audit_step(foreign, (x,))) == ["JA405"]


def test_broken_combo_is_a_JA400_row():
    (combo, rep, ga), = audit_combos(
        combos=[("train_4k", "dpsgd", "not-a-topology")])
    assert combo == "train_4k/dpsgd/not-a-topology"
    assert rep.error is not None
    assert [f.rule for f in rep.findings] == ["JA400"] and ga is None


def test_the_sweep_and_the_stand_in_audit_one_trace_alike():
    """``audit_combos`` and the stand-in's ``dryrun_one`` trace and audit
    a combo through the same ``dryrun.trace_combo``: the same ops,
    collectives and (no) findings, each under its own tag."""
    from repro_torch.launch import dryrun
    (combo, rep, ga), = audit_combos(combos=[("train_4k", "dpsgd", "ring")])
    one = dryrun.dryrun_one(dryrun.SWEEP_ARCH, "train_4k", strategy="dpsgd",
                            topology="ring", reduced=True, verbose=False,
                            mesh=dryrun._parse_mesh(dryrun.SWEEP_MESH))
    sa = one["step_audit"]
    assert (sa["n_eqns"], sa["n_collectives"], sa["collective_axes"]) == (
        rep.n_eqns, rep.n_collectives, rep.collective_axes)
    assert sa["findings"] == rep.findings == ga.findings == []
    assert {k: v for k, v in one["audit"].items() if k != "tag"} == {
        k: v for k, v in ga.to_json().items() if k != "tag"}


def test_step_audit_to_json_has_the_references_keys():
    j = audit_step(lambda x: x * 2, (torch.ones(2),), tag="t").to_json()
    assert set(j) == {"tag", "ok", "n_eqns", "n_collectives",
                      "collective_axes", "max_const_bytes", "n_rng_prims",
                      "error", "findings"}
    assert j["ok"] and j["n_eqns"] == 1


# ---------------------------------------------------------- the real tree

def test_ast_lints_clean():
    assert [f.format() for f in astlint.lint_paths(REPO_ROOT)] == []


def test_registry_parity_clean():
    assert [f.format() for f in check_parity(REPO_ROOT)] == []


def test_rule_ids_unique_and_the_references_families():
    passes = (astlint.RULES, parity.RULES, graph_audit.RULES,
              step_audit.RULES)
    assert sum(len(p) for p in passes) == len(ALL_RULES)
    assert {r[:3] for r in ALL_RULES} == {"RA1", "PA3", "GA2", "JA4"}


def test_cli_gate_covers_the_reference_matrix(tmp_path):
    """``python -m repro_torch.analysis --all-combos``: every combo of the
    reference's ``iter_combos()`` traced, step- and graph-audited, no
    finding, no baseline."""
    code = ("import json; from repro.launch import dryrun as d; "
            "print(json.dumps(list(d.iter_combos())))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO_ROOT, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                PYTHONPATH=os.path.join(REPO_ROOT, "src")))
    assert r.returncode == 0, r.stderr
    want = [step_audit.combo_name(*c) for c in json.loads(r.stdout)]
    out = tmp_path / "AUDIT_TORCH.json"
    assert cli_main(["--all-combos", "-q", "--json", str(out),
                     "--baseline", str(tmp_path / "none.json")]) == 0
    audit = json.loads(out.read_text())
    assert audit["ok"] and audit["findings"] == []
    assert [row["combo"] for row in audit["coverage"]] == want
    for row in audit["coverage"]:
        assert row["jaxpr"]["rules"] == sorted(step_audit.RULES)
        assert row["jaxpr"]["error"] is None and row["jaxpr"]["findings"] == []
        assert row["hlo"]["rules"] == sorted(graph_audit.RULES)
        assert row["hlo"]["findings"] == []
    assert audit["rules"] == ALL_RULES
    assert not os.path.exists(os.path.join(
        REPO_ROOT, ".lint-deep-baseline-torch.json"))


def test_cli_baseline_update_and_stale(tmp_path):
    bl = tmp_path / "bl.json"
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "bad.py").write_text(
        "import torch\ntorch.manual_seed(0)\n")
    root = plant_tree(tmp_path / "tree")
    os.rename(tmp_path / "src" / "repro_torch" / "bad.py",
              tmp_path / "tree" / "src" / "repro_torch" / "bad.py")
    args = ["--root", root, "--skip-graph", "-q", "--baseline", str(bl),
            "--json", str(tmp_path / "a.json")]
    assert cli_main(args) == 1                  # RA101 and half_op's PA3xx
    assert cli_main(args + ["--update-baseline"]) == 0
    assert cli_main(args) == 0
    assert cli_main(args + ["--fail-on-stale"]) == 0
    os.remove(os.path.join(root, "src", "repro_torch", "bad.py"))
    assert cli_main(args) == 0                  # stale, but not failing
    assert cli_main(args + ["--fail-on-stale"]) == 1
    assert json.loads((tmp_path / "a.json").read_text())["stale_baseline"]


# ---------------------------------------------------------------- GA20x

def planted_trace(collectives, *, host_syncs=(), groups=None):
    from repro_torch.launch.meta import Collective, Trace
    return Trace([Collective(*c) for c in collectives],
                 ("pod", "data", "model"), 2, list(host_syncs),
                 groups or {"bfloat16": 8}, None, 1)


GOSSIP_ROW = ("all_gather", "pod", (1, 8), "bfloat16", 16)
LOSS = ("all_reduce", "pod", (1,), "float32", 4)


@pytest.mark.parametrize("extra,syncs,rule", [
    ([("all_reduce", "pod", (4, 8), "float32", 128)], (), "GA201"),
    ([("all_gather_dim", ("pod", "data"), (2, 8), "bfloat16", 32)], (),
     "GA201"),
    ([("all_gather", "pod", (1, 8), "float32", 32)], (), "GA202"),
    ([], ("aten._local_scalar_dense.default",), "GA203"),
    ([("gather", "pod", (1, 8), "bfloat16", 16)], (), "GA205"),
], ids=["GA201-reduction", "GA201-off-axis", "GA202", "GA203", "GA205"])
def test_graph_audit_plants(extra, syncs, rule):
    clean = graph_audit.audit_trace(planted_trace([GOSSIP_ROW, LOSS]),
                                    devices_per_pod=4, check_pod_axis=True,
                                    expect_donation=True)
    assert clean.ok                   # GA204 never fires: no alias to lose
    rep = graph_audit.audit_trace(
        planted_trace([GOSSIP_ROW, LOSS] + extra, host_syncs=syncs),
        devices_per_pod=4, check_pod_axis=True, expect_donation=True)
    assert rule in [f.rule for f in rep.findings]
    assert "GA204" not in [f.rule for f in rep.findings]
