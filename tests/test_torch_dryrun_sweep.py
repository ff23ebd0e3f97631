"""The dry-run stand-in's audit matrix on the CPU, with no card: ``python
-m repro_torch.launch.dryrun --all-combos`` traces the reduced qwen3-0.6b
on the reference's sweep mesh (2 pods x 2 data x 2 model) under every
strategy x topology combo plus the prefill and decode steps: 22 rows,
each ``ok``, each gossip row's exchange on the pod axis alone, above 0
bytes and free of findings.  Then the port's ``roofline`` bench reads the
rows the sweep wrote, and a second run of the sweep takes them from the
cache (the per-combo file names are the reference's ``cfg_tag``)."""
import json

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.benchmarks import roofline
from repro_torch.launch import dryrun
from repro_torch.launch.steps import GOSSIP_STRATEGIES


def test_all_combos_sweep(tmp_path, capsys):
    assert dryrun.main(["--all-combos", "--outdir", str(tmp_path)]) == 0
    rows = [json.loads(p.read_text()) for p in sorted(tmp_path.glob(
        "*.json"))]
    assert len(rows) == 22 and all(r["ok"] for r in rows)
    assert {r["mesh"] for r in rows} == {"2x2x2"}
    gossip = [r for r in rows if r["strategy"] in GOSSIP_STRATEGIES]
    assert len(gossip) == 16
    for r in gossip:
        pex = r["pod_exchange"]
        assert pex["pod_axis_only"] and pex["unparsed_collectives"] == 0
        assert pex["permute_cross_gbytes_per_dev"] > 0
        assert pex["reduce_cross_gbytes_per_dev"] < \
            pex["permute_cross_gbytes_per_dev"]
        assert r["audit"]["findings"] == []
    assert all(r["audit"]["findings"] == [] for r in rows)
    table = roofline.run(combo_dir=str(tmp_path))
    assert len(table) == 22 and all(t["ok"] for t in table)
    assert {t["bottleneck"] for t in table} <= {"compute", "memory",
                                                "collective"}
    capsys.readouterr()
    assert dryrun.main(["--all-combos", "--outdir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count(": cached (ok)") == 22
