"""The port's checkpoints against the reference's (``repro.checkpointing``),
on the CPU: each package restores the other's files bit for bit, the
meta file is byte for byte the reference's, and the port needs no
``msgpack`` package (its own codec is held against ``msgpack`` here)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpointing as jax_ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jax_model
from repro_torch import checkpointing as ckpt
from repro_torch import pytree
from repro_torch.checkpointing import checkpoint as ckpt_mod
from repro_torch.configs.base import CommConfig
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import model

REPO = Path(__file__).resolve().parents[1]


def _trees():
    """The reference's bf16 parameters of the reduced recurrentgemma (two
    RG-LRU layers: no body, ``p["body"]`` None; float32 gates among bf16
    weights), with an int32 leaf added, and the port's copy."""
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-2b").reduced(),
                               dtype="bfloat16")
    jp = jax_model.init_model(jax.random.PRNGKey(3), jcfg)
    jp["step"] = jnp.arange(5, dtype=jnp.int32)
    assert jp["body"] is None
    p = model.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")
    return jp, p


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf (bfloat16 as int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_leaves(port_tree, jax_tree):
    got, want = pytree.leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_leaf_order_and_treedef_follow_jax():
    jp, p = _trees()
    _same_leaves(p, jp)
    assert pytree.treedef_str(p) == str(jax.tree_util.tree_structure(jp))
    odd = {"b": [1, None, (2,)], "a": {"z": 3, "y": None}, "c": [],
           "e": ()}
    assert pytree.treedef_str(odd) == str(jax.tree_util.tree_structure(odd))
    assert pytree.leaves(odd) == jax.tree_util.tree_leaves(odd)


def test_port_save_reference_restore(tmp_path):
    jp, p = _trees()
    target = ckpt.save(str(tmp_path), p, step=7)
    assert target == os.path.join(str(tmp_path), "ckpt_7")
    back = jax_ckpt.restore(str(tmp_path), jp, step=7)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the meta file: the reference's own bytes for the same tree
    jax_ckpt.save(str(tmp_path / "ref"), jp, step=7)
    mine = (tmp_path / "ckpt_7" / "meta.msgpack").read_bytes()
    theirs = (tmp_path / "ref" / "ckpt_7" / "meta.msgpack").read_bytes()
    assert mine == theirs
    meta = ckpt.load_meta(str(tmp_path), step=7)
    assert meta == msgpack.unpackb(theirs)
    assert meta["n_leaves"] == len(pytree.leaves(p)) and meta["step"] == 7
    assert "bfloat16" in meta["dtypes"] and "int32" in meta["dtypes"]


def test_reference_save_port_restore(tmp_path):
    jp, p = _trees()
    jax_ckpt.save(str(tmp_path), jp)                 # no step: path itself
    like = pytree.tree_map(torch.zeros_like, p)
    back = ckpt.restore(str(tmp_path), like)
    assert back["body"] is None and list(back) == list(p)
    _same_leaves(back, jp)
    assert back["step"].dtype == torch.int32


def test_restore_refuses_another_tree(tmp_path):
    _, p = _trees()
    ckpt.save(str(tmp_path), p, step=1)
    fewer = dict(p)
    del fewer["step"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), fewer, step=1)
    reshaped = dict(p, step=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), reshaped, step=1)


def test_train_state_round_trip(tmp_path):
    """An AD-PSGD train state (params, vel, the per-dtype snapshot
    buffers) saved and restored, every bit."""
    cfg = dataclasses.replace(registry.get_config("qwen3-0.6b").reduced(),
                              dtype="bfloat16")
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    state = steps.make_train_state(p, CommConfig(strategy="adpsgd"), 2)
    assert sorted(state["snaps"]) == ["bfloat16", "float32"]
    ckpt.save(str(tmp_path), state, step=3)
    back = ckpt.restore(str(tmp_path), pytree.tree_map(torch.empty_like,
                                                       state), step=3)
    for g, w in zip(pytree.leaves(back), pytree.leaves(state)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_latest_step_agrees(tmp_path):
    _, p = _trees()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.latest_step(str(tmp_path)) == \
        jax_ckpt.latest_step(str(tmp_path)) is None
    for s in (3, 10, 7):
        ckpt.save(str(tmp_path), {"w": p["embed"]["table"]}, step=s)
    ckpt.save(str(tmp_path), {"w": p["embed"]["table"]}, step=10)
    assert ckpt.latest_step(str(tmp_path)) == \
        jax_ckpt.latest_step(str(tmp_path)) == 10
    assert sorted(os.listdir(tmp_path)) == ["ckpt_10", "ckpt_3", "ckpt_7"]


@pytest.mark.parametrize("obj", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, None, True, False, "", "a" * 31, "a" * 32,
    "a" * 255, "a" * 256, "a" * 65536, "é", [], ["x"] * 15, ["x"] * 16,
    ["x"] * 70000, {}, {str(i): i for i in range(15)},
    {str(i): None for i in range(16)},
    {"treedef": "PyTreeDef({'a': *})", "n_leaves": 3, "step": None,
     "dtypes": ["float32", "bfloat16"]}])
def test_msgpack_subset_matches_msgpack(obj):
    assert ckpt_mod.packb(obj) == msgpack.packb(obj)
    assert ckpt_mod.unpackb(msgpack.packb(obj)) == obj


def test_port_imports_no_msgpack():
    code = ("import sys; import repro_torch.checkpointing, "
            "repro_torch.launch.steps, "
            "repro_torch.examples.train_lm_decentralized\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('msgpack', 'jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
