"""The port's checkpoints, on the reference's layout: its own round trip
(bfloat16, float32 and int32 leaves, numpy and torch), a shape, count or
name mismatch refused, ``LATEST`` and retention; a checkpoint the
reference's ``save_tree`` wrote restores in the port and the reverse,
with the same leaf names in the same order; the port trainer's state
(params, AdamW's master, m and v, step) names and shapes its leaves as the
reference trainer's does; and a training run carries across packages: the
port's ``Trainer`` resumes from the reference ``Trainer``'s checkpoint at
step 10 and its losses for steps 10-19 stay within 1e-4 (relative) of the
reference's own resumed run, and the reverse (float32 on the CPU: the two
packages' steps differ by summation order only)."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.checkpoint import manager as R_manager
from repro.configs import ARCHS as R_ARCHS
from repro.runtime import Trainer as RTrainer
from repro.runtime import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import ARCHS
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_leaves_with_names


def _tree(rng):
    return {"params": {"embed": rng.randn(8, 4).astype(np.float32),
                       "prefix": [{"norm": rng.randn(4).astype(np.float32)}],
                       "stages": ({"w": rng.randn(2, 4, 4).astype(np.float32)},
                                  {"w": rng.randn(2, 4, 4).astype(np.float32)})},
            "opt": {"step": np.asarray(7, np.int32), "m": rng.randn(3).astype(np.float32)},
            "err": None}


def test_round_trip_of_numpy_and_torch_leaves(tmp_path):
    rng = np.random.RandomState(0)
    tree = _tree(rng)
    tree["params"]["bf16"] = torch.randn(5, 3).to(torch.bfloat16)
    tree["params"]["f32"] = torch.randn(2)
    save_tree(tree, tmp_path / "s", extras={"cursor": {"step": 3, "shard": 0}})
    manifest = json.loads((tmp_path / "s" / "manifest.json").read_text())
    assert [leaf["name"] for leaf in manifest["leaves"]] == [
        "opt/m", "opt/step", "params/bf16", "params/embed", "params/f32",
        "params/prefix/0/norm", "params/stages/0/w", "params/stages/1/w"]
    assert manifest["leaves"][2]["dtype"] == "float32"  # bf16 written as float32, exactly
    got, extras = restore_tree(tree, tmp_path / "s")
    assert extras == {"cursor": {"step": 3, "shard": 0}}
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        want = b.float().numpy() if isinstance(b, torch.Tensor) else b
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(a, want)
    assert got["err"] is None and not (tmp_path / "s.tmp").exists()


def test_mismatches_are_refused(tmp_path):
    tree = _tree(np.random.RandomState(1))
    save_tree(tree, tmp_path / "s")
    bad = _tree(np.random.RandomState(1))
    bad["params"]["embed"] = np.zeros((8, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        restore_tree(bad, tmp_path / "s")
    bad = _tree(np.random.RandomState(1))
    bad["params"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="leaves"):
        restore_tree(bad, tmp_path / "s")
    bad = _tree(np.random.RandomState(1))
    bad["params"]["prefix"] = [{"other": bad["params"]["prefix"][0]["norm"]}]
    with pytest.raises(ValueError, match="leaf"):
        restore_tree(bad, tmp_path / "s")


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(_tree(np.random.RandomState(0))) is None
    for step in range(5):
        tree = _tree(np.random.RandomState(step))
        mgr.save(step, tree, extras={"cursor": {"step": step, "shard": 0}})
    assert mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "LATEST", "step_00000003", "step_00000004"]
    got, extras = mgr.restore_latest(_tree(np.random.RandomState(9)))
    assert extras["step"] == 4 and extras["cursor"]["step"] == 4
    np.testing.assert_array_equal(got["params"]["embed"],
                                  _tree(np.random.RandomState(4))["params"]["embed"])


def test_reference_checkpoints_restore_in_the_port_and_back(tmp_path):
    tree = _tree(np.random.RandomState(2))
    jtree = jax.tree.map(jnp.asarray, tree)
    R_manager.save_tree(jtree, tmp_path / "ref", extras={"step": 1})
    save_tree(tree, tmp_path / "port", extras={"step": 1})
    names = [[leaf["name"] for leaf in json.loads((tmp_path / d / "manifest.json").read_text())
              ["leaves"]] for d in ("ref", "port")]
    assert names[0] == names[1] == [n for n, _ in tree_leaves_with_names(tree)]
    got, extras = restore_tree(tree, tmp_path / "ref")
    assert extras == {"step": 1}
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    back, _ = R_manager.restore_tree(jtree, tmp_path / "port")
    for a, b in zip(jax.tree.leaves(back), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _tiny(name="h2o-danube-3-4b"):
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=128, n_heads=2, n_kv_heads=1,
              head_dim=16)
    return (dataclasses.replace(ARCHS[name].reduced(), **kw),
            dataclasses.replace(R_ARCHS[name].reduced(), **kw))


@pytest.mark.parametrize("name,compress", [("h2o-danube-3-4b", False),
                                           ("recurrentgemma-2b", True),
                                           ("granite-moe-3b-a800m", False)])
def test_trainer_state_has_the_references_leaves(tmp_path, name, compress):
    cfg, rcfg = _tiny(name)
    tc = dict(seq_len=8, batch=2, total_steps=4, checkpoint_every=4, grad_compression=compress)
    ours = Trainer(cfg, TrainerConfig(**tc), tmp_path / "a", device="cpu").state_numpy()
    theirs = RTrainer(rcfg, RTrainerConfig(**tc), tmp_path / "b").state
    mine = tree_leaves_with_names(ours)
    ref, _ = R_manager._flatten_with_names(theirs)
    assert [n for n, _ in mine] == [n for n, _ in ref]
    assert [np.shape(v) for _, v in mine] == [np.shape(v) for _, v in ref]


def _losses(metrics, lo):
    return {m["step"]: m["loss"] for m in metrics if m["step"] >= lo}


def test_port_trainer_resumes_a_reference_checkpoint(tmp_path):
    cfg, rcfg = _tiny()
    tc = dict(seq_len=16, batch=4, total_steps=20, checkpoint_every=10, lr=5e-3)
    RTrainer(rcfg, RTrainerConfig(**tc), tmp_path / "ref").run(n_steps=10)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    theirs = RTrainer(rcfg, RTrainerConfig(**tc), tmp_path / "ref")
    ours = Trainer(cfg, TrainerConfig(**tc), tmp_path / "port", device="cpu")
    assert ours.start_step == theirs.start_step == 10
    want, got = _losses(theirs.run(), 10), _losses(ours.run(), 10)
    assert sorted(got) == sorted(want) == list(range(10, 20))
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=1e-4), step


def test_reference_trainer_resumes_a_port_checkpoint(tmp_path):
    cfg, rcfg = _tiny()
    tc = dict(seq_len=16, batch=4, total_steps=20, checkpoint_every=10, lr=5e-3)
    Trainer(cfg, TrainerConfig(**tc), tmp_path / "port", device="cpu").run(n_steps=10)
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ours = Trainer(cfg, TrainerConfig(**tc), tmp_path / "port", device="cpu")
    theirs = RTrainer(rcfg, RTrainerConfig(**tc), tmp_path / "ref")
    assert ours.start_step == theirs.start_step == 10
    want, got = _losses(theirs.run(), 10), _losses(ours.run(), 10)
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=1e-4), step
