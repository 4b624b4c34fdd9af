"""The port's checkpoints (repro_torch.checkpoint): round trips of tensor
trees and of a whole TrainState (bf16 leaves included), keep-k and
latest-step, corruption and partial writes, the async manager, and the
on-disk format against the JAX reference's: the same manifest and leaf
files for a tree of the same leaves, readable by either package."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.training import AdamWConfig, init_train_state


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(3, 4, generator=g),
            "b": {"c": torch.randn(5, generator=g).to(torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "e": [torch.randn(2, generator=g), torch.randn(1, 1, generator=g)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_round_trip_with_bf16_leaves(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 3, tree)
    assert path.name == "step_000000003"
    manifest = json.loads((path / "manifest.json").read_text())
    kinds = {m["dtype"]: m["raw_encoded"] for m in manifest["leaves"]}
    assert kinds == {"float32": False, "bfloat16": True, "int32": False}
    _same(restore_checkpoint(tmp_path, 3, _tree(seed=1)), tree)


def test_train_state_round_trip_loads_the_module_in_place(tmp_path):
    cfg = get_smoke_config("smollm_360m")
    opt = AdamWConfig(state_dtype="bfloat16")
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(0.5)
    for n in state.opt.m:
        state.opt.m[n].fill_(0.25)
        state.opt.v[n].fill_(0.125)
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(9, dtype=torch.int32)))
    save_checkpoint(tmp_path, 9, state)
    other = init_train_state(cfg, opt, torch.Generator().manual_seed(1))
    restored = restore_checkpoint(tmp_path, 9, other)
    assert restored.params is other.params          # loaded in place
    assert int(restored.opt.step) == 9
    for (n, p), q in zip(state.params.named_parameters(),
                         restored.params.parameters()):
        assert torch.equal(p, q), n
    for which in ("m", "v"):
        for n, t in getattr(state.opt, which).items():
            got = getattr(restored.opt, which)[n]
            assert got.dtype == torch.bfloat16 and torch.equal(t, got)
    manifest = json.loads((tmp_path / "step_000000009" / "manifest.json")
                          .read_text())
    assert manifest["treedef"].startswith("TrainState(params=LM{tok: *")
    assert len(manifest["leaves"]) == 3 * len(state.opt.m) + 1


def test_keep_k_and_latest(tmp_path):
    assert latest_step(tmp_path / "missing") is None
    for s in range(1, 6):
        save_checkpoint(tmp_path, s, _tree(), keep=2)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_000000004", "step_000000005"]
    assert latest_step(tmp_path) == 5


def test_corruption_is_detected(tmp_path):
    path = save_checkpoint(tmp_path, 1, _tree())
    leaf = path / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(tmp_path, 1, _tree())
    restore_checkpoint(tmp_path, 1, _tree(), verify=False)


def test_partial_writes_are_ignored(tmp_path):
    save_checkpoint(tmp_path, 4, _tree())
    (tmp_path / "step_000000009.tmp-0badf00d").mkdir()   # crashed write
    (tmp_path / "step_000000010").mkdir()                 # no manifest
    assert latest_step(tmp_path) == 4
    step, tree = CheckpointManager(tmp_path).restore_latest(_tree(1))
    assert step == 4
    _same(tree, _tree())


def test_leaf_count_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        restore_checkpoint(tmp_path, 1, {"a": torch.zeros(3, 4)})


def test_async_manager_copies_before_the_caller_moves_on(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, every=2)
    tree = _tree()
    before = {k: v.clone() for k, v in tree.items() if k == "a"}
    assert mgr.maybe_save(1, tree) is False
    assert mgr.maybe_save(2, tree) is True
    tree["a"].add_(1.0)                # the next step updates in place
    mgr.wait()
    step, restored = mgr.restore_latest(_tree(1))
    assert step == 2 and torch.equal(restored["a"], before["a"])


def test_async_manager_reraises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(blocker, every=1)
    assert mgr.maybe_save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                         # reported once


def test_format_matches_the_reference(tmp_path):
    """For the same leaves the port writes the reference's manifest and
    leaf files, and each package restores the other's checkpoint."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.checkpoint import save_checkpoint as jsave

    tree = _tree()
    as_np = jax.tree_util.tree_map(
        lambda t: np.asarray(jax.numpy.asarray(t.float().numpy(),
                                               str(t.dtype)[6:])), tree)
    jpath = jsave(tmp_path / "ref", 2, as_np)
    tpath = save_checkpoint(tmp_path / "port", 2, tree)
    jm = json.loads((jpath / "manifest.json").read_text())
    tm = json.loads((tpath / "manifest.json").read_text())
    assert jm.keys() == tm.keys()
    assert jm["leaves"] == tm["leaves"]
    for meta in tm["leaves"]:
        assert (jpath / meta["name"]).read_bytes() == \
            (tpath / meta["name"]).read_bytes()
    _same(restore_checkpoint(tmp_path / "ref", 2, _tree(1)), tree)
    back = jrestore(tmp_path / "port", 2, as_np)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(as_np)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_non_tensor_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError, match="tensors"):
        save_checkpoint(tmp_path, 1, {"a": np.zeros(3)})
    assert latest_step(tmp_path) is None
