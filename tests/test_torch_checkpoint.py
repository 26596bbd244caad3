"""The port's checkpointer: round trips, atomic replace, keep-N, the
asynchronous saver, and a resumed training run.

Against the reference's on-disk layout (``step_<n>/manifest.json`` and
``arrays.npz``, bf16 stored as uint16): the reference's ``restore`` reads
what the port saved.  A run of 4 train steps on the smoke config equals,
bit for bit, a run of 2 steps, a restore and 2 more.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


def _tree(seed: int = 0) -> dict:
  g = torch.Generator().manual_seed(seed)
  return {"params": {"layers.0.w": torch.randn(3, 4, generator=g),
                     "emb": torch.randn(5, 2, generator=g).bfloat16()},
          "opt": {"adam": {"step": torch.tensor(7, dtype=torch.int32),
                           "m": {"x": torch.randn(6, generator=g)}}}}


def _assert_trees_equal(a: dict, b: dict) -> None:
  assert sorted(a) == sorted(b)
  for k in a:
    if isinstance(a[k], dict):
      _assert_trees_equal(a[k], b[k])
    else:
      assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_save_restore_round_trip_with_bf16(tmp_path):
  tree = _tree()
  path = ckpt.save(str(tmp_path), 12, tree, {"step": 12, "note": "x"})
  assert path.endswith("step_0000000012")
  manifest = json.load(open(os.path.join(path, "manifest.json")))
  assert manifest["dtypes"]["params/emb"] == "bfloat16"
  assert "opt/adam/m/x" in manifest["keys"]
  with np.load(os.path.join(path, "arrays.npz")) as data:
    assert data["params/emb"].dtype == np.uint16
  like = _tree(seed=1)
  got, meta = ckpt.restore(str(tmp_path), like)
  assert meta == {"step": 12, "note": "x"}
  _assert_trees_equal(got, tree)
  # map_location places every leaf there, in the prototype's dtype.
  got, _ = ckpt.restore(str(tmp_path), like, step=12, map_location="cpu")
  _assert_trees_equal(got, tree)


def test_reference_reads_the_ports_checkpoint(tmp_path):
  tree = _tree()
  ckpt.save(str(tmp_path), 3, tree)
  like = {"params": {"layers.0.w": jnp.zeros((3, 4), jnp.float32),
                     "emb": jnp.zeros((5, 2), jnp.bfloat16)},
          "opt": {"adam": {"step": jnp.zeros((), jnp.int32),
                           "m": {"x": jnp.zeros(6, jnp.float32)}}}}
  got, _ = jckpt.restore(str(tmp_path), like)
  np.testing.assert_array_equal(np.asarray(got["params"]["emb"],
                                           np.float32),
                                tree["params"]["emb"].float().numpy())
  np.testing.assert_array_equal(np.asarray(got["params"]["layers.0.w"]),
                                tree["params"]["layers.0.w"].numpy())
  assert int(got["opt"]["adam"]["step"]) == 7


def test_restore_raises_without_checkpoints(tmp_path):
  assert ckpt.latest_step(str(tmp_path / "none")) is None
  with pytest.raises(FileNotFoundError):
    ckpt.restore(str(tmp_path), _tree())


def test_atomic_replace_and_keep_n(tmp_path):
  d = str(tmp_path)
  os.makedirs(os.path.join(d, "tmp.5"))      # a save cut off mid-write
  for step in range(1, 6):
    ckpt.save(d, step, _tree(step), {"step": step}, keep=2)
  assert ckpt.all_steps(d) == [4, 5] and ckpt.latest_step(d) == 5
  assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
  ckpt.save(d, 5, _tree(9), {"step": 5}, keep=2)   # the same step again
  got, _ = ckpt.restore(d, _tree())
  _assert_trees_equal(got, _tree(9))


def test_async_saver_snapshots_and_surfaces_errors(tmp_path):
  saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
  tree = _tree()
  want = {k: v.clone() for k, v in tree["params"].items()}
  saver.save(1, tree, {"step": 1})
  tree["params"]["layers.0.w"].add_(1.0)     # mutated after save returns
  saver.save(2, tree, {"step": 2})           # waits for the first
  saver.wait()
  assert ckpt.all_steps(str(tmp_path)) == [1, 2]
  got, _ = ckpt.restore(str(tmp_path), _tree(), step=1)
  assert torch.equal(got["params"]["layers.0.w"], want["layers.0.w"])
  blocked = tmp_path / "file"
  blocked.write_text("")
  bad = ckpt.AsyncCheckpointer(str(blocked / "sub"))
  bad.save(1, tree)
  with pytest.raises(OSError):
    bad.wait()
  bad.wait()   # the error is raised once


def test_four_steps_equal_two_restore_two(tmp_path, capsys):
  common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--trim-frac", "0.1", "--lr", "1e-2"]
  whole = train.main(common + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "a"), "--ckpt-every", "1"])
  # Saved asynchronously after each step, the newest 3 kept.
  assert ckpt.all_steps(str(tmp_path / "a")) == [2, 3, 4]
  # Two steps of a 4-step schedule, then a new process's worth of state.
  cfg = whole["cfg"]
  first = train.Trainer(cfg, whole["trainer"].opt_cfg, batch=2, seq=16,
                        ckpt_dir=str(tmp_path / "b"), total_steps=4,
                        device="cpu", smoke=True)
  state = first.init_or_restore()
  first.run(state, 2)
  assert ckpt.latest_step(str(tmp_path / "b")) == 2
  second = train.Trainer(cfg, whole["trainer"].opt_cfg, batch=2, seq=16,
                         ckpt_dir=str(tmp_path / "b"), total_steps=4,
                         device="cpu", smoke=True)
  state = second.init_or_restore()
  assert state.step == 2 and "resumed from step 2" in capsys.readouterr().out
  state, metrics = second.run(state, 2)
  assert state.step == 4
  assert float(metrics["loss"]) == float(whole["metrics"]["loss"])
  want = dict(whole["state"].model.named_parameters())
  for name, p in state.model.named_parameters():
    assert torch.equal(p, want[name]), name
  _assert_trees_equal(state.opt_state, whole["state"].opt_state)
