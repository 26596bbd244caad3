"""Sharded state on real process groups: 4 gloo ranks on the CPU (the
harness of ``test_torch_distributed.py``).

* ``pod_psum_int8`` on a (pod = 2, data = 2) mesh with the spec ("pod",
  "data"), a 2-D tensor split on both dims so that each device quantizes
  its own block, equals the reference's on 4 JAX host devices (a
  subprocess with ``--xla_force_host_platform_device_count=4``) bit for
  bit;
* elastic restore: a checkpoint saved from a (2, 2) mesh over ("data",
  "model") restores onto a (2, 2) mesh over ("model", "data"), with the
  placements the rules give there, to the same values.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import ROOT, _run  # noqa: E402


REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.optim.compression import pod_psum_int8
    x = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    spec = P("pod", "data")
    xs = jax.device_put(x, NamedSharding(mesh, spec))
    np.save(sys.argv[2], np.asarray(pod_psum_int8(xs, mesh, spec)))
""")


def _psum_worker(rank, x_path, out_path):
  from repro_torch.launch import mesh
  from repro_torch.optim.compression import pod_psum_int8
  from repro_torch.sharding import specs

  m = mesh.make_debug_mesh((2, 2), ("pod", "data"), device_type="cpu")
  spec = ("pod", "data")
  x = specs.distribute(torch.from_numpy(np.load(x_path)), m, spec)
  out = pod_psum_int8(x, m, spec)
  assert out.placements == specs.placements(m, spec)
  full = out.full_tensor()
  if rank == 0:
    np.save(out_path, full.numpy())


def test_pod_psum_int8_equals_the_references_bit_for_bit(tmp_path):
  rng = np.random.default_rng(0)
  # each device's block has its own amax: the blocks differ in scale
  x = (rng.normal(size=(8, 6)) * np.array([[1.0], [1.0], [1.0], [1.0],
                                            [30.0], [30.0], [30.0], [30.0]])
       * np.array([1, 1, 1, 0.01, 0.01, 0.01])).astype(np.float32)
  x_path, ref_path, out_path = (str(tmp_path / n) for n in
                                ("x.npy", "ref.npy", "out.npy"))
  np.save(x_path, x)
  env = dict(os.environ, JAX_PLATFORMS="cpu",
             PYTHONPATH=os.path.join(ROOT, "src"))
  proc = subprocess.run([sys.executable, "-c", REF_PSUM, x_path, ref_path],
                        env=env, capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr[-2000:]
  _run(_psum_worker, x_path, out_path)
  ref, got = np.load(ref_path), np.load(out_path)
  assert got.dtype == ref.dtype == np.float32
  np.testing.assert_array_equal(got, ref)


def _elastic_worker(rank, directory):
  from repro_torch.checkpoint import checkpointer as ckpt
  from repro_torch.configs.smoke import smoke_config
  from repro_torch.launch import mesh
  from repro_torch.models import transformer as T
  from repro_torch.sharding import specs

  cfg = dataclasses.replace(smoke_config("llama3.2-1b"), fsdp=True)
  model = T.init_params(cfg, 0, "cpu")
  full = {n: p.detach().clone() for n, p in model.named_parameters()}
  old = mesh.make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
  new = mesh.make_debug_mesh((2, 2), ("model", "data"), device_type="cpu")
  old_rules = specs.ShardingRules(old, fsdp=True)
  new_rules = specs.ShardingRules(new, fsdp=True)
  pspecs = specs.param_specs_tree(old_rules, model)
  specs.distribute_model(model, old, pspecs)
  ckpt.save(directory, 7, {"params": dict(model.named_parameters())},
            {"step": 7})
  new_specs = specs.param_specs_tree(new_rules, T.init_params(cfg, 0,
                                                              "meta"))
  places = {"params": {n: specs.placements(new, s)
                       for n, s in new_specs.items()}}
  tree, meta = ckpt.restore(directory, {"params": full}, mesh=new,
                            placements=places)
  assert meta == {"step": 7}
  moved = 0
  for n, t in tree["params"].items():
    assert t.device_mesh is new and t.placements == places["params"][n]
    assert torch.equal(t.full_tensor(), full[n]), n
    moved += t.placements != model.get_parameter(n).placements
  assert moved > 0


def test_elastic_restore_onto_another_mesh(tmp_path):
  _run(_elastic_worker, str(tmp_path))
  from repro_torch.checkpoint import checkpointer as ckpt
  assert ckpt.all_steps(str(tmp_path)) == [7]


