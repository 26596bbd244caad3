"""The port's sharding rules against the reference's, leaf for leaf.

For all ten full configs, on stand-ins of the production meshes (16, 16)
over (data, model) and (2, 16, 16) over (pod, data, model) (only the
sizes matter to a spec), with ``fsdp`` as each config has it and flipped:
every parameter leaf's spec equals the reference's ``param_spec`` with
its leading ``reps`` entry dropped (the port keeps one module per layer,
``models/convert.py::split_layers``); likewise every cache leaf at
``decode_32k`` and ``long_500k``, the batch specs at all four shapes, and
the AdamW state's specs.  The reference's shapes come from
``jax.eval_shape``, the port's from the ``meta`` device.  Then the
counterparts of the reference's ``tests/test_sharding.py`` rule tests,
``placements``, and the identity of ``shard_activation`` without rules.
Exact equality throughout (specs are names, not numbers).
"""

from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs.base import ASSIGNED, get_config  # noqa: E402
from repro_torch.launch import shapes, steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
  """Only what a spec reads: the axis names and sizes (the reference's
  ``tests/test_sharding.py`` stand-in)."""

  def __init__(self, shape: dict):
    self.shape = dict(shape)
    self.axis_names = tuple(shape)


def _rules(pkg, mesh: str, fsdp: bool):
  m = FakeMesh(MESHES[mesh])
  data = tuple(a for a in m.axis_names if a in ("pod", "data"))
  return pkg.ShardingRules(m, data_axes=data, model_axis="model",
                           fsdp=fsdp)


def _norm(spec, ndim: int) -> tuple:
  """A reference ``PartitionSpec`` as the port's tuple, one entry a dim
  (``P()`` and shorter specs padded with None)."""
  parts = tuple(spec)
  return parts + (None,) * (ndim - len(parts))


def _layer_slots(cfg):
  """(segment, key within the segment, rep) of each port layer, in the
  order ``split_layers`` runs them."""
  slots = []
  for si, (cycle, reps) in enumerate(cfg.plan_segments()):
    for rep in range(reps):
      for j, kind in enumerate(cycle):
        slots.append((f"seg{si}", f"l{j}_{kind}", rep))
  return slots


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
  cfg = jget_config(arch)
  return jax.eval_shape(
      lambda: jtransformer.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
  return T.init_params(get_config(arch), 0, "meta")


def _ref_leaf_path(cfg, name: str) -> tuple[str, bool]:
  """The reference's path of a port parameter, and whether it is a layer
  leaf (stacked under a leading reps dim)."""
  parts = name.split(".")
  if parts[0] != "layers":
    return "/".join(parts), False
  seg, key, _ = _layer_slots(cfg)[int(parts[1])]
  return "/".join([seg, key] + parts[3:]), True


def _ref_flat(tree) -> dict:
  flat = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path)
    flat[key] = leaf
  return flat


CASES = [(arch, mesh, flip) for arch in ASSIGNED for mesh in MESHES
         for flip in (False, True)]


@pytest.mark.parametrize("arch,mesh,flip", CASES)
def test_param_specs_equal_the_references(arch, mesh, flip):
  cfg = get_config(arch)
  fsdp = cfg.fsdp != flip
  port = specs.param_specs_tree(_rules(specs, mesh, fsdp), _port_model(arch))
  jrules = _rules(jspecs, mesh, fsdp)
  ref = _ref_flat(_ref_params(arch))
  assert len(port) == sum(1 for _ in _port_model(arch).parameters())
  for name, p in _port_model(arch).named_parameters():
    path, stacked = _ref_leaf_path(cfg, name)
    leaf = ref[path]
    want = _norm(jspecs.param_spec(jrules, path, leaf.shape), leaf.ndim)
    if stacked:
      assert want[0] is None, (path, want)
      want = want[1:]
    assert tuple(leaf.shape[stacked:]) == tuple(p.shape), name
    assert port[name] == want, (name, port[name], want)


@functools.lru_cache(maxsize=None)
def _ref_caches(arch: str, shape: str):
  cfg, cell = jget_config(arch), jshapes.SHAPES[shape]
  return jax.eval_shape(lambda: jtransformer.init_cache(
      cfg, cell.global_batch, cell.seq_len))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_equal_the_references(arch, mesh, shape):
  cfg = get_config(arch)
  rules, jrules = _rules(specs, mesh, cfg.fsdp), _rules(jspecs, mesh,
                                                        cfg.fsdp)
  caches = shapes.cache_specs(cfg, shapes.SHAPES[shape])
  port = specs.cache_specs_tree(rules, caches)
  ref = _ref_caches(arch, shape)
  ref_specs = jspecs.cache_specs_tree(jrules, ref)
  for i, (seg, key, _) in enumerate(_layer_slots(cfg)):
    si = int(seg[3:])
    assert sorted(port[i]) == sorted(ref[si][key]), (i, key)
    for leaf, got in port[i].items():
      jleaf = ref[si][key][leaf]
      want = _norm(ref_specs[si][key][leaf], jleaf.ndim)
      assert want[0] is None and tuple(jleaf.shape[1:]) == tuple(
          caches[i][leaf].shape), (i, leaf)
      assert got == want[1:], (i, leaf, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_specs_equal_the_references(arch, mesh):
  cfg = get_config(arch)
  rules, jrules = _rules(specs, mesh, cfg.fsdp), _rules(jspecs, mesh,
                                                        cfg.fsdp)
  for name, cell in shapes.SHAPES.items():
    port = specs.batch_specs_tree(rules, shapes.batch_specs(cfg, cell))
    jbatch = jshapes.batch_specs(jget_config(arch), jshapes.SHAPES[name])
    ref = jspecs.batch_specs_tree(jrules, jbatch)
    assert sorted(port) == sorted(ref)
    for k, spec in port.items():
      assert spec == _norm(ref[k], jbatch[k].ndim), (name, k)
    tok = shapes.decode_token_specs(cfg, cell)
    jtok = jshapes.decode_token_specs(jget_config(arch),
                                      jshapes.SHAPES[name])
    assert specs.batch_spec(rules, tok.shape) == _norm(
        jrules.spec(jtok.shape, (jrules.data_axes,) + (None,) *
                    (jtok.ndim - 1)), jtok.ndim)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_opt_state_specs_equal_the_references(arch, mesh):
  cfg = get_config(arch)
  rules, jrules = _rules(specs, mesh, cfg.fsdp), _rules(jspecs, mesh,
                                                        cfg.fsdp)
  model = _port_model(arch)
  opt_cfg = adamw.AdamWConfig(
      moment_dtype="bfloat16" if cfg.fsdp else "float32")
  opt = steps.init_opt_state(cfg, opt_cfg, dict(model.named_parameters()))
  pspecs = specs.param_specs_tree(rules, model)
  port = specs.opt_state_specs_tree(rules, opt, pspecs)
  jparams = _ref_params(arch)
  jopt = jax.eval_shape(lambda p: jsteps.init_opt_state(
      jget_config(arch), jadamw.AdamWConfig(), p), jparams)
  ref = jspecs.opt_state_specs_tree(
      jrules, jopt, jspecs.param_specs_tree(jrules, jparams))
  assert sorted(port) == sorted(ref) == ["adam"]
  assert sorted(port["adam"]) == sorted(ref["adam"])
  assert port["adam"]["step"] == _norm(ref["adam"]["step"], 0) == ()
  ref_m = _ref_flat(ref["adam"]["m"])
  jm = _ref_flat(jopt["adam"]["m"])
  for moment in ("m", "v"):
    for name, spec in port["adam"][moment].items():
      path, stacked = _ref_leaf_path(cfg, name)
      want = _norm(ref_m[path], jm[path].ndim)[int(stacked):]
      assert spec == want, (moment, name)
      assert opt["adam"][moment][name].shape == model.get_parameter(
          name).shape


def _stand_in(fsdp=False):
  return _rules(specs, "single", fsdp)


def test_param_rules_divisibility_fallback():
  rules = _stand_in()
  # 10 heads cannot shard over the 16-way model axis: replicated
  spec = specs.param_spec(rules, "layers/0/params/attn/wq", (2560, 10, 256))
  assert spec[1] is None
  spec = specs.param_spec(rules, "layers/0/params/attn/wq", (2560, 32, 80))
  assert spec[1] == "model"


def test_param_rules_moe_vs_dense_ffn():
  rules = _stand_in(fsdp=True)
  # routed experts (E, d, f): E = 64 over model
  spec = specs.param_spec(rules, "layers/0/params/ffn/we_in",
                          (64, 2048, 1408))
  assert spec[0] == "model"
  # dense FFN (d, f): d over data (FSDP), f over model
  spec = specs.param_spec(rules, "layers/0/params/ffn/w_in", (2048, 8192))
  assert spec == ("data", "model")
  # grok: 8 experts cannot take the 16-way axis, the FFN dim does
  spec = specs.param_spec(rules, "layers/0/params/ffn/we_in",
                          (8, 6144, 32768))
  assert spec[0] is None and spec[2] == "model"


def test_no_axis_used_twice():
  rules = _stand_in()
  spec = rules.spec((16, 32, 64), (("data",), ("data", "model"), None))
  flat = [a for s in spec if s is not None
          for a in ((s,) if isinstance(s, str) else s)]
  assert len(flat) == len(set(flat))


def test_cache_rules_long_context_batch1():
  rules = _stand_in()
  # (B = 1, S, H, D): B unshardable, so S takes data and model (256-way)
  spec = specs.cache_spec(rules, "k", (1, 524288, 8, 64))
  assert spec[0] is None
  assert spec[1] == ("data", "model")


def test_activation_rules_noop_without_context():
  x = torch.ones((2, 3, 4))
  assert specs.shard_activation(x, "residual") is x
  # with rules but a plain tensor, the argument itself too
  with specs.use_rules(_stand_in()):
    assert specs.shard_activation(x, "residual") is x
  assert specs.current_rules() is None


def test_placements_of_a_two_axis_dimension_and_mesh_order():
  mesh = FakeMesh(MESHES["multi"])
  assert specs.placements(mesh, (("pod", "data"), None, "model")) == (
      Shard(0), Shard(0), Shard(2))
  assert specs.placements(mesh, (None, None)) == (Replicate(),) * 3
  with pytest.raises(ValueError, match="mesh's order"):
    specs.placements(mesh, (("data", "pod"), None))


def test_a_dimension_of_size_one_is_never_split():
  rules = specs.ShardingRules(FakeMesh({"data": 1, "model": 1}))
  assert rules.spec((1, 64, 1, 16), ("data", None, "model", None)) == (
      None, None, None, None)
  assert rules.spec((8, 64), ("data", "model")) == ("data", "model")


def test_the_rule_tables_are_the_references():
  assert specs.PARAM_RULES == jspecs.PARAM_RULES
  assert specs._ACT_RULES == jspecs._ACT_RULES
  assert [f.name for f in dataclasses.fields(specs.ShardingRules)] == [
      f.name for f in dataclasses.fields(jspecs.ShardingRules)]
