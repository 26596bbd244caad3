"""The dry run's pieces: shapes, parameter counts, the cost model, the
roofline's constants.

* ``launch/shapes.py``: the batch, token and cache stand-ins of all ten
  full configs at all four shapes have the reference's shapes, and its
  dtypes with the port's int64 ids (``Trainer.batch_at``) in place of
  int32; ``cell_applicable`` skips exactly where the reference's does.
* ``analysis/roofline.py``: ``count_active_params`` and ``model_flops``
  equal the reference's exactly (integers, and the same float products),
  on the port's ``meta`` parameters against the reference's
  ``eval_shape``.
* ``analysis/cost.py``: the FLOPs of one product are 2 M K N exactly; L
  layers count L times one layer (the step's other ops once); on a fake
  (4, 1) mesh (data parallel, no FSDP) a smoke train step's only
  collectives are all-reduces of exactly the parameters' bytes (the
  gradients' sync); on (1, 4) a model-parallel MLP issues one all-reduce
  of its output.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jroofline  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.cost import CostMode  # noqa: E402
from repro_torch.configs.base import ASSIGNED, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch import dryrun, mesh, shapes  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

DTYPES = {jnp.int32: torch.int64, jnp.float32: torch.float32}


def _jdtype(x):
  return DTYPES[jnp.dtype(x.dtype).type]


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_shape_stand_ins_match_the_references(arch, shape):
  cfg, jcfg = get_config(arch), jget_config(arch)
  cell, jcell = shapes.SHAPES[shape], jshapes.SHAPES[shape]
  assert dataclasses.astuple(cell) == dataclasses.astuple(jcell)
  assert shapes.cell_applicable(cfg, cell) == jshapes.cell_applicable(
      jcfg, jcell)
  if cell.kind != "decode":
    port, ref = shapes.batch_specs(cfg, cell), jshapes.batch_specs(jcfg,
                                                                   jcell)
    assert sorted(port) == sorted(ref)
    for k, t in port.items():
      assert t.device.type == "meta"
      assert (tuple(t.shape), t.dtype) == (ref[k].shape, _jdtype(ref[k]))
    return
  tok, jtok = (shapes.decode_token_specs(cfg, cell),
               jshapes.decode_token_specs(jcfg, jcell))
  assert (tuple(tok.shape), tok.dtype) == (jtok.shape, _jdtype(jtok))
  if not shapes.cell_applicable(cfg, cell)[0]:
    return
  caches = shapes.cache_specs(cfg, cell)
  ref = jshapes.cache_specs(jcfg, jcell)
  i = 0
  for si, (cycle, reps) in enumerate(jcfg.plan_segments()):
    for _ in range(reps):
      for j, kind in enumerate(cycle):
        for leaf, t in caches[i].items():
          want = ref[si][f"l{j}_{kind}"][leaf]
          assert tuple(t.shape) == want.shape[1:], (i, leaf)
          assert str(t.dtype).removeprefix("torch.") == str(want.dtype)
        i += 1
  assert i == len(caches)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_parameter_counts_and_model_flops_equal_the_references(arch):
  cfg, jcfg = get_config(arch), jget_config(arch)
  model = T.init_params(cfg, 0, "meta")
  jparams = jax.eval_shape(
      lambda: jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
  assert roofline.count_active_params(cfg, model) == (
      jroofline.count_active_params(jcfg, jparams))
  for name in shapes.SHAPES:
    assert roofline.model_flops(cfg, model, shapes.SHAPES[name]) == (
        jroofline.model_flops(jcfg, jparams, jshapes.SHAPES[name]))


def test_the_published_counts():
  model = T.init_params(get_config("llama3.2-1b"), 0, "meta")
  assert roofline.count_active_params(get_config("llama3.2-1b"), model) == (
      1_235_814_400, 1_235_812_352)
  assert roofline.model_flops(get_config("llama3.2-1b"), model,
                              shapes.SHAPES["train_4k"]) == pytest.approx(
      7.775e15, rel=1e-3)


def test_the_roofline_constants_are_the_h100s():
  assert roofline.PEAK_FLOPS == 989e12
  assert roofline.HBM_BW == 3.35e12
  assert roofline.LINK_BW == 50e9
  terms = roofline.roofline_terms(
      {"flops_per_device": 989e12, "hbm_bytes_per_device": 3.35e12 / 2,
       "collective_bytes_per_device": 0}, 2, 989e12)
  assert terms["compute_s"] == 1.0 and terms["memory_s"] == 0.5
  assert terms["dominant"] == "compute_s" and terms["bound_s"] == 1.0
  assert terms["useful_flops_ratio"] == 0.5
  assert terms["roofline_fraction"] == 0.5


def test_the_flops_of_one_product_are_2mkn():
  mode = CostMode()
  with mode:
    a, b = torch.empty(64, 48), torch.empty(48, 40)
    mode.reset()
    c = a @ b
  got = mode.analyze()
  assert tuple(c.shape) == (64, 40)
  assert got["flops_per_device"] == 2 * 64 * 48 * 40
  assert got["hbm_bytes_per_device"] == 4 * (64 * 48 + 48 * 40 + 64 * 40)
  assert got["collective_bytes_per_device"] == 0
  assert got["traced_peak_bytes"] == 4 * 64 * 40


def _prefill_cost(num_layers: int) -> dict:
  cfg = dataclasses.replace(smoke_config("llama3.2-1b"),
                            num_layers=num_layers)
  mode = CostMode()
  with mode, torch.no_grad():
    model = T.init_params(cfg, 0, "cpu")
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int64)}
    mode.reset()
    T.forward_prefill(cfg, model, batch, 16)
  return mode.analyze()


def test_l_layers_count_l_times_one_layer():
  one, two, three = (_prefill_cost(n) for n in (1, 2, 3))
  for key in ("flops_per_device", "hbm_bytes_per_device"):
    layer = two[key] - one[key]
    assert layer > 0
    assert three[key] - two[key] == layer, key
    assert three[key] == one[key] + 2 * layer


def test_data_parallel_step_syncs_the_gradients_bytes():
  cfg = dataclasses.replace(smoke_config("llama3.2-1b"), fsdp=False)
  pbytes = sum(p.numel() * p.element_size()
               for p in T.init_params(cfg, 0, "meta").parameters())
  rec = dryrun.trace_cell(cfg, shapes.ShapeCell("t", 32, 8, "train"),
                          (4, 1), ("data", "model"))
  assert rec["cost"]["collectives_by_type"] == {"all-reduce": pbytes}
  assert rec["memory"]["argument_bytes"] > 3 * pbytes   # params, m, v


def test_model_parallel_mlp_issues_one_all_reduce():
  d, f, b, s = 32, 64, 2, 8
  with mesh.fake_process_group(4):
    m = mesh.make_debug_mesh((1, 4), device_type="cpu")
    rules = specs.ShardingRules(m)
    mode = CostMode()
    with mode, specs.use_rules(rules), torch.no_grad():
      p = {"w_in": torch.empty(d, f), "w_gate": torch.empty(d, f),
           "w_out": torch.empty(f, d)}
      p = {k: specs.distribute(v, m, specs.param_spec(
          rules, f"layers/0/params/ffn/{k}", tuple(v.shape)))
           for k, v in p.items()}
      x = specs.distribute(torch.empty(b, s, d), m, (None, None, None))
      mode.reset()
      y = specs.shard_activation(layers.mlp_apply(p, x, "swiglu"),
                                 "residual")
    got = mode.analyze()
  assert tuple(y.shape) == (b, s, d)
  assert got["collective_counts"] == {"all-reduce": 1}
  assert got["collectives_by_type"] == {"all-reduce": 4 * b * s * d}
  # each rank runs its quarter of the three products
  assert got["flops_per_device"] == 3 * 2 * b * s * d * f // 4


def _xlstm_cost(train: bool) -> dict:
  cfg = dataclasses.replace(smoke_config("xlstm-350m"), remat="none",
                            q_chunk=8, kv_chunk=8, num_layers=2,
                            block_cycle=("mlstm", "slstm"))
  mode = CostMode()
  with mode, torch.set_grad_enabled(train):
    model = T.init_params(cfg, 0, "cpu").requires_grad_(train)
    batch = {"tokens": torch.zeros((2, 24), dtype=torch.int64),
             "targets": torch.zeros((2, 24), dtype=torch.int64)}
    mode.reset()
    if train:
      loss, _ = T.forward_train(cfg, model, batch)
      torch.autograd.grad(loss.mean(), list(model.parameters()))
    else:
      T.forward_prefill(cfg, model, {"tokens": batch["tokens"]}, 24)
  return mode.analyze()


@pytest.mark.parametrize("train", [True, False])
def test_xlstm_loops_traced_once_count_as_every_step(monkeypatch, train):
  import contextlib
  from repro_torch.analysis import cost
  once = _xlstm_cost(train)
  monkeypatch.setattr(cost, "_one_step_counted", lambda s: (
      range(s), contextlib.nullcontext()))
  every = _xlstm_cost(train)
  for key in ("flops_per_device", "hbm_bytes_per_device"):
    assert once[key] == every[key] > 0, key
