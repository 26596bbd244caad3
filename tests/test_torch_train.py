"""The port's training slice against the reference's trainer.

``smoke_config("deepseek-v2-lite-16b")`` in f32 with the reference's own
random weights (``from_jax_params``) and the same token batches: the
training pass (per-token loss and aux loss), the gradient of the loss
with the soft-LTS token trim, whole train steps (AdamW, clipping, the
schedule, gradient accumulation), the chunked LM loss, remat, and the
command line.  The reference runs jitted, with ``REPRO_PROJECTION=
composed`` (``composed_ref``).  Tolerances: values within 1e-5 * (1 +
max|want|); gradients within 1e-4 * (1 + max|want|) a leaf (sums over
the batch through MoE dispatch and the trimmed loss, in f32); train-step
metrics within 1e-4 relative.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
BATCH, SEQ, TRIM = 2, 32, 0.1
pytestmark = pytest.mark.usefixtures("composed_ref")


def _configs(**over):
  over.setdefault("loss_trim_fraction", TRIM)
  return (dataclasses.replace(jsmoke_config(ARCH), **over),
          dataclasses.replace(smoke_config(ARCH), **over))


def _params(jcfg, seed: int = 1):
  return jax.tree.map(np.asarray,
                      jtransformer.init_params(jcfg, jax.random.PRNGKey(seed)))


def _batch(jcfg, step: int = 0):
  """(reference batch, port batch): tokens and targets with 10% of the
  targets corrupted, as the trainer's ``--corrupt 0.1`` makes them."""
  b = jpipeline(jcfg, BATCH, SEQ, seed=2,
                corrupt_fraction=0.1).batch_at(step)
  b = {k: b[k] for k in ("tokens", "targets")}
  return ({k: jnp.asarray(v) for k, v in b.items()},
          {k: torch.from_numpy(v).long() for k, v in b.items()})


def _trainable(cfg, params):
  return convert.from_jax_params(cfg, params).requires_grad_(True)


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


def test_lm_loss_chunked_matches_reference():
  rng = np.random.default_rng(81)
  w, x = rng.normal(size=(16, 50)), rng.normal(size=(2, 12, 16))
  t = rng.integers(0, 50, (2, 12))
  for chunk, softcap in ((5, 0.0), (4, 3.0), (64, 0.0)):
    want = jlayers.lm_loss_chunked(jnp.asarray(w, jnp.float32),
                                   jnp.asarray(x, jnp.float32),
                                   jnp.asarray(t), chunk=chunk,
                                   softcap=softcap)
    got = layers.lm_loss_chunked(as_torch(w), as_torch(x),
                                 torch.from_numpy(t), chunk=chunk,
                                 softcap=softcap)
    assert got.dtype == torch.float32
    assert_close(got, want, want)


def test_lm_loss_chunked_gradient_matches_reference():
  """Backward through the checkpointed chunks against jax.grad."""
  rng = np.random.default_rng(82)
  w, x = rng.normal(size=(16, 50)), rng.normal(size=(2, 12, 16))
  t = rng.integers(0, 50, (2, 12))
  cot = rng.normal(size=(2, 12))
  _, pull = jax.vjp(lambda a, b: jlayers.lm_loss_chunked(
      a, b, jnp.asarray(t), chunk=4), jnp.asarray(w, jnp.float32),
      jnp.asarray(x, jnp.float32))
  want = pull(jnp.asarray(cot, jnp.float32))
  wt, xt = as_torch(w, grad=True), as_torch(x, grad=True)
  got = torch.autograd.grad(layers.lm_loss_chunked(
      wt, xt, torch.from_numpy(t), chunk=4), (wt, xt), as_torch(cot))
  for g, wg in zip(got, want):
    assert_close(g, wg, wg)


def test_forward_train_matches_reference():
  jcfg, cfg = _configs()
  params = _params(jcfg)
  jb, tb = _batch(jcfg)
  want_loss, want_aux = jax.jit(lambda p, b: jtransformer.forward_train(
      jcfg, p, b))(params, jb)
  model = convert.from_jax_params(cfg, params)
  with torch.no_grad():
    loss, aux = T.forward_train(cfg, model, tb)
  assert loss.shape == (BATCH, SEQ) and loss.dtype == torch.float32
  assert_close(loss, want_loss, want_loss)
  assert_close(aux, want_aux, want_aux)


def test_loss_gradient_with_trim_matches_reference():
  """Every leaf's gradient of ``loss_from_batch`` (soft-LTS trim 0.1,
  eps 1e-2, plus 0.01 aux), the reference's stacked gradient split per
  layer the way ``from_jax_params`` splits the parameters."""
  jcfg, cfg = _configs()
  params = _params(jcfg)
  jb, tb = _batch(jcfg)
  (want_total, want_m), want_g = jax.jit(jax.value_and_grad(
      lambda p: jsteps.loss_from_batch(jcfg, p, jb), has_aux=True))(params)
  model = _trainable(cfg, params)
  total, metrics = steps.loss_from_batch(cfg, model, tb)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(total, leaves)))
  assert_close(total, want_total, want_total)
  assert_close(metrics["loss"], want_m["loss"], want_m["loss"])
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads)
  for name, g in grads.items():
    assert g.shape == want[name].shape, name
    assert bool(torch.any(g != 0)), name
    w = want[name].detach().numpy()
    np.testing.assert_allclose(g.numpy(), w, rtol=0,
                               atol=1e-4 * (1 + np.abs(w).max()),
                               err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
  """Three steps of the jitted reference train step and the port's, from
  the same weights, on the same batches: loss, aux loss, grad norm and
  clip scale each step, and the parameters after the last."""
  jcfg, cfg = _configs(grad_accum=accum)
  params = _params(jcfg)
  jopt, opt = jadamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
  jstep = jax.jit(jsteps.make_train_step(
      jcfg, jopt, lr_schedule=lambda s: jschedule.cosine_with_warmup(
          s, warmup=1, total=5)))
  step = steps.make_train_step(
      cfg, opt, lr_schedule=lambda s: schedule.cosine_with_warmup(
          s, warmup=1, total=5))
  jp, jstate = params, jsteps.init_opt_state(jcfg, jopt, params)
  model = _trainable(cfg, params)
  state = steps.init_opt_state(cfg, opt, dict(model.named_parameters()))
  for s in range(3):
    jb, tb = _batch(jcfg, s)
    jp, jstate, want = jstep(jp, jstate, jb)
    _, state, got = step(model, state, tb)
    for key in ("loss", "aux_loss", "grad_norm", "clip_scale"):
      np.testing.assert_allclose(float(got[key]), float(want[key]),
                                 rtol=1e-4, atol=0, err_msg=f"{s} {key}")
  assert int(state["adam"]["step"]) == int(jstate["adam"]["step"]) == 3
  want_p = _port_leaves(cfg, jp)
  for name, p in model.named_parameters():
    assert_close(p, want_p[name], want_p[name], contract=1e-4)


@pytest.mark.parametrize("trim", [0.0, TRIM])
def test_remat_full_equals_none_bit_for_bit(trim):
  """Recomputing each layer in backward changes no bit of the loss or of
  any gradient (the router takes the same route in the recompute)."""
  out = {}
  for remat in ("none", "full"):
    _, cfg = _configs(remat=remat, loss_trim_fraction=trim)
    model = _trainable(cfg, _params(jsmoke_config(ARCH)))
    total, _ = steps.loss_from_batch(cfg, model, _batch(
        jsmoke_config(ARCH))[1])
    names, leaves = zip(*model.named_parameters())
    out[remat] = (total, torch.autograd.grad(total, leaves))
  assert torch.equal(out["none"][0], out["full"][0])
  for name, a, b in zip(names, out["none"][1], out["full"][1]):
    assert torch.equal(a, b), name


def test_remat_dots_is_not_ported():
  _, cfg = _configs(remat="dots")
  model = convert.from_jax_params(cfg, _params(jsmoke_config(ARCH)))
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    T.forward_train(cfg, model, _batch(jsmoke_config(ARCH))[1])


def test_decay_mask_follows_the_reference_layouts():
  _, cfg = _configs()
  mask = T.decay_mask(convert.from_jax_params(cfg,
                                              _params(jsmoke_config(ARCH))))
  assert mask["layers.0.params.norm1.scale"]    # (reps, d) in the reference
  assert mask["embed.table"] and mask["lm_head.w"]
  assert not mask["final_norm.scale"]


def test_command_line_smoke_on_cpu(capsys, tmp_path):
  before = ops.all_launches()
  res = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "3", "--trim-frac", "0.1", "--batch", "2",
                    "--seq", "16", "--ckpt-dir", str(tmp_path)])
  out = capsys.readouterr().out
  assert out.count("[train] step") == 3 and "done at step 3" in out
  assert res["state"].step == 3 and res["cfg"].loss_trim_fraction == 0.1
  assert np.isfinite(float(res["metrics"]["loss"]))
  assert ops.all_launches() == before    # the CPU runs no kernel
  assert (tmp_path / "step_0000000003" / "manifest.json").is_file()


def test_trim_runs_over_the_microbatch_as_one_row(monkeypatch):
  """``loss_from_batch`` trims all of a microbatch's tokens as one row
  (``soft_trimmed_token_loss`` flattens), not each sequence apart: at
  batch 2 the two readings differ, and the loss is the one-row reading.
  Row 0's losses are four times row 1's, so a per-row trim would drop
  tokens of both rows; the one-row trim drops row 0's largest.  Exact
  equality with the one-row call (the same ops on the same values); the
  per-row mean is far off."""
  _, cfg = _configs(loss_trim_fraction=0.25, loss_trim_eps=1e-2)
  x = np.random.default_rng(0).gamma(2.0, 1.25, (2, 8))
  x[0] *= 4.0
  tl = as_torch(x)
  monkeypatch.setattr(steps.T, "forward_train",
                      lambda cfg, model, batch: (tl, torch.zeros(())))
  _, m = steps.loss_from_batch(cfg, None, {})
  one_row = core.soft_trimmed_token_loss(tl.reshape(-1), 0.25, 1e-2)
  per_row = torch.stack([core.soft_trimmed_token_loss(r, 0.25, 1e-2)
                         for r in tl]).mean()
  assert torch.equal(m["loss"], one_row)
  assert float(per_row - one_row) > 0.5
  np.testing.assert_allclose([float(one_row), float(per_row)],
                             [2.2590797, 2.9069772], rtol=1e-6)


def test_plan_and_bench_json_on_the_cpu(tmp_path, capsys):
  """``--plan`` installs the plan for every decision of the run and
  ``--bench-json`` writes an artifact that both packages' validators
  accept, naming the plan."""
  from repro.obs import artifacts as jartifacts
  from repro_torch import plan as plan_mod
  from repro_torch.obs import artifacts, metrics
  plan = plan_mod.ExecutionPlan(name="train-scan", rules=(
      plan_mod.PlanRule("forward", "scan"),
      plan_mod.PlanRule("backward", "scatter")))
  plan_path, bench = tmp_path / "plan.json", tmp_path / "BENCH_train.json"
  plan.save(str(plan_path))
  metrics.reset()
  try:
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                "2", "--trim-frac", "0.1", "--batch", "2", "--seq", "16",
                "--plan", str(plan_path), "--bench-json", str(bench)])
    decided = metrics.counters("plan_decide")
  finally:
    plan_mod.set_active_plan(None)
  assert decided["plan_decide{backend=scan,kind=forward,plan=train-scan,"
                 "source=plan}"] > 0
  assert decided["plan_decide{backend=scatter,kind=backward,"
                 "plan=train-scan,source=plan}"] > 0
  assert not any("source=builtin" in k and "kind=forward" in k
                 for k in decided)
  assert artifacts.validate_file(str(bench)) == []
  assert jartifacts.validate_file(str(bench)) == []
  payload = json.loads(bench.read_text())
  assert payload["meta"]["plan_name"] == "train-scan"
  assert payload["meta"]["plan_hash"] == plan.plan_hash()
  assert payload["results"][0]["steps_timed"] == 2


def test_overrides_cut_the_depth():
  assert train.parse_overrides(["num_layers=4", "router_eps=0.5",
                                "remat=full", "fsdp=False"]) == {
      "num_layers": 4, "router_eps": 0.5, "remat": "full", "fsdp": False}


def test_default_device_is_the_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    train.main(["--arch", ARCH, "--smoke", "--steps", "1"])


@pytest.mark.parametrize("kwargs, exc", [
    ({}, RuntimeError),                           # the card, by default
    ({"smoke": True}, RuntimeError),
    ({"device": "cpu"}, ValueError),              # the CPU needs smoke
])
def test_trainer_built_directly_runs_on_the_card(kwargs, exc):
  """``Trainer`` resolves its device as ``--device`` does: built without
  one it raises where there is no card, and it takes the CPU only for a
  smoke config."""
  if exc is RuntimeError and torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  with pytest.raises(exc):
    train.Trainer(smoke_config(ARCH), adamw.AdamWConfig(), batch=2,
                  seq=16, **kwargs)
  cpu = train.Trainer(smoke_config(ARCH), adamw.AdamWConfig(), batch=2,
                      seq=16, device="cpu", smoke=True)
  assert cpu.device == torch.device("cpu")


@pytest.mark.parametrize("argv, exc", [
    (["--device", "cpu"], ValueError),           # full size on the CPU
])
def test_what_is_not_trained_raises(argv, exc):
  with pytest.raises(exc):
    train.main(["--arch", ARCH, "--steps", "1"] + argv)
