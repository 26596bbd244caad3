"""The port's example programs against the reference's.

``repro_torch.examples.{quickstart,label_ranking,robust_lm_training,
moe_soft_router}`` against the functions of the reference's own
``examples/*.py``, loaded unchanged with ``importlib`` (with
``REPRO_PROJECTION=composed``: fault R1), on the same inputs:

* quickstart: every printed value, from the same random inputs;
* label ranking: the dataset, then ``train`` at 20 steps with and without
  the projection: ``w`` and the held-out rho within 1e-5 * (1 + max|ref|);
* robust LM training and the MoE router: both configs shrunk by the same
  ``dataclasses.replace`` (2 layers, d_model 64), the port started from the
  reference's ``init_params(cfg, PRNGKey(0))`` carried across by
  ``models/convert.py``; 2 steps' losses, the clean-token losses, the
  expert-load CV and the greedy tokens (tolerances below, with AdamW's
  first step in mind: ``tests/test_torch_dense.py``'s train-step test).

And each program's ``main`` on the CPU (``--device cpu``), its refusal
without a card, and its arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import assert_close, composed_ref  # noqa: E402,F401

from repro.models import transformer as jT  # noqa: E402
from repro_torch.examples import label_ranking as label_ranking  # noqa: E402
from repro_torch.examples import moe_soft_router  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import robust_lm_training  # noqa: E402
from repro_torch.models import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHRINK = dict(num_layers=2, d_model=64)


def _reference(name: str):
  """The reference's ``examples/<name>.py`` as a module, run unchanged."""
  spec = importlib.util.spec_from_file_location(
      f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _shrink(monkeypatch, mod) -> None:
  """Both programs' ``make_cfg`` shrunk by the same replace."""
  make = mod.make_cfg
  monkeypatch.setattr(mod, "make_cfg", lambda *a: dataclasses.replace(
      make(*a), **SHRINK))


def _port_model(cfg, ref_cfg):
  """The reference's initial weights (PRNGKey(0)) as the port's model."""
  params = jT.init_params(ref_cfg, jax.random.PRNGKey(0))
  return convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))


def test_quickstart_prints_the_references_values(composed_ref, capsys):
  """Every value the reference prints, computed by the reference's own
  calls on the port's random inputs (the reference draws its own with
  jax.random, which numpy cannot reproduce)."""
  ref = _reference("quickstart")
  x, batch = quickstart.inputs()
  got = quickstart.run(x, batch, CPU)
  theta, scores = ref.theta, ref.scores
  jx, jb = jnp.asarray(x), jnp.asarray(batch)
  ranks = ref.soft_rank(jb, 0.1)
  want = {
      "theta": theta,
      "soft_rank_eps1": ref.soft_rank(theta, 1.0),
      "soft_rank_eps10": ref.soft_rank(theta, 10.0),
      "soft_sort_eps0.1": ref.soft_sort(theta, 0.1),
      "grad_rank0": jax.grad(ref.loss)(theta),
      "soft_rank_kl": ref.soft_rank(theta, 1.0, regularization="kl"),
      "topk_mask": ref.soft_topk_mask(scores, 2, 0.5),
      "soft_median": ref.soft_quantile(jx, 0.5, 0.01),
      "spearman": ref.spearman_correlation(ranks[0], ranks[0]),
  }
  assert sorted(got) == sorted([*want, "ranks_shape"])
  assert got["ranks_shape"] == list(ranks.shape) == [4, 10]
  for key, value in want.items():
    assert_close(np.asarray(got[key]), np.asarray(value), theta, x)
  printed = capsys.readouterr().out
  assert "soft top-2 mask" in printed and "spearman" in printed


def test_label_ranking_dataset_is_the_references(composed_ref):
  ref = _reference("label_ranking")
  jx, jranks = ref.make_dataset(np.random.default_rng(0))
  x, ranks = label_ranking.make_dataset(np.random.default_rng(0))
  np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
  np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))


@pytest.mark.parametrize("use_projection", [True, False],
                         ids=["projection", "no_projection"])
def test_label_ranking_train_matches_reference(composed_ref, use_projection):
  """20 steps of gradient descent, with the soft Spearman loss and without
  the projection: ``w`` and the held-out rho within 1e-5 * (1 +
  max|ref|)."""
  ref = _reference("label_ranking")
  jx, jranks = ref.make_dataset(np.random.default_rng(0))
  x, ranks = label_ranking.make_dataset(np.random.default_rng(0))
  n_tr = int(0.8 * len(x))
  want_w = np.asarray(ref.train(jx[:n_tr], jranks[:n_tr], use_projection,
                                steps=20))
  w = label_ranking.train(x[:n_tr], ranks[:n_tr], use_projection, steps=20)
  assert_close(w, want_w, want_w)
  want_rho = float(jnp.mean(ref.spearman_correlation(
      ref.hard_rank(jx[n_tr:] @ jnp.asarray(want_w), "ASCENDING"),
      jranks[n_tr:])))
  got_rho = label_ranking.held_out_rho(x[n_tr:], ranks[n_tr:], w)
  assert_close(np.float64(got_rho), np.float64(want_rho), np.float64(1.0))


def _printed(pattern: str, text: str) -> list[float]:
  return [float(m) for m in re.findall(pattern, text)]


# AdamW's first update of an element is lr * g / (|g| + eps): an element
# whose gradient sits near eps = 1e-8 moves by up to lr (1e-3) on a
# gradient difference of 1e-9, which the two frameworks' f32 sums give.
# Such elements are rare, and each moves one weight by at most lr: the next
# loss moves far less.  Measured on these configs (CPU, f32): the first
# losses agree bit for bit, the losses after a step to 1.1e-7 (robust LM)
# and 2.2e-7 (MoE) relative.  Held within 1e-5 relative; the printed
# training losses, which the reference rounds to 4 decimals, within that
# rounding.
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("trim", [0.0, 0.25], ids=["baseline", "soft_lts"])
def test_robust_lm_run_matches_reference(composed_ref, monkeypatch, capsys,
                                         trim):
  """Two steps of ``run`` (8 x 128, 25% corrupted targets), with and
  without the soft-LTS trim, from the reference's initial weights: each
  step's training loss and the clean-token loss after each step."""
  ref = _reference("robust_lm_training")
  _shrink(monkeypatch, ref)
  _shrink(monkeypatch, robust_lm_training)
  args = argparse.Namespace(full=False, steps=2, batch=8, seq=128,
                            corrupt=0.25, trim=trim, eval_every=1)
  want_clean = ref.run(trim, args)
  want_train = _printed(r"train (\d+\.\d+)", capsys.readouterr().out)
  model = _port_model(robust_lm_training.make_cfg(False, trim),
                      ref.make_cfg(False, trim))
  got = robust_lm_training.run(trim, args, model=model)
  assert got["eval_steps"] == [0, 1]
  np.testing.assert_allclose(got["clean"], want_clean, rtol=LOSS_RTOL)
  np.testing.assert_allclose(got["train"], want_train, rtol=LOSS_RTOL,
                             atol=5e-5)


@pytest.mark.parametrize("router", ["softmax_topk", "soft_topk"])
def test_moe_train_one_matches_reference(composed_ref, monkeypatch, router):
  """Two steps of ``train_one`` (8 x 64) from the reference's initial
  weights: the final loss, the expert-load CV (the same dispatch counts:
  held to 1e-5) and, for the soft router, the greedy tokens of the
  reference's generation loop."""
  ref = _reference("moe_soft_router")
  _shrink(monkeypatch, ref)
  _shrink(monkeypatch, moe_soft_router)
  jcfg, jparams, want_loss, want_cv = ref.train_one(router, 2, 8, 64)
  cfg = moe_soft_router.make_cfg(router)
  _, model, loss, cv, losses = moe_soft_router.train_one(
      router, 2, 8, 64, model=_port_model(cfg, jcfg))
  assert len(losses) == 2 and losses[-1] == loss
  np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
  np.testing.assert_allclose(cv, want_cv, rtol=0, atol=1e-5)
  if router != "soft_topk":
    return
  prompt = jnp.zeros(moe_soft_router.PROMPT, jnp.int32)
  logits, caches = jax.jit(lambda p, b: jT.forward_prefill(jcfg, p, b, 32))(
      jparams, {"tokens": prompt, "targets": prompt})
  dec = jax.jit(lambda p, c, t, pos: jT.forward_decode(jcfg, p, c, t, pos))
  want, tok = [], jnp.argmax(logits, -1)
  for i in range(moe_soft_router.GENERATE):
    want.append(np.asarray(tok))
    logits, caches = dec(jparams, caches, tok, jnp.int32(16 + i))
    tok = jnp.argmax(logits, -1)
  assert moe_soft_router.generate(cfg, model, CPU) == np.stack(
      want, 1).tolist()


def test_each_main_runs_on_the_cpu(monkeypatch, capsys):
  """``main(argv)`` with ``--device cpu`` at a small size returns what it
  prints."""
  monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
  out = quickstart.main(["--device", "cpu"])
  assert out["soft_rank_eps1"] == [1.0, 3.0, 2.0] and out["seconds"] > 0
  out = label_ranking.main(["--device", "cpu", "--steps", "5"])
  assert 0.5 < out["rho_no_projection"] <= 1.0
  assert 0.5 < out["rho_projection"] <= 1.0
  _shrink(monkeypatch, robust_lm_training)
  out = robust_lm_training.main(["--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16"])
  assert len(out["baseline"]["train"]) == len(out["soft_lts"]["train"]) == 2
  assert all(np.isfinite(out["soft_lts"]["clean"]))
  _shrink(monkeypatch, moe_soft_router)
  out = moe_soft_router.main(["--device", "cpu", "--steps", "2", "--batch",
                              "2", "--seq", "64"])
  assert set(out) == {"softmax_topk", "soft_topk", "tokens", "steps",
                      "seconds"}
  assert np.array(out["tokens"]).shape == (2, moe_soft_router.GENERATE)
  printed = capsys.readouterr().out
  assert "router comparison" in printed and "clean-token loss" in printed


@pytest.mark.parametrize("mod", [quickstart, label_ranking,
                                 robust_lm_training, moe_soft_router],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(monkeypatch, mod):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    mod.main([])


def test_robust_lm_takes_the_references_arguments():
  args = robust_lm_training.parser().parse_args([])
  assert (args.full, args.steps, args.batch, args.seq, args.corrupt,
          args.trim, args.eval_every, args.device) == (
              False, 60, 8, 128, 0.25, 0.25, 10, "cuda")
  full = robust_lm_training.make_cfg(True, 0.25)
  assert (full.num_layers, full.d_model, full.vocab_size) == (12, 768, 32000)
