"""The port's dense GQA family (llama3.2-1b, tinyllama-1.1b) against the
reference.

``smoke_config("llama3.2-1b")`` (tied embeddings, G = 2) and
``smoke_config("tinyllama-1.1b")`` (untied head) in f32, with the
reference's own random weights carried across by ``from_jax_params`` and
the same numpy inputs and token batches: the GQA attention layer over a
sequence and one decode step, ``decode_attention``, the training pass
(per-token loss, and the gradient of every leaf against ``jax.grad``,
the tied table's through both of its uses), prefill (logits and the padded
caches), 4 greedy decode steps, one train step with the soft-LTS token
trim, and the command lines.  The reference runs jitted, with
``REPRO_PROJECTION=composed`` (``composed_ref``).  Tolerance: 1e-5 * (1 +
max|ref|) (``test_torch_common.assert_close`` scaled by the wanted
value), for values, caches, logits and every gradient leaf; train-step
metrics within 1e-4 relative and parameters after the step within 1e-4 *
(1 + max|ref|), as in ``test_torch_train.py``.
"""

from __future__ import annotations

import dataclasses

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

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ("llama3.2-1b", "tinyllama-1.1b")
BATCH, SEQ, PROMPT, GEN, TRIM = 2, 32, 24, 5, 0.1
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg, cfg = jsmoke_config(request.param), smoke_config(request.param)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(5)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  return jax.tree.map(lambda a: jnp.asarray(a[i]),
                      params["seg0"]["l0_dense"])


def _batch(jcfg, step: int = 0):
  """(reference batch, port batch): tokens and targets with 10% of the
  targets corrupted, as the trainer's ``--corrupt 0.1`` makes them."""
  b = jpipeline(jcfg, BATCH, SEQ, seed=4, corrupt_fraction=0.1).batch_at(step)
  b = {k: b[k] for k in ("tokens", "targets")}
  return ({k: jnp.asarray(v) for k, v in b.items()},
          {k: torch.from_numpy(v).long() for k, v in b.items()})


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


@pytest.mark.parametrize("name", [*ARCHS, *(f"{a}-smoke" for a in ARCHS)])
def test_configs_are_the_references(name):
  arch = name.removesuffix("-smoke")
  smoke_ = name.endswith("-smoke")
  want = jsmoke_config(arch) if smoke_ else jget_config(arch)
  got = smoke_config(arch) if smoke_ else get_config(arch)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments()


def test_smoke_llama_has_the_references_parameter_count():
  """90,432 parameters, the tied table counted once, as the reference's
  tree has them; the full config's count from the reference's shapes."""
  cfg = smoke_config("llama3.2-1b")
  model = T.init_params(cfg, 0)
  jparams = jtransformer.init_params(jsmoke_config("llama3.2-1b"),
                                     jax.random.PRNGKey(0))
  assert T.count_params(model) == jtransformer.count_params(jparams) == 90432
  assert not hasattr(model, "lm_head")
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config("llama3.2-1b"), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
      1_235_814_400


def test_convert_splits_the_dense_layers(smoke):
  _, cfg, params, model = smoke
  assert ("lm_head" in params) == (not cfg.tie_embeddings)
  assert len(model.layers) == cfg.num_layers
  stacked = params["seg0"]["l0_dense"]
  for i, layer in enumerate(model.layers):
    assert layer.kind == "dense"
    tree = layer.params.tree()
    for group, leaf in (("attn", "wk"), ("ffn", "w_gate")):
      np.testing.assert_array_equal(tree[group][leaf].numpy(),
                                    stacked[group][leaf][i])
  assert T.count_params(model) == sum(a.size
                                      for a in jax.tree.leaves(params))
  if cfg.tie_embeddings:
    head = model.head_weight()
    assert head.data_ptr() == model.embed.table.data_ptr()
    assert tuple(head.shape) == (cfg.d_model, cfg.vocab_size)


def test_transformer_refuses_a_head_that_does_not_match_the_config(smoke):
  _, cfg, params, _ = smoke
  tree = convert.port_tree(cfg, params)
  if cfg.tie_embeddings:
    tree["lm_head"] = {"w": tree["embed"]["table"].T.contiguous()}
  else:
    del tree["lm_head"]
  with pytest.raises(ValueError, match="lm_head"):
    T.Transformer(cfg, tree)


def test_unported_kinds_still_raise():
  """Every kind of the reference is ported (``mlstm`` builds now); a kind
  that no layer of the reference has either, such as ``local_moe`` of the
  config schema's comment, raises ``ValueError`` as the reference's
  ``_mixer_init`` does."""
  cfg = dataclasses.replace(smoke_config("llama3.2-1b"),
                            block_cycle=("mlstm", "dense"))
  assert [layer.kind for layer in T.init_params(cfg, 0).layers] == [
      "mlstm", "dense"]
  cfg = dataclasses.replace(cfg, block_cycle=("local_moe", "dense"))
  with pytest.raises(ValueError, match="local_moe"):
    T.init_params(cfg, 0)


def test_attention_layer_matches_reference(smoke):
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(61)
  x = rng.normal(size=(2, 19, cfg.d_model))
  pos = np.arange(19)
  want, (want_k, want_v) = jax.jit(lambda p, a: jlayers.attn_apply_seq(
      p, a, jnp.asarray(pos), jcfg, return_kv=True))(
          _layer(params, 1)["attn"], jnp.asarray(x, jnp.float32))
  got, (got_k, got_v) = layers.attn_apply_seq(
      model.layers[1].params.tree()["attn"], as_torch(x), torch.arange(19),
      cfg, return_kv=True)
  assert tuple(got_k.shape) == (2, 19, cfg.num_kv_heads, cfg.head_dim)
  for g, w in ((got, want), (got_k, want_k), (got_v, want_v)):
    assert_close(g, w, w)


def test_attention_decode_matches_reference(smoke):
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(62)
  b, max_len, pos = 2, 12, 7
  shape = (b, max_len, cfg.num_kv_heads, cfg.head_dim)
  cache = {"k": rng.normal(size=shape), "v": rng.normal(size=shape)}
  x = rng.normal(size=(b, cfg.d_model))
  want, want_cache = jax.jit(lambda p, a, c: jlayers.attn_apply_decode(
      p, a, c, jnp.int32(pos), jcfg))(
          _layer(params, 0)["attn"], jnp.asarray(x, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  tcache = {key: as_torch(a) for key, a in cache.items()}
  got, got_cache = layers.attn_apply_decode(
      model.layers[0].params.tree()["attn"], as_torch(x), tcache, pos, cfg)
  assert got_cache is tcache   # written in place
  assert_close(got, want, want)
  for key in cache:
    assert_close(got_cache[key], want_cache[key], want_cache[key])


@pytest.mark.parametrize("h, hkv, cache_len", [(4, 2, 9), (8, 1, 1),
                                               (6, 6, 12)])
def test_decode_attention_matches_reference(h, hkv, cache_len):
  """G = 2, 8 and 1 query heads a kv head; a cache filled to 9 of 12, to
  1, and to the end."""
  rng = np.random.default_rng(63)
  q = rng.normal(size=(3, h, 16))
  k, v = (rng.normal(size=(3, 12, hkv, 16)) for _ in range(2))
  want = jax.jit(lambda a, b, c: jlayers.decode_attention(
      a, b, c, jnp.int32(cache_len)))(
          *(jnp.asarray(t, jnp.float32) for t in (q, k, v)))
  got = layers.decode_attention(as_torch(q), as_torch(k), as_torch(v),
                                cache_len)
  assert_close(got, want, want)
  # Positions at or past cache_len are not read.
  v2 = v.copy()
  v2[:, cache_len:] = 1e6
  again = layers.decode_attention(as_torch(q), as_torch(k), as_torch(v2),
                                  cache_len)
  np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("softcap, window", [(2.0, 0), (1.5, 4)])
def test_decode_attention_softcap_matches_reference(softcap, window):
  """The reference's logit soft-cap (c * tanh(s / c) before the mask),
  alone and under a window, with scores of ~N(0, 3^2) so that it binds;
  without it the result moves by more than the tolerance."""
  rng = np.random.default_rng(64)
  q = 3.0 * rng.normal(size=(2, 4, 16))
  k, v = (rng.normal(size=(2, 12, 2, 16)) for _ in range(2))
  want = jax.jit(lambda a, b, c: jlayers.decode_attention(
      a, b, c, jnp.int32(10), window=window, softcap=softcap))(
          *(jnp.asarray(t, jnp.float32) for t in (q, k, v)))
  args = [as_torch(t) for t in (q, k, v)]
  got = layers.decode_attention(*args, 10, window, softcap=softcap)
  assert_close(got, want, want)
  uncapped = layers.decode_attention(*args, 10, window)
  assert np.abs(uncapped.numpy() - np.asarray(want)).max() > 1e-2


def test_forward_train_and_gradients_match_reference(smoke):
  """The per-token loss and the gradient of its mean on every leaf (the
  tied table's summing the gather's and the head's parts), against
  ``jax.grad`` of the reference's, split per layer by ``port_tree``."""
  jcfg, cfg, params, _ = smoke
  jb, tb = _batch(jcfg)

  def mean_loss(p):
    tl, aux = jtransformer.forward_train(jcfg, p, jb)
    return jnp.mean(tl) + 0.01 * aux, tl

  (_, want_tl), want_g = jax.jit(jax.value_and_grad(mean_loss,
                                                    has_aux=True))(params)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  loss, aux = T.forward_train(cfg, model, tb)
  assert loss.shape == (BATCH, SEQ) and float(aux) == 0.0
  assert_close(loss, want_tl, want_tl)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(
      torch.mean(loss) + 0.01 * aux, leaves)))
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads)
  assert ("lm_head.w" in grads) == (not cfg.tie_embeddings)
  for name, g in grads.items():
    assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], want[name])


def _reference_serve(jcfg, params, tokens):
  """The reference server's loop: jitted prefill, then greedy decode."""
  prefill = jax.jit(jsteps.make_prefill_step(jcfg, PROMPT + GEN))
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
  prefill_caches = jax.tree.map(np.asarray, caches)
  tok = jnp.argmax(logits, -1)
  all_logits, all_tokens = [np.asarray(logits)], [np.asarray(tok)]
  for i in range(GEN - 1):
    logits, caches = decode(params, caches, tok, jnp.int32(PROMPT + i))
    tok = jnp.argmax(logits, -1)
    all_logits.append(np.asarray(logits))
    all_tokens.append(np.asarray(tok))
  return all_logits, np.stack(all_tokens, axis=1), prefill_caches, caches


def test_prefill_and_decode_match_the_reference_server(smoke):
  """Prefill's last-position logits and its caches (k after RoPE and v of
  the prompt, zeros to ``max_len``), then 4 greedy decode steps: logits
  at every step, the tokens, and the caches after the last step."""
  jcfg, cfg, params, model = smoke
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  want_logits, want_tokens, want_pcaches, want_caches = _reference_serve(
      jcfg, params, tokens)
  prefill = steps.make_prefill_step(cfg, PROMPT + GEN)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = prefill(model, {"tokens": torch.from_numpy(tokens)})
    for i, cache in enumerate(caches):
      for key in ("k", "v"):
        want = want_pcaches[0]["l0_dense"][key][i]
        assert tuple(cache[key].shape) == want.shape
        assert_close(cache[key], want, want)
        assert not bool(cache[key][:, PROMPT:].any())
    got_logits, got_tokens = [logits], [serve.greedy(logits)]
    for i in range(GEN - 1):
      logits, caches = decode(model, caches, got_tokens[-1], PROMPT + i)
      got_logits.append(logits)
      got_tokens.append(serve.greedy(logits))
  for got, want in zip(got_logits, want_logits):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got, want, want)
  np.testing.assert_array_equal(torch.stack(got_tokens, 1).numpy(),
                                want_tokens)
  for i, cache in enumerate(caches):
    for key in ("k", "v"):
      want = np.asarray(want_caches[0]["l0_dense"][key][i])
      assert_close(cache[key], want, want)
  res = serve.generate(cfg, model, torch.from_numpy(tokens), GEN)
  np.testing.assert_array_equal(res["tokens"].numpy(), want_tokens)


def test_tied_input_scale_in_every_pass(smoke, monkeypatch):
  """The reference scales the embedded tokens by sqrt(d_model) when the
  embeddings are tied, in training, prefill and decode; the port passes
  the same flag in all three, and without it the logits move."""
  _, cfg, _, model = smoke
  seen = []
  embed = layers.embed_apply

  def record(p, tokens, scale=False):
    seen.append(scale)
    return embed(p, tokens, scale)

  monkeypatch.setattr(layers, "embed_apply", record)
  tokens = torch.from_numpy(np.arange(2 * 6).reshape(2, 6) % cfg.vocab_size)
  with torch.inference_mode():
    T.forward_train(cfg, model, {"tokens": tokens, "targets": tokens})
    logits, caches = T.forward_prefill(cfg, model, {"tokens": tokens}, 8)
    T.forward_decode(cfg, model, caches, tokens[:, 0], 6)
    assert seen == [cfg.tie_embeddings] * 3
    monkeypatch.setattr(layers, "embed_apply",
                        lambda p, t, scale=False: embed(p, t, False))
    unscaled, _ = T.forward_prefill(cfg, model, {"tokens": tokens}, 8)
  assert torch.equal(unscaled, logits) == (not cfg.tie_embeddings)


def test_train_step_with_trim_matches_reference(smoke):
  """One step of the jitted reference train step and the port's, trim
  0.1, from the same weights on the same batch: loss, aux loss, grad
  norm and clip scale, then every parameter.

  AdamW's first update of an element is lr * f(s * g) with f(x) = x /
  (|x| + eps) (plus the decay), s the clip scale: where |g| is near eps =
  1e-8 it turns a gradient difference of 1e-9, well inside the gradients'
  own agreement, into a difference of a few percent of lr.  So the
  reference's step is also taken by ``adamw.update_leaf`` from the
  reference's gradient (``jax.grad`` of its loss), held to the
  reference's parameters within 1e-4 * (1 + max|ref|) on every element;
  elements whose gradient is non-zero and below 100 * eps (fewer than 1
  in 1000 here) are held to that step within what the measured gradient
  difference can move f, lr * min(2, s * |g - g_ref| / eps) (f is
  1/eps-Lipschitz), plus 4 f32 ulps; every other element to 1e-4 *
  (1 + max|ref|)."""
  jcfg, cfg, params, _ = smoke
  jcfg = dataclasses.replace(jcfg, loss_trim_fraction=TRIM)
  cfg = dataclasses.replace(cfg, loss_trim_fraction=TRIM)
  jopt, opt = jadamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
  jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
  step = steps.make_train_step(cfg, opt)
  jb, tb = _batch(jcfg, 1)
  jp, _, want = jstep(params, jsteps.init_opt_state(jcfg, jopt, params), jb)
  want_g = _port_leaves(cfg, jax.jit(jax.grad(
      lambda p: jsteps.loss_from_batch(jcfg, p, jb)[0]))(params))
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  before = {n: p.detach().clone() for n, p in model.named_parameters()}
  total, _ = steps.loss_from_batch(cfg, model, tb)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(total, leaves)))
  state = steps.init_opt_state(cfg, opt, dict(model.named_parameters()))
  _, state, got = step(model, state, tb)
  for key in ("loss", "aux_loss", "grad_norm", "clip_scale"):
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                               atol=0, err_msg=key)
  want_p = _port_leaves(cfg, jp)
  decay = T.decay_mask(model)
  scale = float(want["clip_scale"])
  scalars = [torch.tensor(x, dtype=torch.float32)
             for x in (scale, opt.lr, 1 - opt.b1, 1 - opt.b2)]
  tiny = 0
  for name, p in model.named_parameters():
    w = want_p[name].detach()
    tol = 1e-4 * (1 + float(w.abs().max()))
    g, g_ref = grads[name], want_g[name].detach()
    zero = torch.zeros_like(g_ref)
    ref_step = adamw.update_leaf(opt, before[name], g_ref, zero, zero,
                                 *scalars, decay[name])[0]
    assert float((ref_step - w).abs().max()) <= tol, name
    near_eps = (g != 0) & (g.abs() < 100 * opt.eps)
    tiny += int(near_eps.sum())
    err = (p.detach() - w).abs()
    assert float(err[~near_eps].max()) <= tol, name
    moved = opt.lr * torch.clamp((g - g_ref).abs() * scale / opt.eps, max=2)
    slack = 4 * torch.finfo(torch.float32).eps * w.abs()
    off = (p.detach() - ref_step).abs()
    assert bool((off <= moved + slack)[near_eps].all()), name
  assert tiny < T.count_params(model) / 1000


def test_decay_mask_follows_the_reference_layouts(smoke):
  """The reference decays leaves of ndim >= 2 in its stacked layout:
  every layer leaf, the table (tied or not) and an untied head; not the
  final norm."""
  _, cfg, _, model = smoke
  mask = T.decay_mask(model)
  assert mask["layers.0.params.norm1.scale"] and mask["embed.table"]
  assert not mask["final_norm.scale"]
  assert mask.get("lm_head.w", True)
  assert sorted(mask) == sorted(n for n, _ in model.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("entry", ["serve", "train"])
def test_command_line_smoke_on_cpu(arch, entry, capsys):
  before = ops.all_launches()
  if entry == "serve":
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
    assert "prefill 2x8" in capsys.readouterr().out
  else:
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--trim-frac", "0.1", "--batch", "2",
                      "--seq", "16", "--corrupt", "0.1"])
    assert res["state"].step == 2 and res["cfg"].loss_trim_fraction == 0.1
    assert np.isfinite(float(res["metrics"]["loss"]))
    assert "done at step 2" in capsys.readouterr().out
  assert ops.all_launches() == before    # the CPU runs no kernel
