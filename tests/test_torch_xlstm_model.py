"""The whole xLSTM model (the ``mlstm`` / ``slstm`` kinds) against the
reference.

``smoke_config("xlstm-350m")`` (16 layers in two cycles of seven
``mlstm`` layers and one ``slstm``, d_model 64, 4 heads of 16, LayerNorm,
the GELU MLP of 128 in ``mlstm`` layers and GeGLU of 64 in ``slstm``
layers, an untied head) in f32, with the reference's own random weights
carried across by ``from_jax_params``: the parameter count and the
leaves' dtypes; the training pass over 2 x 48 tokens (three query chunks)
and the gradient of every leaf, the sLSTM's ``r`` and the mLSTM's f32
gate weights among them; prefill and 8 greedy decode steps with every
layer's state; the caches of the full config; both command lines.

With random weights this model amplifies f32 rounding some 10^4-fold end
to end (its mLSTM layers divide by sums of signed terms): the reference's
own loss moves by about 1e-3 when one rounding of its embedding table
changes.  So the model is held to the reference piece by piece on the
reference's own activations, each layer, the head and every gradient at
1e-5 * (1 + max|ref|) (``test_torch_common.assert_close`` scaled by the
wanted value; gradients by the largest gradient), and end to end within
4 times the reference's own spread.  The reference runs jitted, with
``REPRO_PROJECTION=composed`` (``composed_ref``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "xlstm-350m"
BATCH, SEQ, PROMPT, GEN = 2, 48, 40, 9
CYCLE = ("mlstm",) * 7 + ("slstm",)
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(11)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _ref_layers(params):
  """The reference's 16 layers as (kind, weights), in scan order."""
  return [(CYCLE[i % 8], jax.tree.map(
      lambda a, i=i: jnp.asarray(a[i // 8]),
      params["seg0"][f"l{i % 8}_{CYCLE[i % 8]}"])) for i in range(16)]


def _batch(jcfg, seq, seed):
  """The reference pipeline's batch, for both packages."""
  b = jpipeline(jcfg, BATCH, seq, seed=seed,
                corrupt_fraction=0.1).batch_at(0)
  return ({k: jnp.asarray(b[k]) for k in ("tokens", "targets")},
          {k: torch.from_numpy(b[k]).long() for k in ("tokens", "targets")})


def _np(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a))


def test_smoke_parameters_are_the_references(smoke):
  """The seeded init and the converted model: the reference's count, its
  layer kinds in scan order, and its dtypes (the mLSTM's gate weights and
  forget bias, the sLSTM's biases and the norms in f32)."""
  _, cfg, params, model = smoke
  want = jtransformer.count_params(params)
  assert T.count_params(T.init_params(cfg, 0)) == T.count_params(model) == \
      want
  assert [layer.kind for layer in model.layers] == list(CYCLE) * 2
  seeded = T.init_params(get_config(ARCH), 0, "meta")
  f32 = {n for n, p in seeded.named_parameters() if p.dtype == torch.float32}
  assert f32 == {n for n, _ in seeded.named_parameters()
                 if "norm" in n or n.rsplit(".", 1)[1] in (
                     "w_i", "w_f", "b_f", "b")}
  r = seeded.layers[7].params.tree()["slstm"]["r"]
  assert (tuple(r.shape), r.dtype) == ((4, 256, 4, 256), torch.bfloat16)


def test_forward_train_and_gradients_match_reference(smoke):
  """The training pass over 2 x 48 tokens held piece by piece on the
  reference's own activations and cotangents (``jax.vjp`` layer by
  layer): each of the 16 layers' output from the reference's input to it
  and its input cotangent from the reference's output cotangent; the
  per-token loss from the reference's final hidden state; and every
  leaf's gradient of the mean loss, the head's, each layer's (the sLSTM's
  through ``SLSTMScan`` against the ``custom_vjp``) and the embedding's."""
  jcfg, cfg, params, _ = smoke
  jb, tb = _batch(jcfg, SEQ, 4)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  layers = _ref_layers(params)
  fwd = {kind: jax.jit(lambda p, a, kind=kind: jtransformer._layer_apply_seq(
      p, a, jnp.arange(SEQ), jcfg, kind)[0]) for kind in set(CYCLE)}
  xs = [jlayers.embed_apply(params["embed"], jb["tokens"])]
  for kind, lp in layers:
    xs.append(fwd[kind](lp, xs[-1]))

  def head(p, x):
    x = jlayers.norm_apply(p["final_norm"], x, jcfg.norm)
    return jlayers.lm_loss_chunked(p["lm_head"]["w"], x, jb["targets"],
                                   chunk=jcfg.xent_chunk)

  want_tl, head_vjp = jax.vjp(
      head, {k: params[k] for k in ("final_norm", "lm_head")}, xs[-1])
  cot = np.full(want_tl.shape, 1.0 / want_tl.size, np.float32)
  g_head, g = head_vjp(jnp.asarray(cot))
  cots, g_layers = [g], []
  for i in range(len(layers) - 1, -1, -1):
    kind, lp = layers[i]
    gp, g = jax.vjp(fwd[kind], lp, xs[i])[1](g)
    cots.insert(0, g)
    g_layers.insert(0, gp)
  g_embed = jax.vjp(lambda t: jlayers.embed_apply(t, jb["tokens"]),
                    params["embed"])[1](cots[0])[0]

  x = _np(xs[-1]).requires_grad_(True)
  tl = L.lm_loss_chunked(model.lm_head.w, L.norm_apply(
      model.final_norm.tree(), x, cfg.norm), tb["targets"],
                         chunk=cfg.xent_chunk)
  assert_close(tl, want_tl, want_tl)
  heads = (model.final_norm.scale, model.final_norm.bias, model.lm_head.w)
  got = torch.autograd.grad(tl, (x, *heads), _np(cot))
  grads = {"x16": got[0], "final_norm.scale": got[1],
           "final_norm.bias": got[2], "lm_head.w": got[3]}
  want = {"x16": cots[-1], "final_norm.scale": g_head["final_norm"]["scale"],
          "final_norm.bias": g_head["final_norm"]["bias"],
          "lm_head.w": g_head["lm_head"]["w"]}
  for i, layer in enumerate(model.layers):
    xi = _np(xs[i]).requires_grad_(True)
    out, aux = layer.apply_train(xi, torch.arange(SEQ))
    assert float(aux) == 0.0
    assert_close(out, xs[i + 1], xs[i + 1])
    names, leaves = zip(*layer.named_parameters())
    got = torch.autograd.grad(out, (xi, *leaves), _np(cots[i + 1]))
    grads[f"x{i}"], want[f"x{i}"] = got[0], cots[i]
    for name, g in zip(names, got[1:]):
      _, group, leaf = name.split(".")          # params.<group>.<leaf>
      grads[f"layers.{i}.{name}"] = g
      want[f"layers.{i}.{name}"] = g_layers[i][group][leaf]
  xe = L.embed_apply(model.embed.tree(), tb["tokens"])
  (grads["embed.table"],) = torch.autograd.grad(xe, model.embed.table,
                                                _np(cots[0]))
  want["embed.table"] = g_embed["table"]
  assert {n for n in grads if not n.startswith("x")} == {
      n for n, _ in model.named_parameters()}
  assert "layers.7.params.slstm.r" in grads
  scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want.values())
  for name, g in grads.items():
    if "norm" not in name:
      assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], scale)


def _spread(fn, params, n=3):
  """``fn(params)`` and the reference's own spread: the largest change of
  it when its embedding table is perturbed by one f32 rounding (a
  relative 2^-24 of random sign), over ``n`` draws."""
  base = np.asarray(fn(params))
  rng = np.random.default_rng(12)
  out = 0.0
  for _ in range(n):
    t = params["embed"]["table"]
    p = dict(params)
    p["embed"] = {"table": (t * (1 + 2.0**-24 * rng.choice(
        [-1.0, 1.0], size=t.shape))).astype(np.float32)}
    out = max(out, float(np.max(np.abs(np.asarray(fn(p)) - base))))
  return base, out


def test_end_to_end_within_the_references_own_rounding_spread(smoke):
  """The whole model end to end, ``forward_train``'s per-token loss over
  2 x 48 tokens and the prefill's logits over 40, against the reference,
  within 4 times the reference's own spread under one rounding of its
  embedding table (``_spread``; about 1e-3 here, so far above the 1e-5 the
  layers are held to one by one)."""
  jcfg, cfg, params, model = smoke
  jb, tb = _batch(jcfg, SEQ, 4)
  want, spread = _spread(jax.jit(
      lambda p: jtransformer.forward_train(jcfg, p, jb)[0]), params)
  with torch.no_grad():
    got = T.forward_train(cfg, model, tb)[0]
  assert 0 < spread < 0.1
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * spread)
  prompt = {"tokens": jb["tokens"][:, :PROMPT]}
  want, spread = _spread(jax.jit(lambda p: jsteps.make_prefill_step(
      jcfg, PROMPT)(p, prompt)[0]), params)
  with torch.inference_mode():
    got, _ = steps.make_prefill_step(cfg)(
        model, {"tokens": tb["tokens"][:, :PROMPT]})
  assert 0 < spread < 0.1
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * spread)


def test_prefill_and_decode_match_the_reference_server(smoke):
  """The reference server's loop (prefill of 40 tokens, then 8 greedy
  decode steps) held layer by layer on its own activations: every layer's
  output and state (mLSTM C, n, m; sLSTM c, n, m, h) of the prefill from
  the reference's input to it, the logits from its final hidden state;
  then at each decode step, from the reference's token and each layer's
  input, the port's layer carrying its own state: the outputs, the states
  (written in place) and the logits.  Then ``forward_prefill`` and
  ``forward_decode`` on the port's own activations: the states they leave
  are those of ``Layer.apply_seq`` and ``apply_decode``."""
  jcfg, cfg, params, model = smoke
  tokens = jpipeline(jcfg, BATCH, PROMPT, seed=3).batch_at(0)["tokens"]
  layers = _ref_layers(params)
  seq = {kind: jax.jit(lambda p, a, kind=kind: jtransformer._layer_apply_seq(
      p, a, jnp.arange(PROMPT), jcfg, kind, collect_cache=True)[::2])
         for kind in set(CYCLE)}
  dec = {kind: jax.jit(lambda p, a, c, kind=kind:
                       jtransformer._layer_apply_decode(
                           p, a, c, jnp.int32(0), jcfg, kind))
         for kind in set(CYCLE)}
  hp = {k: params[k] for k in ("final_norm", "lm_head")}
  head = jax.jit(lambda p, x: jlayers.lm_head_logits(
      p["lm_head"]["w"], jlayers.norm_apply(p["final_norm"], x, jcfg.norm)))

  def port_head(x):
    return L.lm_head_logits(model.lm_head.w, L.norm_apply(
        model.final_norm.tree(), x, cfg.norm))

  def check_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
      assert got[key].dtype == torch.float32
      assert_close(got[key], want[key], want[key])

  with torch.inference_mode():
    x = jlayers.embed_apply(params["embed"], jnp.asarray(tokens))
    states, jstates = [], []
    for (kind, lp), layer in zip(layers, model.layers):
      out, st = seq[kind](lp, x)
      got, _, got_st = layer.apply_seq(_np(x), torch.arange(PROMPT),
                                       collect_cache=True)
      assert_close(got, out, out)
      check_state(got_st, st)
      states.append(got_st)
      jstates.append(st)
      x = out
    want = head(hp, x[:, -1])
    assert_close(port_head(_np(x[:, -1])), want, want)
    for _ in range(GEN - 1):
      x = jlayers.embed_apply(params["embed"], jnp.argmax(want, -1))
      for i, ((kind, lp), layer) in enumerate(zip(layers, model.layers)):
        out, jstates[i] = dec[kind](lp, x, jstates[i])
        got, same = layer.apply_decode(_np(x), states[i], 0)
        assert same is states[i]
        assert_close(got, out, out)
        check_state(states[i], jstates[i])
        x = out
      want = head(hp, x)
      assert_close(port_head(_np(x)), want, want)

    ptoks = torch.from_numpy(tokens).long()
    logits, caches = steps.make_prefill_step(cfg, PROMPT + 1)(
        model, {"tokens": ptoks})
    x = L.embed_apply(model.embed.tree(), ptoks)
    own = []
    for layer, cache in zip(model.layers, caches):
      x, _, st = layer.apply_seq(x, torch.arange(PROMPT), collect_cache=True)
      assert all(torch.equal(cache[key], st[key]) for key in st)
      own.append(st)
    assert torch.equal(logits, port_head(x[:, -1]))
    nxt = serve.greedy(logits)
    logits, caches = steps.make_decode_step(cfg)(model, caches, nxt, PROMPT)
    x = L.embed_apply(model.embed.tree(), nxt)
    for layer, st, cache in zip(model.layers, own, caches):
      x, _ = layer.apply_decode(x, st, PROMPT)
      assert all(torch.equal(cache[key], st[key]) for key in st)
    assert torch.equal(logits, port_head(x))


def test_init_cache_holds_the_xlstm_states():
  """The full config's caches at batch 8, whatever max_len: each ``mlstm``
  layer C (8, 4, 256, 256), n (8, 4, 256), m (8, 4) = -1e30; each
  ``slstm`` layer c, n = 1e-6, m = -10, h (8, 4, 256); all f32."""
  cfg = get_config(ARCH)
  caches = T.init_cache(cfg, 8, 544, "meta")
  assert len(caches) == 24
  for kind, cache in zip(cfg.layer_kinds(), caches):
    want = ({"c": (8, 4, 256, 256), "n": (8, 4, 256), "m": (8, 4)}
            if kind == "mlstm" else dict.fromkeys("cnmh", (8, 4, 256)))
    assert {k: tuple(t.shape) for k, t in cache.items()} == want
    assert all(t.dtype == torch.float32 for t in cache.values())
  small = T.init_cache(smoke_config(ARCH), 1, 4)
  f32 = np.float32
  assert float(small[0]["m"].max()) == float(f32(-1e30))
  assert float(small[7]["n"].max()) == float(f32(1e-6))
  assert float(small[7]["m"].max()) == -10.0


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_command_line_smoke_on_cpu(entry, capsys):
  """Both entry points at smoke size; the CPU launches no kernel (the
  soft-LTS loss runs the plain PAV)."""
  before = ops.all_launches()
  if entry == "serve":
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert len(res["model"].layers) == 16
    assert tuple(res["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
    assert "prefill 2x20" in capsys.readouterr().out
  else:
    res = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--trim-frac", "0.1", "--batch", "2",
                      "--seq", "32", "--corrupt", "0.1"])
    assert res["state"].step == 2
    assert np.isfinite(float(res["metrics"]["loss"]))
    out = capsys.readouterr().out
    assert "done at step 2" in out and "positions/s" in out
    assert "64 positions a step (2 x 32 tokens)" in out
  assert ops.all_launches() == before
