"""The port's ``moe`` layer kind (grok-1-314b) against the reference.

``smoke_config("grok-1-314b")`` (GQA attention with G = 2, the MoE FFN
with the soft top-k router over 8 experts, top-2, no shared experts, an
untied head with logit soft-cap 30) in f32, and the same config replaced
to 6 query heads over 1 kv head (G = 6, grok's own G, which does not
divide the attention kernel's 128-row tile), with the reference's own
random weights carried across by ``from_jax_params`` and the same numpy
inputs and token batches: the attention layer over a sequence and one
decode step, the MoE FFN, the training pass (per-token loss, and the
gradient of every leaf against ``jax.grad``, through the soft top-k
router's Lemma 2 backward), prefill (logits and the padded caches) and 4
greedy decode steps through the soft-capped head.  Also the configs, the
parameter counts (at smoke size, and at full width from the reference's
``eval_shape`` at 64 and 6 layers), the command line with ``--set``, and
deepseek's seeded smoke weights, which the shared ``moe_init`` must leave
as they were.  The reference runs jitted, with ``REPRO_PROJECTION=
composed`` (``composed_ref``).  Tolerance: 1e-5 * (1 + max|ref|)
(``test_torch_common.assert_close`` scaled by the wanted value).
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import convert, layers, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "grok-1-314b"
BATCH, SEQ, PROMPT, GEN = 2, 32, 24, 5
# The smoke config as it is (G = 2), and with grok's G = 6.
VARIANTS = {"smoke": {}, "g6": {"num_heads": 6, "num_kv_heads": 1}}
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def smoke(request):
  """(JAX config, port config, JAX params as numpy, port model)."""
  over = VARIANTS[request.param]
  jcfg = dataclasses.replace(jsmoke_config(ARCH), **over)
  cfg = dataclasses.replace(smoke_config(ARCH), **over)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(7)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  return jax.tree.map(lambda a: jnp.asarray(a[i]), params["seg0"]["l0_moe"])


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


@pytest.mark.parametrize("smoke_", [False, True], ids=["full", "smoke"])
def test_configs_are_the_references(smoke_):
  want = jsmoke_config(ARCH) if smoke_ else jget_config(ARCH)
  got = smoke_config(ARCH) if smoke_ else get_config(ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments()
  assert got.layer_kinds() == ["moe"] * got.num_layers


def test_smoke_has_the_references_parameter_count():
  cfg = smoke_config(ARCH)
  jparams = jtransformer.init_params(jsmoke_config(ARCH),
                                     jax.random.PRNGKey(0))
  model = T.init_params(cfg, 0)
  assert T.count_params(model) == jtransformer.count_params(jparams) == \
      156_992
  assert hasattr(model, "lm_head") and "shared" not in \
      model.layers[0].params.tree()["ffn"]


@pytest.mark.parametrize("layers_, want", [(64, 316_489_340_928),
                                           (6, 31_130_499_072)])
def test_full_width_parameter_count_is_the_references(layers_, want):
  """The port's shapes on the meta device against the reference's
  ``eval_shape``: the whole model, and the 6 layers one card serves."""
  cfg = dataclasses.replace(get_config(ARCH), num_layers=layers_)
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      dataclasses.replace(jget_config(ARCH), num_layers=layers_),
      jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == want
  model = T.init_params(cfg, 0, "meta")
  assert T.count_params(model) == want
  assert {p.dtype for n, p in model.named_parameters()
          if "norm" not in n and "router" not in n} == {torch.bfloat16}


def test_convert_splits_the_moe_layers(smoke):
  _, cfg, params, model = smoke
  assert len(model.layers) == cfg.num_layers
  stacked = params["seg0"]["l0_moe"]
  for i, layer in enumerate(model.layers):
    assert layer.kind == "moe" and layer.mixer == "attn"
    tree = layer.params.tree()
    assert sorted(tree) == ["attn", "ffn", "norm1", "norm2"]
    for group, leaf in (("attn", "wk"), ("ffn", "router"), ("ffn", "we_out")):
      np.testing.assert_array_equal(tree[group][leaf].numpy(),
                                    stacked[group][leaf][i])
    assert tree["ffn"]["router"].dtype == torch.float32
  assert T.count_params(model) == sum(a.size
                                      for a in jax.tree.leaves(params))


def test_attention_layer_matches_reference(smoke):
  jcfg, cfg, params, model = smoke
  rng = np.random.default_rng(71)
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
  rng = np.random.default_rng(72)
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


@pytest.mark.parametrize("shape", [(2, 24), (3,)], ids=["prefill", "decode"])
def test_moe_matches_reference(smoke, shape):
  """The MoE FFN without shared experts: (2, 24) pads 48 tokens to two
  groups of 32, (3,) is a decode batch, one group of 3; the CPU runs the
  plain gates and launches nothing."""
  jcfg, cfg, params, model = smoke
  x = np.random.default_rng(73).normal(size=shape + (cfg.d_model,))
  want, want_aux = jax.jit(lambda p, a: jmoe.moe_apply(p, a, jcfg))(
      _layer(params, 1)["ffn"], jnp.asarray(x, jnp.float32))
  before = ops.all_launches()
  with torch.inference_mode():
    got, aux = moe.moe_apply(model.layers[1].params.tree()["ffn"],
                             as_torch(x), cfg)
  assert ops.all_launches() == before
  assert_close(got, want, want)
  assert_close(aux, want_aux, want_aux)


def test_forward_train_and_gradients_match_reference(smoke):
  """The per-token loss (through the soft-capped head) and the gradient
  of its mean plus 0.01 of the aux loss on every leaf, the routers'
  through the soft top-k router's Lemma 2 backward, against ``jax.grad``
  of the reference's, split per layer by ``port_tree``."""
  jcfg, cfg, params, _ = smoke
  b = jpipeline(jcfg, BATCH, SEQ, seed=4, corrupt_fraction=0.1).batch_at(0)
  jb = {k: jnp.asarray(b[k]) for k in ("tokens", "targets")}
  tb = {k: torch.from_numpy(b[k]).long() for k in ("tokens", "targets")}

  def mean_loss(p):
    tl, aux = jtransformer.forward_train(jcfg, p, jb)
    return jnp.mean(tl) + 0.01 * aux, (tl, aux)

  (_, (want_tl, want_aux)), want_g = jax.jit(
      jax.value_and_grad(mean_loss, has_aux=True))(params)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  loss, aux = T.forward_train(cfg, model, tb)
  assert loss.shape == (BATCH, SEQ)
  assert_close(loss, want_tl, want_tl)
  assert_close(aux, want_aux, want_aux)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(
      torch.mean(loss) + 0.01 * aux, leaves)))
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads) and "lm_head.w" in grads
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
  within the soft-cap at every step, the tokens, and the caches after the
  last step."""
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
        want = want_pcaches[0]["l0_moe"][key][i]
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
    assert float(got.abs().max()) <= cfg.logit_softcap
    assert_close(got, want, want)
  np.testing.assert_array_equal(torch.stack(got_tokens, 1).numpy(),
                                want_tokens)
  for i, cache in enumerate(caches):
    for key in ("k", "v"):
      want = np.asarray(want_caches[0]["l0_moe"][key][i])
      assert_close(cache[key], want, want)


def test_command_line_smoke_on_cpu(capsys):
  """``--set`` cuts the depth before the model is built; the CPU runs the
  plain versions and launches nothing."""
  before = ops.all_launches()
  res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--set",
                    "num_layers=2", "--batch", "2", "--prompt-len", "8",
                    "--gen", "3"])
  assert res["cfg"].num_layers == len(res["model"].layers) == 2
  assert tuple(res["tokens"].shape) == (2, 3)
  assert float(res["logits"].abs().max()) <= 30.0
  out = capsys.readouterr().out
  assert "grok-1-314b-smoke on cpu: 2 layers" in out and "prefill 2x8" in out
  assert ops.all_launches() == before
  res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--set",
                    "num_layers=3", "--set", "num_heads=6", "--set",
                    "num_kv_heads=1", "--batch", "2", "--prompt-len", "8",
                    "--gen", "2"])
  assert (res["cfg"].num_layers, res["cfg"].num_heads) == (3, 6)


# Deepseek's smoke weights from seed 0 as the port drew them before the MoE
# FFN's init moved into ``moe.moe_init``: each leaf's sum in f64 and its
# first, middle and last elements.
DEEPSEEK_DIGEST = {
    "embed.table": (-2.4822539952688203, -0.022516796365380287,
                    0.005303145386278629, -0.02156415954232216),
    "lm_head.w": (-35.86208169094061, -0.06897950917482376,
                  0.0488588884472847, 0.1406719833612442),
    "layers.0.params.mla.wq": (6.334448729865471, 0.08497732132673264,
                               -0.23069341480731964, 0.14108222723007202),
    "layers.0.params.mla.w_dkv": (-2.032773082566564, 0.056072335690259933,
                                  0.23074693977832794, 0.12274391204118729),
    "layers.0.params.mla.w_uk": (3.7021576201805146, -0.08409970253705978,
                                 0.1288428157567978, -0.009946908801794052),
    "layers.0.params.mla.w_uv": (-2.984073322142649, 0.21281559765338898,
                                 0.04041353240609169, 0.08677993714809418),
    "layers.0.params.mla.wo": (1.8631675367505522, 0.1506493240594864,
                               -0.019812822341918945, -0.016797639429569244),
    "layers.0.params.ffn.router": (-3.3533170961163705,
                                   -0.12225152552127838,
                                   -0.06107504665851593,
                                   0.09063589572906494),
    "layers.0.params.ffn.we_in": (5.818556989685021, -0.042485713958740234,
                                  -0.19035132229328156, 0.10618388652801514),
    "layers.0.params.ffn.we_gate": (17.713628625632737,
                                    -0.03561932221055031,
                                    0.18167538940906525, 0.2582433521747589),
    "layers.0.params.ffn.we_out": (4.023800953130831, 0.014606691896915436,
                                   0.30764323472976685, 0.10276725888252258),
    "layers.0.params.ffn.shared.w_in": (-0.6526829758022359,
                                        -0.03474516049027443,
                                        0.04981466010212898,
                                        -0.06213369220495224),
    "layers.0.params.ffn.shared.w_gate": (-4.244994581886203,
                                          0.12550874054431915,
                                          -0.08861005306243896,
                                          0.007405342534184456),
    "layers.0.params.ffn.shared.w_out": (-2.267326857025182,
                                         0.13864703476428986,
                                         0.24763983488082886,
                                         -0.033518560230731964),
    "layers.1.params.mla.wq": (-11.115183563925711, 0.0776742473244667,
                               0.12207559496164322, -0.21025174856185913),
    "layers.1.params.mla.wo": (-0.3708497763127525, -0.1860434114933014,
                               -0.13581228256225586, -0.1656835526227951),
    "layers.1.params.ffn.router": (0.4618976938072592, 0.016969192773103714,
                                   0.08546387404203415, -0.18427377939224243),
    "layers.1.params.ffn.we_in": (-24.537275511026564, 0.023595869541168213,
                                  -0.003315073437988758, 0.08528923988342285),
    "layers.1.params.ffn.shared.w_out": (-4.063831872561423,
                                         -0.026616284623742104,
                                         0.1359313726425171,
                                         0.3669360280036926),
}


def test_deepseek_smoke_weights_are_unchanged():
  """``moe_init`` and ``mla_init`` draw deepseek's leaves in the order and
  at the scales the port's ``init_params`` always had: the same seeded
  weights, element for element, and sums within f64 rounding."""
  model = T.init_params(smoke_config("deepseek-v2-lite-16b"), 0)
  leaves = dict(model.named_parameters())
  assert len(leaves) == 31
  for name, (total, first, middle, last) in DEEPSEEK_DIGEST.items():
    flat = leaves[name].detach().reshape(-1)
    assert [float(flat[0]), float(flat[flat.numel() // 2]),
            float(flat[-1])] == [first, middle, last], name
    np.testing.assert_allclose(float(leaves[name].double().sum()), total,
                               rtol=1e-12, err_msg=name)
  for name, p in leaves.items():
    if "norm" in name:
      assert bool((p == 1).all()), name
