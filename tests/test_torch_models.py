"""Port of the serving path's model layers against the reference.

MLA (expanded prefill form and absorbed decode form) and the MoE FFN with
the soft top-k router and the softmax top-k baseline router, on
``smoke_config("deepseek-v2-lite-16b")`` in f32,
with the reference's own random weights carried across by
``from_jax_params``, on the same numpy activations.  Also the configs and
the token pipeline, which the port keeps as its own copies.  Tolerance
1e-5 * (1 + max|input|) (``test_torch_common``).
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
    assert_vjp_parity,
    composed_ref,  # noqa: F401
)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import pipeline_for_arch as jpipeline  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.data.pipeline import pipeline_for_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, layers, mla, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
rng = np.random.default_rng(53)
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.fixture(scope="module")
def smoke():
  """(JAX config, port config, JAX params as numpy, port model)."""
  jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
  params = jax.tree.map(np.asarray,
                        jtransformer.init_params(jcfg, jax.random.PRNGKey(3)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


def _layer(params, i):
  return jax.tree.map(lambda a: jnp.asarray(a[i]),
                      params["seg0"]["l0_mla_moe"])


@pytest.mark.parametrize("name", [ARCH, f"{ARCH}-smoke"])
def test_configs_are_the_references(name):
  want = (jget_config(name) if not name.endswith("-smoke")
          else jsmoke_config(ARCH))
  got = get_config(name) if not name.endswith("-smoke") else smoke_config(
      ARCH)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert got.plan_segments() == want.plan_segments()


def test_all_smoke_configs_are_the_references():
  """``all_smoke_configs``: the reference's ten smoke configs, in its
  order, field for field."""
  from repro.configs.smoke import all_smoke_configs as jall
  from repro_torch.configs.smoke import all_smoke_configs
  got, want = all_smoke_configs(), jall()
  assert [c.name for c in got] == [c.name for c in want]
  for g, w in zip(got, want):
    assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_pipeline_gives_the_references_tokens():
  cfg, jcfg = get_config(ARCH), jget_config(ARCH)
  for step, corrupt in ((0, 0.0), (3, 0.25)):
    got = pipeline_for_arch(cfg, 8, 64, seed=5,
                            corrupt_fraction=corrupt).batch_at(step)
    want = jpipeline(jcfg, 8, 64, seed=5,
                     corrupt_fraction=corrupt).batch_at(step)
    assert sorted(got) == sorted(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key])


def test_convert_splits_the_stacked_layers(smoke):
  _, cfg, params, model = smoke
  assert len(model.layers) == cfg.num_layers
  stacked = params["seg0"]["l0_mla_moe"]
  for i, layer in enumerate(model.layers):
    tree = layer.params.tree()
    np.testing.assert_array_equal(tree["mla"]["w_uk"].numpy(),
                                  stacked["mla"]["w_uk"][i])
    np.testing.assert_array_equal(tree["ffn"]["shared"]["w_out"].numpy(),
                                  stacked["ffn"]["shared"]["w_out"][i])
    assert tree["ffn"]["router"].dtype == torch.float32
  n_ref = sum(a.size for a in jax.tree.leaves(params))
  assert sum(p.numel() for p in model.parameters()) == n_ref


def test_convert_carries_bf16_bits():
  a = np.asarray(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16))
  got = convert._tensor(a, "cpu")
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))


def test_rope_norm_mlp_embed_match_reference(smoke):
  _, cfg, params, model = smoke
  x = rng.normal(size=(2, 7, 3, 16))
  pos = np.arange(7)
  assert_close(layers.rope(as_torch(x), torch.arange(7), 1e4),
               jlayers.rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos),
                            1e4), x)
  assert_close(layers.rope(as_torch(x[:, 0]), 5, 1e4),
               jlayers.rope(jnp.asarray(x[:, 0], jnp.float32),
                            jnp.int32(5), 1e4), x)
  h = rng.normal(size=(2, 7, cfg.d_model))
  p = {"scale": rng.normal(size=(cfg.d_model,))}
  assert_close(layers.norm_apply({"scale": as_torch(p["scale"])},
                                 as_torch(h), "rmsnorm"),
               jlayers.norm_apply({"scale": jnp.asarray(p["scale"],
                                                        jnp.float32)},
                                  jnp.asarray(h, jnp.float32), "rmsnorm"),
               h, p["scale"])
  shared = _layer(params, 0)["ffn"]["shared"]
  assert_close(
      layers.mlp_apply(model.layers[0].params.tree()["ffn"]["shared"],
                       as_torch(h), "swiglu"),
      jlayers.mlp_apply(shared, jnp.asarray(h, jnp.float32), "swiglu"), h)
  tokens = rng.integers(0, cfg.vocab_size, (2, 5))
  np.testing.assert_array_equal(
      layers.embed_apply(model.embed.tree(), torch.from_numpy(tokens))
      .numpy(),
      np.asarray(jlayers.embed_apply(params["embed"], jnp.asarray(tokens))))


@pytest.mark.parametrize("what", ["norm", "mlp"])
def test_unported_variants_raise(what):
  """Every norm and MLP variant of the reference's configs is ported; a
  name none of them has raises rather than falling back to another."""
  x = torch.zeros(2, 4)
  with pytest.raises(ValueError, match="unknown"):
    if what == "norm":
      layers.norm_apply({"scale": torch.ones(4)}, x, "groupnorm")
    else:
      layers.mlp_apply({}, x, "relu")


def test_mla_prefill_matches_reference(smoke):
  jcfg, cfg, params, model = smoke
  x = rng.normal(size=(2, 20, cfg.d_model))
  pos = np.arange(20)
  want, want_kv = jax.jit(lambda p, a: jmla.mla_apply_seq(
      p, a, jnp.asarray(pos), jcfg, return_kv=True))(
          _layer(params, 1)["mla"], jnp.asarray(x, jnp.float32))
  got, got_kv = mla.mla_apply_seq(model.layers[1].params.tree()["mla"],
                                  as_torch(x), torch.arange(20), cfg,
                                  return_kv=True)
  assert_close(got, want, x)
  for key in ("c_kv", "k_rope"):
    assert_close(got_kv[key], want_kv[key], x)


def test_mla_decode_matches_reference(smoke):
  jcfg, cfg, params, model = smoke
  b, max_len, pos = 2, 12, 7
  cache = {"c_kv": rng.normal(size=(b, max_len, cfg.kv_lora_rank)),
           "k_rope": rng.normal(size=(b, max_len, cfg.qk_rope_dim))}
  x = rng.normal(size=(b, cfg.d_model))
  want, want_cache = jax.jit(lambda p, a, c: jmla.mla_apply_decode(
      p, a, c, jnp.int32(pos), jcfg))(
          _layer(params, 0)["mla"], jnp.asarray(x, jnp.float32),
          jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), cache))
  tcache = {key: as_torch(a) for key, a in cache.items()}
  got, got_cache = mla.mla_apply_decode(model.layers[0].params.tree()["mla"],
                                        as_torch(x), tcache, pos, cfg)
  assert got_cache is tcache   # written in place
  assert_close(got, want, x, cache["c_kv"])
  for key in cache:
    assert_close(got_cache[key], want_cache[key], x, cache[key])


@pytest.mark.parametrize("shape", [(2, 24), (3,)], ids=["prefill", "decode"])
def test_moe_matches_reference(smoke, shape):
  """(2, 24) pads 48 tokens to two groups of 32 (16 zero rows that take
  capacity); (3,) is a decode batch, one group of 3."""
  jcfg, cfg, params, model = smoke
  x = rng.normal(size=shape + (cfg.d_model,))
  want, want_aux = jax.jit(lambda p, a: jmoe.moe_apply(p, a, jcfg))(
      _layer(params, 0)["ffn"], jnp.asarray(x, jnp.float32))
  before = ops.all_launches()
  with torch.inference_mode():
    got, aux = moe.moe_apply(model.layers[0].params.tree()["ffn"],
                             as_torch(x), cfg)
  assert ops.all_launches() == before   # the CPU runs the plain gates
  assert_close(got, want, x)
  assert_close(aux, want_aux, x)


def test_router_under_autograd_takes_the_soft_topk_operator(smoke,
                                                            monkeypatch):
  """With gradients on, the gates come from core.soft_topk_mask (exact
  Lemma 2 backward), never from the forward-only fused gates; values agree
  with the serving route, values and gradients with the reference."""
  jcfg, cfg, _, _ = smoke
  x = rng.normal(size=(2, 5, cfg.num_experts))
  cot = rng.normal(size=x.shape)
  with torch.no_grad():
    w_serve, _ = moe._router_weights(cfg, as_torch(x))

  def refuse(*args, **kwargs):
    raise AssertionError("fused gates called under autograd")

  monkeypatch.setattr(moe._st, "soft_topk_gates", refuse)
  assert_vjp_parity(lambda a: jmoe._router_weights(jcfg, a)[0],
                    lambda a: moe._router_weights(cfg, a)[0], (x,), cot)
  w, _ = moe._router_weights(cfg, as_torch(x, grad=True))
  assert_close(w, w_serve, x)


def test_dispatch_respects_capacity_and_takes_first_of_equals():
  w = torch.tensor([[[0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.2, 0.3, 0.5]]])
  dispatch, combine = moe._dispatch_mask(w, 1, 1)
  # Tokens 0 and 1 tie between experts 0 and 1: both pick expert 0, which
  # has room for one; token 2 picks expert 2.
  np.testing.assert_array_equal(dispatch[0, :, :, 0].numpy(),
                                [[1, 0, 0], [0, 0, 0], [0, 0, 1]])
  np.testing.assert_allclose(combine.sum().item(), 1.0)


def test_softmax_topk_router_matches_reference(smoke):
  """The baseline router (the reference's ``ArchConfig`` default): values
  and gradients against the reference; the gradient reaches only the
  selected experts' logits plus the softmax's coupling."""
  jcfg, cfg, _, _ = smoke
  jcfg = dataclasses.replace(jcfg, router="softmax_topk")
  cfg = dataclasses.replace(cfg, router="softmax_topk")
  x = rng.normal(size=(2, 5, cfg.num_experts))
  cot = rng.normal(size=x.shape)
  w, _ = assert_vjp_parity(lambda a: jmoe._router_weights(jcfg, a)[0],
                           lambda a: moe._router_weights(cfg, a)[0], (x,),
                           cot)
  assert int((w > 0).sum(-1).min()) == int((w > 0).sum(-1).max()) == \
      cfg.experts_per_token
  with pytest.raises(ValueError, match="router"):
    moe._router_weights(dataclasses.replace(cfg, router="hash"),
                        as_torch(x))


def _router_grads_port(cfg, params, batch):
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  loss, aux = T.forward_train(cfg, model, batch)
  total = torch.mean(loss) + 0.01 * aux
  names, leaves = zip(*[(n, p) for n, p in model.named_parameters()
                        if n.endswith("ffn.router")])
  return dict(zip(names, torch.autograd.grad(total, leaves)))


def _router_grads_reference(jcfg, cfg, params, batch):
  def loss(p):
    tl, aux = jtransformer.forward_train(jcfg, p, batch)
    return jnp.mean(tl) + 0.01 * aux

  g = jax.jit(jax.grad(loss))(params)
  tree = convert.port_tree(cfg, jax.tree.map(np.asarray, g))
  return {n: p for n, p in T.Transformer(cfg, tree).named_parameters()
          if n.endswith("ffn.router")}


def test_soft_topk_router_vs_softmax_router_gradients(smoke):
  """Port of the reference's test of the same name: the paper's router
  sends gradient to every expert logit, softmax top-k only to the selected
  ones, so the soft router's gradient has at least as many non-zero
  entries.  Each router's router gradients are also held to the
  reference's (1e-4 * (1 + max|want|), the trainer tests' bound for
  gradients through the MoE dispatch)."""
  jcfg, cfg, params, _ = smoke
  b = jpipeline(jcfg, 2, 16, seed=7).batch_at(0)
  jbatch = {k: jnp.asarray(b[k]) for k in ("tokens", "targets")}
  tbatch = {k: torch.from_numpy(b[k]).long() for k in ("tokens", "targets")}
  flat = {}
  for router in ("soft_topk", "softmax_topk"):
    jc = dataclasses.replace(jcfg, router=router)
    c = dataclasses.replace(cfg, router=router)
    got = _router_grads_port(c, params, tbatch)
    want = _router_grads_reference(jc, c, params, jbatch)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
      w = want[name].detach().numpy()
      np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                 atol=1e-4 * (1 + np.abs(w).max()),
                                 err_msg=f"{router} {name}")
    flat[router] = np.concatenate([g.numpy().ravel() for g in got.values()])
  assert np.isfinite(flat["soft_topk"]).all()
  assert np.isfinite(flat["softmax_topk"]).all()
  nz_soft = np.mean(np.abs(flat["soft_topk"]) > 1e-12)
  nz_hard = np.mean(np.abs(flat["softmax_topk"]) > 1e-12)
  assert nz_soft >= nz_hard
