"""The vision and audio frontends (llava-next-mistral-7b, musicgen-large)
against the reference.

Both are the reference's stubs: the vision model takes precomputed patch
embeddings before its text tokens and takes the loss over the text only;
the audio model takes frame embeddings, has no embedding table and four
codebook heads.  Here, at smoke size in f32 (2 ``dense`` layers of d_model
64; llava 4 heads over 2 kv heads, SwiGLU, RMSNorm, 8 patches; musicgen 4
heads over 4, LayerNorm, GELU, 4 codebooks of 256), with the reference's
own weights carried across by ``from_jax_params`` (an audio model has no
``embed`` and carries ``codebook_head_<i>``): both pipeline branches bit
for bit; the vision model's training pass (the text-region loss and every
gradient), the embedding-scale rule, prefill and decode at the prefill's
length against the reference there; fault R6 of the reference (its
server decodes at ``prompt_len + num_patches``, which counts the patches
twice: shown against its own longer prefill); the audio model's mean loss
over the codebooks and every gradient, its (B, 4, V) prefill and decode
over frames; the servers' refusal of audio and of a vision prompt no
longer than its patches; both trainers' command lines; and the three new
configs' parameter counts at full width on the meta device against the
reference's ``eval_shape``.  The reference runs jitted, with
``REPRO_PROJECTION=composed`` (``composed_ref``).  Tolerance: 1e-5 * (1 +
max|ref|) (``test_torch_common.assert_close`` scaled by the wanted value;
gradients by the largest gradient).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    assert_close,
    composed_ref,  # noqa: F401
)

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.smoke import smoke_config as jsmoke_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

VISION, AUDIO = "llava-next-mistral-7b", "musicgen-large"
BATCH, SEQ, GEN = 2, 24, 5
PROMPT = 12          # 8 patches + 4 tokens at smoke size
pytestmark = pytest.mark.usefixtures("composed_ref")


def _smoke(arch, seed):
  jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
  params = jax.tree.map(np.asarray, jtransformer.init_params(
      jcfg, jax.random.PRNGKey(seed)))
  return jcfg, cfg, params, convert.from_jax_params(cfg, params)


@pytest.fixture(scope="module")
def vision():
  """(JAX config, port config, JAX params as numpy, port model)."""
  return _smoke(VISION, 13)


@pytest.fixture(scope="module")
def audio():
  return _smoke(AUDIO, 14)


def _port_leaves(cfg, tree) -> dict:
  """A pytree in the reference's layout, by the port's parameter names."""
  return dict(T.Transformer(cfg, convert.port_tree(
      cfg, jax.tree.map(np.asarray, tree))).named_parameters())


def _batches(jcfg, seq, seed, corrupt=0.1):
  """The reference pipeline's batch of step 0, as JAX arrays and as
  tensors (ids int64)."""
  b = jpipeline.pipeline_for_arch(jcfg, BATCH, seq, seed=seed,
                                  corrupt_fraction=corrupt).batch_at(0)
  b.pop("corrupt_mask", None)
  return ({k: jnp.asarray(v) for k, v in b.items()},
          {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
           else torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", [VISION, AUDIO])
@pytest.mark.parametrize("corrupt", [0.0, 0.1])
def test_pipeline_branches_are_the_references_bit_for_bit(arch, corrupt):
  """Steps 0-2, one host and host 1 of 2: every array (vision tokens,
  patch embeddings and text targets; audio frame embeddings and (B, S, 4)
  targets; the corrupt mask) equal, dtype and all."""
  for full in (False, True):
    jcfg = jget_config(arch) if full else jsmoke_config(arch)
    cfg = get_config(arch) if full else smoke_config(arch)
    seq = 600 if full else SEQ
    for hosts, host in ((1, 0), (2, 1)):
      want = jpipeline.pipeline_for_arch(
          jcfg, 4, seq, seed=5, num_hosts=hosts, host_id=host,
          corrupt_fraction=corrupt)
      got = pipeline.pipeline_for_arch(
          cfg, 4, seq, seed=5, num_hosts=hosts, host_id=host,
          corrupt_fraction=corrupt)
      for step in range(3) if not full else (7,):
        w, g = want.batch_at(step), got.batch_at(step)
        assert sorted(g) == sorted(w)
        for key in w:
          assert g[key].dtype == w[key].dtype, key
          np.testing.assert_array_equal(g[key], w[key])
  b = got.batch_at(0)
  if arch == VISION:
    assert b["tokens"].shape == (2, seq - 576)
    assert b["image_embeds"].shape == (2, 576, 4096)
  else:
    assert b["embeds"].shape == (2, seq, 2048)
    assert b["targets"].shape == (2, seq, 4)


def test_vision_pipeline_refuses_fewer_positions_than_patches():
  with pytest.raises(ValueError, match="patches"):
    pipeline.pipeline_for_arch(smoke_config(VISION), 2, 7)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_training_pass_and_gradients_match_reference(arch, vision, audio):
  """forward_train's per-token loss (vision: over the text region only,
  (B, S - P); audio: the mean of the four codebook heads' losses, (B, S))
  and the gradient of its mean on every leaf (the codebook heads, or the
  patches' path into the embedding-free layers), against ``jax.grad``."""
  jcfg, cfg, params, _ = vision if arch == VISION else audio
  jb, tb = _batches(jcfg, SEQ, 4)

  def mean_loss(p):
    tl, aux = jtransformer.forward_train(jcfg, p, jb)
    return jnp.mean(tl) + 0.01 * aux, tl

  (_, want_tl), want_g = jax.jit(jax.value_and_grad(mean_loss,
                                                    has_aux=True))(params)
  model = convert.from_jax_params(cfg, params).requires_grad_(True)
  loss, aux = T.forward_train(cfg, model, tb)
  text = SEQ - cfg.num_patches if arch == VISION else SEQ
  assert loss.shape == (BATCH, text) and float(aux) == 0.0
  assert_close(loss, want_tl, want_tl)
  names, leaves = zip(*model.named_parameters())
  grads = dict(zip(names, torch.autograd.grad(torch.mean(loss), leaves)))
  want = _port_leaves(cfg, want_g)
  assert sorted(want) == sorted(grads)
  if arch == AUDIO:
    assert "embed.table" not in grads and "lm_head.w" not in grads
    assert [n for n in grads if n.startswith("codebook")] == [
        f"codebook_head_{i}.w" for i in range(4)]
  scale = max(float(w.abs().max()) for w in want.values())
  for name, g in grads.items():
    if "norm" not in name:
      assert bool(torch.any(g != 0)), name
    assert_close(g, want[name], scale)


@pytest.mark.parametrize("norm, tie", [("rmsnorm", False), ("rmsnorm", True),
                                       ("layernorm", True)])
def test_vision_embedding_scale_rule(vision, norm, tie):
  """The patches go first, then the tokens, scaled by sqrt(d_model) only
  under RMSNorm with tied embeddings (the reference's ``_embed_inputs``);
  the patches never."""
  jcfg, cfg, params, _ = vision
  jcfg = dataclasses.replace(jcfg, norm=norm, tie_embeddings=tie)
  cfg = dataclasses.replace(cfg, norm=norm, tie_embeddings=tie)
  jb, tb = _batches(jcfg, SEQ, 6)
  want, _ = jax.jit(lambda p, b: jtransformer._embed_inputs(jcfg, p, b))(
      params, jb)
  if tie:
    params = {k: v for k, v in params.items() if k != "lm_head"}
  params = jax.tree.map(np.asarray, params)
  if norm == "layernorm":
    params["final_norm"] = {"scale": params["final_norm"]["scale"],
                            "bias": np.zeros_like(params["final_norm"][
                                "scale"])}
    for seg in params["seg0"].values():
      for n in ("norm1", "norm2"):
        seg[n] = {"scale": seg[n]["scale"],
                  "bias": np.zeros_like(seg[n]["scale"])}
  model = convert.from_jax_params(cfg, params)
  got = T.embed_inputs(cfg, model, tb)
  assert tuple(got.shape) == (BATCH, SEQ, cfg.d_model)
  assert_close(got, want, want)
  np.testing.assert_array_equal(got[:, :cfg.num_patches].numpy(),
                                np.asarray(jb["image_embeds"]))
  scaled = norm == "rmsnorm" and tie
  table = model.embed.table[tb["tokens"]]
  np.testing.assert_allclose(
      got[:, cfg.num_patches:].numpy(),
      (table * (8.0 if scaled else 1.0)).detach().numpy(), rtol=1e-6)


def _reference_prefill(jcfg, params, batch, max_len):
  logits, caches = jax.jit(jsteps.make_prefill_step(jcfg, max_len))(
      params, batch)
  return np.asarray(logits), caches


def test_vision_prefill_and_decode_at_the_prefill_length(vision):
  """A prompt of 8 patches and 4 tokens: the prefill's logits and every
  layer's k / v over its 12 positions, then 4 greedy decode steps from
  position 12, the prefill's length, each against the reference's own
  decode step at that position (the logits and caches)."""
  jcfg, cfg, params, model = vision
  jb, tb = _batches(jcfg, PROMPT, 3, corrupt=0.0)
  jb = {k: jb[k] for k in ("tokens", "image_embeds")}
  tb = {k: tb[k] for k in ("tokens", "image_embeds")}
  assert tb["tokens"].shape == (BATCH, PROMPT - cfg.num_patches)
  assert steps.prefill_length(cfg, tb) == PROMPT
  max_len = PROMPT + GEN
  want, jcaches = _reference_prefill(jcfg, params, jb, max_len)
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  with torch.inference_mode():
    got, caches = steps.make_prefill_step(cfg, max_len)(model, tb)
    assert_close(got, want, want)
    for i, cache in enumerate(caches):
      for key in ("k", "v"):
        w = np.asarray(jcaches[0]["l0_dense"][key][i])
        assert tuple(cache[key].shape) == w.shape
        assert_close(cache[key], w, w)
    tok = serve.greedy(got)
    for t in range(GEN - 1):
      want, jcaches = decode(params, jcaches, jnp.asarray(tok.numpy()),
                             jnp.int32(PROMPT + t))
      got, caches = steps.make_decode_step(cfg)(model, caches, tok,
                                                PROMPT + t)
      assert_close(got, want, want)
      tok = serve.greedy(got)


def test_fault_r6_the_references_server_counts_the_patches_twice(vision):
  """Fault R6: the reference's pipeline counts the patches in
  ``prompt_len`` (4 tokens after 8 patches at ``prompt_len`` 12), but its
  server decodes the next token at ``prompt_len + num_patches`` (20).
  Against the reference's own prefill of the 13-position prompt (the
  same patches and tokens, then that token): its decode step at 12 agrees
  within 1e-5, its step at 20 does not (RoPE puts the token 8 positions
  too far).  The port's server decodes at the prefill's length, 12, and
  agrees with the longer prefill as the reference's step at 12 does."""
  jcfg, cfg, params, model = vision
  jb, tb = _batches(jcfg, PROMPT, 3, corrupt=0.0)
  jb = {k: jb[k] for k in ("tokens", "image_embeds")}
  tb = {k: tb[k] for k in ("tokens", "image_embeds")}
  nxt = jb["tokens"][:, :1] * 0 + 7
  longer = dict(jb, tokens=jnp.concatenate([jb["tokens"], nxt], axis=1))
  want, _ = _reference_prefill(jcfg, params, longer, PROMPT + 1)
  _, jcaches = _reference_prefill(jcfg, params, jb, PROMPT + 4 + 8)
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  at_len = np.asarray(decode(params, jcaches, nxt[:, 0],
                             jnp.int32(PROMPT))[0])
  _, jcaches = _reference_prefill(jcfg, params, jb, PROMPT + 4 + 8)
  at_ref = np.asarray(decode(params, jcaches, nxt[:, 0],
                             jnp.int32(PROMPT + cfg.num_patches))[0])
  assert_close(at_len, want, want)
  assert float(np.max(np.abs(at_ref - want))) > 1e-2
  res = serve.generate(cfg, model, tb, 2)
  with torch.inference_mode():
    _, caches = steps.make_prefill_step(cfg, PROMPT + 1)(model, tb)
    got, _ = steps.make_decode_step(cfg)(model, caches,
                                         torch.full((BATCH,), 7), PROMPT)
  assert_close(got, want, want)
  assert tuple(res["tokens"].shape) == (BATCH, 2)


def test_audio_prefill_and_decode_over_frames(audio):
  """Prefill of 12 frame embeddings: (B, 4, V) logits, one row a codebook
  head, and every layer's k / v; then 4 decode steps, each fed the
  pipeline's next frame (B, d), against the reference's."""
  jcfg, cfg, params, model = audio
  jb, tb = _batches(jcfg, PROMPT + GEN, 3, corrupt=0.0)
  frames = jb["embeds"]
  max_len = PROMPT + GEN
  want, jcaches = _reference_prefill(
      jcfg, params, {"embeds": frames[:, :PROMPT]}, max_len)
  decode = jax.jit(jsteps.make_decode_step(jcfg))
  prompt = {"embeds": tb["embeds"][:, :PROMPT]}
  assert steps.prefill_length(cfg, prompt) == PROMPT
  with torch.inference_mode():
    got, caches = steps.make_prefill_step(cfg, max_len)(model, prompt)
    assert tuple(got.shape) == (BATCH, 4, cfg.vocab_size)
    assert_close(got, want, want)
    for i, cache in enumerate(caches):
      for key in ("k", "v"):
        w = np.asarray(jcaches[0]["l0_dense"][key][i])
        assert_close(cache[key], w, w)
    for t in range(GEN - 1):
      want, jcaches = decode(params, jcaches, frames[:, PROMPT + t],
                             jnp.int32(PROMPT + t))
      got, caches = steps.make_decode_step(cfg)(
          model, caches, tb["embeds"][:, PROMPT + t], PROMPT + t)
      assert tuple(got.shape) == (BATCH, 4, cfg.vocab_size)
      assert_close(got, want, want)
  assert tuple(serve.greedy(got).shape) == (BATCH, 4)


def test_servers_refuse_audio_and_short_vision_prompts():
  """``serve.main`` refuses audio, as the reference does (it points to the
  steps), and a vision prompt that does not exceed its patches (the
  reference's pipeline raises a numpy error below them)."""
  with pytest.raises(SystemExit, match="make_prefill_step"):
    serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])
  with pytest.raises(ValueError, match="counts the 8 patches"):
    serve.main(["--arch", VISION, "--smoke", "--device", "cpu",
                "--prompt-len", "8"])
  with pytest.raises(ValueError, match="decodes token ids"):
    serve.generate(smoke_config(AUDIO), None, {"embeds": torch.zeros(1)}, 2)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_command_lines_on_cpu(arch, capsys):
  """The vision server at smoke size (12 positions: 8 patches + 4
  tokens), and both trainers (their batches' embeddings kept f32 on the
  way in, the positions a step counted with the patches or the frames);
  the CPU launches no kernel."""
  before = ops.all_launches()
  if arch == VISION:
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(PROMPT),
                      "--gen", "3"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert sorted(res["batch"]) == ["image_embeds", "tokens"]
    assert bool(torch.isfinite(res["logits"]).all())
    assert "prefill 2x12 (8 patches + 4 tokens)" in capsys.readouterr().out
  res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--trim-frac", "0.1", "--batch", "2",
                    "--seq", str(SEQ), "--corrupt", "0.1"])
  assert res["state"].step == 2
  assert np.isfinite(float(res["metrics"]["loss"]))
  batch = res["trainer"].batch_at(0)
  key = "image_embeds" if arch == VISION else "embeds"
  assert batch[key].dtype == torch.float32
  assert batch["targets"].dtype == torch.int64
  what = ("text tokens and 8 patches" if arch == VISION
          else "audio frames")
  out = capsys.readouterr().out
  assert f"48 positions a step (2 x {SEQ} {what})" in out
  assert ops.all_launches() == before


@pytest.mark.parametrize("arch, want", [
    ("xlstm-350m", 332_748_884),
    (VISION, 7_241_732_096),
    (AUDIO, 2_433_093_632)])
def test_full_width_parameter_counts_are_the_references(arch, want):
  """The port's shapes on the meta device against the reference's
  ``eval_shape``: every leaf by name and shape, and the totals (xlstm-350m
  0.62 GiB untied, llava 13.49 GiB, musicgen 4.53 GiB with no embedding
  and four 2048 x 2048 codebook heads)."""
  shapes = jax.eval_shape(lambda: jtransformer.init_params(
      jget_config(arch), jax.random.PRNGKey(0)))
  assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == want
  cfg = get_config(arch)
  model = T.init_params(cfg, 0, "meta")
  assert T.count_params(model) == want
  got = dict(model.named_parameters())
  assert "embed.table" in got or arch == AUDIO
  if arch == AUDIO:
    assert "embed" not in shapes and "lm_head" not in shapes
    assert all(tuple(got[f"codebook_head_{i}.w"].shape) == (2048, 2048)
               for i in range(4))
  gib = sum(p.numel() * p.element_size() for p in got.values()) / 2**30
  assert round(gib, 2) == {"xlstm-350m": 0.62, VISION: 13.49,
                           AUDIO: 4.53}[arch]


def test_every_reference_config_is_ported_and_supported():
  """Every config the reference registers (``all_assigned``) is the port's
  field for field, its smoke variant too, and ``check_supported`` passes
  for each; an unknown name raises ``ValueError``."""
  from repro.configs.base import all_assigned

  from repro_torch.configs.base import ASSIGNED

  assert tuple(all_assigned()) == ASSIGNED
  for name in ASSIGNED:
    for got, want in ((get_config(name), jget_config(name)),
                      (smoke_config(name), jsmoke_config(name))):
      assert dataclasses.asdict(got) == dataclasses.asdict(want), name
      T.check_supported(got)
  with pytest.raises(ValueError, match="unknown config"):
    get_config("gpt-2")
