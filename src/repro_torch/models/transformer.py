"""Model assembly: the layer stack by kind, training pass, prefill, decode.

Counterpart of ``repro.models.transformer`` for every layer kind the
reference has, each a mixer and an FFN (``MIXERS``, ``MOE_KINDS``; the
dense FFN is an MLP, ``ffn_variant`` / ``ffn_width``: the config's
``mlp_variant`` and ``d_ff``, SwiGLU, GeGLU or GELU, except in the xLSTM
kinds), under the config's norm (RMSNorm, or LayerNorm with a bias leaf):

  dense     GQA attention + MLP (llama3.2-1b, tinyllama-1.1b, stablelm-3b,
            llava-next-mistral-7b, musicgen-large)
  global    GQA attention + MLP (gemma3-12b's full-attention layers)
  local     GQA attention over the last ``window_size`` positions + MLP
            (gemma3-12b's and recurrentgemma-2b's sliding-window layers,
            ``_window``)
  rg        the RG-LRU recurrent block + MLP (recurrentgemma-2b,
            ``repro_torch.models.recurrent``)
  mlstm     the mLSTM block + the GELU MLP of 2 d_model (xlstm-350m,
            ``repro_torch.models.xlstm``)
  slstm     the sLSTM block + GeGLU of 4/3 d_model rounded to 64
  moe       GQA attention + MoE FFN with the soft top-k router (grok-1)
  mla_moe   MLA attention + MoE FFN with shared experts (deepseek-v2-lite)

Embeddings are tied or not, as the config says (tied: the head is the
embedding table transposed, and the embedded tokens are scaled by
sqrt(d_model), as in the reference); the head's logits are soft-capped
where the config has ``logit_softcap``.  The frontends are the
reference's stubs (``embed_inputs``): ``vision`` puts the batch's
precomputed ``image_embeds`` (B, P, d) before the embedded tokens (scaled
only under RMSNorm with tied embeddings) and takes the loss over the text
region only; ``audio`` has no embedding table, takes the batch's frame
embeddings ``embeds`` (B, S, d) and has ``num_codebooks`` heads
(``codebook_head_<i>``) in place of the LM head, its loss the mean of
theirs over targets (B, S, K) and its logits (B, K, V).  Where the
reference stacks a segment's layers under ``lax.scan``, the port keeps an
``nn.ModuleList`` of one module per layer, in the order the scan visits
them.  ``forward_train`` gives the per-token loss and the aux loss (0
without MoE layers), with the reference's remat: ``"full"`` recomputes
each layer in backward (``torch.utils.checkpoint``, non-reentrant, the
counterpart of ``jax.checkpoint(nothing_saveable)`` around each scan
step), ``"dots"`` keeps the outputs of each layer's products and
recomputes the rest (a selective checkpoint, the counterpart of
``jax.checkpoint(checkpoint_dots)``: ``_dots_context``), ``"none"`` keeps
its activations; another remat, a layer kind or a frontend the reference
does not have raises ``ValueError``.

``init_params`` builds random weights with the reference's distributions
and scales (``attn_init``, ``mla_init``, ``rg_init``, ``mlstm_init`` or
``slstm_init``, ``mlp_init`` or ``moe_init``, the embedding, the LM head
or the codebook heads) directly on the target device and in the config's
dtype, from a seeded ``torch.Generator``;
``repro_torch.models.convert.from_jax_params`` builds the same modules from
the reference's parameters instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as RG
from repro_torch.models import xlstm as XL
from repro_torch.sharding import specs as SP
from repro_torch.sharding import local as _local
from repro_torch.sharding.local import assign, write_positions
from repro_torch.sharding.specs import shard_activation

# Each layer kind's mixer, by its parameter group: GQA attention, MLA, the
# RG-LRU block, the mLSTM or the sLSTM block.
MIXERS = {"dense": "attn", "global": "attn", "local": "attn", "moe": "attn",
          "mla_moe": "mla", "rg": "rg", "mlstm": "mlstm", "slstm": "slstm"}
# The recurrent mixers, each with its sequence pass and decode step: their
# decode cache is a state, copied whole at prefill and updated in place by
# decode.
RECURRENT_SEQ = {"rg": RG.rg_apply_seq, "mlstm": XL.mlstm_apply_seq,
                 "slstm": XL.slstm_apply_seq}
RECURRENT_DECODE = {"rg": RG.rg_apply_decode, "mlstm": XL.mlstm_apply_decode,
                    "slstm": XL.slstm_apply_decode}
RECURRENT = tuple(RECURRENT_SEQ)
# The kinds whose FFN is the MoE FFN; the others' is an MLP (``ffn_variant``).
MOE_KINDS = ("moe", "mla_moe")
KINDS = tuple(MIXERS)
FRONTENDS = ("none", "vision", "audio")


def dtype_of(cfg) -> torch.dtype:
  return getattr(torch, cfg.dtype)


def _window(cfg, kind: str) -> int:
  """The attention window of a layer kind: the config's for ``local``,
  none (0) for every other kind, as in the reference."""
  return cfg.window_size if kind == "local" else 0


def check_supported(cfg) -> None:
  """Raise for a layer kind or frontend the reference does not have
  either (it raises ``ValueError`` for them too)."""
  for kind in cfg.layer_kinds():
    if kind not in KINDS:
      raise ValueError(f"unknown layer kind {kind!r}; the kinds are {KINDS}")
  if cfg.frontend not in FRONTENDS:
    raise ValueError(f"unknown frontend {cfg.frontend!r}; the frontends are "
                     f"{FRONTENDS}")
  if bool(cfg.num_codebooks) != (cfg.frontend == "audio"):
    raise ValueError(f"num_codebooks {cfg.num_codebooks} with the "
                     f"{cfg.frontend!r} frontend: codebook heads are the "
                     "audio frontend's")


def ffn_variant(cfg, kind: str) -> str:
  """A dense layer's MLP: GELU in ``mlstm`` layers, GeGLU in ``slstm``
  layers, the config's ``mlp_variant`` in every other kind (the
  reference's ``_ffn_variant``)."""
  return {"mlstm": "gelu", "slstm": "geglu"}.get(kind, cfg.mlp_variant)


def ffn_width(cfg, kind: str) -> int:
  """A dense layer's MLP width: 2 d_model in ``mlstm`` layers, 4/3 d_model
  rounded to a multiple of 64 (at least 64) in ``slstm`` layers, the
  config's ``d_ff`` in every other kind (the reference's ``_ffn_init``)."""
  if kind == "mlstm":
    return 2 * cfg.d_model
  if kind == "slstm":
    return max(64, int(round(cfg.d_model * 4 / 3 / 64)) * 64)
  return cfg.d_ff


class ParamTree(nn.Module):
  """A nested dict of tensors as a module: tensors become parameters
  (frozen, as serving wants them; the trainer turns gradients on with
  ``requires_grad_``), dicts become sub-modules."""

  def __init__(self, tree: dict):
    super().__init__()
    for name, value in tree.items():
      if isinstance(value, dict):
        self.add_module(name, ParamTree(value))
      else:
        self.register_parameter(
            name, nn.Parameter(value, requires_grad=False))

  def tree(self) -> dict:
    out = dict(self.named_parameters(recurse=False))
    out.update((name, mod.tree()) for name, mod in self.named_children())
    return out


class Layer(nn.Module):
  """One block of kind ``kind``: the pre-norm mixer (GQA attention, over
  the kind's window, MLA, the RG-LRU, mLSTM or sLSTM block, ``MIXERS``),
  then the pre-norm FFN (the MoE FFN for ``MOE_KINDS``, else the kind's
  MLP, ``ffn_variant``)."""

  def __init__(self, cfg, params: dict, kind: str):
    super().__init__()
    self.cfg, self.kind = cfg, kind
    self.mixer = MIXERS[kind]
    self.window = _window(cfg, kind)
    self.params = ParamTree(params)

  def _mix_seq(self, p, h, positions, collect_cache: bool):
    """(mixed, cache or None) of the mixer over the whole sequence (a
    recurrent block's cache: its state after the last position)."""
    if self.mixer in RECURRENT:
      apply = RECURRENT_SEQ[self.mixer]
      if not collect_cache:
        return apply(p[self.mixer], h, self.cfg), None
      return apply(p[self.mixer], h, self.cfg, return_state=True)
    if self.mixer == "attn":
      if not collect_cache:
        return L.attn_apply_seq(p["attn"], h, positions, self.cfg,
                                window=self.window), None
      mixed, (k, v) = L.attn_apply_seq(p["attn"], h, positions, self.cfg,
                                       window=self.window, return_kv=True)
      return mixed, {"k": k, "v": v}
    if not collect_cache:
      return MLA.mla_apply_seq(p["mla"], h, positions, self.cfg), None
    return MLA.mla_apply_seq(p["mla"], h, positions, self.cfg,
                             return_kv=True)

  def _mix_decode(self, p, h, cache, pos: int):
    """(mixed, cache) of one token, the cache updated in place."""
    if self.mixer in RECURRENT:
      return RECURRENT_DECODE[self.mixer](p[self.mixer], h, cache, self.cfg)
    if self.mixer == "attn":
      return L.attn_apply_decode(p["attn"], h, cache, pos, self.cfg,
                                 window=self.window)
    return MLA.mla_apply_decode(p["mla"], h, cache, pos, self.cfg)

  def _ffn(self, p, h):
    """(out, aux): the MoE FFN's aux loss, or 0 for the dense MLP."""
    if self.kind in MOE_KINDS:
      return MOE.moe_apply(p["ffn"], h, self.cfg)
    return (L.mlp_apply(p["ffn"], h, ffn_variant(self.cfg, self.kind)),
            torch.zeros((), dtype=torch.float32, device=h.device))

  def apply_seq(self, x, positions, *, collect_cache: bool = False):
    """Returns (x, aux, cache or None)."""
    cfg, p = self.cfg, self.params.tree()
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    mixed, cache = self._mix_seq(p, h, positions, collect_cache)
    x = shard_activation(x + mixed.to(x.dtype), "residual")
    ff, aux = self._ffn(p, L.norm_apply(p["norm2"], x, cfg.norm))
    return shard_activation(x + ff.to(x.dtype), "residual"), aux, cache

  def apply_train(self, x, positions):
    """(x, aux) of the training pass; the unit that remat recomputes."""
    x, aux, _ = self.apply_seq(x, positions)
    return x, aux

  def apply_decode(self, x, cache, pos: int):
    """x: (B, d).  Returns (x, cache), the cache updated in place."""
    cfg, p = self.cfg, self.params.tree()
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    mixed, cache = self._mix_decode(p, h, cache, pos)
    x = x + mixed.to(x.dtype)
    ff, _ = self._ffn(p, L.norm_apply(p["norm2"], x, cfg.norm))
    return shard_activation(x + ff.to(x.dtype), "residual_decode"), cache


def head_names(cfg) -> tuple[str, ...]:
  """The top-level parameter groups besides the layers, in the order the
  port builds them: the embedding (none for the audio frontend), then the
  codebook heads (audio) or the LM head (untied only), then the final
  norm."""
  names = () if cfg.frontend == "audio" else ("embed",)
  if cfg.num_codebooks:
    names += tuple(f"codebook_head_{i}" for i in range(cfg.num_codebooks))
  elif not cfg.tie_embeddings:
    names += ("lm_head",)
  return names + ("final_norm",)


class Transformer(nn.Module):
  """Embedding, the layer stack, final norm and LM head (none when the
  embeddings are tied: ``head_weight``), or, for the audio frontend, no
  embedding and the codebook heads."""

  def __init__(self, cfg, params: dict):
    """``params``: {"embed": {"table"} (not audio), "lm_head": {"w"}
    (untied only), "codebook_head_<i>": {"w"} (audio only), "final_norm":
    {"scale"[, "bias"]}, "layers": [one dict per layer]}, in the JAX
    layouts."""
    super().__init__()
    check_supported(cfg)
    if len(params["layers"]) != cfg.num_layers:
      raise ValueError(f"{len(params['layers'])} layers given for "
                       f"{cfg.num_layers}")
    want = head_names(cfg)
    if ("lm_head" in want) != ("lm_head" in params):
      raise ValueError(f"tie_embeddings is {cfg.tie_embeddings} but the "
                       f"parameters {'have' if 'lm_head' in params else 'lack'}"
                       " an lm_head")
    if sorted(set(params) - {"layers"}) != sorted(want):
      raise ValueError(f"parameter groups {sorted(params)}, not "
                       f"{sorted(want)} + layers for {cfg.name}")
    self.cfg = cfg
    for name in want:
      self.add_module(name, ParamTree(params[name]))
    self.layers = nn.ModuleList(
        Layer(cfg, lp, kind)
        for lp, kind in zip(params["layers"], cfg.layer_kinds()))

  def head_weight(self) -> torch.Tensor:
    """The LM head (d, V): the embedding table transposed when tied (the
    reference's ``_head_weight``), so its gradient sums both uses."""
    if self.cfg.tie_embeddings:
      return self.embed.table.T
    return self.lm_head.w

  def codebook_heads(self) -> list[torch.Tensor]:
    """The audio frontend's heads (d, V), one a codebook."""
    return [getattr(self, f"codebook_head_{i}").w
            for i in range(self.cfg.num_codebooks)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(cfg, kind, gen, dtype, device) -> dict:
  """One layer's parameters.  A MoE layer draws its FFN before its mixer,
  a dense layer its mixer first: the order the port's seeded weights have
  always had."""
  mixer = MIXERS[kind]

  def init_mixer():
    init = {"attn": L.attn_init, "rg": RG.rg_init, "mla": MLA.mla_init,
            "mlstm": XL.mlstm_init, "slstm": XL.slstm_init}[mixer]
    return init(cfg, gen, dtype, device)

  def init_ffn():
    if kind in MOE_KINDS:
      return MOE.moe_init(cfg, gen, dtype, device)
    return L.mlp_init(gen, cfg.d_model, ffn_width(cfg, kind),
                      ffn_variant(cfg, kind), dtype, device)

  if kind in MOE_KINDS:
    ffn = init_ffn()
    mixed = init_mixer()
  else:
    mixed = init_mixer()
    ffn = init_ffn()
  return {"norm1": L.norm_init(cfg.d_model, cfg.norm, device),
          "norm2": L.norm_init(cfg.d_model, cfg.norm, device),
          mixer: mixed, "ffn": ffn}


def init_params(cfg, seed: int = 0, device="cpu") -> Transformer:
  """Random weights from ``seed``, built on ``device`` in the config's
  dtype (the router, the norms' leaves, the RG-LRU's ``a_param``, the
  mLSTM's gate weights and the sLSTM's biases in f32, as in the
  reference); no LM head when the embeddings are tied, codebook heads in
  its place for the audio frontend (which has no embedding).  On the
  ``meta`` device it builds the shapes alone, as the reference's
  ``jax.eval_shape`` of its init does (a full-depth grok-1 has 590 GiB of
  weights)."""
  check_supported(cfg)
  device = torch.device(device)
  dtype = dtype_of(cfg)
  gen = torch.Generator(device="cpu" if device.type == "meta" else device)
  gen.manual_seed(seed)
  d, v = cfg.d_model, cfg.vocab_size
  params = {}
  for name in head_names(cfg):
    if name == "embed":
      params[name] = L.embed_init(gen, v, d, dtype, device)
    elif name == "final_norm":
      params[name] = L.norm_init(d, cfg.norm, device)
    else:
      params[name] = {"w": L.normal(gen, (d, v), 1.0 / math.sqrt(d), dtype,
                                    device)}
  params["layers"] = [_layer_init(cfg, kind, gen, dtype, device)
                      for kind in cfg.layer_kinds()]
  return Transformer(cfg, params)


def count_params(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())


def decay_mask(model: Transformer) -> dict[str, bool]:
  """Which parameters AdamW decays, by name.  The reference decays the
  leaves of ndim >= 2 in its own layouts, where every layer's leaves carry
  their segment's stacking axis: so every layer leaf (norm scales too),
  and of the others the embedding and the LM head where there is one (the
  tied table is one leaf, decayed once), not the final norm."""
  return {name: name.startswith("layers.") or p.dim() >= 2
          for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Training pass
# ---------------------------------------------------------------------------


def embed_inputs(cfg, model: Transformer, batch: dict) -> torch.Tensor:
  """The model's input (B, S, d) from a batch (the reference's
  ``_embed_inputs``): the embedded ``tokens``, scaled by sqrt(d_model)
  when tied; for ``vision`` the ``image_embeds`` (B, P, d) cast to the
  tokens' dtype before the tokens, which are scaled only under RMSNorm
  with tied embeddings; for ``audio`` the frame embeddings ``embeds``
  cast to the model's dtype."""
  if cfg.frontend == "audio":
    return batch["embeds"].to(dtype_of(cfg))
  if cfg.frontend == "vision":
    tok = L.embed_apply(model.embed.tree(), batch["tokens"],
                        scale=cfg.norm == "rmsnorm" and cfg.tie_embeddings)
    return torch.cat([batch["image_embeds"].to(tok.dtype), tok], dim=1)
  return L.embed_apply(model.embed.tree(), batch["tokens"],
                       scale=cfg.tie_embeddings)


REMATS = ("none", "dots", "full")
# The aten ops that the layers' products (einsum, matmul, F.linear) lower
# to: the outputs that remat "dots" keeps, as checkpoint_dots keeps those of
# dot_general.
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default,
                     torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
  return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
          else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
  """Remat "dots": the products' outputs are kept in forward and handed
  back in the recompute; every other op runs again, the kernels' launches
  through ctypes too (the attention kernel writes into a fresh
  ``torch.empty``, an op that is recomputed, so the recompute never reads a
  buffer of the forward's), each on the same inputs, so that it takes the
  same route (the router's ``pav_l2`` among them; the soft-LTS loss runs
  after the layers, outside any checkpoint)."""
  return create_selective_checkpoint_contexts(_dots_policy)


def forward_train(cfg, model: Transformer, batch: dict):
  """Per-token NLL (B, S) in f32 and the aux loss (a 0-d f32 tensor).  For
  ``vision`` the loss covers the text positions (the last S of the
  ``tokens``); for ``audio`` it is the mean over the codebook heads of
  each head's loss on its targets (``targets`` (B, S, K))."""
  if cfg.remat not in REMATS:
    raise ValueError(f"unknown remat {cfg.remat!r}; the config takes "
                     f"{REMATS}")
  x = embed_inputs(cfg, model, batch)
  positions = torch.arange(x.shape[1], device=x.device)
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for layer in model.layers:
    if cfg.remat == "full":
      x, a = checkpoint(layer.apply_train, x, positions, use_reentrant=False)
    elif cfg.remat == "dots":
      x, a = checkpoint(layer.apply_train, x, positions, use_reentrant=False,
                        context_fn=_dots_context)
    else:
      x, a = layer.apply_train(x, positions)
    aux = aux + a
  x = L.norm_apply(model.final_norm.tree(), x, cfg.norm)
  if cfg.num_codebooks:
    losses = [L.lm_loss_chunked(w, x, batch["targets"][..., i],
                                chunk=cfg.xent_chunk,
                                softcap=cfg.logit_softcap)
              for i, w in enumerate(model.codebook_heads())]
    return torch.mean(torch.stack(losses), dim=0), aux
  if cfg.frontend == "vision":
    x = x[:, -batch["tokens"].shape[1]:]      # loss on the text region only
  loss = L.lm_loss_chunked(model.head_weight(), x, batch["targets"],
                           chunk=cfg.xent_chunk, softcap=cfg.logit_softcap)
  return loss, aux


# ---------------------------------------------------------------------------
# Serving passes
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> list[dict]:
  """One zeroed cache per layer, full length: for a GQA layer (``dense``,
  ``global``, ``local``, ``moe``) k and v (B, max_len, Hkv, dh), for
  ``mla_moe`` the latents c_kv (B, max_len, r) and k_rope (B, max_len,
  rd); for the recurrent kinds their state in f32, whatever ``max_len``:
  ``rg`` h (B, L) and conv (B, W - 1, L), ``mlstm`` C (B, H, dh, dh), n
  (B, H, dh) and m (B, H) = -1e30, ``slstm`` c, n = 1e-6, m = -10 and h
  (B, H, dh).  A ``local`` layer's cache is full length too, as the
  reference keeps it: decode masks the positions below its window."""
  dtype = dtype_of(cfg)

  def one(mixer):
    if mixer == "attn":
      return L.attn_init_cache(cfg, batch, max_len, dtype, device)
    if mixer == "rg":
      return RG.rg_init_state(cfg, batch, device)
    if mixer == "mlstm":
      return XL.mlstm_init_state(cfg, batch, device)
    if mixer == "slstm":
      return XL.slstm_init_state(cfg, batch, device)
    return MLA.mla_init_cache(cfg, batch, max_len, dtype, device)

  return [one(MIXERS[kind]) for kind in cfg.layer_kinds()]


def init_cache_sharded(cfg, batch: int, max_len: int, rules) -> list[dict]:
  """``init_cache`` as DTensors on ``rules.mesh``, each leaf laid out by
  ``cache_specs_tree`` and built as its local block only: each leaf of
  ``init_cache`` holds one value (zeros, or the recurrent states' initial
  m and n), filled into the block."""
  mesh = rules.mesh
  protos = init_cache(cfg, 1, 1, mesh.device_type)
  shapes = init_cache(cfg, batch, max_len, "meta")
  specs = SP.cache_specs_tree(rules, shapes)

  def block(leaf, proto, spec):
    pl = SP.placements(mesh, spec)
    local = list(leaf.shape)
    for i, p in enumerate(pl):
      if isinstance(p, Shard):
        local[p.dim] //= mesh.size(i)
    t = torch.zeros(local, dtype=leaf.dtype, device=mesh.device_type)
    return _local.wrap(t + proto.reshape(-1)[0], mesh, pl)

  return [{name: block(leaf, proto[name], spec[name])
           for name, leaf in shape.items()}
          for proto, shape, spec in zip(protos, shapes, specs)]


def _head(cfg, model: Transformer, x: torch.Tensor) -> torch.Tensor:
  """Logits (B, V), or (B, K, V) over the codebook heads, in f32."""
  x = L.norm_apply(model.final_norm.tree(), x, cfg.norm)
  if cfg.num_codebooks:
    return torch.stack([L.lm_head_logits(w, x, cfg.logit_softcap)
                        for w in model.codebook_heads()], dim=1)
  return L.lm_head_logits(model.head_weight(), x, cfg.logit_softcap)


def forward_prefill(cfg, model: Transformer, batch: dict, max_len: int):
  """Prefill: returns (last-position logits (B, V), or (B, K, V) for the
  audio frontend, f32; caches).

  The input is ``embed_inputs``'s: for ``vision`` the patches and then the
  tokens, so the prefill covers P + S positions and decode goes on at
  position P + S.  The caches hold the k / v (or latents) of every
  position, padded with zeros to ``max_len`` so decode continues in place;
  a recurrent layer's holds its state after the last position (not per
  position: copied whole).
  """
  x = embed_inputs(cfg, model, batch)
  s = x.shape[1]
  if s > max_len:
    raise ValueError(f"prompt of {s} positions exceeds max_len {max_len}")
  positions = torch.arange(s, device=x.device)
  rules = SP.current_rules()
  if rules is not None and isinstance(x, DTensor):
    caches = init_cache_sharded(cfg, x.shape[0], max_len, rules)
  else:
    caches = init_cache(cfg, x.shape[0], max_len, x.device)
  for layer, cache in zip(model.layers, caches):
    x, _, got = layer.apply_seq(x, positions, collect_cache=True)
    for name, latent in got.items():
      if layer.mixer in RECURRENT:
        assign(cache[name], latent)
      else:
        write_positions(cache[name], 0, latent)
  return _head(cfg, model, x[:, -1]), caches


def forward_decode(cfg, model: Transformer, caches: list[dict],
                   inputs: torch.Tensor, pos: int):
  """One decode step.  inputs: (B,) token ids at position ``pos`` (the
  caches' fill level), or for the audio frontend a frame embedding (B, d).
  Returns (logits (B, V), or (B, K, V) for audio, f32; caches), the caches
  written in place."""
  if cfg.frontend == "audio":
    x = inputs.to(dtype_of(cfg))
  else:
    x = L.embed_apply(model.embed.tree(), inputs, scale=cfg.tie_embeddings)
  x = shard_activation(x, "residual_decode")
  for layer, cache in zip(model.layers, caches):
    x, _ = layer.apply_decode(x, cache, pos)
  logits = _head(cfg, model, x)
  if not cfg.num_codebooks:
    logits = shard_activation(logits, "logits_decode")
  return logits, caches
