"""Model assembly: the layer stack by kind, training pass, prefill, decode.

Counterpart of ``repro.models.transformer`` for six layer kinds, each a
mixer and an FFN (``MIXERS``, ``MOE_KINDS``; the dense FFN is the MLP of
the config's ``mlp_variant``, SwiGLU, GeGLU or GELU), under the config's
norm (RMSNorm, or LayerNorm with a bias leaf):

  dense     GQA attention + MLP (llama3.2-1b, tinyllama-1.1b, stablelm-3b)
  global    GQA attention + MLP (gemma3-12b's full-attention layers)
  local     GQA attention over the last ``window_size`` positions + MLP
            (gemma3-12b's and recurrentgemma-2b's sliding-window layers,
            ``_window``)
  rg        the RG-LRU recurrent block + MLP (recurrentgemma-2b,
            ``repro_torch.models.recurrent``)
  moe       GQA attention + MoE FFN with the soft top-k router (grok-1)
  mla_moe   MLA attention + MoE FFN with shared experts (deepseek-v2-lite)

Embeddings are tied or not, as the config says (tied: the head is the
embedding table transposed, and the embedded tokens are scaled by
sqrt(d_model), as in the reference); the head's logits are soft-capped
where the config has ``logit_softcap``.  Where the reference stacks a
segment's layers under ``lax.scan``, the port keeps an ``nn.ModuleList``
of one module per layer, in the order the scan visits them.
``forward_train`` gives the per-token loss and the aux loss (0 without MoE
layers), with the reference's remat: ``"full"`` recomputes each layer in
backward (``torch.utils.checkpoint``, non-reentrant, the counterpart of
``jax.checkpoint(nothing_saveable)`` around each scan step), ``"none"``
keeps its activations.  Other layer kinds, frontends and remat ``"dots"``
raise ``NotImplementedError``.

``init_params`` builds random weights with the reference's distributions
and scales (``attn_init``, ``mla_init`` or ``rg_init``, ``mlp_init`` or
``moe_init``, the embedding, the LM head) directly on the target device
and in the config's dtype, from a seeded ``torch.Generator``;
``repro_torch.models.convert.from_jax_params`` builds the same modules from
the reference's parameters instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as RG

# Each layer kind's mixer, by its parameter group: GQA attention, MLA or
# the RG-LRU block.
MIXERS = {"dense": "attn", "global": "attn", "local": "attn", "moe": "attn",
          "mla_moe": "mla", "rg": "rg"}
# The kinds whose FFN is the MoE FFN; the others' is the config's MLP.
MOE_KINDS = ("moe", "mla_moe")
KINDS = tuple(MIXERS)


def dtype_of(cfg) -> torch.dtype:
  return getattr(torch, cfg.dtype)


def _window(cfg, kind: str) -> int:
  """The attention window of a layer kind: the config's for ``local``,
  none (0) for every other kind, as in the reference."""
  return cfg.window_size if kind == "local" else 0


def check_supported(cfg) -> None:
  """Raise for what the port does not run yet."""
  for kind in cfg.layer_kinds():
    if kind not in KINDS:
      raise L.not_ported(f"layer kind {kind!r}", "other layer kinds")
  if cfg.frontend != "none" or cfg.num_codebooks:
    raise L.not_ported(f"the {cfg.frontend!r} frontend",
                        "other layer kinds")


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
  the kind's window, MLA or the RG-LRU block, ``MIXERS``), then the
  pre-norm FFN (the MoE FFN for ``MOE_KINDS``, else the config's MLP)."""

  def __init__(self, cfg, params: dict, kind: str):
    super().__init__()
    self.cfg, self.kind = cfg, kind
    self.mixer = MIXERS[kind]
    self.window = _window(cfg, kind)
    self.params = ParamTree(params)

  def _mix_seq(self, p, h, positions, collect_cache: bool):
    """(mixed, cache or None) of the mixer over the whole sequence (the
    RG-LRU block's cache: its state after the last position)."""
    if self.mixer == "rg":
      if not collect_cache:
        return RG.rg_apply_seq(p["rg"], h, self.cfg), None
      return RG.rg_apply_seq(p["rg"], h, self.cfg, return_state=True)
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
    if self.mixer == "rg":
      return RG.rg_apply_decode(p["rg"], h, cache, self.cfg)
    if self.mixer == "attn":
      return L.attn_apply_decode(p["attn"], h, cache, pos, self.cfg,
                                 window=self.window)
    return MLA.mla_apply_decode(p["mla"], h, cache, pos, self.cfg)

  def _ffn(self, p, h):
    """(out, aux): the MoE FFN's aux loss, or 0 for the dense MLP."""
    if self.kind in MOE_KINDS:
      return MOE.moe_apply(p["ffn"], h, self.cfg)
    return (L.mlp_apply(p["ffn"], h, self.cfg.mlp_variant),
            torch.zeros((), dtype=torch.float32, device=h.device))

  def apply_seq(self, x, positions, *, collect_cache: bool = False):
    """Returns (x, aux, cache or None)."""
    cfg, p = self.cfg, self.params.tree()
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    mixed, cache = self._mix_seq(p, h, positions, collect_cache)
    x = x + mixed.to(x.dtype)
    ff, aux = self._ffn(p, L.norm_apply(p["norm2"], x, cfg.norm))
    return x + ff.to(x.dtype), aux, cache

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
    return x + ff.to(x.dtype), cache


class Transformer(nn.Module):
  """Embedding, the layer stack, final norm and LM head (none when the
  embeddings are tied: ``head_weight``)."""

  def __init__(self, cfg, params: dict):
    """``params``: {"embed": {"table"}, "lm_head": {"w"} (untied only),
    "final_norm": {"scale"}, "layers": [one dict per layer]}, in the JAX
    layouts."""
    super().__init__()
    check_supported(cfg)
    if len(params["layers"]) != cfg.num_layers:
      raise ValueError(f"{len(params['layers'])} layers given for "
                       f"{cfg.num_layers}")
    if ("lm_head" in params) == cfg.tie_embeddings:
      raise ValueError(f"tie_embeddings is {cfg.tie_embeddings} but the "
                       f"parameters {'have' if 'lm_head' in params else 'lack'}"
                       " an lm_head")
    self.cfg = cfg
    self.embed = ParamTree(params["embed"])
    if not cfg.tie_embeddings:
      self.lm_head = ParamTree(params["lm_head"])
    self.final_norm = ParamTree(params["final_norm"])
    self.layers = nn.ModuleList(
        Layer(cfg, lp, kind)
        for lp, kind in zip(params["layers"], cfg.layer_kinds()))

  def head_weight(self) -> torch.Tensor:
    """The LM head (d, V): the embedding table transposed when tied (the
    reference's ``_head_weight``), so its gradient sums both uses."""
    if self.cfg.tie_embeddings:
      return self.embed.table.T
    return self.lm_head.w


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(cfg, kind, gen, dtype, device) -> dict:
  """One layer's parameters.  A MoE layer draws its FFN before its mixer,
  a dense layer its mixer first: the order the port's seeded weights have
  always had."""
  mixer = MIXERS[kind]

  def init_mixer():
    if mixer == "attn":
      return L.attn_init(cfg, gen, dtype, device)
    if mixer == "rg":
      return RG.rg_init(cfg, gen, dtype, device)
    return MLA.mla_init(cfg, gen, dtype, device)

  def init_ffn():
    if kind in MOE_KINDS:
      return MOE.moe_init(cfg, gen, dtype, device)
    return L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype,
                      device)

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
  dtype (the router, the norms' leaves and the RG-LRU's ``a_param`` in
  f32, as in the reference); no LM head when the embeddings are tied.  On
  the ``meta`` device it builds the shapes alone, as the reference's
  ``jax.eval_shape`` of its init does (a full-depth grok-1 has 590 GiB of
  weights)."""
  check_supported(cfg)
  device = torch.device(device)
  dtype = dtype_of(cfg)
  gen = torch.Generator(device="cpu" if device.type == "meta" else device)
  gen.manual_seed(seed)
  d, v = cfg.d_model, cfg.vocab_size
  params = {"embed": {"table": L.normal(gen, (v, d), 0.02, dtype, device)}}
  if not cfg.tie_embeddings:
    params["lm_head"] = {"w": L.normal(gen, (d, v), 1.0 / math.sqrt(d),
                                       dtype, device)}
  params["final_norm"] = L.norm_init(d, cfg.norm, device)
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


def forward_train(cfg, model: Transformer, batch: dict):
  """Per-token NLL (B, S) in f32 and the aux loss (a 0-d f32 tensor)."""
  if cfg.remat not in ("none", "full"):
    raise L.not_ported(f"remat {cfg.remat!r}", "remat \"dots\"")
  x = L.embed_apply(model.embed.tree(), batch["tokens"],
                    scale=cfg.tie_embeddings)
  positions = torch.arange(x.shape[1], device=x.device)
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for layer in model.layers:
    if cfg.remat == "full":
      x, a = checkpoint(layer.apply_train, x, positions, use_reentrant=False)
    else:
      x, a = layer.apply_train(x, positions)
    aux = aux + a
  x = L.norm_apply(model.final_norm.tree(), x, cfg.norm)
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
  rd), for ``rg`` the RG-LRU state h (B, L) and conv (B, W - 1, L) in f32,
  whatever ``max_len``.  A ``local`` layer's cache is full length too, as
  the reference keeps it: decode masks the positions below its window."""
  dtype = dtype_of(cfg)

  def one(mixer):
    if mixer == "attn":
      return L.attn_init_cache(cfg, batch, max_len, dtype, device)
    if mixer == "rg":
      return RG.rg_init_state(cfg, batch, device)
    return MLA.mla_init_cache(cfg, batch, max_len, dtype, device)

  return [one(MIXERS[kind]) for kind in cfg.layer_kinds()]


def _head(cfg, model: Transformer, x: torch.Tensor) -> torch.Tensor:
  x = L.norm_apply(model.final_norm.tree(), x, cfg.norm)
  return L.lm_head_logits(model.head_weight(), x, cfg.logit_softcap)


def forward_prefill(cfg, model: Transformer, batch: dict, max_len: int):
  """Prefill: returns (last-position logits (B, V) f32, caches).

  The caches hold the k / v (or latents) of positions [0, S), padded with
  zeros to ``max_len`` so decode continues in place; an ``rg`` layer's
  holds its state after position S - 1 (not per position: copied whole).
  """
  tokens = batch["tokens"]
  x = L.embed_apply(model.embed.tree(), tokens, scale=cfg.tie_embeddings)
  s = x.shape[1]
  if s > max_len:
    raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
  positions = torch.arange(s, device=x.device)
  caches = init_cache(cfg, x.shape[0], max_len, x.device)
  for layer, cache in zip(model.layers, caches):
    x, _, got = layer.apply_seq(x, positions, collect_cache=True)
    for name, latent in got.items():
      if layer.mixer == "rg":
        cache[name].copy_(latent)
      else:
        cache[name][:, :s] = latent.to(cache[name].dtype)
  return _head(cfg, model, x[:, -1]), caches


def forward_decode(cfg, model: Transformer, caches: list[dict],
                   tokens: torch.Tensor, pos: int):
  """One decode step.  tokens: (B,) ids at position ``pos`` (the caches'
  fill level).  Returns (logits (B, V) f32, caches), the caches written in
  place."""
  x = L.embed_apply(model.embed.tree(), tokens, scale=cfg.tie_embeddings)
  for layer, cache in zip(model.layers, caches):
    x, _ = layer.apply_decode(x, cache, pos)
  return _head(cfg, model, x), caches
