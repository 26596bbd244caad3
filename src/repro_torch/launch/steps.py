"""Train, prefill and decode step builders.

Counterpart of ``repro.launch.steps``: the functions the trainer and the
server drive.  PyTorch runs them eagerly; there is nothing to jit.  The
train step updates the model and the optimizer state in place.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.losses import soft_trimmed_token_loss
from repro_torch.models import transformer as T
from repro_torch.obs.tracing import span
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_int8_roundtrip, init_residual


def loss_from_batch(cfg, model, batch: dict):
  """(total loss, {"loss", "aux_loss"}): the mean token loss, soft-trimmed
  when ``cfg.loss_trim_fraction > 0`` (paper §6.4), plus 0.01 times the aux
  loss.  The trim runs over all of the microbatch's tokens as one row:
  ``soft_trimmed_token_loss`` flattens its input, so the (batch, seq)
  reshape does not make it per sequence, as in the reference."""
  with span("repro_forward_train"):
    token_losses, aux = T.forward_train(cfg, model, batch)
  if cfg.loss_trim_fraction > 0:
    with span("repro_soft_lts_loss"):
      loss = torch.mean(soft_trimmed_token_loss(
          token_losses.reshape(token_losses.shape[0], -1),
          cfg.loss_trim_fraction, cfg.loss_trim_eps))
  else:
    loss = torch.mean(token_losses)
  total = loss + 0.01 * aux
  return total, {"loss": loss, "aux_loss": aux}


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """``g`` in the placements of its parameter ``p``.  A DTensor
  parameter's gradient comes back ``Partial`` where the data axes split
  the batch but not the parameter: this redistribution is the
  data-parallel all-reduce (or reduce-scatter, under FSDP).  Plain tensors
  pass through."""
  if isinstance(g, DTensor) and g.placements != p.placements:
    return g.redistribute(p.device_mesh, p.placements)
  return g


def microbatches(x: torch.Tensor, accum: int) -> list[torch.Tensor]:
  """The ``accum`` microbatches of ``x``: global rows [i mb, (i + 1) mb),
  as the reference's reshape to (accum, mb, ...).  A DTensor's batch dim is
  gathered once (the split's one collective, which a trace counts), and
  each microbatch is chunked back onto ``x``'s placements (a local slice,
  no communication)."""
  mb = x.shape[0] // accum
  if not isinstance(x, DTensor):
    return [x[i * mb:(i + 1) * mb] for i in range(accum)]
  mesh, pl = x.device_mesh, x.placements
  gathered = [Replicate() if p == Shard(0) else p for p in pl]
  whole = x.redistribute(mesh, gathered).to_local()
  shape = (mb,) + tuple(x.shape[1:])
  stride = torch.empty(shape, device="meta").stride()
  return [DTensor.from_local(whole[i * mb:(i + 1) * mb], mesh, gathered,
                             shape=shape, stride=stride).redistribute(mesh, pl)
          for i in range(accum)]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, lr_schedule=None,
                    compress_grads: bool = False):
  """(model, opt_state, batch) -> (model, opt_state, metrics), the model's
  parameters and the state updated in place.

  Gradient accumulation: the batch is split into ``cfg.grad_accum``
  microbatches run one after another; each one's gradients, from
  ``torch.autograd.grad`` in the parameters' dtype, are added into f32
  accumulators (``cfg.grad_accum_dtype``), then divided by the count and
  cast to ``cfg.dtype``.  The reported loss is the microbatches' mean,
  and the aux loss 0, as in the reference.  A DTensor batch is split into
  the same global rows (``microbatches``).  DTensor parameters take
  gradients in their own placements (``like_param``).
  """

  def grads_of(model, params, batch):
    total, metrics = loss_from_batch(cfg, model, batch)
    grads = torch.autograd.grad(total, list(params.values()))
    return ({k: v.detach() for k, v in metrics.items()},
            {n: like_param(g, params[n]) for n, g in zip(params, grads)})

  def train_step(model, opt_state, batch):
    params = dict(model.named_parameters())
    accum = cfg.grad_accum
    if accum > 1:
      rows = next(iter(batch.values())).shape[0]
      if rows % accum:
        raise ValueError(f"batch {rows} is not a multiple of grad_accum "
                         f"{accum}")
      acc_dt = getattr(torch, cfg.grad_accum_dtype)
      gsum = {n: torch.zeros_like(p, dtype=acc_dt)
              for n, p in params.items()}
      lsum = 0.0
      split = {k: microbatches(v, accum) for k, v in batch.items()}
      for i in range(accum):
        micro = {k: v[i] for k, v in split.items()}
        metrics, g = grads_of(model, params, micro)
        with span("repro_grad_accumulate"):
          for n, acc in gsum.items():
            acc += g[n].to(acc_dt)
        del g
        lsum = lsum + metrics["loss"]
      dt = T.dtype_of(cfg)
      with span("repro_grad_accumulate"):
        grads = {n: (s / accum).to(dt) for n, s in gsum.items()}
      del gsum
      metrics = {"loss": lsum / accum,
                 "aux_loss": torch.zeros((), dtype=torch.float32,
                                         device=lsum.device)}
    else:
      metrics, grads = grads_of(model, params, batch)

    if compress_grads:
      grads, opt_state["ef_residual"] = ef_int8_roundtrip(
          grads, opt_state["ef_residual"])

    lr_scale = (lr_schedule(opt_state["adam"]["step"])
                if lr_schedule else 1.0)
    with span("repro_optimizer_update"):
      _, opt_state["adam"], opt_metrics = adamw.update(
          opt_cfg, grads, opt_state["adam"], params, lr_scale,
          decay=T.decay_mask(model))
    return model, opt_state, {**metrics, **opt_metrics}

  return train_step


def init_opt_state(cfg, opt_cfg, params: dict, *,
                   compress_grads: bool = False) -> dict:
  state = {"adam": adamw.init(opt_cfg, params)}
  if compress_grads:
    state["ef_residual"] = init_residual(params)
  return state


def prefill_length(cfg, batch: dict) -> int:
  """The positions a prefill of ``batch`` covers: the frames for the audio
  frontend, the tokens and, for vision, the patches before them."""
  if cfg.frontend == "audio":
    return batch["embeds"].shape[1]
  return batch["tokens"].shape[1] + (
      cfg.num_patches if cfg.frontend == "vision" else 0)


def make_prefill_step(cfg, max_len: int | None = None):
  """(model, batch) -> (last-position logits (B, V), or (B, K, V) for the
  audio frontend; caches), the caches ``max_len`` long (by default the
  prefill's length, ``prefill_length``)."""
  def prefill(model, batch):
    return T.forward_prefill(cfg, model, batch,
                             max_len or prefill_length(cfg, batch))
  return prefill


def make_decode_step(cfg):
  """(model, caches, inputs, pos) -> (logits, caches): inputs are token
  ids (B,), or frame embeddings (B, d) for the audio frontend, at position
  ``pos``."""
  def decode(model, caches, inputs, pos):
    return T.forward_decode(cfg, model, caches, inputs, pos)
  return decode
