"""Carry the JAX reference's parameters over to the port.

``from_jax_params(cfg, params_np)`` takes the reference's parameter pytree
(``repro.models.transformer.init_params``, leaves as numpy arrays) and
returns the port's ``Transformer`` with the same weights.  The reference
stacks each segment's layers along a leading ``reps`` axis
(``seg<i>/l<j>_<kind>/...``, one slice per scan step); this splits them
into one module per layer, in the order the scan runs them
(``split_layers``; ``port_tree`` maps any pytree of that layout, such as
the reference's gradients, onto the port's leaves the same way).  Every
leaf keeps its JAX layout (``wq`` (d, h, nd+rd), ``w_uk`` (r, h, nd),
``router`` (d, E) f32, ``r`` (h, dh, 4, dh), ...).  With tied embeddings
the reference has no ``lm_head`` and neither has the port; the reference's
gradient of ``embed/table`` already sums the gather's and the head's
contributions, so it maps onto the port's one table as it is.  An audio
model has no ``embed`` and carries ``codebook_head_<i>`` in place of the
LM head, in both packages (``transformer.head_names``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import (Transformer, check_supported,
                                            head_names)


def _tensor(a, device) -> torch.Tensor:
  a = np.asarray(a)
  if a.dtype.name == "bfloat16":   # numpy has no bf16: carry the bits
    return torch.from_numpy(a.view(np.uint16).copy()).view(
        torch.bfloat16).to(device)
  return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
  if isinstance(tree, dict):
    return {name: _map(value, fn) for name, value in tree.items()}
  return fn(tree)


def split_layers(cfg, params_np: dict) -> list[dict]:
  """The reference's stacked segments as one dict per layer, in the order
  the scan runs them (numpy leaves, each a slice of its stack)."""
  layers = []
  for si, (cycle, reps) in enumerate(cfg.plan_segments()):
    seg = params_np[f"seg{si}"]
    for rep in range(reps):
      for j, kind in enumerate(cycle):
        layers.append(_map(seg[f"l{j}_{kind}"],
                           lambda a, r=rep: np.asarray(a)[r]))
  return layers


def port_tree(cfg, params_np: dict, device="cpu") -> dict:
  """A pytree in the reference's layout (parameters, or gradients of
  them) as the port's tree of tensors: ``embed`` (not audio), ``lm_head``
  (untied only) or ``codebook_head_<i>`` (audio), ``final_norm`` and
  ``layers`` (``split_layers``)."""
  check_supported(cfg)
  tree = {name: _map(params_np[name], lambda a: _tensor(a, device))
          for name in head_names(cfg)}
  tree["layers"] = [_map(layer, lambda a: _tensor(a, device))
                    for layer in split_layers(cfg, params_np)]
  return tree


def from_jax_params(cfg, params_np: dict, device="cpu") -> Transformer:
  """The reference's parameters (numpy leaves) as the port's model."""
  return Transformer(cfg, port_tree(cfg, params_np, device))
