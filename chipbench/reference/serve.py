"""The reference's serving passes, layer by layer so that they fit.

Each layer's weights are built again from the seed in float32, used by
every prompt or step of the check and by every precision asked for, and
freed before the next layer's; hidden states stay float32 throughout.

``prefill`` runs whole prompts (each alone, as the configuration's MoE
groups never span two prompts at these lengths) and gives the logits at
each prompt's last position and, where asked, each layer's k and v after
RoPE.  ``decode`` checks chosen decode steps of a batch: step i feeds
token T[:, i] at position P + i and attends over the program's cache
below that position (the program's own state: each checked step's own k
and v are the reference's, and are compared with what the program wrote
there); the step's tokens form one MoE group, as in the program's batch.
"""

from __future__ import annotations

import torch

from chipbench import weights as W
from chipbench.reference import model as M


@torch.no_grad()
def prefill(m: dict, seed: int, prompts: list, device, precs: list,
            keep_kv: bool = False) -> list:
  """For each precision: {"logits": [(V,) a prompt], "kv": [[(k, v) a
  prompt] a layer] where ``keep_kv``}."""
  M.no_tf32()
  top = W.build_group(m, seed, 0, device, torch.float32)
  emb = top["embed"]["table"]
  states = [[prec.q(emb[p][None]) for p in prompts] for prec in precs]
  kvs = [[] for _ in precs]
  for layer in range(m["layers"]):
    lp = W.build_group(m, seed, layer + 1, device, torch.float32)
    for pi, prec in enumerate(precs):
      got = []
      for j, x in enumerate(states[pi]):
        pos = torch.arange(x.shape[1], device=device)
        states[pi][j], _, kv = M.layer_seq(lp, x, pos, m, prec, keep_kv)
        got.append(kv)
      if keep_kv:
        kvs[pi].append(got)
    del lp
  out = []
  for pi, prec in enumerate(precs):
    logits = [M.head_logits(top, x[0, -1], m, prec) for x in states[pi]]
    out.append({"logits": logits, "kv": kvs[pi]})
  return out


@torch.no_grad()
def decode(m: dict, seed: int, caches: list, tokens: torch.Tensor, start: int,
           steps: list, device, precs: list) -> list:
  """For each precision: {"logits": [(B, V) a checked step], "kv":
  [[(k, v) (B, Hkv, dh) a checked step] a layer]}."""
  M.no_tf32()
  top = W.build_group(m, seed, 0, device, torch.float32)
  emb = top["embed"]["table"]
  eps = m["norm_eps"]
  states = [[prec.q(emb[tokens[:, i]][:, None]) for i in steps]
            for prec in precs]
  kvs = [[] for _ in precs]
  for layer in range(m["layers"]):
    lp = W.build_group(m, seed, layer + 1, device, torch.float32)
    a = lp["attn"]
    ck, cv = caches[layer]["k"], caches[layer]["v"]
    for pi, prec in enumerate(precs):
      got = []
      for j, i in enumerate(steps):
        x = states[pi][j]                                   # (B, 1, d)
        p = start + i
        pos = torch.tensor([p], device=device)
        q, k, v = M.gqa_qkv(a, M.rmsnorm(x, lp["norm1"]["scale"], eps), pos,
                            m, prec)
        got.append((k[:, 0], v[:, 0]))
        keys = torch.cat([ck[:, :p].float(), k], dim=1)
        vals = torch.cat([cv[:, :p].float(), v], dim=1)
        o = M.attention(q, keys, vals, pos,
                        torch.arange(p + 1, device=device), prec)
        x = prec.q(x + prec.einsum("bshk,hkd->bsd", o, a["wo"]))
        y, _ = M.moe(lp["ffn"],
                     M.rmsnorm(x, lp["norm2"]["scale"], eps)[:, 0], m, prec)
        states[pi][j] = prec.q(x + y[:, None])
      kvs[pi].append(got)
    del lp
  return [{"logits": [M.head_logits(top, x[:, 0], m, prec)
                      for x in states[pi]], "kv": kvs[pi]}
          for pi, prec in enumerate(precs)]


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
  """How far each chosen token's logit lies below the best, in the
  reference's logits (..., V), over chosen ids (...): flat, f32."""
  best = ref_logits.max(dim=-1).values
  got = torch.gather(ref_logits, -1, chosen[..., None].long())[..., 0]
  return (best - got).reshape(-1).float()


def token_err(got: torch.Tensor, ref: torch.Tensor, dims: int) -> torch.Tensor:
  """||got - ref|| / ||ref|| of each token's vector over the last ``dims``
  dims (a token's k or v: heads x head width): flat, f32."""
  ref = ref.float()
  d = tuple(range(-dims, 0))
  num = torch.linalg.vector_norm(got.float() - ref, dim=d)
  return (num / torch.linalg.vector_norm(ref, dim=d).clamp(min=1e-30)
          ).reshape(-1)


def stats(name: str, x: torch.Tensor) -> dict:
  """Summaries of one kind of reading over the checked tokens: the
  largest, the mean and the median."""
  x = x.float()
  return {f"{name}_max": float(x.max()), f"{name}_mean": float(x.mean()),
          f"{name}_median": float(x.median())}
