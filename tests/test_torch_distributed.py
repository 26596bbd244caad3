"""The sharded path on real process groups: 4 gloo ranks on the CPU.

Each test spawns 4 processes (each bounded in time, every group destroyed
before its process ends; the test process itself never starts one).  Here
(``_run`` and ``_close`` serve ``test_torch_distributed_state.py`` too):

* a sharded train step: the smoke llama3.2-1b on a (2, 2) (data, model)
  mesh with FSDP, its parameters, optimizer state and batch distributed
  by the sharding rules, gives the loss and the updated parameters of the
  port's unsharded CPU step, within the f32 contract 1e-5 * (1 + max|ref|)
  (the collectives sum in another order); once in one microbatch, and
  once in two with the soft-LTS trim, which is not linear in a
  microbatch's rows, so that each microbatch must hold the same global
  rows as the unsharded step's;
* the kernels' wrappers on DTensors (on the CPU, their plain versions on
  each rank's block): attention with the batch over data and the query
  heads over model, its kv heads split alike (Hkv 4) or replicated and
  sliced (Hkv 1, G 8), values and the gradients of q, k and v; the gates
  and the projection by rows; decode attention over caches split by
  positions (FlashDecoding's combine) or by heads, with and without a
  window and a soft-cap; each equal to the call on the whole tensors
  within the f32 contract;
* without processes: the blocks' log-sum-exp combine that the sequence
  split uses (``layers.combine_blocks``), on blocks stacked on one axis,
  equal to the call on the whole cache.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4
TIMEOUT_S = 240
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _run(fn, *args) -> None:
  """``fn(rank, *args)`` in 4 spawned gloo ranks, each bounded."""
  port = _free_port()
  ctx = mp.start_processes(_entry, args=(port, fn, args), nprocs=WORLD,
                           join=False, start_method="spawn")
  deadline = time.monotonic() + TIMEOUT_S
  try:
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
      if time.monotonic() > deadline:
        raise TimeoutError(f"{fn.__name__} did not end in {TIMEOUT_S} s")
  finally:
    for p in ctx.processes:
      if p.is_alive():
        p.kill()
  assert not dist.is_initialized()


def _entry(rank, port, fn, args):
  os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
  torch.set_num_threads(1)
  dist.init_process_group("gloo", rank=rank, world_size=WORLD)
  try:
    fn(rank, *args)
  finally:
    dist.destroy_process_group()


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
  tol = 1e-5 * (1 + float(want.abs().max()))
  err = float((got - want).abs().max())
  assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


def _train_worker(rank, grad_accum, trim):
  from repro_torch.configs.smoke import smoke_config
  from repro_torch.launch import mesh, steps
  from repro_torch.models import transformer as T
  from repro_torch.optim import adamw
  from repro_torch.sharding import specs

  cfg = dataclasses.replace(smoke_config("llama3.2-1b"), fsdp=True,
                            grad_accum=grad_accum, loss_trim_fraction=trim)
  opt_cfg = adamw.AdamWConfig()
  g = torch.Generator().manual_seed(0)
  batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
           for k in ("tokens", "targets")}
  step = steps.make_train_step(cfg, opt_cfg)
  ref = T.init_params(cfg, 0, "cpu").requires_grad_(True)
  _, _, ref_metrics = step(ref, steps.init_opt_state(
      cfg, opt_cfg, dict(ref.named_parameters())), batch)

  m = mesh.make_debug_mesh((2, 2), device_type="cpu")
  rules = specs.ShardingRules(m, data_axes=mesh.data_axes_of(m), fsdp=True)
  model = T.init_params(cfg, 0, "cpu").requires_grad_(True)
  pspecs = specs.param_specs_tree(rules, model)
  specs.distribute_model(model, m, pspecs)
  opt = steps.init_opt_state(cfg, opt_cfg, dict(model.named_parameters()))
  ospecs = specs.opt_state_specs_tree(rules, opt, pspecs)
  for name, t in opt["adam"]["m"].items():
    assert t.placements == specs.placements(m, ospecs["adam"]["m"][name])
  dbatch = {k: specs.distribute(v, m, specs.batch_spec(rules, v.shape))
            for k, v in batch.items()}
  with specs.use_rules(rules):
    _, _, metrics = step(model, opt, dbatch)
  _close(metrics["loss"].full_tensor(), ref_metrics["loss"], "loss")
  for name, p in model.named_parameters():
    assert p.placements == specs.placements(m, pspecs[name]), name
    _close(p.full_tensor().detach(), ref.get_parameter(name).detach(), name)


@pytest.mark.parametrize("grad_accum,trim", [(1, 0.0), (2, 0.25)])
def test_sharded_train_step_matches_the_unsharded_step(grad_accum, trim):
  _run(_train_worker, grad_accum, trim)


def _kernels_worker(rank):
  from torch.distributed.tensor import DTensor, Replicate, Shard
  from repro_torch.core.operators import soft_topk_mask
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import soft_topk as st
  from repro_torch.launch import mesh

  m = mesh.make_debug_mesh((2, 2), device_type="cpu")
  g = torch.Generator().manual_seed(0)
  for hkv in (4, 1):
    q = torch.randn(4, 16, 8, 16, generator=g)
    k, v = (torch.randn(4, 16, hkv, 16, generator=g) for _ in range(2))
    ref_q, ref_k, ref_v = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = fa.flash_attention(ref_q, ref_k, ref_v, q_chunk=8, kv_chunk=8)
    do = torch.randn(want.shape, generator=g)
    want.backward(do)
    kv_pl = (Shard(0), Shard(2) if hkv % 2 == 0 else Replicate())
    dq = DTensor.from_local(q, m, [Replicate(), Replicate()]).redistribute(
        m, (Shard(0), Shard(2))).detach().requires_grad_(True)
    dk, dv = (DTensor.from_local(t, m, [Replicate(), Replicate()])
              .redistribute(m, kv_pl).detach().requires_grad_(True)
              for t in (k, v))
    out = fa.flash_attention(dq, dk, dv, q_chunk=8, kv_chunk=8)
    assert out.placements == (Shard(0), Shard(2))
    out.backward(DTensor.from_local(do, m, [Replicate(), Replicate()])
                 .redistribute(m, out.placements))
    _close(out.full_tensor().detach(), want.detach(), f"attention {hkv}")
    for name, got, ref in (("dq", dq, ref_q), ("dk", dk, ref_k),
                           ("dv", dv, ref_v)):
      _close(got.grad.full_tensor(), ref.grad, f"{name} at Hkv {hkv}")
  logits = torch.randn(64, 8, generator=g)
  dl = DTensor.from_local(logits, m, [Replicate(), Replicate()])
  gates = st.soft_topk_gates(dl.redistribute(m, (Shard(0), Replicate())), 2)
  _close(gates.full_tensor(), st.soft_topk_gates(logits, 2), "gates")
  z = torch.randn(6, 8, 10, generator=g)
  dz = DTensor.from_local(z, m, [Replicate(), Replicate()]).redistribute(
      m, (Shard(0), Shard(2)))
  mask = soft_topk_mask(dz, 3)
  assert mask.placements == (Shard(0), Replicate())
  _close(mask.full_tensor(), soft_topk_mask(z, 3), "projection")
  from repro_torch.models.layers import decode_attention
  q = torch.randn(4, 8, 16, generator=g)
  kc, vc = (torch.randn(4, 12, 2, 16, generator=g) for _ in range(2))
  for cache_pl in ((Shard(0), Shard(1)), (Shard(0), Shard(2))):
    dk, dv = (DTensor.from_local(t, m, [Replicate(), Replicate()])
              .redistribute(m, cache_pl) for t in (kc, vc))
    for window, softcap in ((0, 0.0), (4, 5.0)):
      got = decode_attention(q, dk, dv, 10, window, softcap)
      _close(got.full_tensor(), decode_attention(q, kc, vc, 10, window,
                                                 softcap),
             f"decode over {cache_pl}, window {window}")


def test_kernel_wrappers_on_local_blocks():
  _run(_kernels_worker)


@pytest.mark.parametrize("cuts,window,softcap",
                         [((7,), 0, 0.0), ((12,), 0, 0.0), ((3, 9), 4, 5.0),
                          ((2, 5, 11), 4, 0.0), ((16,), 6, 0.0)])
def test_lse_combine_of_blocks_is_the_one_block_result(cuts, window,
                                                       softcap):
  """FlashDecoding's combine as the sharded path runs it
  (``layers.combine_blocks``), with the blocks of a cache split by
  positions stacked on a leading axis for the reduction: each block's
  (o, lse) from ``decode_block`` at its offset, combined, equals the call
  on the whole cache (blocks past ``cache_len`` or before the window, lse
  -inf, weigh 0)."""
  from repro_torch.kernels import decode_attention as da
  from repro_torch.models.layers import combine_blocks

  g = torch.Generator().manual_seed(11)
  q = torch.randn(3, 8, 16, generator=g)
  k, v = (torch.randn(3, 24, 2, 16, generator=g) for _ in range(2))
  cache_len = 14
  want, want_lse = da.decode_block(q, k, v, 0, cache_len, window, softcap)
  bounds = (0,) + cuts + (24,)
  blocks = [da.decode_block(q, k[:, a:e], v[:, a:e], a, cache_len, window,
                            softcap) for a, e in zip(bounds, bounds[1:])]
  o = torch.stack([b[0] for b in blocks])
  lse = torch.stack([b[1] for b in blocks])

  def reduce(x, op):
    r = x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)
    return r.expand_as(x)

  got = combine_blocks(o, lse, reduce)
  for i in range(len(blocks)):
    _close(got[i], want, f"block {i} of {bounds}")
  _close(torch.logsumexp(lse, 0), want_lse, f"lse over {bounds}")
