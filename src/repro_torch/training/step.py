"""The train step: microbatch gradient accumulation + AdamW, in PyTorch.

Counterpart of ``repro.training.step``. ``batch["tokens"]`` arrives shaped
``[accum, mb, S]``; the JAX ``lax.scan`` over microbatches becomes a loop
that takes each microbatch's gradient with ``torch.autograd.grad`` and adds
it into accumulators of ``hp.grad_accum_dtype`` (f32 or bf16; each add in
that dtype) in a fixed order (``0 + g_1 + g_2 + ...``, as the scan does),
then divides by ``accum`` in that dtype. With ``compress_grads`` every
accumulated gradient then goes through ``quant.dequant(quant.quant(g))``
(per-row int8 and back), as the JAX code does; like it, no error-feedback
buffer is kept. Attention runs through ``ops.flash_attention`` (the flash
kernel of the params' dtype and its backward kernel on the card), the Mamba
recurrence through ``ops.selective_scan_fused`` where JAX chunks (S > 256,
S % 256 == 0: the fused scan pair, ``ops.SelectiveScanFused``) and through
``ops.selective_scan`` elsewhere (the scan kernel and its reverse-scan
backward kernel, ``ops.SelectiveScan``). The state is

    {"params": DecoderParams, "opt": {"m": moments, "v": moments,
     "count": int32}, "step": int32}

with the moments as ``optimizer.init_opt_state`` makes them (a copy of
the parameter module in f32 or bf16, or {name: ``QTensor``} for int8); the
update is written in place (``optimizer.adamw_update``).

Sharded: a state distributed by ``parallel.sharding.distribute`` (DTensor
leaves) and a batch split on its microbatch dim over the data axes, with
``Runtime(shard_activations=True)``. The gradients come back as DTensors
in the parameters' layout, already summed over the data axes (autograd
reduce-scatters the FSDP gathers and reduces the Partial sums), and the
microbatch loop is the same; the metrics are DTensors.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.bridge import TORCH_DTYPES, to_torch
from repro_torch.models import model as M
from repro_torch.parallel.dtensor import is_dtensor, redistribute
from repro_torch.training import quant
from repro_torch.training.loss import loss_fn
from repro_torch.training.optimizer import (ACCUM_DTYPES, OptHParams,
                                            adamw_update, init_opt_state)

State = Dict[str, Any]


def init_train_state(generator: torch.Generator, cfg, hp: OptHParams,
                     dtype=torch.bfloat16, device=None) -> State:
    """Seeded params (``models.model.init_params``, on ``device``: ``cuda``
    unless ``"cpu"`` is asked for), zero moments, step 0."""
    dev = resolve_device(device)
    params = M.init_params(generator, cfg, dtype, dev).requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, hp),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_step(state: State, batch: Dict[str, torch.Tensor], *, cfg,
               hp: OptHParams, rt: M.Runtime = M.Runtime(),
               compress_grads: bool = False
               ) -> Tuple[State, Dict[str, Any]]:
    """batch: tokens/labels [accum, mb, S] (+frames [accum, mb, S, d] for
    an encoder-decoder). Microbatch i takes index i of every entry, as the
    JAX scan over the batch does. Updates ``state`` in place and returns it
    with {"loss", "ce", "grad_norm"} (0-d tensors)."""
    params = state["params"]
    leaves = list(params.parameters())
    dev = params.embed.device
    batch = {key: val.to(dev) for key, val in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    accum = batch["tokens"].shape[0]
    acc_dt = ACCUM_DTYPES[hp.grad_accum_dtype]
    grads = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    ces = []
    for i in range(accum):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, {key: val[i] for key, val
                                             in batch.items()}, cfg, rt)
            g = [_placed_like(x, p) for x, p in
                 zip(torch.autograd.grad(loss, leaves), leaves)]
        if grads is None:   # 0 + g_1, rounded to the accumulator's dtype
            grads = [x.to(acc_dt) for x in g]
        else:
            for acc, x in zip(grads, g):
                acc.add_(x.to(acc_dt))
        del g
        loss_sum = loss_sum + loss.detach()
        ces.append(metrics["ce"].detach())
    for acc in grads:
        acc.div_(accum)
    if compress_grads:
        grads = [_compress(x) for x in grads]
    _, _, gnorm = adamw_update(leaves, grads, state["opt"], hp)
    del grads
    state["step"] = state["step"] + 1
    return state, {"loss": loss_sum / accum, "ce": torch.stack(ces).mean(),
                   "grad_norm": gnorm}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a Partial sum left
    by the backward is reduced here); anything else as it is."""
    return redistribute(g, p.placements) if is_dtensor(g) else g


def _compress(g: torch.Tensor) -> torch.Tensor:
    """``dequant(quant(g))`` (per-row int8 and back); a DTensor gradient on
    its local shard, with the row maxima across the shards of its last
    axis."""
    from repro_torch.training.optimizer import row_groups
    if not is_dtensor(g):
        return quant.dequant(quant.quant(g.float()))
    from torch.distributed.tensor import DTensor
    local = quant.dequant(quant.quant(g.to_local().float(),
                                      row_groups=row_groups(g)))
    return DTensor.from_local(local, g.device_mesh, g.placements,
                              run_check=False)


def make_train_step(cfg, hp: OptHParams, rt: M.Runtime = M.Runtime(),
                    compress_grads: bool = False):
    """``train_step`` with its configuration bound."""
    return functools.partial(train_step, cfg=cfg, hp=hp, rt=rt,
                             compress_grads=compress_grads)


def train_state_from_host(host: Dict[str, Any], cfg, device=None) -> State:
    """A train state on ``device`` from its numpy form
    (``checkpoint.store.to_host``: each parameter module as {name: array},
    int8 moments as {name: {"q": array, "scale": array}}). Every leaf keeps
    its dtype and bits."""
    dev = resolve_device(device)
    names = [name for name, _ in M.DecoderParams(cfg, torch.float32,
                                                 "meta").named_parameters()]

    def check(d):
        if set(names) != set(d):
            raise ValueError(f"train state: leaves {sorted(set(d) ^ set(names))}"
                             " differ from the config's")

    def mod(d):
        check(d)
        m = M.DecoderParams(cfg, TORCH_DTYPES[d["embed"].dtype.name], dev)
        with torch.no_grad():
            for name, t in m.named_parameters():
                src = to_torch(d[name], dev)
                if src.dtype != t.dtype:   # an f32 leaf of a bf16 model
                    t.data = src
                else:
                    t.copy_(src)
        return m

    def moment(d):
        if not isinstance(d["embed"], dict):
            return mod(d).requires_grad_(False)
        check(d)
        return {name: quant.QTensor(to_torch(d[name]["q"], dev),
                                    to_torch(d[name]["scale"], dev))
                for name in names}
    return {"params": mod(host["params"]).requires_grad_(True),
            "opt": {"m": moment(host["opt"]["m"]),
                    "v": moment(host["opt"]["v"]),
                    "count": to_torch(host["opt"]["count"], dev)},
            "step": to_torch(host["step"], dev)}
