"""The train step: microbatch gradient accumulation + AdamW, in PyTorch.

Counterpart of ``repro.training.step``. ``batch["tokens"]`` arrives shaped
``[accum, mb, S]``; the JAX ``lax.scan`` over microbatches becomes a loop
that takes each microbatch's gradient with ``torch.autograd.grad`` and adds
it into f32 accumulators in a fixed order (``0 + g_1 + g_2 + ...``, as the
scan does), then divides by ``accum``. Attention runs through
``ops.flash_attention`` (the flash kernel and its backward kernel on the
card), the Mamba recurrence through ``ops.selective_scan`` (the scan
kernel and its reverse-scan backward kernel, ``ops.SelectiveScan``). The
state is

    {"params": DecoderParams, "opt": {"m": DecoderParams (f32),
     "v": DecoderParams (f32), "count": int32}, "step": int32}

with the moments in the parameters' layout; the update is written in place
(``optimizer.adamw_update``). Gradient compression (``compress_grads``)
raises ``NotImplementedError``: it arrives with the low-precision optimizer
slice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.bridge import TORCH_DTYPES, to_torch
from repro_torch.models import model as M
from repro_torch.training.loss import loss_fn
from repro_torch.training.optimizer import (OptHParams, adamw_update,
                                            init_opt_state)

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
               hp: OptHParams, rt: M.Runtime = M.Runtime()
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
    grads = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    ces = []
    for i in range(accum):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, {key: val[i] for key, val
                                             in batch.items()}, cfg, rt)
            g = torch.autograd.grad(loss, leaves)
        if grads is None:
            grads = [x.float() for x in g]
        else:
            for acc, x in zip(grads, g):
                acc.add_(x.float())
        del g
        loss_sum = loss_sum + loss.detach()
        ces.append(metrics["ce"].detach())
    for acc in grads:
        acc.div_(accum)
    _, _, gnorm = adamw_update(leaves, grads, state["opt"], hp)
    del grads
    state["step"] = state["step"] + 1
    return state, {"loss": loss_sum / accum, "ce": torch.stack(ces).mean(),
                   "grad_norm": gnorm}


def make_train_step(cfg, hp: OptHParams, rt: M.Runtime = M.Runtime(),
                    compress_grads: bool = False):
    """``train_step`` with its configuration bound."""
    if compress_grads:
        raise NotImplementedError(
            "repro_torch: compress_grads is not ported yet; it arrives with "
            "the low-precision optimizer slice")
    return functools.partial(train_step, cfg=cfg, hp=hp, rt=rt)


def train_state_from_host(host: Dict[str, Any], cfg, device=None) -> State:
    """A train state on ``device`` from its numpy form
    (``checkpoint.store.to_host``: each parameter module as {name: array})."""
    dev = resolve_device(device)

    def mod(d, dtype):
        m = M.DecoderParams(cfg, dtype, dev)
        named = dict(m.named_parameters())
        if set(named) != set(d):
            raise ValueError(f"train state: leaves {sorted(set(d) ^ set(named))}"
                             " differ from the config's")
        with torch.no_grad():
            for name, t in named.items():
                t.copy_(to_torch(d[name], dev))
        return m
    params = mod(host["params"], TORCH_DTYPES[host["params"]["embed"].dtype.name])
    return {"params": params.requires_grad_(True),
            "opt": {"m": mod(host["opt"]["m"], torch.float32),
                    "v": mod(host["opt"]["v"], torch.float32),
                    "count": to_torch(host["opt"]["count"], dev)},
            "step": to_torch(host["step"], dev)}
