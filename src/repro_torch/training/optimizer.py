"""AdamW written out by hand, in the order of ``repro.training.optimizer``.

Not ``torch.optim.AdamW``, which orders the operations differently. Per
step: count + 1; the global gradient norm; the clip factor
``min(1, clip / (gn + 1e-9))``; the warmup schedule; bias correction; weight
decay inside the step. Moments are f32 (``moment_dtype="float32"``); the
bf16 and int8 moments of the JAX package raise ``NotImplementedError`` (a
later slice).

The state is ``{"m", "v", "count"}`` (``training.step.init_opt_state``: the
moments in the parameters' layout, count an int32 scalar). The update is
written into the parameters and moments in place (the JAX package returns
new arrays of the same values), which keeps one copy of the state on the
card.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptHParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    moment_dtype: str = "float32"       # only "float32" is ported
    grad_accum_dtype: str = "float32"   # only "float32" is ported

    def __post_init__(self):
        for name in ("moment_dtype", "grad_accum_dtype"):
            val = getattr(self, name)
            if val in ("bfloat16", "int8"):
                raise NotImplementedError(
                    f"repro_torch: {name}={val!r} is not ported yet; it "
                    "arrives with the low-precision optimizer slice")
            if val != "float32":
                raise ValueError(f"unknown {name} {val!r}")


def _zeros_f32(params: nn.Module) -> nn.Module:
    """A moment: a copy of ``params``' structure in f32 zeros, no grad."""
    m = copy.deepcopy(params).float().requires_grad_(False)
    for t in m.parameters():
        t.zero_()
    return m


def init_opt_state(params: nn.Module, hp: OptHParams) -> Dict[str, Any]:
    return {"m": _zeros_f32(params), "v": _zeros_f32(params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(params.parameters()).device)}


def schedule(count: torch.Tensor, hp: OptHParams) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(hp.warmup, 1), max=1.0)
    return hp.lr * warm


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32 (leaf order
    differs from the JAX pytree's, so equal to it only up to rounding)."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
    return total.sqrt()


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 opt_state: Dict[str, Any], hp: OptHParams):
    """One AdamW step, in place on ``params`` (the parameter leaves, in
    ``parameters()`` order) and ``opt_state``.

    Returns (params, opt_state, grad norm): the same objects, updated."""
    count = opt_state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(hp.clip_norm / (gn + 1e-9), max=1.0)
    lr = schedule(count, hp)
    b1c = 1.0 - hp.b1 ** count.float()
    b2c = 1.0 - hp.b2 ** count.float()
    for p, g, m, v in zip(params, grads, opt_state["m"].parameters(),
                          opt_state["v"].parameters()):
        g = g.float() * scale
        m.copy_(hp.b1 * m + (1 - hp.b1) * g)
        v.copy_(hp.b2 * v + (1 - hp.b2) * g.square())
        mh = m / b1c
        vh = v / b2c
        step = mh / (vh.sqrt() + hp.eps) + hp.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, gn
