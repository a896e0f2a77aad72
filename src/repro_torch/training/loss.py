"""Next-token cross-entropy loss (+ z-loss), in PyTorch.

Counterpart of ``repro.training.loss``; the MoE aux term is 0 for the
dense configs this slice carries (``forward`` returns it as a 0 scalar).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model as M


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """logits [.., S, V] f32, labels [.., S] integer (-1 = masked)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None]
                        )[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = mask.sum().clamp(min=1.0)
    return (nll.sum() + zl.sum()) / denom


AUX_LOSS_WEIGHT = 0.01   # ``repro.models.model.Runtime.aux_loss_weight``


def loss_fn(params: M.DecoderParams, batch: Dict[str, torch.Tensor], cfg,
            rt: M.Runtime = M.Runtime()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S]. Returns (total, {"ce", "moe_aux"})."""
    logits, aux = M.forward(params, batch, cfg, rt)
    ce = cross_entropy(logits, batch["labels"].to(logits.device))
    total = ce + AUX_LOSS_WEIGHT * aux
    return total, {"ce": ce, "moe_aux": aux}
