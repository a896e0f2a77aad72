"""Next-token cross-entropy loss (+ z-loss + MoE aux), in PyTorch.

Counterpart of ``repro.training.loss``: the total adds the MoE aux loss
(``forward``'s second value; 0 without MoE) weighed by
``rt.aux_loss_weight``.
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


def loss_fn(params: M.DecoderParams, batch: Dict[str, torch.Tensor], cfg,
            rt: M.Runtime = M.Runtime()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S] (+frames [B,Ss,d] for an
    encoder-decoder, read by ``forward``). Returns (total, {"ce",
    "moe_aux"})."""
    logits, aux = M.forward(params, batch, cfg, rt)
    ce = cross_entropy(logits, batch["labels"].to(logits.device))
    total = ce + rt.aux_loss_weight * aux
    return total, {"ce": ce, "moe_aux": aux}
