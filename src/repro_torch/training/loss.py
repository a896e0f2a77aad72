"""Next-token cross-entropy loss (+ z-loss + MoE aux), in PyTorch.

Counterpart of ``repro.training.loss``: the total adds the MoE aux loss
(``forward``'s second value; 0 without MoE) weighed by
``rt.aux_loss_weight``. Sharded logits (DTensors) go through
``_cross_entropy_sharded``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.parallel.dtensor import (all_reduce, is_dtensor, local_map,
                                          redistribute)


def _ce_parts(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """(sum of the unmasked tokens' nll + z-loss, their count)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None]
                        )[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    return nll.sum() + zl.sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """logits [.., S, V] f32, labels [.., S] integer (-1 = masked)."""
    num, count = _ce_parts(logits, labels, z_loss)
    return num / count.clamp(min=1.0)


def _cross_entropy_sharded(logits, labels, z_loss: float = 1e-4):
    """``cross_entropy`` of DTensor logits split on the batch over the data
    axes and on the vocab over "tp": the vocab is all-gathered, each rank
    sums its tokens' terms over the global token count (an all-reduce of
    the counts), and the Partial sums are reduced. Returns a replicated
    DTensor."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = logits.device_mesh
    full = redistribute(logits, [Replicate() if pl.is_shard(2) else pl
                                 for pl in logits.placements])
    dp = [i for i, pl in enumerate(full.placements) if pl.is_shard(0)]
    names = [mesh.mesh_dim_names[i] for i in dp]

    def local(lg, lb):
        num, count = _ce_parts(lg, lb, z_loss)
        return num / all_reduce(count, mesh, names).clamp(min=1.0)

    ce = local_map(local, [Partial() if i in dp else Replicate()
                           for i in range(mesh.ndim)], full, labels)
    return redistribute(ce, [Replicate()] * mesh.ndim)


def loss_fn(params: M.DecoderParams, batch: Dict[str, torch.Tensor], cfg,
            rt: M.Runtime = M.Runtime()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S] (+frames [B,Ss,d] for an
    encoder-decoder, read by ``forward``). Returns (total, {"ce",
    "moe_aux"})."""
    logits, aux = M.forward(params, batch, cfg, rt)
    labels = batch["labels"].to(logits.device)
    if is_dtensor(logits):
        ce = _cross_entropy_sharded(logits, labels)
        if is_dtensor(aux):   # a Partial sum over the data axes
            aux = redistribute(aux, ce.placements)
    else:
        ce = cross_entropy(logits, labels)
    total = ce + rt.aux_loss_weight * aux
    return total, {"ce": ce, "moe_aux": aux}
