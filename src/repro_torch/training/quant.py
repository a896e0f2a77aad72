"""Shape-preserving int8 quantization for optimizer moments and gradient
compression: the port's copy of ``repro.training.quant``.

``QTensor`` keeps the int8 payload ``q`` in the parameter's own shape with
one f32 ``scale`` per last-dim row (``shape[:-1] + (1,)``): 1.25 bytes an
element against 2 (bf16) or 4 (f32). ``quant`` gives the JAX package's bits
on the same f32 input: the scale is one f32 division and one add
(``max|x| / 127 + 1e-20``), and ``torch.round`` rounds half to even, as
``jnp.round`` does. On a DTensor leaf the optimizer quantises each
rank's shard with ``row_groups``, which gives the whole tensor's values.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor       # int8, the parameter's shape
    scale: torch.Tensor   # f32, shape[:-1] + (1,)

    @property
    def shape(self):
        return self.q.shape


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def quant(x32: torch.Tensor, like: "QTensor | None" = None,
          row_groups=()) -> QTensor:
    """Per-row int8 of ``x32`` (``like`` is unused, as in JAX: the shape
    comes from the input). ``row_groups``: the process groups over which
    this tensor's last axis is split (a rank's shard of a sharded leaf); the
    row maxima are taken across them, so the scale is the whole row's."""
    x32 = x32.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if row_groups:
        import torch.distributed as dist
        for g in row_groups:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    scale = amax / 127.0 + 1e-20
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequant(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale


def qzeros_like(p: torch.Tensor) -> QTensor:
    return QTensor(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                               device=p.device))
