"""AdamW written out by hand, in the order of ``repro.training.optimizer``.

Not ``torch.optim.AdamW``, which orders the operations differently. Per
step: count + 1; the global gradient norm; the clip factor
``min(1, clip / (gn + 1e-9))``; the warmup schedule; bias correction; weight
decay inside the step. The moments are read into f32, updated in f32 and
written back in their own dtype (``moment_dtype``): f32, bf16 (rounded to
nearest even, as JAX's ``astype``) or int8 (``quant.QTensor``: per-row int8
with an f32 scale, through ``quant.quant`` / ``quant.dequant``).

The state is ``{"m", "v", "count"}`` (``init_opt_state``; count an int32
scalar). f32 and bf16 moments are copies of the parameter module in that
dtype; int8 moments are a dict {parameter name: ``QTensor``} in
``named_parameters()`` order. The update is written into the parameters and
moments in place (the JAX package returns new arrays of the same values),
which keeps one copy of the state on the card.

Sharded state (DTensor leaves, ``repro_torch.parallel.sharding``): the
update runs on each rank's local shards, which the elementwise update
allows; the gradient norm sums every leaf's squares over its shards, and an
int8 moment whose last axis is split takes its row maxima across the
shards (``quant.quant``'s ``row_groups``), so both give the unsharded
values up to the order of the sums.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Sequence

import torch
from torch import nn

from repro_torch.parallel.dtensor import all_reduce, is_dtensor
from repro_torch.training import quant

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}
ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptHParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    moment_dtype: str = "float32"       # "float32" | "bfloat16" | "int8"
    grad_accum_dtype: str = "float32"   # "float32" | "bfloat16"

    def __post_init__(self):
        for name, known in (("moment_dtype", MOMENT_DTYPES),
                            ("grad_accum_dtype", ACCUM_DTYPES)):
            if getattr(self, name) not in known:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"one of {sorted(known)}")


def _moment_init(params: nn.Module, dtype_name: str):
    """Zero moments of ``params``' structure in ``dtype_name``, no grad."""
    if dtype_name == "int8":
        return {name: quant.qzeros_like(p.detach())
                for name, p in params.named_parameters()}
    m = copy.deepcopy(params).to(MOMENT_DTYPES[dtype_name])
    m.requires_grad_(False)
    for t in m.parameters():
        t.zero_()
    return m


def init_opt_state(params: nn.Module, hp: OptHParams) -> Dict[str, Any]:
    return {"m": _moment_init(params, hp.moment_dtype),
            "v": _moment_init(params, hp.moment_dtype),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(params.parameters()).device)}


def moment_leaves(m) -> list:
    """A moment's leaves in ``parameters()`` order: tensors (f32, bf16) or
    ``QTensor``s (int8)."""
    return list(m.values()) if isinstance(m, dict) else list(m.parameters())


def _read_moment(x) -> torch.Tensor:
    return quant.dequant(x) if quant.is_qtensor(x) else x.float()


def _local(x):
    """A leaf's local shard (a ``QTensor``'s q and scale each): the tensor
    itself when it is not a DTensor."""
    if quant.is_qtensor(x):
        return quant.QTensor(_local(x.q), _local(x.scale))
    return x.to_local() if is_dtensor(x) else x


def row_groups(t) -> tuple:
    """The process groups over which DTensor ``t``'s last axis is split."""
    if not is_dtensor(t):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.get_group(i) for i, pl in enumerate(t.placements)
                 if pl.is_shard(t.dim() - 1))


def _write_moment(x, x32: torch.Tensor, groups=()) -> None:
    """x32 into the moment leaf ``x``, in place, in x's own form."""
    if quant.is_qtensor(x):
        new = quant.quant(x32, x, row_groups=groups)
        x.q.copy_(new.q)
        x.scale.copy_(new.scale)
    else:
        x.copy_(x32.to(x.dtype))


def schedule(count: torch.Tensor, hp: OptHParams) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(hp.warmup, 1), max=1.0)
    return hp.lr * warm


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32 (leaf order
    differs from the JAX pytree's, so equal to it only up to rounding).

    DTensor leaves (in Shard / Replicate placements): each rank adds its
    local shards' sums, a leaf's divided by the number of ranks that hold
    the same shard, and one sum over the mesh follows; on a mesh of one
    rank that is the unsharded sum bit for bit."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    mesh = None
    for g in grads:
        if is_dtensor(g):
            mesh = g.device_mesh
            copies = 1
            for i, pl in enumerate(g.placements):
                copies *= 1 if pl.is_shard() else mesh.size(i)
            sq = g.to_local().float().square().sum()
            total = total + (sq / copies if copies > 1 else sq)
        else:
            total = total + g.float().square().sum()
    if mesh is not None:
        total = all_reduce(total, mesh, mesh.mesh_dim_names, inplace=True)
    return total.sqrt()


# AdamW updates a leaf larger than this many elements a slice of rows at a
# time: the update is elementwise (int8 moments: per last-dim row), so the
# slices give the same bits, and the f32 temporaries stay this small (an
# MoE expert weight of grok-1 is 1.6e9 elements: 6.4 GB for each f32
# temporary of it whole)
ADAMW_CHUNK = 1 << 27


def _row_slices(p: torch.Tensor):
    """Slices of ``p``'s first dim, each at most ADAMW_CHUNK elements (one
    row at least); the whole leaf when it is small or 1-d."""
    if p.numel() <= ADAMW_CHUNK or p.dim() < 2:
        return [slice(None)]
    rows = max(1, ADAMW_CHUNK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _moment_rows(x, sl: slice):
    return quant.QTensor(x.q[sl], x.scale[sl]) if quant.is_qtensor(x) else x[sl]


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 opt_state: Dict[str, Any], hp: OptHParams):
    """One AdamW step, in place on ``params`` (the parameter leaves, in
    ``parameters()`` order) and ``opt_state``; a large leaf a slice of rows
    at a time (``ADAMW_CHUNK``).

    Returns (params, opt_state, grad norm): the same objects, updated."""
    count_t = opt_state["count"] + 1     # a DTensor in a sharded state
    count = _local(count_t)
    gn = global_norm(grads)
    scale = torch.clamp(hp.clip_norm / (gn + 1e-9), max=1.0)
    lr = schedule(count, hp)
    b1c = 1.0 - hp.b1 ** count.float()
    b2c = 1.0 - hp.b2 ** count.float()
    for p_all, g_all, m_all, v_all in zip(
            params, grads, moment_leaves(opt_state["m"]),
            moment_leaves(opt_state["v"])):
        groups = row_groups(p_all)
        p_all, g_all, m_all, v_all = (_local(p_all), _local(g_all),
                                      _local(m_all), _local(v_all))
        for sl in _row_slices(p_all):
            p, m, v = p_all[sl], _moment_rows(m_all, sl), _moment_rows(v_all, sl)
            # each f32 temporary is freed (or divided in place) as soon as
            # it is written back
            g = g_all[sl].float() * scale
            m32 = hp.b1 * _read_moment(m) + (1 - hp.b1) * g
            _write_moment(m, m32, groups)
            mh = m32.div_(b1c)
            v32 = hp.b2 * _read_moment(v) + (1 - hp.b2) * g.square()
            del g
            _write_moment(v, v32, groups)
            vh = v32.div_(b2c)
            step = mh / (vh.sqrt() + hp.eps) + hp.weight_decay * p.float()
            del mh, vh
            p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state["count"] = count_t
    return params, opt_state, gn
