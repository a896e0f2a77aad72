"""Shape-only stand-ins and spec trees for every model input: the port's
counterpart of ``repro.launch.input_specs``.

Nothing is allocated: the train state, the params, batches and decode
caches are ``meta`` tensors (JAX's ``eval_shape`` / ``ShapeDtypeStruct``),
each returned with its spec tree (``repro_torch.parallel.sharding``), whose
specs ``sharding.placements`` turns into DTensor placements on a mesh and
which ``sharding.distribute`` applies to real tensors. The mesh is read for its
axis names and sizes only: a ``sharding.MeshShape`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.launch.presets import Preset
from repro_torch.models import model as M
from repro_torch.parallel import sharding as S
from repro_torch.training.optimizer import OptHParams, init_opt_state


def dp_total(mesh, strat: S.ShardingStrategy) -> int:
    sizes = S.mesh_sizes(mesh)
    n = 1
    for a in strat.dp_axes:
        n *= sizes[a]
    return n


def train_batch_layout(shape: ShapeSpec, mesh, strat: S.ShardingStrategy,
                       preset: Preset) -> Tuple[int, int]:
    """(accum, microbatch) with accum*microbatch == global_batch."""
    dp = dp_total(mesh, strat)
    mb = preset.microbatch or dp
    mb = min(mb, shape.global_batch)
    while shape.global_batch % mb != 0:
        mb -= 1
    return shape.global_batch // mb, mb


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(cfg: ArchConfig) -> M.DecoderParams:
    return M.DecoderParams(cfg, torch.bfloat16, "meta")


def train_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                strat: S.ShardingStrategy, preset: Preset, hp: OptHParams):
    """Returns (state_shapes, batch_shapes, state_specs, batch_specs): the
    train state of ``training.step.init_train_state`` (bf16 params that
    require grad, as it makes them) and the batch [accum, mb, S] with mb on
    the data axes."""
    rules = S.make_rules(cfg, mesh, strat)
    accum, mb = train_batch_layout(shape, mesh, strat, preset)
    Ssq = shape.seq_len
    batch = {"tokens": _meta((accum, mb, Ssq), torch.int32),
             "labels": _meta((accum, mb, Ssq), torch.int32)}
    bspec = {"tokens": S.spec(None, strat.dp_axes, None),
             "labels": S.spec(None, strat.dp_axes, None)}
    if cfg.enc_dec:
        batch["frames"] = _meta((accum, mb, Ssq, cfg.d_model), torch.bfloat16)
        bspec["frames"] = S.spec(None, strat.dp_axes, None, None)
    params = _meta_params(cfg).requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params, hp),
             "step": _meta((), torch.int32)}
    return state, batch, S.state_pspecs(cfg, rules, hp.moment_dtype), bspec


def prefill_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                  strat: S.ShardingStrategy):
    """Returns (param shapes, batch shapes, param specs, batch specs); the
    batch is replicated when it does not divide over the data axes."""
    rules = S.make_rules(cfg, mesh, strat)
    B, Ssq = shape.global_batch, shape.seq_len
    shardable = B % dp_total(mesh, strat) == 0
    dp = strat.dp_axes if shardable else None
    batch = {"tokens": _meta((B, Ssq), torch.int32)}
    bspec = {"tokens": S.spec(dp, None)}
    if cfg.enc_dec:
        batch["frames"] = _meta((B, Ssq, cfg.d_model), torch.bfloat16)
        bspec["frames"] = S.spec(dp, None, None)
    return _meta_params(cfg), batch, S.param_pspecs(cfg, rules), bspec


def decode_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                 strat: S.ShardingStrategy, cross_len: int = 4096):
    """Returns (param shapes, cache shapes, token shapes, param specs, cache
    specs, token specs); tokens and pos are replicated, as the cache's
    batch, when the batch does not divide over the data axes (long_500k,
    B = 1)."""
    rules = S.make_rules(cfg, mesh, strat)
    B, Ssq = shape.global_batch, shape.seq_len
    shardable = B % dp_total(mesh, strat) == 0
    dp = strat.dp_axes if shardable else None
    cache = M.init_cache(cfg, B, Ssq, torch.bfloat16, "meta",
                         cross_len=cross_len)
    cspec = S.cache_pspecs(cfg, rules, shardable)
    toks = {"tokens": _meta((B,), torch.int32), "pos": _meta((B,), torch.int32)}
    tspec = {"tokens": S.spec(dp), "pos": S.spec(dp)}
    return (_meta_params(cfg), cache, toks, S.param_pspecs(cfg, rules),
            cspec, tspec)
