"""Sharding rules: logical axes -> mesh axes, per strategy, on a torch
``DeviceMesh``. The port's counterpart of ``repro.parallel.sharding``.

The model annotates params and caches with *logical* axis names ("embed",
"heads", "expert", "kv_seq", ...; ``models.model.logical_specs`` and
``cache_logical_specs``). A ``ShardingStrategy`` maps those to the mesh:

  * TP   — heads / mlp / inner / vocab / expert(-internal) -> "model";
  * FSDP — the "embed" dim -> "data" (+"pod"): a weight is all-gathered on
           that dim where it is used (``models.layers.gather_weight``) and
           its gradient reduce-scattered back by autograd;
  * EP   — experts -> "model" when n_experts divides the axis; otherwise
           TP inside the expert (expert_mlp -> "model"), e.g. grok's 8
           experts on a 16-way axis;
  * SP   — decode KV caches shard their sequence dim over "model";
  * DP   — batch dims -> ("data",) or ("pod", "data").

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names (that dim split over several mesh axes, the first outermost, as a
JAX ``PartitionSpec`` entry), or ``None``; ``()`` is a scalar's. The spec
trees are keyed like the port's state: a parameter's name in
``DecoderParams.named_parameters()``, int8 moments as ``QTensor(q spec,
scale spec)``, the cache as ``models.model.init_cache``'s list of dicts.
``placements`` turns a spec into DTensor placements (the counterpart of
JAX's ``named`` / ``NamedSharding``), ``distribute`` a tree of tensors into
DTensors by a tree of specs and ``full`` gathers them back. ``make_rules`` reads only the mesh's axis
names and sizes, so a ``MeshShape`` stands in for a mesh of any size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

from repro_torch.models import model as M
from repro_torch.training import quant

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without ranks (what ``make_rules``
    and the input specs read)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    fsdp: bool = True
    tp: bool = True
    ep: bool = True
    seq_shard_decode: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    @staticmethod
    def for_mesh(mesh, *, fsdp: bool = True, ep: bool = True,
                 fsdp_over_pod: bool = False,
                 seq_shard_decode: bool = True) -> "ShardingStrategy":
        multi = "pod" in mesh_sizes(mesh)
        dp = ("pod", "data") if multi else ("data",)
        fa = (("pod", "data") if (multi and fsdp_over_pod) else ("data",))
        return ShardingStrategy(fsdp=fsdp, ep=ep, dp_axes=dp, fsdp_axes=fa,
                                seq_shard_decode=seq_shard_decode)


def make_rules(cfg, mesh, strat: ShardingStrategy) -> dict:
    model_n = mesh_sizes(mesh)[strat.tp_axis]
    rules = {
        None: None,
        "vocab": strat.tp_axis if strat.tp else None,
        "embed": strat.fsdp_axes if strat.fsdp else None,
        "heads": strat.tp_axis if strat.tp else None,
        "kv_heads": None,
        "head": None,
        "mlp": strat.tp_axis if strat.tp else None,
        "inner": strat.tp_axis if strat.tp else None,
        "layers": None,
        "batch": strat.dp_axes,
        "kv_seq": strat.tp_axis if strat.seq_shard_decode else None,
        "expert": None,
        "expert_mlp": None,
    }
    if cfg.moe is not None and strat.tp:
        if strat.ep and cfg.moe.n_experts % model_n == 0:
            rules["expert"] = strat.tp_axis          # true EP
        else:
            rules["expert_mlp"] = strat.tp_axis      # TP-within-expert
    return rules


def runtime(cfg, mesh, strat: ShardingStrategy, **kw) -> M.Runtime:
    """The ``Runtime`` that runs ``cfg`` sharded by ``strat`` on ``mesh``
    (the JAX dry-run's): activation sharding on, the strategy's data and
    tensor axes, and EP exactly where ``make_rules`` puts the experts on
    the tensor axis, so the MoE computes in the layout its weights have;
    ``kw`` sets the other fields. (The JAX dry-run asks for EP where
    n_experts * expert_split divides the axis, which for grok-1 on a 16-way
    axis disagrees with its own rules' ``expert_mlp``.)"""
    ep = make_rules(cfg, mesh, strat)["expert"] is not None
    return M.Runtime(shard_activations=True, dp_axes=strat.dp_axes,
                     tp_axis=strat.tp_axis if strat.tp else "", ep=ep, **kw)


def _map(tree: Any, fn) -> Any:
    """``fn`` on every leaf (a tuple of axes, a spec or a ``QTensor`` of
    specs counts as a leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {key: _map(val, fn) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_map(val, fn) for val in tree]
    return fn(tree)


def spec(*entries) -> Spec:
    """A spec of these entries, normalised as JAX's ``PartitionSpec`` does:
    a one-name tuple becomes the name, an empty one None."""
    return tuple((e[0] if len(e) == 1 else (e or None))
                 if isinstance(e, tuple) else e for e in entries)


def logical_to_pspecs(logical_tree, rules: dict):
    return _map(logical_tree, lambda axes: spec(*(rules.get(a) for a in axes)))


def param_pspecs(cfg, rules: dict):
    return logical_to_pspecs(M.logical_specs(cfg), rules)


def opt_pspecs(cfg, rules: dict, moment_dtype: str):
    """Moment trees mirror params; int8 moments are shape-preserving
    (``QTensor``: q keeps the param's spec; the per-row scale drops the
    last axis)."""
    ps = param_pspecs(cfg, rules)
    if moment_dtype != "int8":
        return ps

    def to_q(s: Spec):
        scale = s[:-1] + (None,) if s else (None,)
        return quant.QTensor(s, scale)

    return _map(ps, to_q)


def state_pspecs(cfg, rules: dict, moment_dtype: str = "float32"):
    ps = param_pspecs(cfg, rules)
    return {
        "params": ps,
        "opt": {"m": opt_pspecs(cfg, rules, moment_dtype),
                "v": opt_pspecs(cfg, rules, moment_dtype),
                "count": ()},
        "step": (),
    }


def cache_pspecs(cfg, rules: dict, batch_shardable: bool):
    r = dict(rules)
    if not batch_shardable:
        r["batch"] = None
    return logical_to_pspecs(M.cache_logical_specs(cfg), r)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(i)`` on each
    mesh axis named by tensor dim i's entry, ``Replicate()`` elsewhere. An
    entry of several axes shards dim i over them with the first outermost,
    which DTensor does when they come in the mesh's own order (a JAX
    ``PartitionSpec`` entry ("pod", "data") on a ("pod", "data", "model")
    mesh); another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r}: axes must come in the "
                             f"mesh's order {tuple(names)}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec!r} uses mesh axis {names[j]!r} "
                                 "twice")
            out[j] = Shard(i)
    return out


def _shard(t: torch.Tensor, spec: Spec, mesh):
    """A full tensor, the same on every rank, -> a DTensor holding this
    rank's shard (cut locally, no communication)."""
    from torch.distributed.tensor import distribute_tensor
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a "
                         f"{t.dim()}-d tensor")
    return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                             src_data_rank=None)


def distribute(tree, spec_tree, mesh):
    """A tree of full tensors (an ``nn.Module``'s parameters, dicts, lists,
    ``QTensor``s), the same on every rank, -> the same tree of DTensors
    sharded by ``spec_tree`` (see the module's docstring for its keys). A
    module's parameters are replaced in place, keeping ``requires_grad``,
    and the module is returned."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(mod_name) if mod_name else tree
            mod._parameters[leaf] = nn.Parameter(
                _shard(p, spec_tree[name], mesh), requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {key: distribute(val, spec_tree[key], mesh)
                for key, val in tree.items()}
    if isinstance(tree, list):
        return [distribute(val, s, mesh) for val, s in zip(tree, spec_tree)]
    if quant.is_qtensor(tree):
        return quant.QTensor(_shard(tree.q, spec_tree.q, mesh),
                             _shard(tree.scale, spec_tree.scale, mesh))
    return _shard(tree, spec_tree, mesh)


def full(tree):
    """``distribute``'s inverse: every DTensor of a tree gathered to its full
    tensor (a collective: every rank calls it), the same structure back; a
    module's parameters are replaced in place."""
    def one(t):
        return t.full_tensor() if type(t).__name__ == "DTensor" else t
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(mod_name) if mod_name else tree
            mod._parameters[leaf] = nn.Parameter(one(p.detach()),
                                                 requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {key: full(val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [full(val) for val in tree]
    if quant.is_qtensor(tree):
        return quant.QTensor(one(tree.q), one(tree.scale))
    return one(tree)


def _leaves(tree):
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for val in tree.values():
            yield from _leaves(val)
    elif isinstance(tree, (list, tuple)):
        for val in tree:
            yield from _leaves(val)
    elif quant.is_qtensor(tree):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, torch.Tensor):
        yield tree


def bytes_of(tree) -> int:
    """Bytes of a tree's tensors; a DTensor counts the shard this rank
    holds, a meta tensor its full size."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total
