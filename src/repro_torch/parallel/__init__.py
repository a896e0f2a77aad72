"""The multi-device layout: ``sharding`` (rules and spec trees, their DTensor
placements) and ``dtensor`` (the sharded path's DTensor mechanics).

The names of ``sharding`` are loaded at first use: ``sharding`` imports
the model, whose layers import ``dtensor`` from this package.
"""
import importlib

_SHARDING = ("MeshShape", "ShardingStrategy", "bytes_of", "cache_pspecs",
             "distribute", "full", "logical_to_pspecs", "make_rules",
             "mesh_sizes", "opt_pspecs", "param_pspecs", "placements",
             "runtime", "spec", "state_pspecs")

__all__ = list(_SHARDING)


def __getattr__(name):
    if name in _SHARDING:
        module = importlib.import_module("repro_torch.parallel.sharding")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
