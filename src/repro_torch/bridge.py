"""Move the JAX package's params, train states and decode caches into the
port and back.

Both sides speak numpy at the boundary: the caller turns JAX arrays into
numpy (``jax.tree.map(np.asarray, ...)``) and this module never imports JAX.
Leaf shapes stay as they are. The JAX params stack every block position's
leaves over ``n_blocks`` on axis 0 (``params["blocks"][i][...][n]``); the
port holds them as ``layers[n * len(cfg.block) + i]``; an encoder-decoder's
``params["encoder"]["layers"]`` stack its ``n_enc_layers`` on axis 0 and
become ``encoder.layers[n]`` (``["encoder"]["final_norm"]``:
``encoder.final_norm``). The cache keeps the same stacked layout on both
sides, so its leaves copy one to one (``k``/``v`` for attention,
``conv``/``ssm`` for Mamba, ``xk``/``xv`` for cross-attention). bf16 leaves travel as
``ml_dtypes.bfloat16`` numpy arrays, the type JAX hands out. Leaves keep
their dtype: a Mamba model's ``A_log``, ``D`` and ``dt_bias`` and an MoE
layer's ``router`` are f32 in a bf16 model on both sides, and a leaf whose
dtype differs from the port's parameter is refused, never cast.

Spec trees and shape trees cross the same way (``specs_to_jax``,
``shapes_to_jax``): the port keys them by parameter name, one layer a
module; the JAX package stacks them, with a leading "layers" axis.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Cache, DecoderParams

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy (f32/f16/ml_dtypes bf16/int) -> tensor of the same dtype, bits kept."""
    a = np.array(a, order="C", copy=True)   # torch wants a writable buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy of the same dtype (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bf16 type; only needed for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaves(tree: Dict[str, Any], prefix=()):
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (name,))
        else:
            yield prefix + (name,), val


def _map(tree: Any, fn) -> Any:
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {key: _map(val, fn) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(val, fn) for val in tree]
    return fn(tree)


def _zip(a: Any, b: Any, fn) -> Any:
    """``fn(x, y)`` for the leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {key: _zip(a[key], b[key], fn) for key in a}
    if isinstance(a, (list, tuple)):
        return [_zip(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)


def _zip_dl(a: Any, b: Any, fn) -> Any:
    """``_zip`` for trees whose leaves are tuples (specs, shapes): only dicts
    and lists are walked."""
    if isinstance(a, dict):
        return {key: _zip_dl(a[key], b[key], fn) for key in a}
    if isinstance(a, list):
        return [_zip_dl(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)


def _jax_named(np_params: Dict[str, Any], cfg: ArchConfig):
    """(port parameter name, numpy leaf) for every leaf of a tree in the JAX
    params layout: stacked block and encoder leaves split by layer."""
    nb = len(cfg.block)
    for name, leaf in np_params.items():
        if name == "blocks":
            for i, block in enumerate(leaf):
                for path, stacked in _leaves(block):
                    for n in range(cfg.n_blocks):
                        yield ".".join(("layers", str(n * nb + i)) + path), stacked[n]
        elif name == "encoder":
            for path, stacked in _leaves(leaf["layers"]):
                for n in range(cfg.n_enc_layers):
                    yield ".".join(("encoder", "layers", str(n)) + path), stacked[n]
            yield "encoder.final_norm", leaf["final_norm"]
        else:
            yield name, leaf


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig,
                    device=None, *, moment: bool = False) -> DecoderParams:
    """A numpy copy of ``repro.models.model.init_params``'s pytree -> port.

    The model dtype is the embedding's. Raises ``ValueError`` when a leaf's
    shape or dtype differs from the port's parameter, or a leaf is missing
    or unexpected. ``moment``: an AdamW moment in the params' layout, whose
    leaves all have the moment's dtype (a bf16 model's f32 leaves too), kept
    as they come."""
    dev = resolve_device(device)
    dtype = TORCH_DTYPES[np.asarray(np_params["embed"]).dtype.name]
    out = DecoderParams(cfg, dtype, dev)
    named = dict(out.named_parameters())
    seen = set()
    for name, leaf in _jax_named(np_params, cfg):
        seen.add(name)
        if name not in named:
            continue
        dst, src = named[name], to_torch(np.asarray(leaf), dev)
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"bridge: {name} has shape {tuple(src.shape)}, "
                             f"the port wants {tuple(dst.shape)}")
        if dst.dtype != src.dtype and not moment:
            raise ValueError(f"bridge: {name} has dtype {src.dtype}, the "
                             f"port wants {dst.dtype}")
        with torch.no_grad():
            if dst.dtype != src.dtype:
                dst.data = src
            else:
                dst.copy_(src)
    if seen != set(named):
        raise ValueError(f"bridge: leaves missing {sorted(set(named) - seen)}, "
                         f"unexpected {sorted(seen - set(named))}")
    return out


def _put_stacked(tree: Dict[str, Any], path, n: int, count: int,
                 leaf: np.ndarray) -> None:
    """Put layer ``n`` of ``count`` of the leaf at ``path`` into ``tree``."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree.setdefault(path[-1], [None] * count)[n] = leaf


def _stack(tree: Dict[str, Any], stack=np.stack) -> Dict[str, Any]:
    """``_put_stacked``'s lists of layers -> leaves stacked on axis 0
    (``stack`` of each list)."""
    return {key: _stack(val, stack) if isinstance(val, dict) else stack(val)
            for key, val in tree.items()}


def _to_jax_layout(named, cfg: ArchConfig, stack=np.stack) -> Dict[str, Any]:
    """(port parameter name, numpy leaf) pairs -> a tree in the JAX params
    layout (``_jax_named``'s inverse); ``stack`` joins a block position's
    layers (numpy leaves: ``np.stack``)."""
    out: Dict[str, Any] = {}
    nb = len(cfg.block)
    blocks: List[Dict[str, Any]] = [{} for _ in range(nb)]
    enc_layers: Dict[str, Any] = {}
    for name, leaf in named:
        path = name.split(".")
        if path[0] == "layers":
            n, i = divmod(int(path[1]), nb)
            _put_stacked(blocks[i], path[2:], n, cfg.n_blocks, leaf)
        elif path[:2] == ["encoder", "layers"]:
            _put_stacked(enc_layers, path[3:], int(path[2]), cfg.n_enc_layers,
                         leaf)
        elif path[0] == "encoder":
            out.setdefault("encoder", {})[path[1]] = leaf
        else:
            out[name] = leaf
    out["blocks"] = [_stack(block, stack) for block in blocks]
    if cfg.enc_dec:
        out["encoder"]["layers"] = _stack(enc_layers, stack)
    return out


def _stack_same(lead):
    """A ``stack`` for per-layer values that must agree across layers: the
    layers' common value with ``lead`` in front."""
    def stack(xs):
        if any(x != xs[0] for x in xs):
            raise ValueError(f"bridge: layers of one block position differ: "
                             f"{xs}")
        return lead(len(xs), xs[0])
    return stack


def specs_to_jax(specs: Dict[str, Any], cfg: ArchConfig, lead=None,
                 qtensor=None) -> Dict[str, Any]:
    """A spec tree keyed like the port's params ({parameter name: spec},
    ``models.model.logical_specs`` or ``parallel.sharding.param_pspecs`` /
    ``opt_pspecs``) -> the JAX package's stacked layout: a block position's
    layers (and the encoder's) share one spec, with ``lead`` in front (JAX's
    "layers" axis: "layers" for logical axes, None for mesh axes). An int8
    moment's ``QTensor(q spec, scale spec)`` comes back as ``qtensor(q,
    scale)`` (the JAX package's ``QTensor``, which the bridge never
    imports)."""
    stack = _stack_same(lambda n, x: (lead,) + tuple(x))
    first = next(iter(specs.values()))
    if not (hasattr(first, "q") and hasattr(first, "scale")):
        return _to_jax_layout(specs.items(), cfg, stack)
    q = _to_jax_layout(((n, x.q) for n, x in specs.items()), cfg, stack)
    scale = _to_jax_layout(((n, x.scale) for n, x in specs.items()), cfg,
                           stack)
    return _zip_dl(q, scale, qtensor)


def shapes_to_jax(module, cfg: ArchConfig) -> Dict[str, Any]:
    """A parameter module's leaves (meta tensors of ``launch.input_specs``
    too) -> the JAX stacked layout with (shape, dtype name) at its leaves,
    stacked leaves with their layer count in front (as JAX's
    ``eval_shape`` gives them). An int8 moment dict {name: ``QTensor``}
    gives {"q", "scale"} pairs of those."""
    stack = _stack_same(lambda n, x: ((n,) + x[0], x[1]))

    def layout(named):
        return _to_jax_layout(((n, (tuple(t.shape),
                                    str(t.dtype).removeprefix("torch.")))
                               for n, t in named), cfg, stack)
    if isinstance(module, dict):
        return _zip_dl(layout((n, x.q) for n, x in module.items()),
                       layout((n, x.scale) for n, x in module.items()),
                       lambda q, s: {"q": q, "scale": s})
    return layout(module.named_parameters())


def params_to_jax(params: DecoderParams, cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a numpy pytree in the JAX layout."""
    return _to_jax_layout(((name, to_numpy(t))
                           for name, t in params.named_parameters()), cfg)


def cache_from_jax(np_cache: List[Dict[str, Any]], device=None) -> Cache:
    """A numpy copy of ``repro.models.model.init_cache``'s list -> port."""
    dev = resolve_device(device)
    return [{name: to_torch(np.asarray(leaf), dev) for name, leaf in c.items()}
            for c in np_cache]


def cache_to_jax(cache: Cache) -> List[Dict[str, np.ndarray]]:
    return [{name: to_numpy(t) for name, t in c.items()} for c in cache]


def _is_jax_qtensor(leaf) -> bool:
    """JAX's ``QTensor`` (int8 ``q``, f32 ``scale``), told by its fields."""
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _moment_from_jax(tree: Dict[str, Any], cfg: ArchConfig, dev):
    """An AdamW moment: f32 or bf16 in the params' layout -> a parameter
    module of that dtype; JAX's ``QTensor`` leaves -> {name: ``QTensor``}
    (``training.quant``), q and scale split by layer as the params are."""
    if not _is_jax_qtensor(tree["embed"]):
        return params_from_jax(tree, cfg, dev, moment=True)
    from repro_torch.training.quant import QTensor
    q = dict(_jax_named(_map(tree, lambda x: x.q), cfg))
    scale = dict(_jax_named(_map(tree, lambda x: x.scale), cfg))
    shapes = {name: tuple(t.shape) for name, t in
              DecoderParams(cfg, torch.float32, "meta").named_parameters()}
    if set(q) != set(shapes):
        raise ValueError(f"bridge: moment leaves {sorted(set(q) ^ set(shapes))}"
                         " differ from the config's")
    out = {}
    for name, shape in shapes.items():
        qt = QTensor(to_torch(np.asarray(q[name]), dev),
                     to_torch(np.asarray(scale[name]), dev))
        if (tuple(qt.q.shape) != shape or qt.q.dtype != torch.int8
                or tuple(qt.scale.shape) != shape[:-1] + (1,)):
            raise ValueError(f"bridge: int8 moment {name} has q "
                             f"{tuple(qt.q.shape)} {qt.q.dtype}, scale "
                             f"{tuple(qt.scale.shape)}; the port wants q "
                             f"{shape} int8, scale {shape[:-1] + (1,)}")
        out[name] = qt
    return out


def _moment_to_jax(m, cfg: ArchConfig, qtensor):
    if not isinstance(m, dict):
        return params_to_jax(m, cfg)
    if qtensor is None:
        raise ValueError("bridge: int8 moments go back as the JAX package's "
                         "QTensor; pass it as qtensor")
    q = _to_jax_layout(((n, to_numpy(x.q)) for n, x in m.items()), cfg)
    scale = _to_jax_layout(((n, to_numpy(x.scale)) for n, x in m.items()), cfg)
    return _zip(q, scale, qtensor)


def train_state_from_jax(np_state: Dict[str, Any], cfg: ArchConfig,
                         device=None) -> Dict[str, Any]:
    """A numpy copy of ``repro.training.step.init_train_state``'s state ->
    the port's (``repro_torch.training.step``): params (with grad on),
    ``opt.m`` / ``opt.v`` as ``optimizer.init_opt_state`` makes them (f32 or
    bf16 moments as parameter modules of that dtype; JAX's int8
    ``QTensor`` moments as {name: ``QTensor``}), ``opt.count`` and ``step``
    as int32 scalars. Every leaf keeps its bits."""
    dev = resolve_device(device)
    opt = np_state["opt"]
    return {"params": params_from_jax(np_state["params"], cfg,
                                      dev).requires_grad_(True),
            "opt": {"m": _moment_from_jax(opt["m"], cfg, dev),
                    "v": _moment_from_jax(opt["v"], cfg, dev),
                    "count": to_torch(np.asarray(opt["count"]), dev)},
            "step": to_torch(np.asarray(np_state["step"]), dev)}


def train_state_to_jax(state: Dict[str, Any], cfg: ArchConfig,
                       qtensor=None) -> Dict[str, Any]:
    """The inverse of ``train_state_from_jax``: a numpy pytree in the JAX
    layout. int8 moments come back as ``qtensor(q, scale)`` a leaf: the
    caller passes the JAX package's ``QTensor``, which the bridge never
    imports (without it, int8 moments raise)."""
    opt = state["opt"]
    return {"params": params_to_jax(state["params"], cfg),
            "opt": {"m": _moment_to_jax(opt["m"], cfg, qtensor),
                    "v": _moment_to_jax(opt["v"], cfg, qtensor),
                    "count": to_numpy(opt["count"])},
            "step": to_numpy(state["step"])}
