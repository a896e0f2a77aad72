"""Move the JAX package's params, train states and decode caches into the
port and back.

Both sides speak numpy at the boundary: the caller turns JAX arrays into
numpy (``jax.tree.map(np.asarray, ...)``) and this module never imports JAX.
Leaf shapes stay as they are. The JAX params stack every block position's
leaves over ``n_blocks`` on axis 0 (``params["blocks"][i][...][n]``); the
port holds them as ``layers[n * len(cfg.block) + i]``. The cache keeps the
same stacked layout on both sides, so its leaves copy one to one (``k``/``v``
for attention, ``conv``/``ssm`` for Mamba). bf16 leaves travel as
``ml_dtypes.bfloat16`` numpy arrays, the type JAX hands out. Leaves keep
their dtype: a Mamba model's ``A_log``, ``D`` and ``dt_bias`` are f32 in a
bf16 model on both sides, and a leaf whose dtype differs from the port's
parameter is refused, never cast.
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


def _get(module: torch.nn.Module, path) -> torch.Tensor:
    for name in path:
        module = getattr(module, name)
    return module


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> DecoderParams:
    """A numpy copy of ``repro.models.model.init_params``'s pytree -> port.

    The model dtype is the embedding's. Raises ``ValueError`` when a leaf's
    shape or dtype differs from the port's parameter, or a leaf is missing
    or unexpected."""
    dev = resolve_device(device)
    dtype = TORCH_DTYPES[np.asarray(np_params["embed"]).dtype.name]
    out = DecoderParams(cfg, dtype, dev)
    expected = {name for name, _ in out.named_parameters()}
    seen = set()

    def put(path, leaf):
        dst = _get(out, path)
        src = to_torch(np.asarray(leaf), dev)
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"bridge: {'.'.join(path)} has shape "
                             f"{tuple(src.shape)}, the port wants "
                             f"{tuple(dst.shape)}")
        if dst.dtype != src.dtype:
            raise ValueError(f"bridge: {'.'.join(path)} has dtype "
                             f"{src.dtype}, the port wants {dst.dtype}")
        with torch.no_grad():
            dst.copy_(src)
        seen.add(".".join(path))

    nb = len(cfg.block)
    for name, leaf in np_params.items():
        if name == "blocks":
            for i, block in enumerate(leaf):
                for path, stacked in _leaves(block):
                    for n in range(cfg.n_blocks):
                        put(("layers", str(n * nb + i)) + path, stacked[n])
        else:
            put((name,), leaf)
    if seen != expected:
        raise ValueError(f"bridge: leaves missing {sorted(expected - seen)}, "
                         f"unexpected {sorted(seen - expected)}")
    return out


def params_to_jax(params: DecoderParams, cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a numpy pytree in the JAX layout."""
    out: Dict[str, Any] = {}
    nb = len(cfg.block)
    blocks: List[Dict[str, Any]] = [{} for _ in range(nb)]
    for name, t in params.named_parameters():
        path = name.split(".")
        if path[0] != "layers":
            out[name] = to_numpy(t)
            continue
        idx = int(path[1])
        n, i = divmod(idx, nb)
        node = blocks[i]
        for key in path[2:-1]:
            node = node.setdefault(key, {})
        node.setdefault(path[-1], [None] * cfg.n_blocks)[n] = to_numpy(t)
    for block in blocks:
        for path, parts in list(_leaves(block)):
            node = block
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = np.stack(parts)
    out["blocks"] = blocks
    return out


def cache_from_jax(np_cache: List[Dict[str, Any]], device=None) -> Cache:
    """A numpy copy of ``repro.models.model.init_cache``'s list -> port."""
    dev = resolve_device(device)
    return [{name: to_torch(np.asarray(leaf), dev) for name, leaf in c.items()}
            for c in np_cache]


def cache_to_jax(cache: Cache) -> List[Dict[str, np.ndarray]]:
    return [{name: to_numpy(t) for name, t in c.items()} for c in cache]


def train_state_from_jax(np_state: Dict[str, Any], cfg: ArchConfig,
                         device=None) -> Dict[str, Any]:
    """A numpy copy of ``repro.training.step.init_train_state``'s state ->
    the port's (``repro_torch.training.step``): params (with grad on),
    ``opt.m`` / ``opt.v`` in the params' layout (f32 moments only),
    ``opt.count`` and ``step`` as int32 scalars."""
    dev = resolve_device(device)
    opt = np_state["opt"]
    return {"params": params_from_jax(np_state["params"], cfg,
                                      dev).requires_grad_(True),
            "opt": {"m": params_from_jax(opt["m"], cfg, dev),
                    "v": params_from_jax(opt["v"], cfg, dev),
                    "count": to_torch(np.asarray(opt["count"]), dev)},
            "step": to_torch(np.asarray(np_state["step"]), dev)}


def train_state_to_jax(state: Dict[str, Any], cfg: ArchConfig
                       ) -> Dict[str, Any]:
    """The inverse of ``train_state_from_jax``: a numpy pytree in the JAX
    layout."""
    opt = state["opt"]
    return {"params": params_to_jax(state["params"], cfg),
            "opt": {"m": params_to_jax(opt["m"], cfg),
                    "v": params_to_jax(opt["v"], cfg),
                    "count": to_numpy(opt["count"])},
            "step": to_numpy(state["step"])}
