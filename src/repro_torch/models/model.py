"""Model assembly for the dense decoder families, in PyTorch.

Counterpart of ``repro.models.model``. The JAX package stacks the layers of a
block position over ``n_blocks`` and scans; here the layers are a
``ModuleList`` in execution order: layer ``n * len(cfg.block) + i`` is block
``n``'s position ``i`` (``repro_torch.bridge`` maps between the two).

Public API (the JAX signatures and layouts):
    init_params(generator, cfg, dtype, device)   -> DecoderParams
    forward(params, batch, cfg, rt)              -> (logits [B,S,V], aux)
    init_cache(cfg, B, S, dtype, device)         -> [{"k","v"} per block pos]
    decode_step(params, cache, tokens, pos, cfg, rt) -> (logits [B,V], cache)

Mamba, MoE and encoder-decoder configs raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L

Cache = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs. ``attn_impl``: "kernel" (the hand-written CUDA kernels
    on the card, their plain versions on the CPU) or "plain" (the plain
    PyTorch versions everywhere; an explicit request for references)."""
    attn_impl: str = "kernel"

    def __post_init__(self):
        if self.attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{L.ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class LayerParams(nn.Module):
    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        self.norm1 = L.leaf((cfg.d_model,), dtype, device)
        self.attn = L.AttentionParams(cfg, spec.attn, dtype, device)
        if spec.ffn != "none":
            self.norm2 = L.leaf((cfg.d_model,), dtype, device)
        if spec.ffn == "dense":
            self.mlp = L.MLPParams(cfg, dtype, device)


class DecoderParams(nn.Module):
    """All weights of a dense decoder, leaves in the JAX package's shapes."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        L.check_supported(cfg)
        d, V = cfg.d_model, cfg.eff_vocab
        self.embed = L.leaf((V, d), dtype, device)
        self.final_norm = L.leaf((d,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.leaf((d, V), dtype, device)
        self.layers = nn.ModuleList(
            LayerParams(cfg, spec, dtype, device) for spec in cfg.layer_kinds())


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16, device=None) -> DecoderParams:
    """Seeded full-size weights made directly on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). Same distributions as ``repro.models.model``'s
    init, not the same bits. ``generator`` must live on that device."""
    dev = resolve_device(device)
    p = DecoderParams(cfg, dtype, dev)
    L.normal_(p.embed, generator, 1.0)
    p.final_norm.zero_()
    if not cfg.tie_embeddings:
        L.normal_(p.unembed, generator, 1.0 / math.sqrt(cfg.d_model))
    for layer in p.layers:
        layer.norm1.zero_()
        L.init_attention(layer.attn, generator, cfg)
        if hasattr(layer, "norm2"):
            layer.norm2.zero_()
        if hasattr(layer, "mlp"):
            L.init_mlp(layer.mlp, generator, cfg)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _no_tf32(device: torch.device) -> None:
    """f32 products on the card run in full f32, never TF32: the references
    and tolerances of this package assume it."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _ffn(layer: LayerParams, spec: LayerSpec, x: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    if spec.ffn == "none":
        return x
    h = L.rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + L.apply_mlp(layer.mlp, h, cfg.act)


def _embed(params: DecoderParams, tokens: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    x = params.embed[tokens]
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params: DecoderParams, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params.embed)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params.unembed)
    logits = logits.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.eff_vocab != cfg.vocab:   # mask TP-padded vocab rows
        keep = torch.arange(cfg.eff_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(keep, logits, -1e30)
    return logits


def forward(params: DecoderParams, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, rt: Runtime = Runtime()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V] f32, moe_aux scalar; 0 for dense configs).

    batch: {"tokens": [B,S] integer}. Attention runs through the flash
    kernel (``rt.attn_impl="kernel"``) once per layer.
    """
    L.check_supported(cfg)
    dev = params.embed.device
    _no_tf32(dev)
    tokens = batch["tokens"].to(dev)
    S = tokens.shape[1]
    positions = torch.arange(S, device=dev)[None, :]
    x = _embed(params, tokens, cfg)
    for layer, spec in zip(params.layers, cfg.layer_kinds()):
        h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
        x = x + L.apply_attention(layer.attn, h, spec.attn, cfg, positions,
                                  attn_impl=rt.attn_impl)
        x = _ffn(layer, spec, x, cfg)
    return _logits(params, x, cfg), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Decode cache: per in-block position ``{"k","v"}`` of
    ``[n_blocks, B, S, kv, dh]`` zeros, as in the JAX package."""
    L.check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_blocks, B, S, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in cfg.block]


def decode_step(params: DecoderParams, cache: Cache, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig, rt: Runtime = Runtime()
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: [B] integer; pos: [B] current positions.

    Returns (logits [B,V] f32, cache). The cache is updated IN PLACE (see
    ``layers.apply_attention_decode``) and returned. Attention runs through
    the decode kernel once per layer.
    """
    L.check_supported(cfg)
    dev = params.embed.device
    _no_tf32(dev)
    tokens, pos = tokens.to(dev), pos.to(dev)
    x = _embed(params, tokens[:, None], cfg)                    # [B,1,d]
    nb = len(cfg.block)
    for idx, (layer, spec) in enumerate(zip(params.layers, cfg.layer_kinds())):
        c = cache[idx % nb]
        n = idx // nb
        h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
        mix, _, _ = L.apply_attention_decode(
            layer.attn, h, spec.attn, cfg, c["k"][n], c["v"][n], pos,
            attn_impl=rt.attn_impl)
        x = _ffn(layer, spec, x + mix, cfg)
    return _logits(params, x, cfg)[:, 0, :], cache
