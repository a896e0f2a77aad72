"""Architecture config registry + reduced-size variants for CPU tests.

The port's own copy of ``repro.configs`` (registry, aliases, ``reduced``,
and the shape sets of ``configs.shapes``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MambaSpec, MoESpec)
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                        PREFILL_32K, TRAIN_4K, ShapeSpec,
                                        shapes_for)

from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.starcoder2_7b import CONFIG as STARCODER2_7B
from repro_torch.configs.internlm2_1_8b import CONFIG as INTERNLM2_1_8B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.seamless_m4t_large import CONFIG as SEAMLESS_M4T_LARGE
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B

__all__ = ["ARCHS", "ALIASES", "ALL_SHAPES", "ArchConfig", "AttnSpec",
           "DECODE_32K", "LONG_500K", "LayerSpec", "MambaSpec", "MoESpec",
           "PREFILL_32K", "ShapeSpec", "TRAIN_4K", "get_config", "reduced",
           "shapes_for"]

ARCHS = {c.name: c for c in (
    CHAMELEON_34B, STARCODER2_7B, INTERNLM2_1_8B, QWEN3_32B, GEMMA2_9B,
    JAMBA_1_5_LARGE, SEAMLESS_M4T_LARGE, GROK_1_314B, ARCTIC_480B,
    FALCON_MAMBA_7B,
)}

# short aliases for --arch flags
ALIASES = {
    "chameleon-34b": "chameleon-34b",
    "starcoder2-7b": "starcoder2-7b",
    "internlm2-1.8b": "internlm2-1.8b",
    "qwen3-32b": "qwen3-32b",
    "gemma2-9b": "gemma2-9b",
    "jamba-1.5-large-398b": "jamba-1.5-large-398b",
    "jamba": "jamba-1.5-large-398b",
    "seamless-m4t-large-v2": "seamless-m4t-large-v2",
    "seamless": "seamless-m4t-large-v2",
    "grok-1-314b": "grok-1-314b",
    "grok": "grok-1-314b",
    "arctic-480b": "arctic-480b",
    "arctic": "arctic-480b",
    "falcon-mamba-7b": "falcon-mamba-7b",
    "falcon-mamba": "falcon-mamba-7b",
}


def get_config(name: str) -> ArchConfig:
    return ARCHS[ALIASES.get(name, name)]


def reduced(cfg: ArchConfig, *, d_model: int = 128, n_layers: int | None = None,
            vocab: int = 512, d_ff: int = 256, n_heads: int = 4,
            n_kv_heads: int | None = None) -> ArchConfig:
    """A tiny same-family variant of ``cfg`` for CPU tests.

    Keeps the block pattern (so gemma2 still alternates local/global, jamba
    still interleaves mamba/attn/moe) but shrinks every dimension.
    """
    n_layers = n_layers if n_layers is not None else len(cfg.block)
    if n_layers % len(cfg.block) != 0:
        n_layers = len(cfg.block)
    kv = n_kv_heads if n_kv_heads is not None else max(1, n_heads // 2)
    if cfg.n_heads == 0:   # attention-free
        n_heads, kv, d_head = 0, 0, 0
    else:
        d_head = max(8, d_model // n_heads)
    moe = None
    if cfg.moe is not None:
        moe = MoESpec(n_experts=min(cfg.moe.n_experts, 4),
                      top_k=min(cfg.moe.top_k, 2),
                      capacity_factor=cfg.moe.capacity_factor)
    mamba = None
    if cfg.mamba is not None:
        mamba = MambaSpec(d_state=8, d_conv=4, expand=2)
    # shrink local windows so they are exercised at tiny seq lens
    block = tuple(
        dataclasses.replace(
            s, attn=dataclasses.replace(
                s.attn, window=(8 if s.attn.window else None)))
        for s in cfg.block)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=kv, d_head=d_head,
        d_ff=(0 if cfg.d_ff == 0 else d_ff), vocab=vocab, block=block,
        moe=moe, mamba=mamba,
        n_enc_layers=(2 if cfg.enc_dec else 0),
    )
