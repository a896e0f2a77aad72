"""Model layers of the dense decoder families, in PyTorch.

Counterpart of ``repro.models.layers`` (``rms_norm``, ``_act``, ``rope``,
attention, decode attention and the gated MLP). Parameter leaves keep the
JAX package's shapes (``wq [d,h,dh]``, ``wo [h,dh,d]``, ``w1 [d,f]`` ...), so
the einsum formulas carry over and ``repro_torch.bridge`` copies leaves as
they are. Attention goes through the hand-written kernels
(``attn_impl="kernel"``, the default) or their plain versions
(``attn_impl="plain"``); on the CPU the kernel wrappers take the plain
versions themselves.

The MoE and Mamba layers of ``repro.models.layers`` belong to later slices.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.kernels import ops, ref

ATTN_IMPLS = ("kernel", "plain")

# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, scaled by ``1 + scale``, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x: [..., S, H, D]; positions: [..., S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def leaf(shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight. No autograd in the serving slice: the kernels
    are forward only."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class AttentionParams(nn.Module):
    """Leaves of one attention mixer, in the JAX package's shapes."""

    def __init__(self, cfg: ArchConfig, spec: AttnSpec, dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.eff_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = leaf((d, h, dh), dtype, device)
        self.wk = leaf((d, kv, dh), dtype, device)
        self.wv = leaf((d, kv, dh), dtype, device)
        self.wo = leaf((h, dh, d), dtype, device)
        if spec.qk_norm:
            self.q_norm = leaf((dh,), dtype, device)
            self.k_norm = leaf((dh,), dtype, device)


def init_attention(p: AttentionParams, generator: torch.Generator,
                   cfg: ArchConfig) -> None:
    """Fill ``p`` in place: normal weights as in ``repro.models.layers``
    (scale 1/sqrt(d) for wq/wk/wv, 1/sqrt(h*dh) for wo), zero qk-norm scales.
    The draws are torch's, not JAX's bits."""
    s = 1.0 / math.sqrt(cfg.d_model)
    for name, scale in (("wq", s), ("wk", s), ("wv", s),
                        ("wo", 1.0 / math.sqrt(cfg.eff_heads * cfg.d_head))):
        normal_(getattr(p, name), generator, scale)
    for name in ("q_norm", "k_norm"):
        if hasattr(p, name):
            getattr(p, name).zero_()


def normal_(t: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    """``t <- N(0,1) * scale`` drawn in f32, then cast to t's dtype."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32).mul_(scale))


def _head_mask(out: torch.Tensor, cfg: ArchConfig, head_dim: int) -> torch.Tensor:
    """Zero the heads padded for tensor parallelism (heads on ``head_dim``)."""
    h = out.shape[head_dim]
    if h == cfg.n_heads:
        return out
    keep = (torch.arange(h, device=out.device) < cfg.n_heads).to(out.dtype)
    shape = [1] * out.dim()
    shape[head_dim] = h
    return out * keep.view(shape)


def apply_attention(p: AttentionParams, x: torch.Tensor, spec: AttnSpec,
                    cfg: ArchConfig, positions: torch.Tensor, *,
                    causal: bool = True, attn_impl: str = "kernel"
                    ) -> torch.Tensor:
    """Full-sequence self-attention (prefill / forward). x: [B,S,d].

    K/V stay at kv heads: the kernel (or its plain version) reads kv head
    ``h // groups`` for q head ``h``, so the JAX path's repeat is never made.
    Padded heads are zeroed after attention, as on the JAX XLA path.
    """
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if spec.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta).contiguous()
    k = rope(k, positions, cfg.rope_theta).contiguous()
    v = v.contiguous()
    kw = dict(causal=causal, window=spec.window, softcap=spec.softcap)
    if attn_impl == "kernel":
        out = ops.flash_attention(q, k, v, **kw)
    elif attn_impl == "plain":
        out = ref.flash_attention_ref(q, k, v, **kw)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    out = _head_mask(out, cfg, head_dim=2)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


def apply_attention_decode(p: AttentionParams, x: torch.Tensor, spec: AttnSpec,
                           cfg: ArchConfig, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: torch.Tensor, *,
                           attn_impl: str = "kernel"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: [B,1,d]; cache_k/v: [B,S,kv,dh]; pos: [B].

    Returns (out [B,1,d], cache_k, cache_v). The new K/V row is written
    IN PLACE at ``pos % S`` of each slot (the JAX code blends it in with a
    one-hot; the values written are the same), so the returned caches are
    the tensors passed in. Keys are valid where ``kpos <= pos`` (and
    ``kpos > pos - window``), absolute positions as in the JAX code, which
    the kernel evaluates as ``kpos < pos + 1`` on the same predicate, for
    ``pos >= S`` too. q is cast to the cache's dtype (exact when widening).
    """
    B, S = x.shape[0], cache_k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k_new = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v_new = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if spec.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k_new = rms_norm(k_new, p.k_norm, cfg.norm_eps)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    slots = torch.arange(B, device=x.device)
    at = (pos % S).long()
    cache_k[slots, at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[slots, at] = v_new[:, 0].to(cache_v.dtype)
    lengths = (pos + 1).to(torch.int32)
    qd = q[:, 0].to(cache_k.dtype).contiguous()                 # [B,h,dh]
    kw = dict(window=spec.window, softcap=spec.softcap)
    if attn_impl == "kernel":
        out = ops.decode_attention(qd, cache_k, cache_v, lengths, **kw)
    elif attn_impl == "plain":
        out = ref.decode_attention_ref(qd, cache_k, cache_v, lengths, **kw)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    out = _head_mask(out, cfg, head_dim=1).to(x.dtype)[:, None]   # [B,1,h,dh]
    return torch.einsum("bshk,hkd->bsd", out, p.wo), cache_k, cache_v


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------


class MLPParams(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = leaf((d, f), dtype, device)
        self.w3 = leaf((d, f), dtype, device)
        self.w2 = leaf((f, d), dtype, device)


def init_mlp(p: MLPParams, generator: torch.Generator, cfg: ArchConfig) -> None:
    d, f = cfg.d_model, cfg.d_ff
    normal_(p.w1, generator, 1 / math.sqrt(d))
    normal_(p.w3, generator, 1 / math.sqrt(d))
    normal_(p.w2, generator, 1 / math.sqrt(f))


def apply_mlp(p: MLPParams, x: torch.Tensor, act: str) -> torch.Tensor:
    g = _act(act)(torch.einsum("bsd,df->bsf", x, p.w1))
    u = torch.einsum("bsd,df->bsf", x, p.w3)
    return torch.einsum("bsf,fd->bsd", g * u, p.w2)


def unsupported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet; it arrives with the "
        f"{slice_name} slice")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the families this slice does not carry (never run another
    path instead)."""
    if cfg.enc_dec:
        raise unsupported(f"{cfg.name}: encoder-decoder", "encoder-decoder")
    for spec in cfg.block:
        if spec.mixer != "attn":
            raise unsupported(f"{cfg.name}: the {spec.mixer} mixer", "Mamba")
        if spec.ffn in ("moe", "moe_dense"):
            raise unsupported(f"{cfg.name}: the {spec.ffn} FFN", "MoE")
        if spec.ffn not in ("dense", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
