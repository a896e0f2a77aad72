"""Model layers of the dense decoder and Mamba families, in PyTorch.

Counterpart of ``repro.models.layers`` (``rms_norm``, ``_act``, ``rope``,
attention, decode attention, the gated MLP and the Mamba-1 mixer). Parameter
leaves keep the JAX package's shapes (``wq [d,h,dh]``, ``wo [h,dh,d]``,
``w1 [d,f]``, ``in_proj [d,2*di]`` ...), so the einsum formulas carry over
and ``repro_torch.bridge`` copies leaves as they are. Attention and the scan
go through the hand-written kernels (``attn_impl`` / ``scan_impl`` "kernel",
the default) or their plain versions ("plain"); on the CPU the kernel
wrappers take the plain versions themselves.

The MoE layers of ``repro.models.layers`` belong to a later slice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.kernels import ops, ref

ATTN_IMPLS = ("kernel", "plain")
SCAN_IMPLS = ("kernel", "plain")

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


# ---------------------------------------------------------------------------
# Mamba-1 mixer (conv + selective scan)
# ---------------------------------------------------------------------------


class MambaParams(nn.Module):
    """Leaves of one Mamba mixer, in the JAX package's shapes. ``dt_bias``,
    ``A_log`` and ``D`` are f32 whatever the model's dtype, as in JAX."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, di, ds = cfg.d_model, cfg.d_inner, cfg.mamba.d_state
        dc, dr = cfg.mamba.d_conv, cfg.dt_rank
        self.in_proj = leaf((d, 2 * di), dtype, device)
        self.conv_w = leaf((dc, di), dtype, device)
        self.x_proj = leaf((di, dr + 2 * ds), dtype, device)
        self.dt_proj = leaf((dr, di), dtype, device)
        self.dt_bias = leaf((di,), torch.float32, device)
        self.A_log = leaf((di, ds), torch.float32, device)
        self.D = leaf((di,), torch.float32, device)
        self.out_proj = leaf((di, d), dtype, device)


def init_mamba(p: MambaParams, generator: torch.Generator,
               cfg: ArchConfig) -> None:
    """Fill ``p`` in place as ``repro.models.layers.init_mamba`` does: normal
    projections (scales 1/sqrt of their fan-in), ``dt_bias = log(expm1(0.01))``,
    ``A_log = log(1..d_state)`` on every row, ``D = 1``."""
    di, ds, dc, dr = (cfg.d_inner, cfg.mamba.d_state, cfg.mamba.d_conv,
                      cfg.dt_rank)
    for name, fan_in in (("in_proj", cfg.d_model), ("conv_w", dc),
                         ("x_proj", di), ("dt_proj", dr), ("out_proj", di)):
        normal_(getattr(p, name), generator, 1.0 / math.sqrt(fan_in))
    with torch.no_grad():
        p.dt_bias.fill_(torch.log(torch.expm1(torch.tensor(0.01))))   # in f32
        p.A_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                             device=p.A_log.device)
                                ).expand(di, ds))
        p.D.fill_(1.0)


def _mamba_pre(p: MambaParams, x: torch.Tensor, cfg: ArchConfig,
               conv_state: Optional[torch.Tensor] = None):
    """In-projection, causal depthwise conv, silu, x/dt projections. x: [B,S,d].

    Returns (u [B,S,di] after conv and silu, z gate [B,S,di], dt [B,S,di]
    f32, Bc [B,S,ds], Cc [B,S,ds], new conv tail [B,dc-1,di] in u's dtype).
    The conv is the JAX code's shifted adds in order i = 0..dc-1 (no
    ``conv1d``: cuDNN would sum in another order, in TF32 by default).
    """
    di, ds, dc, dr = (cfg.d_inner, cfg.mamba.d_state, cfg.mamba.d_conv,
                      cfg.dt_rank)
    S = x.shape[1]
    u, z = torch.einsum("bsd,de->bse", x, p.in_proj).split(di, dim=-1)
    if conv_state is None:
        pad = u.new_zeros((u.shape[0], dc - 1, di))
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                          # [B,S+dc-1,di]
    conv = up[:, 0:S] * p.conv_w[0]
    for i in range(1, dc):
        conv = conv + up[:, i:i + S] * p.conv_w[i]
    new_tail = up[:, up.shape[1] - (dc - 1):]
    u = F.silu(conv)
    dt, Bc, Cc = torch.einsum("bsi,ie->bse", u, p.x_proj).split([dr, ds, ds],
                                                               dim=-1)
    dt = torch.einsum("bsr,ri->bsi", dt, p.dt_proj).float() + p.dt_bias
    dt = torch.logaddexp(dt, dt.new_zeros(()))   # softplus, as jax.nn.softplus
    return u, z, dt, Bc, Cc, new_tail


def _scan_inputs(p: MambaParams, u, dt, Bc):
    """a = exp(dt * A) and b = dt * u * B, both [B,S,di,ds] f32."""
    A = -torch.exp(p.A_log)                                  # [di,ds]
    a = (dt[..., None] * A).exp_()
    b = (dt * u.float())[..., None] * Bc.float()[:, :, None, :]
    return a, b


def _scan(a, b, h0, scan_impl: str):
    if scan_impl == "kernel":
        return ops.selective_scan(a, b, h0)
    if scan_impl == "plain":
        return ref.selective_scan_ref(a, b, h0)
    raise ValueError(f"scan_impl {scan_impl!r} not in {SCAN_IMPLS}")


def _mamba_out(p: MambaParams, x, y, u, z) -> torch.Tensor:
    """y + u * D, gated by silu(z) in f32, cast to x's dtype, out-projected."""
    y = y + u.float() * p.D
    y = (y * F.silu(z.float())).to(x.dtype)
    return torch.einsum("...i,id->...d", y, p.out_proj)


def apply_mamba(p: MambaParams, x: torch.Tensor, cfg: ArchConfig, *,
                scan_impl: str = "kernel") -> torch.Tensor:
    """Full-sequence Mamba mixer. x: [B,S,d] -> [B,S,d].

    The ``scan_impl="pallas"`` branch of the JAX code: a and b are built at
    [B,S,di,ds] in f32 and the recurrence runs in one scan-kernel launch
    (``scan_impl="kernel"``) or the plain loop (``"plain"``).
    """
    u, z, dt, Bc, Cc, _ = _mamba_pre(p, x, cfg)
    a, b = _scan_inputs(p, u, dt, Bc)
    h = _scan(a, b, None, scan_impl)
    del a, b
    y = torch.einsum("bsin,bsn->bsi", h, Cc.float())
    return _mamba_out(p, x, y, u, z)


def apply_mamba_decode(p: MambaParams, x: torch.Tensor, cfg: ArchConfig,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor, *,
                       scan_impl: str = "kernel"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step. x: [B,1,d]; conv_state [B,dc-1,di]; ssm_state
    [B,di,ds] f32.

    Returns (out [B,1,d], conv_state, ssm_state). The new conv tail and the
    new SSM state are written IN PLACE into the tensors passed in (the JAX
    code returns new arrays with the same values), so the returned states
    are those tensors. The state update ``h = a * ssm_state + b`` is one
    step of the scan kernel with ``h0 = ssm_state``.
    """
    u, z, dt, Bc, Cc, new_tail = _mamba_pre(p, x, cfg, conv_state=conv_state)
    a, b = _scan_inputs(p, u, dt, Bc)                        # [B,1,di,ds]
    h = _scan(a, b, ssm_state, scan_impl)[:, 0]              # [B,di,ds]
    conv_state.copy_(new_tail)
    ssm_state.copy_(h)
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0].float())
    out = _mamba_out(p, x, y, u[:, 0], z[:, 0])[:, None, :]
    return out, conv_state, ssm_state


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
        if spec.mixer not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.ffn in ("moe", "moe_dense"):
            raise unsupported(f"{cfg.name}: the {spec.ffn} FFN", "MoE")
        if spec.ffn not in ("dense", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
