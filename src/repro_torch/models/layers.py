"""Model layers of every family (dense, Mamba, MoE, encoder-decoder), in PyTorch.

Counterpart of ``repro.models.layers`` (``rms_norm``, ``_act``, ``rope``,
attention, decode attention, the gated MLP, the MoE FFN and the Mamba-1
mixer). Parameter leaves keep the JAX package's shapes (``wq [d,h,dh]``,
``wo [h,dh,d]``, ``w1 [d,f]``, ``in_proj [d,2*di]`` ...), so the einsum
formulas carry over and ``repro_torch.bridge`` copies leaves as they are.
Attention and the scan go through the hand-written kernels (``attn_impl`` /
``scan_impl`` "kernel", the default) or their plain versions ("plain"); on
the CPU the kernel wrappers take the plain versions themselves. The MoE
FFN runs no kernel of its own: its expert GEMMs are ``torch.bmm``, as the
JAX code's are XLA einsums.
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
    """An uninitialised weight, without grad (serving); the train state turns
    grad on (``training.step.init_train_state``)."""
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
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    causal: bool = True, attn_impl: str = "kernel"
                    ) -> torch.Tensor:
    """Full-sequence attention (prefill / forward / encoder / cross). x: [B,S,d].

    ``kv_override=(memory, mem_positions)`` (cross-attention) projects k and
    v from the encoder memory [B,Ss,d] through ``wk``/``wv``. RoPE applies
    when ``causal or kv_override is None``, as in the JAX code: decoder and
    encoder self-attention get it (at ``positions``), cross-attention does
    not. K/V stay at kv heads: the kernel (or its plain version) reads kv
    head ``h // groups`` for q head ``h``, so the JAX path's repeat is never
    made. Padded heads are zeroed after attention, as on the JAX XLA path.
    """
    xkv, k_pos = (x, positions) if kv_override is None else kv_override
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", xkv, p.wk)
    v = torch.einsum("bsd,dhk->bshk", xkv, p.wv)
    if spec.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if causal or kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, k_pos, cfg.rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
                           cross: bool = False, attn_impl: str = "kernel"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: [B,1,d]; cache_k/v: [B,S,kv,dh]; pos: [B].

    Returns (out [B,1,d], cache_k, cache_v). Self-attention writes the new
    K/V row IN PLACE at ``pos % S`` of each slot (the JAX code blends it in
    with a one-hot; the values written are the same), so the returned caches
    are the tensors passed in. Keys are valid where ``kpos <= pos`` (and
    ``kpos > pos - window``), absolute positions as in the JAX code, which
    the kernel evaluates as ``kpos < pos + 1`` on the same predicate, for
    ``pos >= S`` too. With ``cross=True`` the cache holds the encoder
    memory's K/V: no RoPE on q, no write, and every key valid (lengths S,
    made on the device, no host sync). q is cast to the cache's dtype
    (exact when widening).
    """
    B, S = x.shape[0], cache_k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if spec.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    if cross:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        k_new = torch.einsum("bsd,dhk->bshk", x, p.wk)
        v_new = torch.einsum("bsd,dhk->bshk", x, p.wv)
        if spec.qk_norm:
            k_new = rms_norm(k_new, p.k_norm, cfg.norm_eps)
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_new = rope(k_new, pos[:, None], cfg.rope_theta)
        slots = torch.arange(B, device=x.device)
        at = (pos % S).long()
        cache_k[slots, at] = k_new[:, 0].to(cache_k.dtype)
        cache_v[slots, at] = v_new[:, 0].to(cache_v.dtype)
        lengths = (pos + 1).to(torch.int32)
    qd = q[:, 0].to(cache_k.dtype).contiguous()                 # [B,h,dh]
    kw = dict(window=None if cross else spec.window, softcap=spec.softcap)
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
# MoE: top-k routing with capacity, sort-based slotting, gather dispatch and
# a gather combine (no scatter, no atomics, no host sync)
# ---------------------------------------------------------------------------


class MoEParams(nn.Module):
    """Leaves of one MoE FFN, in the JAX package's shapes: ``router`` [d, E]
    in f32 whatever the model's dtype; ``w1`` / ``w3`` [E*sp, d, f/sp] and
    ``w2`` [E*sp, f/sp, d], sp = ``expert_split``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        sp = cfg.moe.expert_split
        self.router = leaf((d, E), torch.float32, device)
        self.w1 = leaf((E * sp, d, f // sp), dtype, device)
        self.w3 = leaf((E * sp, d, f // sp), dtype, device)
        self.w2 = leaf((E * sp, f // sp, d), dtype, device)


def init_moe(p: MoEParams, generator: torch.Generator, cfg: ArchConfig) -> None:
    """Fill ``p`` in place with ``repro.models.layers.init_moe``'s
    distributions: N(0, 1) / sqrt(d) for the router, w1 and w3, / sqrt(f)
    for w2."""
    d, f = cfg.d_model, cfg.d_ff
    for name, fan_in in (("router", d), ("w1", d), ("w3", d), ("w2", f)):
        normal_(getattr(p, name), generator, 1.0 / math.sqrt(fan_in))


def moe_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: capacity_factor * n_tokens * top_k / n_experts,
    rounded up to a multiple of 32, at least 32 (as the JAX code)."""
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * n_tokens * m.top_k / m.n_experts))
    return max(32, -(-c // 32) * 32)


MOE_TOKEN_CHUNK = 65_536


def apply_moe(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss, f32 scalar).

    When T = B*S exceeds ``MOE_TOKEN_CHUNK`` and divides by it, the tokens
    run in chunks of that size, each with its own capacity, and aux is the
    mean of the chunks' (the JAX code's ``lax.map``). Decode calls this too,
    on [B, 1, d], as the JAX ``decode_step`` does.
    """
    B, S, d = x.shape
    T = B * S
    if T > MOE_TOKEN_CHUNK and T % MOE_TOKEN_CHUNK == 0:
        parts = [_moe_block(p, xi[None], cfg)
                 for xi in x.reshape(T // MOE_TOKEN_CHUNK, -1, d)]
        out = torch.cat([o for o, _ in parts]).reshape(B, S, d)
        return out, torch.stack([a for _, a in parts]).mean()
    return _moe_block(p, x, cfg)


def moe_route(p: MoEParams, xf: torch.Tensor, cfg: ArchConfig):
    """xf: [T, d] -> (probs [T, E] f32, top_w [T, K] f32, top_e [T, K]):
    router logits in f32, softmax, the top k by probability renormalised.
    With ``expert_split`` sp > 1, expert e becomes shards e*sp ..
    e*sp+sp-1, each with the token's weight (K = k * sp). A token's
    assignments come in ascending (shard) id, which changes no rank in
    ``moe_slots`` (ids are distinct within a token).

    The top k come from a stable descending sort, not ``torch.topk``:
    ``lax.top_k`` breaks ties toward the lower expert id, which a stable
    sort keeps, while ``torch.topk`` promises no order among equal values
    on CUDA. Ties need exactly equal probs, as a zero input row gives
    (uniform probs)."""
    m = cfg.moe
    T, sp = xf.shape[0], m.expert_split
    logits = torch.einsum("td,de->te", xf.float(), p.router)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :m.top_k], top_e[:, :m.top_k]
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
    if sp > 1:
        top_e = (top_e[..., None] * sp
                 + torch.arange(sp, device=xf.device)).reshape(T, -1)
        top_w = top_w[..., None].expand(T, m.top_k, sp).reshape(T, -1)
    top_e, perm = torch.sort(top_e, dim=-1)
    return probs, torch.gather(top_w, -1, perm), top_e


def moe_slots(top_e: torch.Tensor, n_experts: int, C: int):
    """Capacity slotting of the assignments ``top_e`` [T, K] (expert ids,
    ascending within each token) over ``n_experts`` experts (E) of C slots.

    Returns (counts [E], slot_tok [E*C], slot_valid [E*C], slot [T, K],
    kept [T, K]). An assignment's rank is its position among its expert's
    assignments in token order (the JAX code's stable argsort); ranks below
    C are kept, in slot e*C + rank. Each slot is read from the sorted
    assignments (a gather), so no slot is written twice.

    Pinned reference behaviour: the JAX code writes a dropped assignment to
    slot e*C and keeps the last of the duplicate writes (XLA on the CPU),
    so an expert with more than C assignments ends with slot e*C empty: its
    rank-0 token also loses that expert's output. This reproduces it.
    """
    T, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    ids = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(sorted_e, ids)
    counts = torch.searchsorted(sorted_e, ids, right=True) - starts
    over = counts > C
    r = torch.arange(C, device=dev)
    slot_valid = (r < counts[:, None]) & ((r > 0) | ~over[:, None])
    src = order[(starts[:, None] + r).clamp(max=T * K - 1)]
    slot_tok = torch.where(slot_valid, src // K, 0).reshape(-1)
    rank = (torch.argsort(order) - starts[flat_e]).reshape(T, K)
    kept = (rank < C) & ((rank > 0) | ~over[top_e])
    slot = top_e * C + rank.clamp(max=C - 1)
    return counts, slot_tok, slot_valid.reshape(-1), slot, kept


def moe_experts(p: MoEParams, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFNs on their slots: xe [E, C, d] -> [E, C, d]."""
    g = _act(act)(torch.bmm(xe, p.w1))
    u = torch.bmm(xe, p.w3)
    return torch.bmm(g * u, p.w2)


def _moe_block(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capacity block of tokens, in the JAX code's order of operations.

    The combine is a gather: each token adds its kept assignments from zero
    in ascending expert id, the order in which XLA's serial scatter-add on
    the CPU adds its slots, each product ``ye * w`` with w rounded to the
    model dtype first. So bf16 rounds as in JAX step by step, and the card
    gives one answer bitwise every time. The aux loss is Switch's, on the
    un-split router.
    """
    B, S, d = x.shape
    m = cfg.moe
    sp = m.expert_split
    T, E, K = B * S, m.n_experts * sp, m.top_k * sp
    C = moe_capacity(T, cfg)
    xf = x.reshape(T, d)
    probs, top_w, top_e = moe_route(p, xf, cfg)
    counts, slot_tok, slot_valid, slot, kept = moe_slots(top_e, E, C)

    xe = torch.where(slot_valid[:, None], xf[slot_tok], 0).reshape(E, C, d)
    ye = moe_experts(p, xe, cfg.act).reshape(E * C, d)
    w = top_w.to(ye.dtype)
    out = torch.zeros((T, d), dtype=ye.dtype, device=x.device)
    for j in range(K):
        out = out + torch.where(kept[:, j, None], ye[slot[:, j]] * w[:, j, None],
                                0)

    frac = counts.reshape(m.n_experts, sp).sum(-1).float() / (T * K)
    aux = m.n_experts * torch.sum(frac * probs.mean(dim=0))
    return out.reshape(B, S, d), aux


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
    (``scan_impl="kernel"``) or the plain loop (``"plain"``). Both
    differentiate: the kernel route through ``ops.SelectiveScan`` (its
    backward is one reverse-scan kernel launch, from the saved a and h),
    the plain one through autograd of the loop. JAX differentiates its XLA
    scans (``scan_impl="chunked"``), which the tests hold the gradients to.
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


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a mixer or FFN kind the port does not know (never run
    another path instead)."""
    for spec in cfg.block:
        if spec.mixer not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.ffn not in ("dense", "moe", "moe_dense", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
