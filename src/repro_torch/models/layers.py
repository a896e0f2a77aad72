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

Each parameter module carries ``AXES``, the logical axis names of its
leaves (the tuples of the JAX ``init_*`` functions), which
``model.logical_specs`` collects and ``repro_torch.parallel.sharding`` maps
to a mesh. Sharded runs go through the same functions: with a shard context
set (``set_shard_ctx``, by ``model.forward`` / ``decode_step`` from
``Runtime.shard_ctx()``) and DTensor operands, projections are DTensor
einsums on weights gathered on their FSDP dims (``gather_weight``), the
JAX package's ``with_sharding_constraint`` sites are ``_cs``
redistributes, and what DTensor has no rule for (RoPE, the kernels, the
embedding lookup, the Mamba conv and scan, MoE routing) runs on each rank's
local shards through ``local_map``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.kernels import ops, ref
from repro_torch.parallel.dtensor import (GatherRows, SumRows, all_gather,
                                          axes_size, block_index,
                                          gather_rows, is_dtensor, local_map,
                                          redistribute, sharded_on)

ATTN_IMPLS = ("kernel", "plain")
SCAN_IMPLS = ("kernel", "plain")

# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, scaled by ``1 + scale``, cast back to x's dtype. A
    DTensor x without grad (serving) is normalised on its local shard, one
    dispatch in place of ten; with grad it runs as DTensor ops, whose
    backward adds x's gradients in the unsharded path's order."""
    if is_dtensor(x) and not torch.is_grad_enabled():
        return local_map(lambda xl, sl: _rms_norm(xl, sl, eps), x.placements,
                         x, scale)
    return _rms_norm(x, scale, eps)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x: [..., S, H, D]; positions: [..., S].
    A DTensor x (and positions, plain or a DTensor) runs on its local shard."""
    if is_dtensor(x):
        return local_map(lambda xl, pl: _rope(xl, pl, theta), x.placements,
                         x, positions)
    return _rope(x, positions, theta)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activation-sharding context (the JAX package's ``set_shard_ctx`` /
# ``_cs``): set by ``model.forward`` / ``decode_step`` from
# ``Runtime.shard_ctx()`` plus the params' mesh, None otherwise. Tokens:
# "dp" -> the data axes, "tp" -> the tensor axis, None -> unsharded. The
# context's "ep" is read where the JAX code reads it, in the MoE block (the
# JAX ``_cs_ep`` has no caller, so the port has none).
# ---------------------------------------------------------------------------

_SHARD_CTX: Optional[dict] = None


def set_shard_ctx(ctx: Optional[dict]) -> None:
    global _SHARD_CTX
    _SHARD_CTX = ctx


def _resolve(axes) -> tuple:
    ctx = _SHARD_CTX
    return tuple(ctx["dp"] if a == "dp" else (ctx["tp"] if a == "tp" else None)
                 for a in axes)


def _cs(x, *axes):
    """Redistribute the DTensor ``x`` to the placements the tokens resolve to
    (``with_sharding_constraint``'s counterpart; a Partial sum is reduced
    here). A no-op without a context or for a tensor that is not a DTensor."""
    if _SHARD_CTX is None or not is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import placements
    return redistribute(x, placements(_resolve(axes), _SHARD_CTX["mesh"]))


def gather_weight(w):
    """A weight as the sharded path uses it: a DTensor all-gathered on every
    mesh dim but the tensor axis (FSDP's gather on use; autograd
    reduce-scatters its gradient back), its TP shard kept. Anything else,
    and everything without a context, as it is."""
    if _SHARD_CTX is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = list(w.device_mesh.mesh_dim_names)
    tp = _SHARD_CTX["tp"]
    return redistribute(w, [pl if names[i] == tp else Replicate()
                            for i, pl in enumerate(w.placements)])


def _tp_coord() -> Tuple[int, int]:
    """(this rank's index on the tensor axis, the axis' size); (0, 1) when
    the context has no tensor axis."""
    ctx = _SHARD_CTX
    if ctx is None or not ctx["tp"]:
        return 0, 1
    mesh = ctx["mesh"]
    return mesh.get_local_rank(ctx["tp"]), axes_size(mesh, (ctx["tp"],))


def _dp_axes() -> Tuple[str, ...]:
    dp = _SHARD_CTX["dp"] if _SHARD_CTX is not None else None
    return () if not dp else ((dp,) if isinstance(dp, str) else tuple(dp))


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
    AXES = {"wq": ("embed", "heads", "head"),
            "wk": ("embed", "kv_heads", "head"),
            "wv": ("embed", "kv_heads", "head"),
            "wo": ("heads", "head", "embed"),
            "q_norm": (None,), "k_norm": (None,)}

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


def _head_mask(out: torch.Tensor, cfg: ArchConfig, head_dim: int,
               h0: int = 0) -> torch.Tensor:
    """Zero the heads padded for tensor parallelism (heads on ``head_dim``;
    ``out``'s first head is head ``h0`` of the model). A DTensor is masked
    on its local heads (the rank's first head follows from its placement)."""
    if cfg.eff_heads == cfg.n_heads:
        return out
    if is_dtensor(out):
        split = sharded_on(out, head_dim, _SHARD_CTX["tp"])
        r = _tp_coord()[0] if split else 0
        return local_map(lambda o: _head_mask(o, cfg, head_dim,
                                              r * o.shape[head_dim]),
                         out.placements, out)
    h = out.shape[head_dim]
    keep = (h0 + torch.arange(h, device=out.device) < cfg.n_heads).to(out.dtype)
    shape = [1] * out.dim()
    shape[head_dim] = h
    return out * keep.view(shape)


def _kv_slice(H_l: int, h0: int, cfg: ArchConfig) -> Tuple[int, int]:
    """(first kv head, kv heads) that q heads [h0, h0 + H_l) read: q head h
    reads kv head h // (H / KV). The local heads must hold whole groups or
    lie within one group."""
    G = cfg.eff_heads // cfg.n_kv_heads
    if H_l % G == 0:
        return h0 // G, H_l // G
    if G % H_l == 0:
        return h0 // G, 1
    raise ValueError(f"{cfg.name}: {H_l} heads a rank and head group {G} "
                     "do not divide one another")


def _attend(q, k, v, attn_impl: str, kw: dict) -> torch.Tensor:
    if attn_impl == "kernel":
        return ops.flash_attention(q, k, v, **kw)
    if attn_impl == "plain":
        return ref.flash_attention_ref(q, k, v, **kw)
    raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")


def _flash_sharded(q, k, v, cfg: ArchConfig, attn_impl: str, kw: dict):
    """Flash attention on each rank's q heads (q sharded on heads over the
    tensor axis, K/V at all kv heads): the rank's kv heads are cut out of
    K/V, so the kernel runs unchanged on local tensors. K and V get Partial
    gradients over the tensor axis (each rank's covers its kv heads)."""
    r = _tp_coord()[0] if sharded_on(q, 2, _SHARD_CTX["tp"]) else 0

    def local(ql, kl, vl):
        h0 = r * ql.shape[2]
        kv0, nkv = _kv_slice(ql.shape[2], h0, cfg)
        out = _attend(ql, kl[:, :, kv0:kv0 + nkv].contiguous(),
                      vl[:, :, kv0:kv0 + nkv].contiguous(), attn_impl, kw)
        return _head_mask(out, cfg, head_dim=2, h0=h0)
    return local_map(local, q.placements, q, k, v)


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
    Sharded, q and the output are split on heads over "tp" and K/V kept
    whole (``_flash_sharded``).
    """
    xkv, k_pos = (x, positions) if kv_override is None else kv_override
    q = torch.einsum("bsd,dhk->bshk", x, gather_weight(p.wq))
    k = torch.einsum("bsd,dhk->bshk", xkv, gather_weight(p.wk))
    v = torch.einsum("bsd,dhk->bshk", xkv, gather_weight(p.wv))
    if spec.qk_norm:
        q = rms_norm(q, gather_weight(p.q_norm), cfg.norm_eps)
        k = rms_norm(k, gather_weight(p.k_norm), cfg.norm_eps)
    if causal or kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, k_pos, cfg.rope_theta)
    q = _cs(q, "dp", None, "tp", None)
    k, v = _cs(k, "dp", None, None, None), _cs(v, "dp", None, None, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kw = dict(causal=causal, window=spec.window, softcap=spec.softcap)
    if is_dtensor(q):
        out = _flash_sharded(q, k, v, cfg, attn_impl, kw)
    else:
        out = _head_mask(_attend(q, k, v, attn_impl, kw), cfg, head_dim=2)
    out = _cs(out, "dp", None, "tp", None)
    return torch.einsum("bshk,hkd->bsd", out, gather_weight(p.wo))


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """cache[b, pos[b] % S] = new[b, 0] for every slot b, in place. A
    sequence-sharded DTensor cache is written by the rank that holds that
    key (a select by ``torch.where``: no host sync)."""
    if not is_dtensor(cache):
        B, S = cache.shape[0], cache.shape[1]
        slots = torch.arange(B, device=cache.device)
        cache[slots, (pos % S).long()] = new[:, 0].to(cache.dtype)
        return
    S = cache.shape[1]
    cl, nl = cache.to_local(), new.to_local()
    pl = pos.to_local() if is_dtensor(pos) else pos
    tp = _SHARD_CTX["tp"]
    r = _tp_coord()[0] if sharded_on(cache, 1, tp) else 0
    S_l = cl.shape[1]
    at = (pl % S).long() - r * S_l
    own = (at >= 0) & (at < S_l)
    idx = at.clamp(0, S_l - 1)
    slots = torch.arange(cl.shape[0], device=cl.device)
    cl[slots, idx] = torch.where(own[:, None, None], nl[:, 0].to(cl.dtype),
                                 cl[slots, idx])


def _decode(q, k, v, lengths, attn_impl: str, kw: dict, offset: int = 0,
            want_lse: bool = False):
    if attn_impl == "kernel":
        return ops.decode_attention(q, k, v, lengths, offset=offset,
                                    return_lse=want_lse, **kw)
    if attn_impl == "plain":
        return ref.decode_attention_ref(q, k, v, lengths, offset=offset,
                                        return_lse=want_lse, **kw)
    raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")


def _decode_sharded(q, k, v, lengths, S: int, attn_impl: str, kw: dict):
    """Decode attention on a cache sequence-sharded over "tp": each rank runs
    the kernel on its key range (key offset ``rank * S_local``, with the row
    log-sum-exp), then the ranks' (o, lse) are all-gathered over the axis,
    never the cache, and merged (``ops.merge_attention_parts``). lengths
    None: every key valid (cross-attention)."""
    tp = _SHARD_CTX["tp"]
    seq = sharded_on(k, 1, tp)
    r = _tp_coord()[0] if seq else 0
    mesh = _SHARD_CTX["mesh"]

    def local(ql, kl, vl, ll):
        if ll is None:
            ll = torch.full((ql.shape[0],), S, dtype=torch.int32,
                            device=ql.device)
        o, lse = _decode(ql, kl, vl, ll, attn_impl, kw,
                         offset=r * kl.shape[1], want_lse=True)
        if seq:
            o = ops.merge_attention_parts(
                all_gather(o[None].float(), 0, mesh, (tp,)),
                all_gather(lse[None], 0, mesh, (tp,))).to(o.dtype)
        return o
    return local_map(local, q.placements, q, k, v, lengths)


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
    (exact when widening). Sharded, q is gathered to all heads (the JAX
    ``_cs(q, "dp", None, None, None)``) and the cache stays split on its
    sequence (``_decode_sharded``).
    """
    B, S = x.shape[0], cache_k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, gather_weight(p.wq))
    if spec.qk_norm:
        q = rms_norm(q, gather_weight(p.q_norm), cfg.norm_eps)
    lengths = None
    if not cross:
        k_new = torch.einsum("bsd,dhk->bshk", x, gather_weight(p.wk))
        v_new = torch.einsum("bsd,dhk->bshk", x, gather_weight(p.wv))
        if spec.qk_norm:
            k_new = rms_norm(k_new, gather_weight(p.k_norm), cfg.norm_eps)
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_new = rope(k_new, pos[:, None], cfg.rope_theta)
        _write_rows(cache_k, k_new, pos)
        _write_rows(cache_v, v_new, pos)
        lengths = (pos + 1).to(torch.int32)
    qd = _cs(q, "dp", None, None, None)[:, 0].to(cache_k.dtype).contiguous()
    kw = dict(window=None if cross else spec.window, softcap=spec.softcap)
    if is_dtensor(qd):
        out = _decode_sharded(qd, cache_k, cache_v, lengths, S, attn_impl, kw)
    else:
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        out = _decode(qd, cache_k, cache_v, lengths, attn_impl, kw)
    out = _head_mask(out, cfg, head_dim=1).to(x.dtype)[:, None]   # [B,1,h,dh]
    return (torch.einsum("bshk,hkd->bsd", out, gather_weight(p.wo)),
            cache_k, cache_v)


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------


class MLPParams(nn.Module):
    AXES = {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
            "w2": ("mlp", "embed")}

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
    g = _act(act)(_cs(torch.einsum("bsd,df->bsf", x, gather_weight(p.w1)),
                      "dp", None, "tp"))
    u = _cs(torch.einsum("bsd,df->bsf", x, gather_weight(p.w3)),
            "dp", None, "tp")
    return torch.einsum("bsf,fd->bsd", g * u, gather_weight(p.w2))


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity, sort-based slotting, gather dispatch and
# a gather combine (no scatter, no atomics, no host sync)
# ---------------------------------------------------------------------------


class MoEParams(nn.Module):
    """Leaves of one MoE FFN, in the JAX package's shapes: ``router`` [d, E]
    in f32 whatever the model's dtype; ``w1`` / ``w3`` [E*sp, d, f/sp] and
    ``w2`` [E*sp, f/sp, d], sp = ``expert_split``."""
    AXES = {"router": ("embed", None),
            "w1": ("expert", "embed", "expert_mlp"),
            "w3": ("expert", "embed", "expert_mlp"),
            "w2": ("expert", "expert_mlp", "embed")}

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


def _moe_chunk(T: int) -> int:
    """The tokens of one capacity block out of T: ``MOE_TOKEN_CHUNK`` when T
    exceeds it and divides by it, else all T."""
    return (MOE_TOKEN_CHUNK if T > MOE_TOKEN_CHUNK and T % MOE_TOKEN_CHUNK == 0
            else T)


def apply_moe(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss, f32 scalar).

    When T = B*S exceeds ``MOE_TOKEN_CHUNK`` and divides by it, the tokens
    run in chunks of that size, each with its own capacity, and aux is the
    mean of the chunks' (the JAX code's ``lax.map``). Decode calls this too,
    on [B, 1, d], as the JAX ``decode_step`` does. A DTensor x runs the
    same blocks sharded (``_moe_sharded``).
    """
    if is_dtensor(x):
        return _moe_sharded(p, x, cfg)
    B, S, d = x.shape
    T = B * S
    ch = _moe_chunk(T)
    if ch == T:
        return _moe_block(p, x, cfg)
    parts = [_moe_block(p, xi[None], cfg) for xi in x.reshape(T // ch, -1, d)]
    out = torch.cat([o for o, _ in parts]).reshape(B, S, d)
    return out, torch.stack([a for _, a in parts]).mean()


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
                 + torch.arange(sp, device=xf.device)).reshape(T, m.top_k * sp)
        top_w = top_w[..., None].expand(T, m.top_k, sp).reshape(
            T, m.top_k * sp)
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


def _moe_combine(ye: torch.Tensor, top_w: torch.Tensor, slot: torch.Tensor,
                 kept: torch.Tensor) -> torch.Tensor:
    """out[t] = sum_j (kept) ye[slot[t, j]] * w[t, j], from zero in
    ascending expert id, each product with w rounded to ye's dtype first."""
    w = top_w.to(ye.dtype)
    out = torch.zeros((slot.shape[0], ye.shape[1]), dtype=ye.dtype,
                      device=ye.device)
    for j in range(slot.shape[1]):
        out = out + torch.where(kept[:, j, None], ye[slot[:, j]] * w[:, j, None],
                                0)
    return out


def apply_moe_decode(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
                     ) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]: the MoE FFN for a few tokens with no
    capacity, each token through its own top k experts' weights gathered
    densely ([T, k, d, f]), as ``repro.models.layers.apply_moe_decode``
    (router in f32, the top k renormalised, ties toward the lower expert
    id; the expert ids index ``w1`` / ``w3`` / ``w2`` as they are, whatever
    ``expert_split``). Plain PyTorch. No path calls it: ``decode_step``
    calls ``apply_moe``, as the JAX package's does."""
    B, S, d = x.shape
    m = cfg.moe
    xf = x.reshape(B * S, d)
    probs = torch.softmax(torch.einsum("td,de->te", xf.float(), p.router), -1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :m.top_k], top_e[:, :m.top_k]
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
    g = _act(cfg.act)(torch.einsum("td,tkdf->tkf", xf, p.w1[top_e]))
    u = torch.einsum("td,tkdf->tkf", xf, p.w3[top_e])
    y = torch.einsum("tkf,tkfd->tkd", g * u, p.w2[top_e])
    out = torch.einsum("tkd,tk->td", y, top_w.to(y.dtype))
    return out.reshape(B, S, d)


class _MoEComm(NamedTuple):
    """How one capacity block is split over the ranks (``_moe_sharded``):
    this rank holds the block's tokens ``lo ..`` of ``n``, which the mesh
    axes ``dp`` split; it works on experts ``e0 ..`` (as many as its local
    weights hold) and on its share, block ``i_dp`` of ``n_dp``, of each
    expert's capacity; ``work`` are the mesh axes whose ranks hold other
    experts or other parts of each expert's FFN."""
    mesh: object
    lo: int
    n: int
    dp: Tuple[str, ...]
    work: Tuple[str, ...]
    e0: int
    i_dp: int
    n_dp: int


def _moe_block(p: MoEParams, x: torch.Tensor, cfg: ArchConfig,
               comm: Optional[_MoEComm] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capacity block of tokens, in the JAX code's order of operations.

    The combine is a gather: each token adds its kept assignments from zero
    in ascending expert id, the order in which XLA's serial scatter-add on
    the CPU adds its slots, each product ``ye * w`` with w rounded to the
    model dtype first. So bf16 rounds as in JAX step by step, and the card
    gives one answer bitwise every time. The aux loss is Switch's, on the
    un-split router.

    Sharded (``comm``; ``p`` holds local weights), x is this rank's part of
    the block: the ids, tokens and weights of the whole block are assembled
    (``gather_rows``), every rank slots the whole block as the unsharded
    block does, computes its own experts on its share of their slots, and
    combines them into partial sums for the whole block, which are added
    over the ranks and cut to this rank's tokens (``SumRows``). The aux
    loss is this rank's tokens' share. Unsharded, the gathers and the sum
    are identities and the share is all the experts and all the slots.
    """
    B, S, d = x.shape
    m = cfg.moe
    sp = m.expert_split
    T_l = B * S
    T = T_l if comm is None else comm.n
    E, K = m.n_experts * sp, m.top_k * sp
    C = moe_capacity(T, cfg)
    xf = x.reshape(T_l, d)
    probs, top_w, top_e = moe_route(p, xf, cfg)
    E_l, C_l, e0, c0 = E, C, 0, 0
    if comm is not None:
        top_e = gather_rows(top_e, comm.lo, T, comm.mesh, comm.dp)
        xf, top_w = (GatherRows.apply(t, comm.lo, T, comm.mesh, comm.dp,
                                      comm.work) for t in (xf, top_w))
        E_l, C_l = p.w1.shape[0], C // comm.n_dp
        e0, c0 = comm.e0, comm.i_dp * C_l
    counts, slot_tok, slot_valid, slot, kept = moe_slots(top_e, E, C)

    mine = (slice(e0, e0 + E_l), slice(c0, c0 + C_l))
    xe = torch.where(slot_valid.reshape(E, C)[mine][..., None],
                     xf[slot_tok.reshape(E, C)[mine]], 0)
    ye = moe_experts(p, xe, cfg.act).reshape(E_l * C_l, d)
    if comm is None:
        out = _moe_combine(ye, top_w, slot, kept)
    else:   # the assignments in this rank's slots, at their local rows
        e, c = slot // C, slot % C
        held = kept & (e >= e0) & (e < e0 + E_l) & (c >= c0) & (c < c0 + C_l)
        at = ((e - e0) * C_l + (c - c0)).clamp(0, E_l * C_l - 1)
        out = SumRows.apply(_moe_combine(ye, top_w, at, held), comm.lo, T_l,
                            comm.mesh, comm.dp + comm.work, comm.dp)

    frac = counts.reshape(m.n_experts, sp).sum(-1).float() / (T * K)
    share = probs.mean(dim=0)
    if comm is not None:   # this rank's tokens' part of the block's mean
        share = share * (T_l / T) if T_l else probs.new_zeros(probs.shape[1:])
    aux = m.n_experts * torch.sum(frac * share)
    return out.reshape(B, S, d), aux


def _moe_sharded(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe`` of x [B, S, d] split on B over the data axes: the same
    capacity blocks (``MOE_TOKEN_CHUNK`` tokens of the global order) with
    the same slots as unsharded, each run by every rank (``_moe_block``
    with a ``_MoEComm``), so no rank holds more than one block's tokens.

    The experts' layout is the context's "ep", as in the JAX code: whole
    experts on "tp" (EP) or each expert's FFN dim on "tp" (``expert_mlp``);
    weights laid out otherwise are redistributed to it (no data moves when
    ``sharding.make_rules`` laid them out so, as ``sharding.runtime``'s ep
    agrees with it). Each expert's capacity is split over the data axes
    (the JAX ``_cs(xe, .., "dp", ..)``). The aux loss comes back as a
    Partial sum over the data axes."""
    from torch.distributed.tensor import Partial, Replicate
    from types import SimpleNamespace
    ctx = _SHARD_CTX
    mesh, tp = ctx["mesh"], ctx["tp"]
    ep = bool(ctx.get("ep")) and bool(tp)
    m = cfg.moe
    E, f = m.n_experts * m.expert_split, p.w1.shape[2]
    r_tp, n_tp = _tp_coord()
    if (E if ep else f) % n_tp:
        raise ValueError(f"{cfg.name}: {'experts' if ep else 'expert FFN'} "
                         f"{E if ep else f} do not split over {n_tp} ranks")
    dp = tuple(a for a in _dp_axes() if sharded_on(x, 0, a))
    lay = ("tp", None, None) if ep else (None, None, "tp")
    router = gather_weight(p.router)
    w1, w3 = (_cs(w, *lay) for w in (p.w1, p.w3))
    w2 = _cs(p.w2, *(lay if ep else (None, "tp", None)))
    B, S, d = x.shape
    T = B * S
    ch = _moe_chunk(T)
    i_dp, n_dp = block_index(mesh, dp)
    C = moe_capacity(ch, cfg)
    if C % n_dp:
        raise ValueError(f"MoE capacity {C} does not split over {n_dp} ranks")
    work = (tp,) if tp else ()

    def local(xl, router_l, w1_l, w3_l, w2_l):
        T_l = xl.shape[0] * xl.shape[1]
        lo = i_dp * T_l
        xf = xl.reshape(T_l, d)
        pl = SimpleNamespace(router=router_l, w1=w1_l, w3=w3_l, w2=w2_l)
        outs, auxes = [], []
        for a in range(0, T, ch):
            s = max(a, lo)
            e = max(s, min(a + ch, lo + T_l))
            o, aux = _moe_block(pl, xf[s - lo:e - lo][None], cfg, _MoEComm(
                mesh, s - a, ch, dp, work, r_tp * w1_l.shape[0] if ep else 0,
                i_dp, n_dp))
            outs.append(o[0])
            auxes.append(aux)
        aux = auxes[0] if len(auxes) == 1 else torch.stack(auxes).mean()
        return torch.cat(outs).reshape(xl.shape), aux

    names = list(mesh.mesh_dim_names)
    partial = [Partial() if n in dp else Replicate() for n in names]
    return local_map(local, (x.placements, partial), x, router, w1, w3, w2,
                     grads={0: x.placements, 1: partial})


# ---------------------------------------------------------------------------
# Mamba-1 mixer (conv + selective scan)
# ---------------------------------------------------------------------------


class MambaParams(nn.Module):
    """Leaves of one Mamba mixer, in the JAX package's shapes. ``dt_bias``,
    ``A_log`` and ``D`` are f32 whatever the model's dtype, as in JAX."""
    AXES = {"in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
            "x_proj": ("inner", None), "dt_proj": (None, "inner"),
            "dt_bias": ("inner",), "A_log": ("inner", None),
            "D": ("inner",), "out_proj": ("inner", "embed")}

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


def _conv(u: torch.Tensor, conv_w: torch.Tensor,
          conv_state: Optional[torch.Tensor]):
    """Causal depthwise conv (the JAX code's shifted adds in order i =
    0..dc-1; no ``conv1d``: cuDNN would sum in another order, in TF32 by
    default) and silu. u: [B,S,di] -> (silu(conv) [B,S,di], new conv tail
    [B,dc-1,di] in u's dtype); the tail before u is ``conv_state`` or
    zeros."""
    dc, S = conv_w.shape[0], u.shape[1]
    if conv_state is None:
        pad = u.new_zeros((u.shape[0], dc - 1, u.shape[2]))
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                          # [B,S+dc-1,di]
    conv = up[:, 0:S] * conv_w[0]
    for i in range(1, dc):
        conv = conv + up[:, i:i + S] * conv_w[i]
    return F.silu(conv), up[:, up.shape[1] - (dc - 1):]


def _softplus(dt: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(dt, dt.new_zeros(()))   # as jax.nn.softplus


def _mamba_pre(p: MambaParams, x: torch.Tensor, cfg: ArchConfig,
               conv_state: Optional[torch.Tensor] = None):
    """In-projection, causal depthwise conv, silu, x/dt projections. x: [B,S,d].

    Returns (u [B,S,di] after conv and silu, z gate [B,S,di], dt [B,S,di]
    f32, Bc [B,S,ds], Cc [B,S,ds], new conv tail [B,dc-1,di] in u's dtype).
    Sharded, u, z, dt and the tail are split on d_inner over "tp" (the
    conv runs on local channels), Bc and Cc are whole.
    """
    di, ds, dr = cfg.d_inner, cfg.mamba.d_state, cfg.dt_rank
    xz = _cs(torch.einsum("bsd,de->bse", x, gather_weight(p.in_proj)),
             "dp", None, "tp")
    u, z = xz.split(di, dim=-1)
    u, z = _cs(u, "dp", None, "tp"), _cs(z, "dp", None, "tp")
    conv_w = gather_weight(p.conv_w)
    if is_dtensor(u):
        u, new_tail = local_map(_conv, (u.placements, u.placements), u,
                                conv_w, conv_state)
    else:
        u, new_tail = _conv(u, conv_w, conv_state)
    dt, Bc, Cc = torch.einsum("bsi,ie->bse", u, gather_weight(p.x_proj)
                              ).split([dr, ds, ds], dim=-1)
    dt = torch.einsum("bsr,ri->bsi", dt, gather_weight(p.dt_proj)).float() \
        + gather_weight(p.dt_bias)
    dt = (local_map(_softplus, dt.placements, dt) if is_dtensor(dt)
          else _softplus(dt))
    return (u, z, dt, _cs(Bc, "dp", None, None), _cs(Cc, "dp", None, None),
            new_tail)


def _scan_inputs(A_log, u, dt, Bc):
    """a = exp(dt * A) and b = dt * u * B, both [B,S,di,ds] f32."""
    A = -torch.exp(A_log)                                    # [di,ds]
    a = (dt[..., None] * A).exp_()
    b = (dt * u.float())[..., None] * Bc.float()[:, :, None, :]
    return a, b


def _scan(a, b, h0, scan_impl: str):
    if scan_impl == "kernel":
        return ops.selective_scan(a, b, h0)
    if scan_impl == "plain":
        return ref.selective_scan_ref(a, b, h0)
    raise ValueError(f"scan_impl {scan_impl!r} not in {SCAN_IMPLS}")


def _gate(y, u, z, D, dtype) -> torch.Tensor:
    """y + u * D, gated by silu(z) in f32, cast to ``dtype``."""
    y = y + u.float() * D
    return (y * F.silu(z.float())).to(dtype)


# JAX's chunk of its default Mamba branch (``repro.models.layers.MAMBA_CHUNK``)
MAMBA_CHUNK = 256


def chunked(S: int) -> bool:
    """Whether a sequence of S takes the fused route: JAX's rule for its
    chunked branch, S > MAMBA_CHUNK and S % MAMBA_CHUNK == 0."""
    return S > MAMBA_CHUNK and S % MAMBA_CHUNK == 0


def _mamba_y(A_log, D, u, z, dt, Bc, Cc, scan_impl: str, dtype):
    """The recurrence and its read-out on [B,S,di] channels: the gated y
    before the out-projection. Where ``chunked(S)``, the fused scan (a, b
    and h.C inside it); else a and b built at [B,S,di,ds] and scanned, then
    contracted with C (they live only in here)."""
    if chunked(u.shape[1]):
        A = -torch.exp(A_log)
        if scan_impl == "kernel":
            y = ops.selective_scan_fused(u, dt, A, Bc, Cc)
        elif scan_impl == "plain":
            y = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc)
        else:
            raise ValueError(f"scan_impl {scan_impl!r} not in {SCAN_IMPLS}")
        return _gate(y, u, z, D, dtype)
    a, b = _scan_inputs(A_log, u, dt, Bc)
    h = _scan(a, b, None, scan_impl)
    del a, b
    y = torch.einsum("bsin,bsn->bsi", h, Cc.float())
    return _gate(y, u, z, D, dtype)


def apply_mamba(p: MambaParams, x: torch.Tensor, cfg: ArchConfig, *,
                scan_impl: str = "kernel") -> torch.Tensor:
    """Full-sequence Mamba mixer. x: [B,S,d] -> [B,S,d].

    JAX's branch rule (``chunked``): a sequence of S > 256 with S % 256 == 0
    takes JAX's default chunked branch, here the fused scan: a and b built,
    the recurrence run and y = h.C taken inside one kernel launch
    (``ops.selective_scan_fused``, ``csrc/selective_scan_fused.cu``; its
    plain chunked loop with ``scan_impl="plain"``), so no [B,S,di,ds]
    tensor exists. Any other S takes the counterpart of JAX's associative
    branch: a and b built at [B,S,di,ds] in f32, the recurrence in one
    scan-kernel launch (``ops.selective_scan``; the plain loop with
    "plain"), then the h.C einsum. Both differentiate: the kernel routes
    through ``ops.SelectiveScanFused`` (its backward recomputes each chunk
    from the state saved at its start) and ``ops.SelectiveScan`` (one
    reverse-scan launch from the saved a and h), the plain ones through
    autograd of the loops. JAX differentiates its XLA scans, which the
    tests hold the gradients to. Sharded, the recurrence runs on each
    rank's d_inner channels (the JAX ``_cs(a/b, "dp", None, "tp", None)``).
    """
    u, z, dt, Bc, Cc, _ = _mamba_pre(p, x, cfg)
    args = (gather_weight(p.A_log), gather_weight(p.D), u, z, dt, Bc, Cc)
    if is_dtensor(u):
        y = local_map(lambda *a: _mamba_y(*a, scan_impl, x.dtype),
                      u.placements, *args)
    else:
        y = _mamba_y(*args, scan_impl, x.dtype)
    return torch.einsum("...i,id->...d", y, gather_weight(p.out_proj))


def _mamba_step(A_log, D, u, z, dt, Bc, Cc, ssm_state, scan_impl: str,
                dtype):
    """One recurrence step from ``ssm_state`` [B,di,ds], written back in
    place; returns the gated y [B,di]."""
    a, b = _scan_inputs(A_log, u, dt, Bc)                    # [B,1,di,ds]
    h = _scan(a, b, ssm_state, scan_impl)[:, 0]              # [B,di,ds]
    ssm_state.copy_(h)
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0].float())
    return _gate(y, u[:, 0], z[:, 0], D, dtype)


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
    step of the scan kernel with ``h0 = ssm_state``. Sharded (states split
    on d_inner over "tp"), each rank steps its own channels.
    """
    u, z, dt, Bc, Cc, new_tail = _mamba_pre(p, x, cfg, conv_state=conv_state)
    args = (gather_weight(p.A_log), gather_weight(p.D), u, z, dt, Bc, Cc,
            ssm_state)
    if is_dtensor(u):
        y = local_map(lambda *a: _mamba_step(*a, scan_impl, x.dtype),
                      u[:, 0].placements, *args)
        conv_state.to_local().copy_(new_tail.to_local())
    else:
        y = _mamba_step(*args, scan_impl, x.dtype)
        conv_state.copy_(new_tail)
    out = torch.einsum("...i,id->...d", y, gather_weight(p.out_proj))
    return out[:, None, :], conv_state, ssm_state


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a mixer or FFN kind the port does not know (never run
    another path instead)."""
    for spec in cfg.block:
        if spec.mixer not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.ffn not in ("dense", "moe", "moe_dense", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
