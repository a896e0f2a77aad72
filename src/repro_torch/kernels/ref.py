"""Plain PyTorch versions of the kernels (the allclose ground truth).

Same signatures as the wrappers in ``ops``: K/V at kv heads (q head ``h``
reads kv head ``h // (H // KV)``) and any sequence length. Flash attention's
backward is written out as well (``flash_attention_backward_ref``), from the
row log-sum-exp the forward saves (``flash_attention_lse_ref``). Scores are f32
and the full score matrix is built, as in ``repro.kernels.ref``. The scan is
a loop over the sequence. The tests use these, and ``ops`` uses them for
tensors on the CPU; on the card the model only reaches them when
``Runtime(attn_impl="plain")`` or ``Runtime(scan_impl="plain")`` asks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(sc: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return sc if softcap is None else softcap * torch.tanh(sc / softcap)


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
          device) -> Optional[torch.Tensor]:
    """Kept (q, k) pairs [Sq, Sk]: kpos <= qpos and, with a window,
    kpos > qpos - window; None when not causal (all kept)."""
    if not causal:
        return None
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, causal, window, softcap) -> torch.Tensor:
    """Masked f32 scores [B,KV,G,Sq,Sk] (G = H // KV), masked pairs -1e30."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, D)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    sc = _softcap(sc, softcap)
    mask = _mask(Sq, Sk, causal, window, q.device)
    return sc if mask is None else torch.where(mask, sc, NEG_INF)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype."""
    B, Sq, H, D = q.shape
    pr = torch.softmax(_scores(q, k, causal, window, softcap), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pr, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp of the masked scores, [B,H,Sq] f32: what the f32
    flash kernel writes beside its output for the backward."""
    B, Sq, H, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window, softcap), dim=-1)
    return lse.reshape(B, H, Sq)


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None):
    """The gradient of ``flash_attention_ref`` written out, as the backward
    kernel computes it: P = exp(s - lse) on kept pairs (0 elsewhere), delta =
    rowsum(dout * out), dS = P (dout V^T - delta) (1 - tanh^2) / sqrt(D).

    q, out, dout: [B,Sq,H,D]; k, v: [B,Sk,KV,D]; lse: [B,H,Sq] f32 ->
    (dq, dk, dv) in the dtypes of q, k, v; dk and dv sum the group's q heads.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, D)
    x = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if softcap is None:
        sc, chain = x, None
    else:
        t = torch.tanh(x / softcap)
        sc, chain = softcap * t, 1.0 - t * t
    p = torch.exp(sc - lse.float().reshape(B, KV, G, Sq, 1))
    mask = _mask(Sq, Sk, causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dog = dout.float().reshape(B, Sq, KV, G, D)
    delta = (dog * out.float().reshape(B, Sq, KV, G, D)).sum(-1)   # [B,Sq,KV,G]
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if chain is not None:
        ds = ds * chain
    ds = ds / math.sqrt(D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The most a bf16 attention output row may be off: bf16's unit roundoff is
# 2^-8 = 3.9e-3 (the output's rounding plus that of P before P.V), while a
# key tile of 128 dropped from 2048 moves a row by ~25%.
BF16_ROW_TOL = 1e-2


def row_error(got: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest error of a row of ``got`` (over the last axis) relative to
    that row of ``exact``: the measure a bf16 attention output is held to
    against the f32 result (``BF16_ROW_TOL``), since late causal rows, whose
    values are ~1/sqrt(keys), sit below any useful absolute tolerance."""
    diff = (got.float() - exact.float()).norm(dim=-1)
    return (diff / exact.float().norm(dim=-1).clamp_min(1e-30)).max().item()


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         softcap: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,D]; k,v: [B,S,KV,D]; lengths: [B] -> [B,H,D] in q's dtype.

    Keys are valid where ``kpos < length`` and, with a window,
    ``kpos >= length - window``. A slot with no valid key gets the uniform
    softmax over all S keys (every score is the same -1e30).
    """
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(D)
    sc = _softcap(sc, softcap)
    kpos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", pr, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor,
                       h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over axis 1.

    a, b: [B,S,DI,DS] f32; h0: [B,DI,DS] f32, zeros when None -> h
    [B,S,DI,DS] f32. One rounded product and one rounded sum per step, in
    order over t (no fused multiply-add).
    """
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def selective_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                                h0: Optional[torch.Tensor],
                                dh: torch.Tensor):
    """The gradient of ``selective_scan_ref`` written out as a reverse loop.

    a, h (the forward's output), dh: [B,S,DI,DS] f32; h0: [B,DI,DS] f32 or
    None -> (da, db [B,S,DI,DS], dh0 [B,DI,DS] or None). With g the gradient
    that reaches h_t, ``g_t = dh_t + a_{t+1} * g_{t+1}`` (g = dh_{S-1} at the
    end), ``db_t = g_t``, ``da_t = g_t * h_{t-1}`` (h_{-1} = h0, or zeros),
    ``dh0 = a_0 * g_0``. One rounded product and one rounded sum per step,
    in order over t: autograd through the forward loop rounds the same
    operations (up to the order of a commutative product or sum), so the
    bits are the same.
    """
    S = a.shape[1]
    hprev0 = torch.zeros_like(a[:, 0]) if h0 is None else h0
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = dh[:, S - 1]
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = dh[:, t] + a[:, t + 1] * g
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else hprev0)
    return da, db, None if h0 is None else a[:, 0] * g
