"""Plain PyTorch versions of the kernels (the allclose ground truth).

Same signatures as the wrappers in ``ops``: K/V at kv heads (q head ``h``
reads kv head ``h // (H // KV)``) and any sequence length. Scores are f32
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, D)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    sc = _softcap(sc, softcap)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        sc = torch.where(mask, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pr, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


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
