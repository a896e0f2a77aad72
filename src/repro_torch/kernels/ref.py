"""Plain PyTorch versions of the kernels (the allclose ground truth).

Same signatures as the wrappers in ``ops``: K/V at kv heads (q head ``h``
reads kv head ``h // (H // KV)``) and any sequence length. Scores are f32
and the full score matrix is built, as in ``repro.kernels.ref``. The tests
use these, and ``ops`` uses them for tensors on the CPU; on the card the
model only reaches them when ``Runtime(attn_impl="plain")`` asks for them.
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
