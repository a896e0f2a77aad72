"""Plain PyTorch versions of the kernels (the allclose ground truth).

Same signatures as the wrappers in ``ops``: K/V at kv heads (q head ``h``
reads kv head ``h // (H // KV)``) and any sequence length. Flash attention's
backward is written out as well (``flash_attention_backward_ref``), from the
row log-sum-exp the forward saves (``flash_attention_lse_ref``). Scores are f32
and the full score matrix is built, as in ``repro.kernels.ref``. The scan is
a loop over the sequence; the fused scan (``selective_scan_fused_ref`` and
its written-out backward) the same loop a chunk of ``FUSED_CHUNK`` steps at
a time, with a, b and h.C built and taken per chunk. The tests use these, and ``ops`` uses them for
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
                         window: Optional[int] = None, offset: int = 0,
                         return_lse: bool = False):
    """q: [B,H,D]; k,v: [B,S,KV,D]; lengths: [B] -> [B,H,D] in q's dtype
    (and, with ``return_lse``, the row log-sum-exp [B,H] f32).

    Key j stands for position ``offset + j`` (a rank's range of a
    sequence-sharded cache). Keys are valid where ``kpos < length`` and,
    with a window, ``kpos >= length - window``. A slot with no valid key gets
    the uniform softmax over all S keys (every score is the same -1e30),
    and its lse is -1e30: ``ops.merge_attention_parts`` then weighs equal
    key ranges alike.
    """
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(D)
    sc = _softcap(sc, softcap)
    kpos = offset + torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", pr, v.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(sc, dim=-1).reshape(B, H)


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


# The fused scan's state interval: the kernels (``csrc/selective_scan_fused.cu``,
# kInterval) save the state entering every FUSED_CHUNK-th step for the
# backward, which walks each interval back from its state with one
# exponential an element; the plain versions walk the sequence in chunks of
# this many steps.
FUSED_CHUNK = 16


def fused_chunks(S: int) -> int:
    """Chunks of ``FUSED_CHUNK`` steps over a sequence of S (the last may be
    shorter): the states' second axis."""
    return -(-S // FUSED_CHUNK)


def _fused_chunk(u, dt, A, Bc, t0: int, t1: int):
    """a = exp(dt * A), w = dt * u and b = w * B of steps [t0, t1), rounded as
    JAX's ``expand`` rounds them (every product in f32): a, b [B,T,DI,DS],
    w [B,T,DI]."""
    dtc = dt[:, t0:t1]
    a = torch.exp(dtc[..., None] * A)
    w = dtc * u[:, t0:t1].float()
    b = w[..., None] * Bc[:, t0:t1].float()[:, :, None, :]
    return a, b, w


def selective_scan_fused_ref(u: torch.Tensor, dt: torch.Tensor,
                             A: torch.Tensor, Bc: torch.Tensor,
                             Cc: torch.Tensor, *, want_states: bool = False):
    """The Mamba recurrence with its inputs built and its read-out taken per
    chunk: ``h_t = a_t * h_{t-1} + b_t`` from h_{-1} = 0 with a_t = exp(dt_t
    A) and b_t = dt_t u_t B_t, and ``y_t = sum_n h_t[n] C_t[n]``.

    u: [B,S,DI] (f32 or bf16); dt: [B,S,DI] f32; A: [DI,DS] f32; Bc, Cc:
    [B,S,DS] in u's dtype -> y [B,S,DI] f32 (and, with ``want_states``, the
    state entering each chunk, [B, fused_chunks(S), DI, DS] f32, the first
    zeros). JAX's chunk body (``repro.models.layers.apply_mamba``) run one
    chunk of ``FUSED_CHUNK`` steps at a time, so no more than a [B, chunk,
    DI, DS] working set exists; the recurrence in each chunk is the plain
    loop (a rounded product, then a rounded sum). Differentiable by
    autograd (without ``want_states``).
    """
    B, S, DI = u.shape
    n = fused_chunks(S)
    y = u.new_empty((B, S, DI), dtype=torch.float32)
    h = u.new_zeros((B, DI, A.shape[1]), dtype=torch.float32)
    states = (u.new_empty((B, n, DI, A.shape[1]), dtype=torch.float32)
              if want_states else None)
    for c in range(n):
        t0, t1 = c * FUSED_CHUNK, min(S, (c + 1) * FUSED_CHUNK)
        if states is not None:
            states[:, c] = h
        a, b, _ = _fused_chunk(u, dt, A, Bc, t0, t1)
        hs = torch.empty_like(a)
        for t in range(t1 - t0):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
        y[:, t0:t1] = torch.einsum("btin,btn->bti", hs, Cc[:, t0:t1].float())
    return (y, states) if want_states else y


def selective_scan_fused_backward_ref(u: torch.Tensor, dt: torch.Tensor,
                                      A: torch.Tensor, Bc: torch.Tensor,
                                      Cc: torch.Tensor, states: torch.Tensor,
                                      dy: torch.Tensor):
    """The gradient of ``selective_scan_fused_ref`` written out: (du, ddt,
    dA, dB, dC) in the dtypes of u, dt, A, Bc, Cc, from the forward's inputs,
    its chunk states and dy [B,S,DI] f32.

    Each chunk, last first, is recomputed from its saved state (a, b and h),
    then walked backwards with g, the gradient reaching h_t: ``g_t = dy_t C_t
    + a_{t+1} g_{t+1}``; with ``dx = g_t h_{t-1} a_t`` (through a = exp(x),
    x = dt A) and w = dt u: ``ddt = sum_n dx A + u sum_n g B``, ``du = dt
    sum_n g B``, ``dA = sum_{b,t} dx dt`` (over t last to first, then over
    b in order), ``dB_t = sum_i g w``, ``dC_t = sum_i dy h_t``. The
    products and their order are the kernel's; only the sums over n and i
    may run in another order.
    """
    B, S, DI = u.shape
    DS = A.shape[1]
    f32 = dict(dtype=torch.float32)
    du, ddt = u.new_empty((B, S, DI), **f32), u.new_empty((B, S, DI), **f32)
    dB, dC = u.new_empty((B, S, DS), **f32), u.new_empty((B, S, DS), **f32)
    dA = u.new_zeros((B, DI, DS), **f32)
    g = u.new_zeros((B, DI, DS), **f32)
    a_next = torch.zeros_like(g)
    for c in range(fused_chunks(S) - 1, -1, -1):
        t0, t1 = c * FUSED_CHUNK, min(S, (c + 1) * FUSED_CHUNK)
        a, b, w = _fused_chunk(u, dt, A, Bc, t0, t1)
        hs = torch.empty_like(a)
        h = states[:, c]
        for t in range(t1 - t0):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
        Bf, Cf = Bc[:, t0:t1].float(), Cc[:, t0:t1].float()
        dtc, uc, dyc = dt[:, t0:t1], u[:, t0:t1].float(), dy[:, t0:t1]
        for t in range(t1 - t0 - 1, -1, -1):
            g = dyc[:, t, :, None] * Cf[:, t, None, :] + a_next * g
            dx = (g * (hs[:, t - 1] if t > 0 else states[:, c])) * a[:, t]
            dA = dA + dx * dtc[:, t, :, None]
            dw = (g * Bf[:, t, None, :]).sum(-1)
            ddt[:, t0 + t] = (dx * A).sum(-1) + dw * uc[:, t]
            du[:, t0 + t] = dw * dtc[:, t]
            dB[:, t0 + t] = (g * w[:, t, :, None]).sum(1)
            dC[:, t0 + t] = (dyc[:, t, :, None] * hs[:, t]).sum(1)
            a_next = a[:, t]
    dA_sum = dA[0]
    for i in range(1, B):
        dA_sum = dA_sum + dA[i]
    return (du.to(u.dtype), ddt, dA_sum, dB.to(Bc.dtype), dC.to(Cc.dtype))
