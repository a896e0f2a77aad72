"""Public wrappers around the CUDA kernels.

Each wrapper checks what it is given and picks its path by the tensors'
device alone: a CPU tensor gets the plain version from ``ref``; a CUDA
tensor gets the kernel (for flash attention, the variant of its dtype:
``flash_variant``) or an exception. Nothing falls back from the card to the
plain version, nor from one kernel to another. Outputs and scratch are
allocated here with ``torch.empty`` and the kernel runs on
``torch.cuda.current_stream()``.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reaches
the card); ``reset_launches()`` sets every count to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0, "decode_attention": 0, "selective_scan": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP = 16
_SMS = 132   # H100 SXM: the decode split aims for two blocks per SM


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_heads(H: int, KV: int) -> None:
    if KV <= 0 or H % KV != 0:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KV}")


def _check_attention_limits(name: str, H: int, KV: int, D: int) -> None:
    """Head dims and head groups the attention kernels are built for."""
    if H // KV > _MAX_GROUP:
        raise ValueError(f"{name}: head group {H // KV} > {_MAX_GROUP}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")


def _check_cuda_operands(name: str, *ts: torch.Tensor, align: int = 16) -> None:
    """What the kernels take beyond the plain versions: one CUDA device,
    contiguous operands aligned to ``align`` bytes, no grad."""
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: operands must be {align}-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; its backward arrives "
            "with the training slice")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


# ---------------------------------------------------------------------------
# flash attention (forward)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (kv heads) -> [B,Sq,H,D], q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v disagree on batch or dim")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of {list(_DTYPES)}")
    _check_heads(H, k.shape[2])
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    _check_attention_limits("flash_attention", H, k.shape[2], D)
    _check_cuda_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _launch_flash_attention(q, k, v, out, causal, window, softcap)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_variant(dtype: torch.dtype) -> str:
    """The CUDA kernel that takes flash attention in ``dtype``: bf16 runs on
    the tensor cores (``csrc/flash_attention_tc.cu``, wgmma + TMA); f32 stays
    on the CUDA cores (``csrc/flash_attention.cu``), since TF32 products
    cannot meet the f32 tolerance."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash_attention: no kernel for {dtype}")


def _launch_flash_attention(q, k, v, out, causal, window, softcap) -> None:
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = build.load()
    entry = (lib.repro_flash_attention_tc if flash_variant(q.dtype) == "tensor_core"
             else lib.repro_flash_attention)
    code = entry(_ptr(q), _ptr(k), _ptr(v), _ptr(out), B, Sq, Sk, H, KV, D,
                 int(causal), int(window or 0), float(softcap or 0.0), _stream())
    _raise_on(code, "flash_attention")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_splits(B: int, KV: int, S: int) -> int:
    """Pieces the key axis is cut into: enough blocks for two per SM, and at
    least 256 keys a piece."""
    want = -(-2 * _SMS // (B * KV))
    return max(1, min(want, -(-S // 256)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, softcap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,D]; k,v: [B,S,KV,D]; lengths: [B] int32 -> [B,H,D], q's dtype."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("decode_attention: q and k/v disagree on batch or dim")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("decode_attention: lengths must be int32 of shape [B]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of {list(_DTYPES)}")
    _check_heads(H, k.shape[2])
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths, softcap=softcap,
                                        window=window)
    _check_attention_limits("decode_attention", H, k.shape[2], D)
    _check_cuda_operands("decode_attention", q, k, v, lengths)
    out = torch.empty_like(q)
    _launch_decode_attention(q, k, v, lengths, out, window, softcap)
    LAUNCHES["decode_attention"] += 1
    return out


def _launch_decode_attention(q, k, v, lengths, out, window, softcap) -> None:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    lib = build.load()
    n_split = _decode_splits(B, KV, S)
    n_parts = n_split * lib.repro_decode_attention_warps()
    part_acc = torch.empty(B * H * n_parts * D, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * n_parts * 2, dtype=torch.float32,
                          device=q.device)
    code = lib.repro_decode_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(lengths), _ptr(out), _ptr(part_acc),
        _ptr(part_ml), B, S, H, KV, D, _DTYPES[q.dtype], int(window or 0),
        float(softcap or 0.0), n_split, _stream())
    _raise_on(code, "decode_attention")


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def selective_scan(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1. a, b: [B,S,DI,DS] f32;
    h0: [B,DI,DS] f32 (zeros when None) -> h [B,S,DI,DS] f32."""
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"selective_scan: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    ts = (a, b) if h0 is None else (a, b, h0)
    if h0 is not None and h0.shape != (a.shape[0],) + a.shape[2:]:
        raise ValueError(f"selective_scan: h0{tuple(h0.shape)} must be "
                         f"{(a.shape[0],) + tuple(a.shape[2:])}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("selective_scan: a, b and h0 must be float32")
    if a.device.type == "cpu":
        return ref.selective_scan_ref(a, b, h0)
    _check_cuda_operands("selective_scan", *ts, align=4)
    out = torch.empty_like(a)
    _launch_selective_scan(a, b, h0, out)
    LAUNCHES["selective_scan"] += 1
    return out


def _launch_selective_scan(a, b, h0, out) -> None:
    B, S, DI, DS = a.shape
    code = build.load().repro_selective_scan(
        _ptr(a), _ptr(b), ctypes.c_void_p(None) if h0 is None else _ptr(h0),
        _ptr(out), B, S, DI * DS, _stream())
    _raise_on(code, "selective_scan")
