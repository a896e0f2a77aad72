"""Public wrappers around the CUDA kernels.

Each wrapper checks what it is given and picks its path by the tensors'
device alone: a CPU tensor gets the plain version from ``ref``; a CUDA
tensor gets the kernel (for flash attention, the variant of its dtype:
``flash_variant``; for the scan, the variant of its shape and alignment:
``scan_variant``) or an exception. Nothing falls back from the card to the
plain version, nor from one kernel to another. Outputs (and the flash
backward's one scratch buffer, delta) are allocated here with
``torch.empty``, and the kernel runs on ``torch.cuda.current_stream()``.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reaches
the card; a flash backward call runs three kernels and counts one),
``SCAN_VARIANTS`` the scan's launches by variant (``scan_variant``);
``reset_launches()`` sets every count to 0.

Flash attention is differentiable: with grad on and an operand that needs
it, ``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``), whose forward saves the output and the row
log-sum-exp (the f32 kernel writes it) and whose backward is the kernel of
``csrc/flash_attention_bwd.cu`` (``flash_attention_backward``). On the CPU
the Function takes the plain versions of both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0,
            "decode_attention": 0, "selective_scan": 0}
SCAN_VARIANTS = {"step": 0, "sequential": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP = 16
MAX_CLUSTER = 8   # the portable thread block cluster size


def reset_launches() -> None:
    for counts in (LAUNCHES, SCAN_VARIANTS):
        for name in counts:
            counts[name] = 0


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (132 on an H100
    SXM, 114 on an H100 PCIe), read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
            f"{name}: a bare kernel call takes no grad; gradients of flash "
            "attention go through ops.FlashAttention (the "
            "torch.autograd.Function that ops.flash_attention applies)")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


# ---------------------------------------------------------------------------
# flash attention (forward and backward)
# ---------------------------------------------------------------------------


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (kv heads) -> [B,Sq,H,D], q's dtype.

    Differentiable through ``FlashAttention`` when grad is on and an operand
    needs it (f32 only: the backward kernel is f32)."""
    _check_flash(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return flash_attention_forward(q, k, v, causal, window, softcap,
                                   want_lse=False)[0]


def flash_attention_forward(q, k, v, causal, window, softcap, *,
                            want_lse: bool):
    """(out, lse or None): the forward kernel on the card, the plain version
    on the CPU, without autograd (a call with grad raises; ``FlashAttention``
    is the differentiable route). lse [B,H,Sq] f32, the row log-sum-exp the
    backward reads, comes from the f32 kernel only."""
    B, Sq, H, D = q.shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, **kw)
        return out, ref.flash_attention_lse_ref(q, k, **kw) if want_lse else None
    _check_attention_limits("flash_attention", H, k.shape[2], D)
    _check_cuda_operands("flash_attention", q, k, v)
    if want_lse and q.dtype != torch.float32:
        raise NotImplementedError(
            "flash_attention: the backward kernel is f32 only; the bf16 "
            "(tensor-core) backward is a later slice")
    out = torch.empty_like(q)
    lse = q.new_empty((B, H, Sq), dtype=torch.float32) if want_lse else None
    _launch_flash_attention(q, k, v, out, lse, causal, window, softcap)
    LAUNCHES["flash_attention"] += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernel: the forward saves q, k, v,
    the output and the row log-sum-exp; the backward recomputes the scores
    from them (``flash_attention_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_forward(q, k, v, causal, window,
                                           softcap, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             softcap: Optional[float] = None):
    """(dq, dk, dv) of flash attention. q, out, dout: [B,Sq,H,D]; k, v:
    [B,Sk,KV,D]; lse: [B,H,Sq] f32 from the forward. f32 on the card (the
    kernel of ``csrc/flash_attention_bwd.cu``: three launches, no atomics,
    the same bits on every call); the plain version on the CPU."""
    _check_flash(q, k, v)
    B, Sq, H, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_backward: out and dout must have "
                         f"q's shape {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be f32 of "
                         f"shape {(B, H, Sq)}")
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    if q.dtype != torch.float32 or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise NotImplementedError(
            "flash_attention_backward: the kernel is f32 only; the bf16 "
            "(tensor-core) backward is a later slice")
    _check_attention_limits("flash_attention_backward", H, k.shape[2], D)
    _check_cuda_operands("flash_attention_backward", q, k, v, out, lse, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    code = build.load().repro_flash_attention_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse),
        _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), B, Sq, k.shape[1], H,
        k.shape[2], D, int(causal), int(window or 0), float(softcap or 0.0),
        _stream())
    _raise_on(code, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv


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


def _launch_flash_attention(q, k, v, out, lse, causal, window, softcap) -> None:
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = build.load()
    args = (B, Sq, Sk, H, KV, D, int(causal), int(window or 0),
            float(softcap or 0.0), _stream())
    if flash_variant(q.dtype) == "tensor_core":
        code = lib.repro_flash_attention_tc(_ptr(q), _ptr(k), _ptr(v),
                                            _ptr(out), *args)
    else:
        lse_p = ctypes.c_void_p(None) if lse is None else _ptr(lse)
        code = lib.repro_flash_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                         lse_p, *args)
    _raise_on(code, "flash_attention")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def decode_grid(B: int, KV: int, S: int, sms: int) -> int:
    """n_split, the cluster size of the decode kernel: one cluster of n_split
    blocks per (kv head, slot), grid (n_split, KV, B) (built by the C entry).
    n_split aims for two blocks per SM and at least 256 keys of S a block,
    within the portable cluster size; the lengths are never read here (that
    would sync)."""
    want = -(-2 * sms // (B * KV))
    return max(1, min(want, -(-S // 256), MAX_CLUSTER))


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
    n_split = decode_grid(B, KV, S, sm_count(q.device.index))
    code = build.load().repro_decode_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(lengths), _ptr(out), B, S, H, KV, D,
        _DTYPES[q.dtype], int(window or 0), float(softcap or 0.0), n_split,
        _stream())
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
    variant = scan_variant(a, b, h0)
    _launch_selective_scan(a, b, h0, out, variant)
    LAUNCHES["selective_scan"] += 1
    SCAN_VARIANTS[variant] += 1
    return out


def scan_variant(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> str:
    """The scan kernel that takes these operands: "step" (one decode step,
    a float4 per thread) when S == 1, F % 4 == 0 and every operand is
    16-byte aligned; else "sequential" (a thread per f, the t loop in it)."""
    ts = (a, b) if h0 is None else (a, b, h0)
    if (a.shape[1] == 1 and (a.shape[2] * a.shape[3]) % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in ts)):
        return "step"
    return "sequential"


def _launch_selective_scan(a, b, h0, out, variant: str) -> None:
    B, S, DI, DS = a.shape
    lib = build.load()
    h0p = ctypes.c_void_p(None) if h0 is None else _ptr(h0)
    if variant == "step":   # out is a fresh allocation: 16-byte aligned too
        code = lib.repro_selective_scan_step(
            _ptr(a), _ptr(b), h0p, _ptr(out), a.numel(),
            sm_count(a.device.index), _stream())
    else:
        code = lib.repro_selective_scan(_ptr(a), _ptr(b), h0p, _ptr(out), B,
                                        S, DI * DS, _stream())
    _raise_on(code, "selective_scan")
