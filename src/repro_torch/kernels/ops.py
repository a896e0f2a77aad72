"""Public wrappers around the CUDA kernels.

Each wrapper checks what it is given and picks its path by the tensors'
device alone: a CPU tensor gets the plain version from ``ref``; a CUDA
tensor gets the kernel (for flash attention, the variant of its dtype and
head dim: ``flash_variant``; for the scan, the variant of its shape and
alignment: ``scan_variant``) or an exception. Nothing falls back from the
card to the plain version, nor from one kernel to another. Outputs and
scratch (the flash backward's delta, the split-f32 kernels' workspace of
hi/lo operand copies) are allocated here with ``torch.empty``, and the
kernels run on ``torch.cuda.current_stream()``.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reaches
the card, however many device kernels the call runs: a split-f32 flash
forward runs two, a flash backward three),
``SCAN_VARIANTS`` the scan's launches by variant (``scan_variant``);
``reset_launches()`` sets every count to 0.

Flash attention and the scan are differentiable: with grad on and an
operand that needs it, ``flash_attention`` goes through ``FlashAttention``
(a ``torch.autograd.Function``), whose forward saves the output and the row
log-sum-exp (the f32 kernels write it) and whose backward is the f32
backward kernel of the forward's variant (``flash_attention_backward``);
``selective_scan`` goes through ``SelectiveScan``, whose forward saves a, h
and h0 and whose backward is the reverse-scan kernel
(``selective_scan_backward``). On the CPU each Function takes the plain
versions of both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0,
            "decode_attention": 0, "selective_scan": 0,
            "selective_scan_backward": 0}
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


# How each wrapper's gradient is taken, for the message of a bare kernel call
# with grad.
_GRAD_ROUTE = {
    "flash_attention": "gradients of flash attention go through "
                       "ops.FlashAttention (the torch.autograd.Function that "
                       "ops.flash_attention applies)",
    "decode_attention": "decode attention is inference only",
    "selective_scan": "gradients of the selective scan go through "
                      "ops.SelectiveScan (the torch.autograd.Function that "
                      "ops.selective_scan applies)",
}


def _check_cuda_operands(name: str, *ts: torch.Tensor, align: int = 16) -> None:
    """What the kernels take beyond the plain versions: one CUDA device,
    contiguous operands aligned to ``align`` bytes, no grad (the message
    names the wrapper's own gradient route)."""
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: operands must be {align}-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        route = _GRAD_ROUTE[name.removesuffix("_backward")]
        raise NotImplementedError(
            f"{name}: a kernel call takes no grad; {route}")


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
    [B,Sk,KV,D]; lse: [B,H,Sq] f32 from the forward. f32 on the card, the
    backward of the forward's variant (``flash_variant``): split-f32 on the
    tensor cores (``csrc/flash_attention_f32tc.cu``: prep, dk/dv and dq
    launches) or the CUDA cores (``csrc/flash_attention_bwd.cu``: delta,
    dk/dv and dq); no atomics in either, the same bits on every call. The
    plain version on the CPU."""
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
    lib = build.load()
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse),
            _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv))
    args = (B, Sq, k.shape[1], H, k.shape[2], D, int(causal), int(window or 0),
            float(softcap or 0.0), _stream())
    if flash_variant(q.dtype, D) == "split_f32":
        work = _f32tc_workspace(q, k, backward=True)
        code = lib.repro_flash_attention_f32tc_bwd(*ptrs, _ptr(work), *args)
    else:
        code = lib.repro_flash_attention_bwd(*ptrs, *args)
    _raise_on(code, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv


SPLIT_F32_HEAD_DIMS = (32, 64, 128)


def flash_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernels that take flash attention in ``dtype`` at head dim
    ``head_dim``, chosen by shape before any launch (never a fallback):

    - bf16: "tensor_core", ``csrc/flash_attention_tc.cu`` (wgmma + TMA);
    - f32, D in ``SPLIT_F32_HEAD_DIMS``: "split_f32",
      ``csrc/flash_attention_f32tc.cu``, forward and backward on the tensor
      cores with split-f32 products (hi + lo tf32 parts, three wgmma a
      product): one TF32 product keeps 10 mantissa bits and misses the f32
      tolerance (2e-5), three of them meet it;
    - f32, other D (256): "cuda_core", ``csrc/flash_attention.cu`` and
      ``csrc/flash_attention_bwd.cu``, f32 FMAs."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "split_f32" if head_dim in SPLIT_F32_HEAD_DIMS else "cuda_core"
    raise ValueError(f"flash_attention: no kernel for {dtype}")


def _f32tc_workspace(q, k, *, backward: bool) -> torch.Tensor:
    """The split-f32 kernels' workspace (the hi/lo operand copies their prep
    launch writes), as many bytes as the C side asks for."""
    B, Sq, H, D = q.shape
    nbytes = build.load().repro_flash_f32tc_workspace(
        B, Sq, k.shape[1], H, k.shape[2], D, int(backward))
    return torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)


def _launch_flash_attention(q, k, v, out, lse, causal, window, softcap) -> None:
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = build.load()
    args = (B, Sq, Sk, H, KV, D, int(causal), int(window or 0),
            float(softcap or 0.0), _stream())
    variant = flash_variant(q.dtype, D)
    lse_p = ctypes.c_void_p(None) if lse is None else _ptr(lse)
    if variant == "tensor_core":
        code = lib.repro_flash_attention_tc(_ptr(q), _ptr(k), _ptr(v),
                                            _ptr(out), *args)
    elif variant == "split_f32":
        work = _f32tc_workspace(q, k, backward=False)
        code = lib.repro_flash_attention_f32tc(_ptr(q), _ptr(k), _ptr(v),
                                               _ptr(out), lse_p, _ptr(work),
                                               *args)
    else:
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


def _check_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor]) -> tuple:
    """The operands as a tuple, after the checks every device shares."""
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"selective_scan: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    ts = (a, b) if h0 is None else (a, b, h0)
    if h0 is not None and h0.shape != (a.shape[0],) + a.shape[2:]:
        raise ValueError(f"selective_scan: h0{tuple(h0.shape)} must be "
                         f"{(a.shape[0],) + tuple(a.shape[2:])}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("selective_scan: a, b and h0 must be float32")
    return ts


def selective_scan(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1. a, b: [B,S,DI,DS] f32;
    h0: [B,DI,DS] f32 (zeros when None) -> h [B,S,DI,DS] f32.

    Differentiable through ``SelectiveScan`` when grad is on and an operand
    needs it."""
    ts = _check_scan(a, b, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SelectiveScan.apply(a, b, h0)
    return selective_scan_forward(a, b, h0)


def selective_scan_forward(a: torch.Tensor, b: torch.Tensor,
                           h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan's forward kernel (of ``scan_variant``) on the card, the plain
    loop on the CPU, without autograd (a call with grad raises;
    ``SelectiveScan`` is the differentiable route)."""
    ts = _check_scan(a, b, h0)
    if a.device.type == "cpu":
        return ref.selective_scan_ref(a, b, h0)
    _check_cuda_operands("selective_scan", *ts, align=4)
    out = torch.empty_like(a)
    variant = scan_variant(a, b, h0)
    _launch_selective_scan(a, b, h0, out, variant)
    LAUNCHES["selective_scan"] += 1
    SCAN_VARIANTS[variant] += 1
    return out


class SelectiveScan(torch.autograd.Function):
    """The scan with its backward kernel: the forward saves a (the caller's
    tensor itself, no copy), its output h and h0; the backward runs the
    reverse scan (``selective_scan_backward``) from them."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = selective_scan_forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = selective_scan_backward(a, h, h0, dh.contiguous())
        return da, db, dh0 if ctx.needs_input_grad[2] else None


def selective_scan_backward(a: torch.Tensor, h: torch.Tensor,
                            h0: Optional[torch.Tensor], dh: torch.Tensor):
    """(da, db, dh0) of the scan. a, h (the forward's output), dh:
    [B,S,DI,DS] f32; h0: [B,DI,DS] f32 or None (then dh0 is None). On the
    card the reverse-scan kernel (``csrc/selective_scan.cu``, one kernel for
    every S: the S = 1 step variant has no backward), bit-identical to the
    plain reverse loop and the same bits on every call; that loop
    (``ref.selective_scan_backward_ref``) on the CPU."""
    ts = _check_scan(a, h, h0) + (dh,)
    if dh.shape != a.shape or dh.dtype != torch.float32:
        raise ValueError(f"selective_scan_backward: dh must be float32 of "
                         f"shape {tuple(a.shape)}")
    if a.device.type == "cpu":
        return ref.selective_scan_backward_ref(a, h, h0, dh)
    _check_cuda_operands("selective_scan_backward", *ts, align=4)
    B, S, DI, DS = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    none = ctypes.c_void_p(None)
    code = build.load().repro_selective_scan_bwd(
        _ptr(a), _ptr(h), none if h0 is None else _ptr(h0), _ptr(dh),
        _ptr(da), _ptr(db), none if dh0 is None else _ptr(dh0), B, S,
        DI * DS, _stream())
    _raise_on(code, "selective_scan_backward")
    LAUNCHES["selective_scan_backward"] += 1
    return da, db, dh0


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
