"""Public wrappers around the CUDA kernels.

Each wrapper checks what it is given and picks its path by the tensors'
device alone: a CPU tensor gets the plain version from ``ref``; a CUDA
tensor gets the kernel (for flash attention, the variant of its dtype and
head dim: ``flash_variant``; for the scan, the variant of its shape and alignment:
``scan_variant``) or an exception. Nothing falls back from the
card to the plain version, nor from one kernel to another. Outputs and
scratch (the flash backward's delta, the split-f32 kernels' workspace of
hi/lo operand copies) are allocated here with ``torch.empty``, and the
kernels run on ``torch.cuda.current_stream()``.

A ``meta`` tensor (the dry-run's trace, ``repro_torch.launch.dryrun``)
gets a shape-only route: the outputs the kernel route allocates, as
``meta`` tensors, and nothing computed; the call is handed to ``COST_HOOK``
(when set) with the work the card's kernel does (``_meta_call``). It takes
the kernel route's checks, so the trace fails where the card would.

The attention kernels are built for head dims 32, 64, 128, 192 and 256
(``HEAD_DIMS``). Any other head dim up to 256 runs the instance of the next
of those (``built_head_dim``), chosen before any launch: its operands get
zero columns up to that width, which add nothing to a score, and its
outputs are cut back to the true width; the kernels scale the scores by
1 / sqrt of the true head dim. Above 256 every head dim runs too, rounded
up to a multiple of ``WIDE_ALIGN`` (64): decode on the decode kernel's wide
instance; flash attention up to 1024 on the split-f32 kernels with a tile's
head dim over a cluster of N ranks (``flash_variant`` "cluster", at
``CLUSTER_WIDTHS``: ``flash_built_head_dim`` takes 704, 832 and 960 to the
next of them), above 1024 on CUDA-core kernels (``flash_variant``
"cuda_core", ``csrc/flash_attention_wide.cu``). The split-f32 flash
kernels (up to 256 and on the cluster route) pad in their prep launch,
which copies every operand anyway, and write their outputs at the true
width; the bf16 flash pair, the CUDA-core route and decode take operands
padded here (``_pad_head``, a copy on the device, none where the head dim
is already a built width) and give outputs sliced here. Every head group
runs (decode takes a group above 16, and every head dim above 256, on its
group route: ``decode_plan``); among the shapes only ``H % KV != 0`` and
decode at a head dim above 16384 (``GROUP_ACC_FLOATS``: a head's
accumulators fill a block's budget) raise.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reaches
the card, however many device kernels the call runs: a split-f32 flash
forward runs two, a flash backward three in either dtype, the fused scan's
backward two),
``SCAN_VARIANTS`` the scan's launches by variant (``scan_variant``),
``FLASH_VARIANTS`` the flash launches by (wrapper, ``flash_variant``),
``BUILT_WIDTHS`` the attention launches by (wrapper, head dim, built head
dim), ``DECODE_ROUTES`` the decode launches by ``decode_plan`` route;
``reset_launches()`` sets every count to 0.

Flash attention and the scan are differentiable: with grad on and an
operand that needs it, ``flash_attention`` goes through ``FlashAttention``
(a ``torch.autograd.Function``), whose forward saves the output and the row
log-sum-exp (the forward kernels write it) and whose backward is the
backward kernel of the forward's variant (``flash_attention_backward``);
``selective_scan`` goes through ``SelectiveScan``, whose forward saves a, h
and h0 and whose backward is the reverse-scan kernel
(``selective_scan_backward``); ``selective_scan_fused`` (the Mamba scan
with a and b built and h.C taken in the kernel: JAX's chunked branch) goes
through ``SelectiveScanFused``, whose forward saves its operands and the
state entering each chunk and whose backward recomputes each chunk from it
(``selective_scan_fused_backward``). On the CPU each Function takes the
plain versions of both.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0,
            "decode_attention": 0, "selective_scan": 0,
            "selective_scan_backward": 0, "selective_scan_fused": 0,
            "selective_scan_fused_backward": 0}
SCAN_VARIANTS = {"step": 0, "sequential": 0}
# flash launches by (wrapper, flash_variant)
FLASH_VARIANTS: collections.Counter = collections.Counter()
# launches of the attention wrappers by (wrapper, head dim, built head dim)
BUILT_WIDTHS: collections.Counter = collections.Counter()
# decode launches by route ("narrow", "group": ``decode_plan``)
DECODE_ROUTES: collections.Counter = collections.Counter()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)   # the attention kernels' instances
WIDE_ALIGN = 64   # above 256, head dims are built at a multiple of this
MAX_CLUSTER = 8   # the portable thread block cluster size
# flash's cluster route: head dims N x DH, DH in (128, 96, 64), N <= 8
CLUSTER_WIDTHS = tuple(D for D in range(HEAD_DIMS[-1] + WIDE_ALIGN, 1025,
                                        WIDE_ALIGN)
                       if any(D % dh == 0 and D // dh <= MAX_CLUSTER
                              for dh in (128, 96, 64)))


# The dry-run's cost hook: None, or a callable that every call on ``meta``
# operands reaches as COST_HOOK(name, flops, rate, read, written): the
# wrapper's name, the arithmetic of its products (0 for the scan), the
# units that do them ("bf16": bf16 tensor cores; "tf32x3": the split-f32
# kernels' three TF32 products for each f32 one; "tf32": one TF32 product,
# the cluster route's in bf16; "f32": CUDA cores), and the bytes its
# operands and outputs take (each read or written once; never the scores).
# The arithmetic is what the card's kernels do (``attention_work``: on
# flash's CUDA-core route the scores once per column slice).
COST_HOOK = None


def reset_launches() -> None:
    for counts in (LAUNCHES, SCAN_VARIANTS):
        for name in counts:
            counts[name] = 0
    BUILT_WIDTHS.clear()
    FLASH_VARIANTS.clear()
    DECODE_ROUTES.clear()


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (132 on an H100
    SXM, 114 on an H100 PCIe), read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_heads(H: int, KV: int) -> None:
    if KV <= 0 or H % KV != 0:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KV}")


def built_head_dim(dtype: torch.dtype, head_dim: int) -> int:
    """The head dim of the attention kernel instance that takes ``head_dim``
    in ``dtype`` on the card: ``head_dim`` itself where it is one of
    ``HEAD_DIMS``, else the smallest of them above it; above 256 (decode's
    group route) ``head_dim`` rounded up to a multiple of ``WIDE_ALIGN``.
    The operands are padded with zero columns up to it. The same in f32 and
    bf16; decode's width, and flash's except where ``flash_built_head_dim``
    says otherwise; a head dim below 1 raises, and decode raises above
    16384 (``group_plan``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"attention: no kernel for {dtype}")
    if head_dim < 1:
        raise ValueError(f"attention: head dim {head_dim} below 1")
    if head_dim > HEAD_DIMS[-1]:
        return -(-head_dim // WIDE_ALIGN) * WIDE_ALIGN
    return next(d for d in HEAD_DIMS if d >= head_dim)


def flash_built_head_dim(dtype: torch.dtype, head_dim: int) -> int:
    """The head dim of the flash kernel instance that takes ``head_dim`` in
    ``dtype`` on the card: ``built_head_dim``'s, except that from 257 to
    1024 (the cluster route) it is the smallest of ``CLUSTER_WIDTHS`` at or
    above that: 704 runs at 768, 832 at 896 and 960 at 1024 (no cluster of
    at most 8 ranks of 64, 96 or 128 columns takes them)."""
    built = built_head_dim(dtype, head_dim)
    if HEAD_DIMS[-1] < built <= CLUSTER_WIDTHS[-1]:
        return next(d for d in CLUSTER_WIDTHS if d >= built)
    return built


def _built(name: str, D: int, dtype: torch.dtype) -> int:
    """``built_head_dim`` (``flash_built_head_dim`` for the flash wrappers)
    with the wrapper's name in its message."""
    rule = built_head_dim if name == "decode_attention" else flash_built_head_dim
    try:
        return rule(dtype, D)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


# the column slices of flash's CUDA-core route
WIDE_FLASH_SLICE = 128


def attention_work(name: str, Db: int) -> int:
    """Flops the card's kernels spend on a kept (query, key) pair and q head
    (decode: a key and q head) at built head dim Db: 4 Db (two products)
    forward and in decode at every width, 10 Db (five) backward, each score
    computed once, flash's cluster route (Db 320 to 1024) included. Above
    1024 flash's CUDA-core route cuts the head dim into column slices (n of
    them) and recomputes the scores once per slice: forward (2 n + 2) Db (S
    per slice, then P V), backward (8 n + 6) Db (dk/dv: S and dP per slice,
    then dV and dK; dq: S and dP per slice, then dQ)."""
    backward = name == "flash_attention_backward"
    if name == "decode_attention" or Db <= CLUSTER_WIDTHS[-1]:
        return (10 if backward else 4) * Db
    n = -(-Db // WIDE_FLASH_SLICE)
    return ((8 * n + 6) if backward else (2 * n + 2)) * Db


def _pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """t [..., D] with zero columns up to ``width`` (t itself at D = width):
    a new contiguous tensor on t's device."""
    D = t.shape[-1]
    return t if D == width else torch.nn.functional.pad(t, (0, width - D))


def _cut_head(t: torch.Tensor, D: int) -> torch.Tensor:
    """The first D columns of a padded output, contiguous (t itself when it
    has D)."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


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
    "selective_scan_fused": "gradients of the fused scan go through "
                            "ops.SelectiveScanFused (the "
                            "torch.autograd.Function that "
                            "ops.selective_scan_fused applies)",
}


def _check_cuda_operands(name: str, *ts: torch.Tensor, align: int = 16,
                         rows: tuple = ()) -> None:
    """What the kernels take beyond the plain versions: one CUDA device,
    contiguous operands aligned to ``align`` bytes (``rows``: operands that
    need only a unit stride over their last axis), no grad (the message
    names the wrapper's own gradient route). The shape-only route takes
    the same on ``meta`` operands, which have no address to align."""
    for t in ts + rows:
        if t.device.type not in ("cuda", "meta") or t.device != ts[0].device:
            raise ValueError(f"{name}: all operands must be on one CUDA device")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % align:
            raise ValueError(f"{name}: operands must be {align}-byte aligned")
    if any(t.stride(-1) != 1 for t in rows):
        raise ValueError(f"{name}: Bc and Cc need unit stride over their "
                         f"last axis")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts + rows):
        route = _GRAD_ROUTE[name.removesuffix("_backward")]
        raise NotImplementedError(
            f"{name}: a kernel call takes no grad; {route}")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _meta_call(name: str, flops: float, rate: str, reads, writes) -> None:
    """Hand one shape-only call to ``COST_HOOK``."""
    if COST_HOOK is not None:
        COST_HOOK(name, float(flops), rate, _nbytes(*reads), _nbytes(*writes))


@functools.cache
def kept_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the flash kernels compute: all Sq * Sk, or
    causal key <= query (positions from 0 on both sides) and, with a
    window, key > query - window."""
    if not causal:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, min(Sk, i + 1) - lo)
    return total


def flash_rate(dtype: torch.dtype, head_dim: int) -> str:
    """The units the flash kernels of ``dtype`` at ``head_dim`` multiply
    on: "bf16" (the bf16 pair), "tf32x3" (split-f32: f32 up to 1024), "tf32"
    (one TF32 product: bf16 on the cluster route), "f32" (CUDA cores: the
    CUDA-core route above 1024, in both dtypes)."""
    variant = flash_variant(dtype, head_dim)
    if variant == "cuda_core":
        return "f32"
    if variant == "tensor_core":
        return "bf16"
    return "tf32" if dtype == torch.bfloat16 else "tf32x3"


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
    needs it (bf16 and f32: each variant has its backward kernel)."""
    _check_flash(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return flash_attention_forward(q, k, v, causal, window, softcap,
                                   want_lse=False)[0]


def flash_attention_forward(q, k, v, causal, window, softcap, *,
                            want_lse: bool):
    """(out, lse or None): the forward kernel on the card, the plain version
    on the CPU, without autograd (a call with grad raises; ``FlashAttention``
    is the differentiable route). lse [B,H,Sq] f32 is the row log-sum-exp the
    backward reads; the output is the same bits with it or without."""
    B, Sq, H, D = q.shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, **kw)
        return out, ref.flash_attention_lse_ref(q, k, **kw) if want_lse else None
    Db = _built("flash_attention", D, q.dtype)
    _check_cuda_operands("flash_attention", q, k, v)
    lse = q.new_empty((B, H, Sq), dtype=torch.float32) if want_lse else None
    if q.device.type == "meta":   # the work of the built width (attention_work)
        padded = [_pad_head(t, Db) for t in (q, k, v)]
        _meta_call("flash_attention", attention_work("flash_attention", Db)
                   * B * H * kept_pairs(Sq, k.shape[1], causal, window),
                   flash_rate(q.dtype, D), padded, (padded[0], lse))
        return torch.empty_like(q), lse
    out = _launch_flash_attention(q, k, v, Db, lse, causal, window, softcap)
    LAUNCHES["flash_attention"] += 1
    FLASH_VARIANTS["flash_attention", flash_variant(q.dtype, D)] += 1
    BUILT_WIDTHS["flash_attention", D, Db] += 1
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
    [B,Sk,KV,D], all of one dtype; lse: [B,H,Sq] f32 from the forward. On
    the card the backward of the forward's variant (``flash_variant``): bf16
    ``csrc/flash_attention_tc_bwd.cu`` (delta, dk/dv and dq launches on the
    tensor cores), f32 ``csrc/flash_attention_f32tc.cu`` (prep, dk/dv and
    dq), from head dim 257 to 1024 ``csrc/flash_attention_f32tc_cluster.cu``
    (prep, dk/dv and dq, either dtype), above 1024
    ``csrc/flash_attention_wide.cu`` (dk/dv and dq, either dtype); none has
    atomics, so every call gives the same bits. The plain version on the
    CPU."""
    _check_flash(q, k, v)
    B, Sq, H, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_backward: out and dout must have "
                         f"q's shape {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be f32 of "
                         f"shape {(B, H, Sq)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: out and dout must be "
                         f"{q.dtype}, as q")
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    Db = _built("flash_attention_backward", D, q.dtype)
    ts = (q, k, v, out, lse, dout)
    _check_cuda_operands("flash_attention_backward", *ts)
    variant = flash_variant(q.dtype, D)
    if q.device.type == "meta":   # the work of the built width (attention_work)
        padded = [_pad_head(t, Db) for t in (q, k, v, out, dout)]
        _meta_call("flash_attention_backward",
                   attention_work("flash_attention_backward", Db)
                   * B * H * kept_pairs(Sq, k.shape[1], causal, window),
                   flash_rate(q.dtype, D), padded + [lse], padded[:3])
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = build.load()
    args = (B, Sq, k.shape[1], H, k.shape[2], D, Db, int(causal),
            int(window or 0), float(softcap or 0.0), _stream())
    if variant in ("cuda_core", "tensor_core"):   # padded to Db, cut back
        padded = [_pad_head(t, Db) for t in (q, k, v, out, dout)]
        grads = [torch.empty_like(t) for t in padded[:3]]
        if variant == "cuda_core":
            code = lib.repro_flash_attention_wide_bwd(
                *map(_ptr, padded), _ptr(lse), *map(_ptr, grads), *args[:7],
                _DTYPES[q.dtype], *args[7:])
        else:
            delta = torch.empty_like(lse)
            code = lib.repro_flash_attention_tc_bwd(
                *map(_ptr, padded), _ptr(lse), _ptr(delta), *map(_ptr, grads),
                *args)
        grads = [_cut_head(t, D) for t in grads]
    else:   # split-f32 and cluster: the prep launch pads, grads written at D
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        work = _f32tc_workspace(q, k, Db, backward=True)
        ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse),
                _ptr(delta), *map(_ptr, grads), _ptr(work))
        if variant == "cluster":
            code = lib.repro_flash_attention_cluster_bwd(
                *ptrs, *args[:7], _DTYPES[q.dtype], *args[7:])
        else:
            code = lib.repro_flash_attention_f32tc_bwd(*ptrs, *args)
    _raise_on(code, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    FLASH_VARIANTS["flash_attention_backward", variant] += 1
    BUILT_WIDTHS["flash_attention_backward", D, Db] += 1
    return tuple(grads)


def flash_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernels that take flash attention in ``dtype`` at head dim
    ``head_dim`` (the instance of ``flash_built_head_dim``), chosen by dtype
    and head dim before any launch (never a fallback):

    - bf16: "tensor_core", ``csrc/flash_attention_tc.cu`` (wgmma + TMA; the
      forward, ``flash_fwd_tc_kernel``) and ``csrc/flash_attention_tc_bwd.cu``
      (its backward: ``flash_bwd_tc_delta_kernel``, ``flash_bwd_tc_dkdv_kernel``
      and ``flash_bwd_tc_dq_kernel``; two warpgroups a block, each owning 64
      of its 128 rows, or splitting the products of its 64 rows: dk/dv from
      D = 128, dq from D = 192);
    - f32: "split_f32", ``csrc/flash_attention_f32tc.cu``, forward and
      backward on the tensor cores with split-f32 products (hi + lo tf32
      parts, three wgmma a product): one TF32 product keeps 10 mantissa bits
      and misses the f32 tolerance (2e-5), three of them meet it. At D = 192
      and 256 a tile takes a cluster of two blocks, one per half of the head
      dim;
    - from head dim 257 to 1024, either dtype: "cluster",
      ``csrc/flash_attention_f32tc_cluster.cu`` (the kernels of
      ``csrc/flash_attention_f32tc.cuh``: ``flash_f32tc_fwd_cluster_kernel``;
      its backward ``flash_f32tc_dkdv_cluster_kernel`` and
      ``flash_f32tc_dq_cluster_kernel``): a tile's head dim over a cluster
      of N ranks of 64, 96 or 128 columns that sum their partial scores in
      rank order, so each score is computed once; split-f32 products in
      f32, one TF32 product in bf16 (exact on bf16 operands);
    - above 1024, either dtype: "cuda_core", ``csrc/flash_attention_wide.cu``
      (``flash_wide_fwd_kernel``; its backward ``flash_wide_dkdv_kernel`` and
      ``flash_wide_dq_kernel``): f32 products on the CUDA cores, one block
      per (64 rows, head, slice of 128 output columns), the scores over the
      whole head dim recomputed by each slice."""
    built = _built("flash_attention", head_dim, dtype)
    if built > CLUSTER_WIDTHS[-1]:
        return "cuda_core"
    if built > HEAD_DIMS[-1]:
        return "cluster"
    return "tensor_core" if dtype == torch.bfloat16 else "split_f32"


def _f32tc_workspace(q, k, Db: int, *, backward: bool) -> torch.Tensor:
    """The split-f32 kernels' workspace (the hi/lo operand copies their prep
    launch writes, at the built head dim Db; on the cluster route in bf16
    the hi copies alone), as many bytes as the C side asks for."""
    B, Sq, H, _ = q.shape
    lib = build.load()
    shape = (B, Sq, k.shape[1], H, k.shape[2], Db)
    if Db > HEAD_DIMS[-1]:
        nbytes = lib.repro_flash_cluster_workspace(*shape, _DTYPES[q.dtype],
                                                   int(backward))
    else:
        nbytes = lib.repro_flash_f32tc_workspace(*shape, int(backward))
    return torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)


def _launch_flash_attention(q, k, v, Db, lse, causal, window,
                            softcap) -> torch.Tensor:
    """The forward kernel of q's dtype at built head dim Db; returns the
    output [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = build.load()
    args = (B, Sq, Sk, H, KV, D, Db, int(causal), int(window or 0),
            float(softcap or 0.0), _stream())
    lse_p = ctypes.c_void_p(None) if lse is None else _ptr(lse)
    variant = flash_variant(q.dtype, D)
    if variant in ("cuda_core", "tensor_core"):   # padded to Db, cut back
        qp, kp, vp = (_pad_head(t, Db) for t in (q, k, v))
        out = torch.empty_like(qp)
        ptrs = (_ptr(qp), _ptr(kp), _ptr(vp), _ptr(out), lse_p)
        if variant == "cuda_core":
            code = lib.repro_flash_attention_wide(*ptrs, *args[:7],
                                                  _DTYPES[q.dtype], *args[7:])
        else:
            code = lib.repro_flash_attention_tc(*ptrs, *args)
        out = _cut_head(out, D)
    else:   # split-f32 and cluster: the prep launch pads; o is written at D
        out = torch.empty_like(q)
        work = _f32tc_workspace(q, k, Db, backward=False)
        ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), lse_p, _ptr(work))
        if variant == "cluster":
            code = lib.repro_flash_attention_cluster(
                *ptrs, *args[:7], _DTYPES[q.dtype], *args[7:])
        else:
            code = lib.repro_flash_attention_f32tc(*ptrs, *args)
    _raise_on(code, "flash_attention")
    return out


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


# The group route's sizes (``csrc/decode_attention.cu``, kGroup*): threads a
# block; a chunk's f32 accumulators (heads x D) at most; the ring's panels,
# a score's column groups and a block's shared memory at most, and what
# two blocks an SM leave; the panel's bytes the tile's keys aim for; a
# panel's columns; a cluster's blocks at most (``kGroupMaxCluster``; clusters
# of 4 and of up to 16 were measured slower over a full cache: ``PERF.md``
# §6, PR 32); blocks wanted per SM; keys of S a block at least.
GROUP_THREADS = 256
GROUP_ACC_FLOATS = 16384
GROUP_STAGES = 5          # panels of the ring
GROUP_MAX_CS = 16         # column groups of a score at most
GROUP_MAX_SMEM = 232448   # a block's shared memory at most (227 KB)
GROUP_TWO_SMEM = 115712   # two blocks an SM (228 KB less 1 KB a block)
GROUP_PANEL_BYTES = 16384
GROUP_PANEL_COLS = 256
GROUP_CLUSTER = 2
GROUP_BLOCKS_PER_SM = 2
GROUP_MIN_KEYS = 128


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one decode call runs on the card (``decode_plan``)."""
    route: str        # "narrow" (decode_attention_kernel) or "group"
    head_chunk: int   # query heads a block takes (the whole group: narrow)
    chunks: int       # chunks of a group, on grid y
    cluster: int      # blocks a cluster
    clusters: int     # clusters per (slot, kv head, chunk): > 1 merges twice
    tile_keys: int    # group route: keys a tile (TK); 0 on the narrow one
    panel_cols: int   # group route: columns a ring panel (DC); 0 narrow

    @property
    def pieces(self) -> int:
        """Blocks per (slot, kv head, chunk): the key range's pieces."""
        return self.cluster * self.clusters


def _group_units(Gc: int) -> int:
    """Heads a thread of the group kernel takes at once (HU)."""
    return 1 if Gc <= 2 else 4


def group_smem(Gc: int, D: int, tk: int, cols: int, cluster: int,
               el: int) -> int:
    """Dynamic shared memory of a group-route block, for the plan: a copy of
    ``GroupLayout`` in ``csrc/decode_attention.cu``, which owns it (the
    launch takes ``repro_decode_group_smem``'s bytes; the tests on the card
    hold the two equal). q (as stored) and acc (f32) of the chunk's Gc
    heads padded to whole thread tiles, the tile's scores and the column
    groups' partials (at least a partial a thread: row mode's), m, l and
    alpha, the inbox of ``cluster`` - 1 records (acc, m, l) that rank 0 of a
    cluster receives, and the ring of ``GROUP_STAGES`` panels of tk rows
    (cols elements of el bytes and 16 of pad)."""
    hu = _group_units(Gc)
    gp = -(-Gc // hu) * hu
    tiles = gp // hu * (tk // 4)
    cs = 1
    while (cs * 2 * tiles <= GROUP_THREADS and cs * 2 <= GROUP_MAX_CS
           and cs * 2 <= cols // 4):
        cs *= 2
    up4 = lambda n: -(-n // 4) * 4   # noqa: E731
    floats = (gp * (D * el + 16) // 4 + up4(gp * D) + up4(tk * gp)
              + max(up4(cs * tk * gp), GROUP_THREADS) + 3 * up4(gp)
              + (cluster - 1) * up4(gp * (D + 2)))
    return 4 * floats + GROUP_STAGES * tk * (cols * el + 16)


def decode_plan(B: int, H: int, KV: int, S: int, D: int, sms: int,
                dtype: torch.dtype = torch.float32) -> DecodePlan:
    """The decode launch for q [B,H,D] and a cache [B,S,KV,D] at built head
    dim D in ``dtype`` on a card of ``sms`` SMs, from shapes alone (the
    lengths are never read: that would sync), handed to the C entry as it
    is: a group up to 16 at D <= 256 on the narrow kernel, one cluster of
    ``decode_grid`` blocks per (slot, kv head); any other on the group route
    (``group_plan``)."""
    _check_heads(H, KV)
    G = H // KV
    if G <= 16 and D <= HEAD_DIMS[-1]:
        return DecodePlan("narrow", G, 1, decode_grid(B, KV, S, sms), 1, 0, 0)
    return group_plan(B, H, KV, S, D, sms, dtype)


def group_plan(B: int, H: int, KV: int, S: int, D: int, sms: int,
               dtype: torch.dtype = torch.float32) -> DecodePlan:
    """The group route's launch (any group; D a multiple of 32 up to
    ``GROUP_ACC_FLOATS``, 16384, else ValueError): the group in chunks only
    where its accumulators exceed ``GROUP_ACC_FLOATS`` (Gc D <= 16384,
    balanced chunks); panels of min(D, ``GROUP_PANEL_COLS``) columns and TK
    keys (64 down to 4: within ``GROUP_PANEL_BYTES``, one score tile of up
    to 4 heads x 4 keys a thread and a block's shared memory); clusters of
    ``GROUP_CLUSTER`` blocks, fewer where rank 0's inbox of the others'
    records would not fit two blocks an SM (``GROUP_TWO_SMEM``, where one
    block fits that); the key range of each (slot, kv head, chunk) cut into
    pieces, a block each, for ``GROUP_BLOCKS_PER_SM`` blocks an SM in one
    wave and at least ``GROUP_MIN_KEYS`` keys of S a block, in whole
    clusters, and never fewer than one cluster's blocks (a cache of at
    most a cluster's ``GROUP_MIN_KEYS`` keys takes one cluster, no second
    merge). The kernel gives each piece at least a tile of keys, so a short
    valid range takes the first pieces only (and where those lie in cluster
    0 the second merge has nothing to do)."""
    _check_heads(H, KV)
    if D % 32 or not 0 < D <= GROUP_ACC_FLOATS:
        raise ValueError(f"decode_attention: built head dim {D} is not a "
                         f"multiple of 32 up to {GROUP_ACC_FLOATS}")
    G = H // KV
    cols = min(D, GROUP_PANEL_COLS)
    el = torch.empty((), dtype=dtype).element_size()
    chunks = -(-G // (GROUP_ACC_FLOATS // D))
    while True:   # more chunks only where a block's shared memory overflows
        Gc = -(-G // chunks)
        chunks = -(-G // Gc)                     # none of them empty
        heads = -(-Gc // _group_units(Gc))      # score tiles of a key group
        tk = 64
        while tk > 4 and (tk * cols * el > GROUP_PANEL_BYTES
                          or heads * tk // 4 > GROUP_THREADS
                          or group_smem(Gc, D, tk, cols, 1, el)
                          > GROUP_MAX_SMEM):
            tk //= 2
        if group_smem(Gc, D, tk, cols, 1, el) <= GROUP_MAX_SMEM:
            break
        if Gc == 1:
            raise ValueError(f"decode_attention: head dim {D} does not fit "
                             f"a block")
        chunks += 1
    # a cluster as large as rank 0's inbox (its other ranks' records)
    # lets: within two blocks an SM where one block fits that, else one
    limit = (GROUP_TWO_SMEM if group_smem(Gc, D, tk, cols, 1, el)
             <= GROUP_TWO_SMEM else GROUP_MAX_SMEM)
    cap = max(n for n in range(1, GROUP_CLUSTER + 1)
              if group_smem(Gc, D, tk, cols, n, el) <= limit)
    want = GROUP_BLOCKS_PER_SM * sms // (B * KV * chunks)   # one wave
    pieces = max(1, min(want, max(cap, -(-S // GROUP_MIN_KEYS))))
    if pieces > cap:
        pieces -= pieces % cap   # whole clusters
    clusters = -(-pieces // cap)
    return DecodePlan("group", Gc, chunks, -(-pieces // clusters), clusters,
                      tk, cols)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, softcap: Optional[float] = None,
                     window: Optional[int] = None, offset: int = 0,
                     return_lse: bool = False):
    """q: [B,H,D]; k,v: [B,S,KV,D]; lengths: [B] int32 -> [B,H,D], q's dtype.

    ``offset``: key j is position ``offset + j`` (a rank's key range of a
    sequence-sharded cache; the lengths stay global). ``return_lse``: also
    the row log-sum-exp [B,H] f32 (-1e30 for a row with no valid key), for
    ``merge_attention_parts``; the output is the same bits either way."""
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
    if offset < 0:
        raise ValueError(f"decode_attention: offset {offset} < 0")
    _check_heads(H, k.shape[2])
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths, softcap=softcap,
                                        window=window, offset=offset,
                                        return_lse=return_lse)
    Db = _built("decode_attention", D, q.dtype)
    _check_cuda_operands("decode_attention", q, k, v, lengths)
    lse = (q.new_empty((B, H), dtype=torch.float32) if return_lse else None)
    if q.device.type == "meta":   # the whole cache's keys, at the built width
        decode_plan(B, H, k.shape[2], k.shape[1], Db, 1, q.dtype)   # its checks
        padded = [_pad_head(t, Db) for t in (q, k, v)]
        _meta_call("decode_attention",
                   attention_work("decode_attention", Db) * B * H * k.shape[1],
                   "f32",
                   padded + [lengths], (padded[0], lse))
        out = torch.empty_like(q)
        return (out, lse) if return_lse else out
    out = _launch_decode_attention(q, k, v, lengths, Db, lse, offset, window,
                                   softcap)
    LAUNCHES["decode_attention"] += 1
    BUILT_WIDTHS["decode_attention", D, Db] += 1
    return (out, lse) if return_lse else out


def _launch_decode_attention(q, k, v, lengths, Db, lse, offset, window,
                             softcap) -> torch.Tensor:
    """The decode launch of ``decode_plan`` at built head dim Db (q, k, v
    padded to it here): the narrow kernel, or the group route with its
    scratch of the clusters' records when it has several clusters per
    (slot, kv head, chunk). Returns the output [B, H, D]."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    plan = decode_plan(B, H, KV, S, Db, sm_count(q.device.index), q.dtype)
    qp, kp, vp = (_pad_head(t, Db) for t in (q, k, v))
    out = torch.empty_like(qp)
    none = ctypes.c_void_p(None)
    ptrs = (_ptr(qp), _ptr(kp), _ptr(vp), _ptr(lengths), _ptr(out),
            none if lse is None else _ptr(lse))
    args = (S, H, KV, D, Db, _DTYPES[q.dtype], int(offset), int(window or 0),
            float(softcap or 0.0))
    lib = build.load()
    if plan.route == "narrow":
        code = lib.repro_decode_attention(*ptrs, B, *args, plan.cluster,
                                          _stream())
    else:
        # the C side owns the record's layout (its floats: group_rec)
        part = (torch.empty(B * KV * plan.chunks * plan.clusters
                            * lib.repro_decode_group_record(plan.head_chunk,
                                                            Db),
                            dtype=torch.float32, device=q.device)
                if plan.clusters > 1 else None)
        code = lib.repro_decode_group(
            *ptrs, none if part is None else _ptr(part), B, *args,
            plan.head_chunk, plan.chunks, plan.cluster, plan.clusters,
            plan.tile_keys, plan.panel_cols, _stream())
    _raise_on(code, "decode_attention")
    DECODE_ROUTES[plan.route] += 1
    return _cut_head(out, D)


def merge_attention_parts(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Softmax attention over several key ranges merged from each range's
    result: o [n, B, H, D] (each range's normalised output), lse [n, B, H]
    f32 -> [B, H, D] f32: ``sum_r w_r o_r / sum_r w_r`` with ``w_r =
    exp(lse_r - max lse)``, in range order. A range with no valid key
    (lse -1e30) weighs 0 beside one that has; when no range has one, all
    weigh 1 and the result is the mean of the ranges' uniform means: the
    uniform mean over all keys, for ranges of equal size. One range gives
    its o back exactly (w = 1). Plain PyTorch, on either device."""
    w = torch.exp(lse - lse.max(dim=0).values)
    return (w[..., None] * o.float()).sum(0) / w.sum(0)[..., None]


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
    if a.device.type == "meta":   # no product: its bytes only
        _meta_call("selective_scan", 0, "f32", ts, (out,))
        return out
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
    if a.device.type == "meta":
        _meta_call("selective_scan_backward", 0, "f32", ts, (da, db, dh0))
        return da, db, dh0
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


# ---------------------------------------------------------------------------
# the fused selective scan (a and b built, h.C taken, in the kernel)
# ---------------------------------------------------------------------------

FUSED_THREADS = 256   # a block of the fused kernels (kThreads)
# the kernels' f32 operations a state element (b, t, i, n), the exponential
# counted as one: forward a = exp(dt A), b = (dt u) B, h = a h + b, y += h C
# (7); backward pass A and pass B's recompute (5 each, pass A over 3/4 of
# the steps), g, dx, dA, the two sums over n and the two over the channels
# (16)
FUSED_FLOPS = {"selective_scan_fused": 7, "selective_scan_fused_backward": 25}


def fused_lanes(DS: int) -> int:
    """Lanes the fused kernels give one channel: DS rounded up to 8, 16 or
    32 (a lane a state element); DS outside 1..32 raises."""
    for lanes in (8, 16, 32):
        if 1 <= DS <= lanes:
            return lanes
    raise ValueError(f"selective_scan_fused: d_state {DS} not in 1..32")


def fused_blocks(DI: int, DS: int) -> int:
    """The fused kernels' channel blocks (``FUSED_THREADS`` / lanes channels
    each): the first axis of the backward's partials of dB and dC."""
    return -(-DI // (FUSED_THREADS // fused_lanes(DS)))


def _check_fused(u, dt, A, Bc, Cc) -> tuple:
    """(B, S, DI, DS) after the checks every device shares."""
    if u.dim() != 3 or dt.shape != u.shape or A.dim() != 2 \
            or A.shape[0] != u.shape[2] or Bc.dim() != 3 \
            or Bc.shape != Cc.shape or Bc.shape[:2] != u.shape[:2] \
            or Bc.shape[2] != A.shape[1]:
        raise ValueError(
            f"selective_scan_fused: bad shapes u{tuple(u.shape)} "
            f"dt{tuple(dt.shape)} A{tuple(A.shape)} Bc{tuple(Bc.shape)} "
            f"Cc{tuple(Cc.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("selective_scan_fused: dt and A must be float32")
    if not (u.dtype == Bc.dtype == Cc.dtype) or u.dtype not in _DTYPES:
        raise ValueError(f"selective_scan_fused: u, Bc, Cc dtypes {u.dtype}/"
                         f"{Bc.dtype}/{Cc.dtype}; need one of {list(_DTYPES)}")
    B, S, DI = u.shape
    fused_lanes(A.shape[1])
    return B, S, DI, A.shape[1]


def selective_scan_fused(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """The Mamba recurrence with its inputs built and its read-out taken in
    the kernel: ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t`` from 0 and
    ``y_t = sum_n h_t[n] C_t[n]``. u: [B,S,DI] f32 or bf16; dt: [B,S,DI]
    f32; A: [DI,DS] f32; Bc, Cc: [B,S,DS] in u's dtype -> y [B,S,DI] f32.

    Differentiable through ``SelectiveScanFused`` when grad is on and an
    operand needs it."""
    _check_fused(u, dt, A, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, A, Bc, Cc)):
        return SelectiveScanFused.apply(u, dt, A, Bc, Cc)
    return selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                        want_states=False)[0]


def selective_scan_fused_forward(u, dt, A, Bc, Cc, *, want_states: bool):
    """(y, states or None): the fused forward kernel
    (``csrc/selective_scan_fused.cu``) on the card, the plain chunked loop
    (``ref.selective_scan_fused_ref``) on the CPU, without autograd (a call
    with grad raises; ``SelectiveScanFused`` is the differentiable route).
    states [B, ceil(S / ref.FUSED_CHUNK), DI, DS] f32, the state entering
    each chunk, is what the backward starts its chunks from; y is the same
    bits with it or without. u, dt and A contiguous; Bc and Cc with unit
    stride over DS (the x_proj split's views)."""
    B, S, DI, DS = _check_fused(u, dt, A, Bc, Cc)
    if u.device.type == "cpu":
        if want_states:
            return ref.selective_scan_fused_ref(u, dt, A, Bc, Cc,
                                                want_states=True)
        return ref.selective_scan_fused_ref(u, dt, A, Bc, Cc), None
    _check_cuda_operands("selective_scan_fused", u, dt, A, align=4,
                         rows=(Bc, Cc))
    y = u.new_empty((B, S, DI), dtype=torch.float32)
    states = (u.new_empty((B, ref.fused_chunks(S), DI, DS),
                          dtype=torch.float32) if want_states else None)
    if u.device.type == "meta":
        _meta_call("selective_scan_fused",
                   FUSED_FLOPS["selective_scan_fused"] * B * S * DI * DS,
                   "f32", (u, dt, A, Bc, Cc), (y, states))
        return y, states
    code = build.load().repro_selective_scan_fused(
        _ptr(u), _ptr(dt), _ptr(A), _ptr(Bc), _ptr(Cc), _ptr(y),
        ctypes.c_void_p(None) if states is None else _ptr(states), B, S, DI,
        DS, Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
        _DTYPES[u.dtype], _stream())
    _raise_on(code, "selective_scan_fused")
    LAUNCHES["selective_scan_fused"] += 1
    return y, states


class SelectiveScanFused(torch.autograd.Function):
    """The fused scan with its backward kernels: the forward saves its
    operands (the caller's tensors, no copies) and the chunk states; the
    backward recomputes each chunk from its state
    (``selective_scan_fused_backward``)."""

    @staticmethod
    def forward(ctx, u, dt, A, Bc, Cc):
        y, states = selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                                 want_states=True)
        ctx.save_for_backward(u, dt, A, Bc, Cc, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, A, Bc, Cc, states = ctx.saved_tensors
        grads = selective_scan_fused_backward(u, dt, A, Bc, Cc, states,
                                              dy.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy):
    """(du, ddt, dA, dB, dC) of the fused scan, in the dtypes of u, dt, A,
    Bc, Cc, from its operands, the forward's ``states`` and dy [B,S,DI] f32.
    On the card the backward kernel and the reduce of its per-block
    partials (``csrc/selective_scan_fused.cu``: no atomics, the same bits
    on every call); the plain version
    (``ref.selective_scan_fused_backward_ref``) on the CPU."""
    B, S, DI, DS = _check_fused(u, dt, A, Bc, Cc)
    if states.shape != (B, ref.fused_chunks(S), DI, DS) \
            or states.dtype != torch.float32:
        raise ValueError(f"selective_scan_fused_backward: states must be "
                         f"f32 of shape {(B, ref.fused_chunks(S), DI, DS)}")
    if dy.shape != u.shape or dy.dtype != torch.float32:
        raise ValueError(f"selective_scan_fused_backward: dy must be f32 of "
                         f"shape {tuple(u.shape)}")
    if u.device.type == "cpu":
        return ref.selective_scan_fused_backward_ref(u, dt, A, Bc, Cc,
                                                     states, dy)
    _check_cuda_operands("selective_scan_fused_backward", u, dt, A, states,
                         dy, align=4, rows=(Bc, Cc))
    f32 = dict(dtype=torch.float32)
    du, ddt = u.new_empty((B, S, DI), **f32), u.new_empty((B, S, DI), **f32)
    dB, dC = u.new_empty((B, S, DS), **f32), u.new_empty((B, S, DS), **f32)
    dA = u.new_empty((DI, DS), **f32)
    if u.device.type == "meta":
        _meta_call("selective_scan_fused_backward",
                   FUSED_FLOPS["selective_scan_fused_backward"]
                   * B * S * DI * DS, "f32", (u, dt, A, Bc, Cc, states, dy),
                   (du, ddt, dA, dB, dC))
    else:
        blocks = fused_blocks(DI, DS)
        part_b = u.new_empty((blocks, B, S, DS), **f32)
        part_c = torch.empty_like(part_b)
        dA_part = u.new_empty((B, DI, DS), **f32)
        code = build.load().repro_selective_scan_fused_bwd(
            *map(_ptr, (u, dt, A, Bc, Cc, states, dy, du, ddt, part_b, part_c,
                        dA_part, dB, dC, dA)), blocks, B, S, DI, DS,
            Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
            _DTYPES[u.dtype], _stream())
        _raise_on(code, "selective_scan_fused_backward")
        LAUNCHES["selective_scan_fused_backward"] += 1
    return du.to(u.dtype), ddt, dA, dB.to(Bc.dtype), dC.to(Cc.dtype)
