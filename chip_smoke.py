#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Models, at full width with random weights from a seed, depth not cut
except in phase 7: internlm2-1.8b (24 layers, d=2048, 16 heads, 8 kv heads,
dh=128, d_ff=8192, V=92544) and falcon-mamba-7b (64 Mamba layers, d=4096,
d_inner=8192, d_state=16, d_conv=4, dt_rank=256, V=65024). Phases:

1. device: name, power limit, kernel build (nvcc, sm_90a) and its seconds;
2. each CUDA kernel, launched directly, against its plain PyTorch version
   on the card (tolerance 2e-5 for f32, 2e-2 for bf16, as the JAX package's
   kernel tests use; bf16 flash also row by row against the f32 result of
   its inputs, ``ref.BF16_ROW_TOL``; the scan, in both its variants,
   bit-identical to the plain loop, and its backward bit-identical to the
   plain reverse loop and bitwise repeatable);
3. internlm2 ``forward`` in bf16 on tokens [2, 2048] with the flash kernel
   (its tensor-core variant) against the plain path, and the flash launch
   count (one per layer, none of them an f32 variant);
   3b. falcon-mamba ``forward`` the same way through the scan kernel (one
   launch per layer);
4. internlm2 ``SlotServer`` with f32 weights and its f32 cache (4 slots,
   max_len 4096, 8 requests x 64 tokens) through the decode kernel: every
   request gets its tokens, a lockstep kernel/plain ``serve_step`` run holds
   the logits, the greedy streams agree, and the decode launch count is
   n_layers x steps (each one launch of the cluster kernel);
   4b. falcon-mamba ``SlotServer`` the same way through the scan kernel
   (f32 conv and SSM caches; n_layers x steps scan launches, every one of
   them the decode-step variant), and the scan's device time per launch
   inside the serve step beside the sequential kernel's and that of
   ``torch.addcmul`` in its place;
5. timings (CUDA-event medians and profiler device time) of each kernel,
   its plain version and, where one exists, one PyTorch library call at the
   shapes of phases 3-4, with the kernel's bound; flash at dh = 128 in both
   of its variants there (bf16 on the tensor cores against the bf16 peak;
   f32 split-f32, three TF32 products against the TF32 peak, with the f32
   CUDA-core bound beside it); decode attention at the serve shape and at a
   full cache; the scan at the forward shape and at the decode step; the f32
   flash backward beside its bounds; beside the f32 pair, memory-efficient
   SDPA on K/V repeated to the q heads and SDPA with ``enable_gqa`` (MATH),
   after step 0, which measures that SDPA's error against the plain
   versions at phase 2's f32 cases (the evidence for split-f32); the f32
   CUDA-core flash pair at gemma2-9b's attention shape (dh = 256, softcap
   50; off the main paths) beside its 67 TFLOP/s bound and SDPA without
   the softcap; the scan's backward at phase 7's shape beside its bound;
6. internlm2 ``make_train_step`` at full width in f32 (24 layers, tokens
   [accum 1, mb 2, S 2048], 30.2 GB of params, grads and AdamW moments):
   step ms, tokens/s, the device breakdown, 24 forward and 24 backward
   flash launches a step (counted, and recorded on the split-f32 kernels
   only: prep and forward, prep, dk/dv and dq), a first loss near ln V,
   two steps from the same state bitwise equal, and the grads at full width
   and depth cut to 2 layers against the ``attn_impl="plain"`` path;
   6b. ``run_training(device="cuda")`` (the LOG.io-protected feed, reduced
   to d_model 512 and 4 layers so dh = 128) with a trainer kill and a
   worker kill, whose losses and final state must equal, bit for bit, a run
   without kills;
7. falcon-mamba ``make_train_step`` (mamba-train-f32) at full width in f32,
   depth cut to MAMBA_TRAIN_LAYERS (4 of 64: device memory, reckoned on its
   own line), tokens [1, 2, 2048]: the same checks and timings as phase 6,
   with 4 forward (sequential variant) and 4 backward scan launches a step,
   the scan pair's share of the step and the grads at depth 2 against
   ``scan_impl="plain"`` (and whether they are bitwise equal);
   7b. (mamba-train-logio) phase 6b's pair of runs on falcon-mamba, reduced
   to d_model 512 and 4 layers (d_inner 1024, d_state 8).

Phase 2 also holds the f32 flash backward (``csrc/flash_attention_f32tc.cu``
at D <= 128, ``csrc/flash_attention_bwd.cu`` at D = 256) against its plain
version at rtol = atol = 2e-5 relative to each
gradient's largest magnitude, bitwise repeatable, and the forward's lse.
Training needs ``CUBLAS_WORKSPACE_CONFIG`` (set here before torch starts)
and runs under ``torch.use_deterministic_algorithms(True)`` from phase 6 on.
The phases that drive a main path (3-4b, 6-7b) set the launch counts to 0
just before and read them just after.

Every breakdown prints the port's kernel launches the profiler recorded
beside those the wrappers counted, and reads its device busy time as a lower
bound when records are missing. Peak device memory is printed per phase.
f32 products run in full f32 (``allow_tf32`` off for matmul and cuDNN).
Any failure raises and exits non-zero; nothing is turned into success. The
last line is ``{"ok": true, "device": {...}}``. Needs one card; exits
non-zero without one, or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# deterministic cuBLAS for the training phases; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.serving import SlotServer, serve_step  # noqa: E402
from repro_torch.training import loss_fn, make_train_step  # noqa: E402
from repro_torch.training import OptHParams, init_train_state  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
TF32_FLOPS = 495e12   # dense TF32 on the tensor cores; split-f32 runs three products
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SEED = 0
DEVICE = "cuda"   # the phases take their device from here
ARCH = "internlm2-1.8b"
MAMBA_ARCH = "falcon-mamba-7b"
FWD_B, FWD_S = 2, 2048
SLOTS, MAX_LEN, REQUESTS, TOKENS = 4, 4096, 8, 64
TRAIN_STEPS = 2          # timed full-width steps after the checked first one
GRAD_LAYERS = 2          # depth of the kernel-vs-plain gradient check
GRAD_TOL = 1e-4          # that check's tolerance, relative to each leaf's max
LOGIO_RUN = dict(steps=10, ckpt_every=3, seq_len=128, batch_size=4,
                 d_model=512, n_layers=4, seed=3)   # phases 6b and 7b
MAMBA_TRAIN_LAYERS = 4   # phase 7's depth (of 64): what device memory allows

KERNELS = {
    # bf16 (the forward path) runs on the tensor cores; f32 (the train path)
    # on split-f32 tensor-core kernels at D <= 128 (``ops.flash_variant``),
    # timed beside it in phase 5
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    # the Pallas kernel has no backward (JAX differentiates XLA attention);
    # this is the backward of the kernel that replaces it, on the train path
    "flash_attention_backward": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:79"),
    "selective_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:49"),
    # the Pallas scan has no backward (JAX differentiates its XLA scans,
    # models/layers.py:539-561); this is the backward of the kernel that
    # replaces it, on the Mamba train path
    "selective_scan_backward": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:49"),
}
# flash's device kernels by variant (``ops.flash_variant``: dtype and head
# dim), the scan's by ``ops.scan_variant``. Names are matched as substrings;
# no name of one variant contains another's.
FLASH_TC, FLASH_CC = "flash_fwd_tc_kernel", "flash_fwd_kernel"
F32TC_FWD_PREP, F32TC_FWD = "flash_f32tc_fwd_prep_kernel", "flash_f32tc_fwd_kernel"
F32TC_BWD = ("flash_f32tc_bwd_prep_kernel", "flash_f32tc_dkdv_kernel",
             "flash_f32tc_dq_kernel")
SCAN_KERNEL = {"sequential": "selective_scan_kernel",
               "step": "selective_scan_step_kernel"}
SCAN_BWD = "selective_scan_bwd_kernel"
FLASH_BWD = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")   # the CUDA-core backward (f32, D = 256)
# per wrapper, per variant: its device kernels and how many of them one
# counted launch runs
DEVICE_KERNELS = {
    "flash_attention": [((FLASH_TC,), 1), ((FLASH_CC,), 1),
                        ((F32TC_FWD_PREP, F32TC_FWD), 2)],
    "flash_attention_backward": [(FLASH_BWD, 3), (F32TC_BWD, 3)],
    "decode_attention": [(("decode_attention_kernel",), 1)],
    "selective_scan": [(tuple(SCAN_KERNEL.values()), 1)],
    "selective_scan_backward": [((SCAN_BWD,), 1)],
}


def sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(got, want, tol, what) -> float:
    err = max_err(got, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return err


def check_flash_rows(got, q, k, v, kw, what) -> float:
    """The bf16 flash output against the f32 result of its own inputs,
    row by row (``ref.BF16_ROW_TOL``)."""
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    err = ref.row_error(got, exact)
    check(err <= ref.BF16_ROW_TOL,
          f"{what}: row error {err:.3e} > {ref.BF16_ROW_TOL}")
    return err


def cuda_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of fn() in ms; ``flush`` runs between launches
    outside the timed window (to start from a cold L2)."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _dev_time_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def profile_kernels(fn, iters: int = 10) -> dict:
    """Device time of fn() by kernel name, from torch.profiler (CUPTI):
    {"kernels": {name: (launches recorded / iters, ms recorded / iters)},
    "counted": {wrapper: launches ``ops.LAUNCHES`` counted / iters}}.
    "kernels" is empty when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    counted = {k: (ops.LAUNCHES[k] - before[k]) / iters for k in before
               if ops.LAUNCHES[k] != before[k]}
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = _dev_time_us(ev)
            if t > 0:
                out[ev.key] = (ev.count / iters, t / iters / 1e3)
    return {"kernels": out, "counted": counted}


def kernel_ms(prof: dict, *names: str):
    """Device ms per launch, summed over the kernels whose names contain one
    of names (each launched once per call); per launch recorded, so a launch
    the profiler dropped does not dilute it."""
    hits = [ms / n for key, (n, ms) in prof["kernels"].items()
            if n and any(x in key for x in names)]
    return sum(hits) if hits else None


def recorded(prof: dict, name: str) -> float:
    """Launches per call the profiler recorded of the device kernel ``name``."""
    return sum(n for key, (n, _) in prof["kernels"].items() if name in key)


def log_breakdown(tag: str, prof: dict, wall_ms: float, top: int = 6) -> None:
    """Device busy time against host wall time per call, and the top kernels.

    Busy time is the sum of the milliseconds the profiler recorded, per call.
    Beside it stand the port's kernel launches the profiler recorded and
    those the wrappers counted for the same calls: when fewer were recorded,
    records were dropped and the busy total is a lower bound (drops among
    library kernels cannot be seen this way)."""
    kernels = prof["kernels"]
    if not kernels:
        log(f"breakdown {tag}: profiler saw no device time (not measured)")
        return
    busy = sum(ms for _, ms in kernels.values())
    short = []
    for name, per_call in sorted(prof["counted"].items()):
        variants = DEVICE_KERNELS[name]
        by_name = {x: recorded(prof, x) for names, _ in variants for x in names}
        # counted launches the records account for, each variant's kernels
        # divided by how many one launch runs
        seen = sum(sum(by_name[x] for x in names) / per_launch
                   for names, per_launch in variants)
        ran = [x for names, _ in variants for x in names if by_name[x]]
        log(f"breakdown {tag}: {name} launches recorded {seen:g} / counted "
            f"{per_call:g} per call ("
            + ", ".join(f"{x} {by_name[x]:g}" for x in ran)
            + f"), {_fmt(kernel_ms(prof, *ran))} ms per launch")
        if seen < per_call:
            short.append(name)
    bound = ">= " if short else ""
    note = (f" (lower bound: launch records of {', '.join(short)} missing)"
            if short else "")
    log(f"breakdown {tag}: wall {wall_ms:.3f} ms/call, device busy "
        f"{bound}{busy:.3f} ms/call ({bound}{100 * busy / wall_ms:.1f}%, idle "
        f"{'<= ' if short else ''}{100 * (1 - busy / wall_ms):.1f}%){note}")
    for key, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {100 * ms / busy:5.1f}% {ms:8.4f} ms x{n:g} {key[:90]}")


def log_memory(tag: str, reckoned_gb=None) -> None:
    """Peak device memory since the last reset (beside what was reckoned
    for it, where given), then reset it."""
    if torch.device(DEVICE).type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        log(f"memory {tag}: peak {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)"
            f" allocated" + (f", reckoned {reckoned_gb:.1f} GB"
                             if reckoned_gb is not None else ""))
        torch.cuda.reset_peak_memory_stats()


def runtime(impl: str) -> M.Runtime:
    """The kernel path or the plain path, for attention and scan alike."""
    return M.Runtime(attn_impl=impl, scan_impl=impl)


def host_ms(fn, iters: int) -> float:
    """Host wall time per call of fn(), synchronised at both ends."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    _, secs = build.build()
    build.load()
    log(f"build: {secs:.1f} s ({build.library_path().name})")
    text = build.build_log()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
    serial = len(re.findall(r"wgmma.mma_async instructions are serialized", text))
    log(f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} registers, "
        f"{sum(1 for x in spills if x)} with spills (max {max(spills, default=0)}"
        f" bytes), {serial} with wgmma serialized")
    return {"name": name, "smi": smi.splitlines()[0]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device=DEVICE).to(dtype)


DECODE_CASES = [
    # (B, S, H, KV, D, dtype, window, softcap, lengths) ; None -> random in [1,S]
    (4, 4096, 16, 8, 128, torch.float32, None, None, None),
    (4, 4096, 16, 8, 128, torch.bfloat16, None, None, None),
    (2, 8192, 16, 8, 256, torch.float32, 4096, 50.0, None),
    (4, 1024, 16, 8, 128, torch.float32, None, None, [1025, 2048, 1500, 3072]),
    # with a window, lengths > S + window leave no valid key (uniform softmax)
    (4, 1024, 16, 8, 128, torch.float32, 512, None, [1100, 1535, 1536, 2048]),
    # the serve path's lengths (64 keys a slot: most splits of each cluster
    # get none), most splits empty, S a multiple of neither the split count
    # nor the ring tile, head group 16 at D = 256, bf16 with window and
    # softcap
    (4, 4096, 16, 8, 128, torch.float32, None, None, [64, 64, 64, 64]),
    (4, 4096, 16, 8, 128, torch.float32, None, None, [1, 64, 1, 4096]),
    (2, 2047, 16, 8, 128, torch.float32, None, None, [2047, 1999]),
    (2, 4096, 32, 2, 256, torch.float32, None, None, [4096, 3000]),
    (4, 4096, 16, 8, 128, torch.bfloat16, 1000, 30.0, None),
]

FLASH_CASES = [
    # (B, S, H, KV, D, dtype, causal, window, softcap)
    (2, 2048, 16, 8, 128, torch.bfloat16, True, None, None),
    (2, 2048, 16, 8, 128, torch.float32, True, None, None),
    (1, 2048, 16, 8, 256, torch.bfloat16, True, 512, 50.0),
    (1, 1024, 16, 8, 256, torch.float32, True, 300, 50.0),
    (2, 1024, 16, 8, 128, torch.bfloat16, False, None, None),
    (2, 1000, 16, 8, 128, torch.float32, True, None, None),
    (1, 1000, 8, 2, 64, torch.bfloat16, True, 128, 30.0),
    (2, 2048, 16, 8, 32, torch.bfloat16, True, None, None),
    (2, 1024, 8, 2, 64, torch.bfloat16, True, None, None),
    (2, 1000, 16, 8, 128, torch.bfloat16, False, None, None),   # ragged, no mask
]

BWD_CASES = [
    # f32 flash backward: (B, Sq, Sk, H, KV, D, causal, window, softcap); the
    # train step's shape first, then D = 64 / 256, groups 1 / 4, window and
    # softcap, ragged S, Sq != Sk without a mask
    (2, 2048, 2048, 16, 8, 128, True, None, None),
    (2, 1024, 1024, 16, 8, 64, True, None, None),
    (1, 1024, 1024, 16, 8, 256, True, None, None),
    (1, 1024, 1024, 16, 16, 64, True, None, None),
    (1, 1024, 1024, 16, 4, 128, True, None, None),
    (1, 1024, 1024, 16, 8, 128, True, 256, 50.0),
    (2, 1000, 1000, 16, 8, 128, True, None, None),
    (1, 700, 1000, 16, 8, 128, False, None, None),
]


def assert_close_to_max(got, want, tol, what) -> float:
    """rtol = atol = tol after dividing both by max|want|: a gradient's
    tolerance relative to its own scale. Returns the largest error over
    max|want|."""
    scale = want.abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return max_err(got, want) / scale.item()


def check_flash_backward(g, case) -> float:
    """One backward case: the forward's o with and without lse (bitwise),
    its lse against the plain one, the backward kernel against the plain
    backward, and a second backward call bitwise equal to the first."""
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    q = _randn(g, (B, Sq, H, D), torch.float32)
    k = _randn(g, (B, Sk, KV, D), torch.float32)
    v = _randn(g, (B, Sk, KV, D), torch.float32)
    dout = _randn(g, (B, Sq, H, D), torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    what = f"flash backward {case}"
    out_plain = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_forward(q, k, v, causal, window, softcap,
                                  want_lse=True)
    check(bool(torch.equal(out, out_plain)), f"{what}: o moved with lse on")
    lse_err = assert_close(lse, ref.flash_attention_lse_ref(q, k, **kw),
                           TOL[torch.float32], f"{what} lse")
    before = ops.LAUNCHES["flash_attention_backward"]
    got = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    sync()
    check(ops.LAUNCHES["flash_attention_backward"] == before + 1,
          f"{what}: the backward kernel did not launch")
    want = ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    errs = [assert_close_to_max(a, b, TOL[torch.float32], f"{what} {n}")
            for n, a, b in zip(("dq", "dk", "dv"), got, want)]
    abs_err = max(max_err(a, b) for a, b in zip(got, want))
    again = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    log(f"flash backward B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
        f"({ops.flash_variant(torch.float32, D)}) "
        f"causal={causal} window={window} softcap={softcap}: dq/dk/dv error "
        f"relative to max {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} "
        f"(tol {TOL[torch.float32]}), bitwise repeatable, o unchanged by lse, "
        f"lse max_abs_err {lse_err:.3e}, grads max_abs_err {abs_err:.3e}")
    return abs_err


SCAN_CASES = [
    # (B, S, DI, DS, h0, variant); h0 None, "fresh" or "offset" (a view 4
    # bytes into its buffer, not 16-byte aligned): falcon-mamba's forward
    # shape, its decode step (with and without h0), a ragged F (8240 * 16 =
    # 515 blocks of 256 and a half), a small odd F, a decode step with
    # F % 4 != 0 and one with an unaligned h0
    (2, 2048, 8192, 16, None, "sequential"),
    (4, 1, 8192, 16, "fresh", "step"),
    (4, 1, 8192, 16, None, "step"),
    (3, 1000, 8192 + 48, 16, None, "sequential"),
    (2, 300, 7, 3, "fresh", "sequential"),
    (4, 1, 8191, 3, "fresh", "sequential"),
    (4, 1, 8192, 16, "offset", "sequential"),
]


def _scan_operands(g, B, S, DI, DS, h0):
    """a in [0.499, 0.999) (a decay, as exp(dt * A) is), b and h0 normal;
    h0 as in ``SCAN_CASES``."""
    a = torch.rand((B, S, DI, DS), generator=g, device=DEVICE) * 0.5 + 0.499
    b = torch.randn((B, S, DI, DS), generator=g, device=DEVICE)
    if h0 is not None:
        buf = torch.randn((B * DI * DS + 1,), generator=g, device=DEVICE)
        h0 = (buf[1:] if h0 == "offset" else buf[:-1]).view(B, DI, DS)
    return a, b, h0


SCAN_BWD_CASES = [
    # (B, S, DI, DS, h0) as in ``SCAN_CASES``: phase 7's shape (the train
    # path's, no h0), a ragged F with h0 and S one past a multiple of the
    # kernel's 8-step groups, a small odd F with h0, S below one group, an
    # h0 that is 4 bytes into its buffer, S = 1 with and without h0
    (2, 2048, 8192, 16, None),
    (3, 1001, 8192 + 48, 16, "fresh"),
    (2, 300, 7, 3, "fresh"),
    (2, 13, 24, 5, None),
    (2, 37, 64, 16, "offset"),
    (4, 1, 8192, 16, "fresh"),
    (4, 1, 8192, 16, None),
]


def check_scan_backward(g, case) -> float:
    """One backward case: the kernel against the plain reverse loop, bit for
    bit (dh0 too, with h0), from the forward kernel's h and a random dh; a
    second call bitwise equal to the first. Returns the max abs error (0)."""
    B, S, DI, DS, h0_kind = case
    a, b, h0 = _scan_operands(g, B, S, DI, DS, h0_kind)
    h = ops.selective_scan(a, b, h0)
    del b
    dh = torch.randn(a.shape, generator=g, device=DEVICE)
    what = f"scan backward {B, S, DI, DS, h0_kind}"
    before = ops.LAUNCHES["selective_scan_backward"]
    got = ops.selective_scan_backward(a, h, h0, dh)
    sync()
    check(ops.LAUNCHES["selective_scan_backward"] == before + 1,
          f"{what}: the backward kernel did not launch")
    want = ref.selective_scan_backward_ref(a, h, h0, dh)
    check((got[2] is None) == (h0 is None) == (want[2] is None),
          f"{what}: dh0 given without h0 or missing with it")
    pairs = [(x, y) for x, y in zip(got, want) if y is not None]
    err = max(max_err(x, y) for x, y in pairs)
    check(all(bool(torch.equal(x, y)) for x, y in pairs),
          f"{what}: not bit-identical to the plain reverse loop (max_abs_err "
          f"{err:.3e})")
    again = ops.selective_scan_backward(a, h, h0, dh)
    check(all(bool(torch.equal(x, y)) for x, y in zip(got, again)
              if x is not None), f"{what}: two calls differ")
    log(f"scan backward B={B} S={S} DI={DI} DS={DS} h0={h0_kind}: da, db"
        f"{', dh0' if h0 is not None else ''} bit-identical to the plain "
        f"reverse loop, bitwise repeatable")
    return err


def phase_kernels() -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}
    for B, S, DI, DS, h0_kind, variant in SCAN_CASES:
        a, b, h0 = _scan_operands(g, B, S, DI, DS, h0_kind)
        what = f"scan {B, S, DI, DS, h0_kind}"
        check(ops.scan_variant(a, b, h0) == variant,
              f"{what}: variant {ops.scan_variant(a, b, h0)} != {variant}")
        before = ops.SCAN_VARIANTS[variant]
        out = ops.selective_scan(a, b, h0)
        sync()
        check(ops.SCAN_VARIANTS[variant] == before + 1,
              f"{what}: the {variant} kernel did not launch")
        want = ref.selective_scan_ref(a, b, h0)
        err = max_err(out, want)
        # one rounded product and one rounded sum per step, in both
        check(bool(torch.equal(out, want)),
              f"{what}: not bit-identical to the plain loop (max_abs_err "
              f"{err:.3e})")
        errs["selective_scan"] = max(errs["selective_scan"], err)
        log(f"scan B={B} S={S} DI={DI} DS={DS} h0={h0_kind} ({variant}): "
            f"bit-identical to the plain loop")
        del a, b, h0, out, want
    for case in SCAN_BWD_CASES:
        errs["selective_scan_backward"] = max(
            errs["selective_scan_backward"], check_scan_backward(g, case))
    for B, S, H, KV, D, dt, window, softcap, lens in DECODE_CASES:
        q = _randn(g, (B, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        if lens is None:
            lengths = torch.randint(1, S + 1, (B,), generator=g, device=DEVICE)
            lengths[0], lengths[-1] = 1, S
        else:
            lengths = torch.tensor(lens, device=DEVICE)
        lengths = lengths.to(torch.int32)
        out = ops.decode_attention(q, k, v, lengths, window=window,
                                   softcap=softcap)
        sync()
        want = ref.decode_attention_ref(q, k, v, lengths, window=window,
                                        softcap=softcap)
        err = assert_close(out, want, TOL[dt], f"decode {B,S,H,KV,D,dt}")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        n_split = ops.decode_grid(B, KV, S, ops.sm_count(0))
        log(f"decode B={B} S={S} H={H} KV={KV} D={D} {str(dt)[6:]} "
            f"window={window} softcap={softcap} lengths={lengths.tolist()} "
            f"cluster {n_split}: max_abs_err {err:.3e} (tol {TOL[dt]})")
    for B, S, H, KV, D, dt, causal, window, softcap in FLASH_CASES:
        q = _randn(g, (B, S, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = ops.flash_attention(q, k, v, **kw)
        sync()
        want = ref.flash_attention_ref(q, k, v, **kw)
        what = f"flash {B,S,H,KV,D,dt,causal}"
        err = assert_close(out, want, TOL[dt], what)
        rows = (f", row error {check_flash_rows(out, q, k, v, kw, what):.3e} "
                f"(tol {ref.BF16_ROW_TOL})" if dt == torch.bfloat16 else "")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"flash B={B} S={S} H={H} KV={KV} D={D} {str(dt)[6:]} "
            f"({ops.flash_variant(dt, D)}) causal={causal} "
            f"window={window} softcap={softcap}: max_abs_err {err:.3e} "
            f"(tol {TOL[dt]}){rows}")
    for case in BWD_CASES:
        errs["flash_attention_backward"] = max(
            errs["flash_attention_backward"], check_flash_backward(g, case))
    return errs


# ---------------------------------------------------------------------------
# phase 3 / 3b: forward at full width, bf16
# ---------------------------------------------------------------------------


def as_f32(params, cfg):
    """An f32 copy of ``params`` made leaf by leaf (no second bf16 copy)."""
    p32 = M.DecoderParams(cfg, torch.float32, params.embed.device)
    with torch.no_grad():
        for dst, src in zip(p32.parameters(), params.parameters()):
            dst.copy_(src)
    return p32


def phase_forward(cfg, kernel: str) -> dict:
    """``forward`` in bf16 on tokens [FWD_B, FWD_S] through ``kernel`` (one
    launch per layer), held against the plain path and an f32 forward."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = M.init_params(g, cfg, torch.bfloat16, DEVICE)
    tokens = torch.randint(0, cfg.vocab, (FWD_B, FWD_S), generator=g,
                           device=DEVICE)
    batch = {"tokens": tokens}
    tag = f"forward {cfg.name} bf16 [{FWD_B},{FWD_S}]"
    with torch.inference_mode():
        ops.reset_launches()
        logits_k, _ = M.forward(params, batch, cfg, runtime("kernel"))
        sync()
        launches = ops.LAUNCHES[kernel]
        variants = dict(ops.SCAN_VARIANTS)
        logits_p, _ = M.forward(params, batch, cfg, runtime("plain"))
        sync()
    check(launches == cfg.n_layers,
          f"{kernel} launches {launches} != n_layers {cfg.n_layers}")
    if kernel == "selective_scan":
        check(variants["sequential"] == launches,
              f"forward scan launches by variant {variants}")
    check(tuple(logits_k.shape) == (FWD_B, FWD_S, cfg.vocab), "logits shape")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    # bf16 activations round at every layer, so two bf16 paths that differ
    # only in a kernel's summation order drift apart by about what bf16
    # itself costs. The stated tolerance is relative to that cost: against
    # an f32 forward of the same weights (the plain path in full f32), the
    # kernel path's max and mean errors may be at most 2x and 1.25x the
    # plain bf16 path's.
    with torch.inference_mode():
        p32 = as_f32(params, cfg)
        logits_r, _ = M.forward(p32, batch, cfg, runtime("plain"))
        del p32
    e_k, e_p = max_err(logits_k, logits_r), max_err(logits_p, logits_r)
    m_k = (logits_k - logits_r).abs().mean().item()
    m_p = (logits_p - logits_r).abs().mean().item()
    top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"{tag}: {kernel} launches {launches}; vs f32 forward: kernel max "
        f"{e_k:.3e} mean {m_k:.3e}, plain max {e_p:.3e} mean {m_p:.3e}; "
        f"kernel vs plain max {max_err(logits_k, logits_p):.3e}, "
        f"max|logit| {logits_r.abs().max().item():.3f}, top-1 agreement "
        f"{top1:.4f}")
    check(e_k <= 2 * e_p and m_k <= 1.25 * m_p,
          "forward logits: the kernel path is less accurate than the plain "
          "path beyond the stated tolerance")
    del logits_k, logits_p, logits_r
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                           runtime("kernel")), iters=5,
                         warmup=1)
        fwd_plain_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                                 runtime("plain")), iters=3,
                               warmup=1)
        prof = profile_kernels(
            lambda: M.forward(params, batch, cfg, runtime("kernel")), 2)
        log_breakdown(f"{tag} kernel", prof, fwd_ms)
    if kernel == "flash_attention" and prof["kernels"]:
        # bf16 goes to the tensor-core variant; a dropped record cannot make
        # an f32 launch appear
        check(recorded(prof, FLASH_CC) == 0 and recorded(prof, F32TC_FWD) == 0,
              "the bf16 forward launched an f32 flash kernel")
    log(f"{tag}: kernel {fwd_ms:.2f} ms "
        f"({FWD_B * FWD_S / fwd_ms * 1e3:.0f} tok/s), plain path "
        f"{fwd_plain_ms:.2f} ms ({FWD_B * FWD_S / fwd_plain_ms * 1e3:.0f} tok/s)")
    del params
    log_memory(tag)
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 4 / 4b: serving at full width, f32
# ---------------------------------------------------------------------------


def _serve(server: SlotServer, gaps: list) -> tuple[dict, int, float]:
    """Drive ``server`` as repro_torch.launch.serve does; record per step the
    plain top-2 logit gap of each active request (rid -> gap)."""
    inner = server._step

    def recording(*a, **kw):
        nxt, logits, cache = inner(*a, **kw)
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        gaps.append({server._slot_req[s]: gap[s]
                     for s in range(server.n_slots) if server.active[s]})
        return nxt, logits, cache

    server._step = recording
    sync()
    t0 = time.perf_counter()
    pending = list(range(REQUESTS))
    active, done, steps = {}, {}, 0
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            active[server.submit(prompt_token=req + 2)] = req
        server.step()
        steps += 1
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= TOKENS:
                done[active.pop(rid)] = server.finish(rid)
    sync()
    return done, steps, time.perf_counter() - t0


def phase_serve(cfg, kernel: str) -> dict:
    """``SlotServer`` with f32 weights and cache through ``kernel`` (one
    launch per layer per step): lockstep logits, greedy streams, launches.
    Returns the kernel path's lockstep cache and last positions, which
    phase 5 times the kernel on."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = M.init_params(g, cfg, torch.float32, DEVICE)
    tol = TOL[torch.float32]
    tag = f"serve {cfg.name} f32"
    with torch.inference_mode():
        # (a) lockstep: the same tokens into both paths at every step
        caches = {impl: M.init_cache(cfg, SLOTS, MAX_LEN, torch.float32, DEVICE)
                  for impl in ("kernel", "plain")}
        tokens = torch.arange(2, 2 + SLOTS, device=DEVICE, dtype=torch.int32)
        worst = 0.0
        for t in range(TOKENS):
            pos = torch.full((SLOTS,), t, device=DEVICE, dtype=torch.int32)
            nk, lk, _ = serve_step(params, caches["kernel"], tokens, pos,
                                   cfg=cfg, rt=runtime("kernel"))
            _, lp, _ = serve_step(params, caches["plain"], tokens, pos,
                                  cfg=cfg, rt=runtime("plain"))
            worst = max(worst, assert_close(lk, lp, tol, f"lockstep step {t}"))
            tokens = nk
        log(f"{tag} lockstep {TOKENS} steps x {SLOTS} slots: "
            f"max|dlogit| {worst:.3e} (tol {tol})")
        # one decode step of each path, timed in turns (plain, kernel,
        # kernel, plain) at the last lockstep position, then profiled
        step = {impl: (lambda impl=impl: serve_step(
            params, caches[impl], tokens, pos, cfg=cfg, rt=runtime(impl)))
            for impl in ("kernel", "plain")}
        step_ms = {"kernel": [], "plain": []}
        for impl in ("plain", "kernel", "kernel", "plain"):
            step_ms[impl].append(host_ms(step[impl], 10))
        for impl in ("kernel", "plain"):
            ms = statistics.mean(step_ms[impl])
            log(f"{tag} serve_step {impl} B={SLOTS} pos={TOKENS - 1}: "
                f"{'/'.join(f'{x:.3f}' for x in step_ms[impl])} ms "
                f"({SLOTS / ms * 1e3:.1f} tok/s)")
            log_breakdown(f"{tag} serve_step {impl}",
                          profile_kernels(step[impl], 5), ms)
        in_step = (scan_in_step(step["kernel"], tag)
                   if kernel == "selective_scan" else None)
        # (b) the servers: kernel (counted) and plain
        gaps_k, gaps_p = [], []
        ops.reset_launches()
        out_k, steps, secs_k = _serve(
            SlotServer(params, cfg, runtime("kernel"), SLOTS, MAX_LEN), gaps_k)
        launches = ops.LAUNCHES[kernel]
        variants = dict(ops.SCAN_VARIANTS)
        out_p, steps_p, secs_p = _serve(
            SlotServer(params, cfg, runtime("plain"), SLOTS, MAX_LEN), gaps_p)
    check(launches == cfg.n_layers * steps,
          f"{kernel} launches {launches} != n_layers x steps "
          f"{cfg.n_layers} x {steps}")
    if kernel == "selective_scan":
        # every decode step of the server goes to the float4 step kernel
        check(variants["step"] == launches,
              f"server scan launches by variant {variants}")
        log(f"{tag}: scan launches by variant {variants}")
    check(sorted(out_k) == list(range(REQUESTS)), "missing requests")
    check(all(len(o) == TOKENS for o in out_k.values()), "short requests")
    diverged = []
    for req in range(REQUESTS):
        a, b = out_k[req], out_p[req]
        if a != b:
            t = next(i for i in range(TOKENS) if a[i] != b[i])
            # the request's t-th token came out of the t-th step it was active
            seen = [s for s in gaps_p if req in s]
            gap = seen[t][req]
            diverged.append((req, t, gap))
            log(f"{tag}: request {req} diverges at token {t}; plain top-2 "
                f"gap there {gap:.3e} (tol {tol})")
            check(gap < tol, f"request {req}: streams diverge at a clear "
                             f"top-2 gap {gap:.3e}")
    tok = REQUESTS * TOKENS
    log(f"{tag} {REQUESTS} req x {TOKENS} tok, {SLOTS} slots, max_len "
        f"{MAX_LEN}: {steps} steps, {kernel} launches {launches}; kernel "
        f"{secs_k:.2f} s ({tok / secs_k:.1f} tok/s), plain path {secs_p:.2f} s "
        f"({tok / secs_p:.1f} tok/s); diverged requests: {len(diverged)}")
    check(steps == steps_p, "plain server took another number of steps")
    del params
    log_memory(tag)
    return {"launches": launches, "cache": caches["kernel"], "pos": pos,
            "scan_in_step": in_step}


def _scan_addcmul(a, b, h0=None):
    """One decode step of the scan as one library call (S = 1 and h0 only):
    h = a * h0 + b. Timed, never used by the port; CUDA may fuse its
    product and sum, so its bits may differ from the kernel's."""
    return torch.addcmul(b, a, h0.unsqueeze(1))


def scan_in_step(step, tag: str) -> dict:
    """Device ms per scan launch inside the Mamba serve step, where a and b
    were just written and sit in L2, three ways in turns: the step kernel
    (the path's), the sequential kernel at S = 1 (what took S = 1 before the
    step kernel; ``ops.scan_variant`` patched for the run) and one library
    call in the kernel's place (``_scan_addcmul``, ``ops.selective_scan``
    patched for the run). The patched runs only time; nothing is checked or
    counted from them."""
    ways = {
        "step": (contextlib.nullcontext, SCAN_KERNEL["step"]),
        "sequential": (lambda: mock.patch.object(
            ops, "scan_variant", lambda *_: "sequential"),
            SCAN_KERNEL["sequential"]),
        "addcmul": (lambda: mock.patch.object(
            ops, "selective_scan", _scan_addcmul), "addcmul"),
    }
    runs = {way: [] for way in ways}
    for way in ("step", "sequential", "addcmul", "addcmul", "sequential",
                "step"):
        patch, name = ways[way]
        with patch():
            prof = profile_kernels(step, 5)
        runs[way].append(kernel_ms(prof, name))
        busy = sum(ms for _, ms in prof["kernels"].values())
        log(f"{tag} serve_step scan in the step, {way} ({name}): "
            f"{_fmt(runs[way][-1])} ms per launch, {recorded(prof, name):g} "
            f"launches recorded a step, device busy {busy:.3f} ms a step")
    out = {way: (statistics.mean(t) if None not in t else None)
           for way, t in runs.items()}
    log(f"{tag} serve_step scan per launch (mean of 2): "
        + ", ".join(f"{way} {_fmt(ms)} ms" for way, ms in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _sdpa_flash(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def time_flash(cfg, sdpa_err: dict) -> dict:
    """The flash forward at the forward's shape in both of its variants at
    dh = 128: bf16 on the tensor cores (the forward path's) and f32 split-f32
    (the train path's), each against its bound: bf16 at 989 TFLOP/s; f32 as
    three TF32 products at 495 TFLOP/s, with the 67 TFLOP/s CUDA-core bound
    beside it. Beside each, SDPA: ``enable_gqa`` for bf16; for f32 the
    memory-efficient backend on K/V repeated to the q heads, and the fastest
    backend that takes ``enable_gqa`` (MATH), each with its error from
    ``sdpa_err`` (step 0). The f32 prep launch's device time apart."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    B, S, H, KV, D = FWD_B, FWD_S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        variant = ops.flash_variant(dt, D)
        names = (FLASH_TC,) if dt == torch.bfloat16 else (F32TC_FWD_PREP, F32TC_FWD)
        q = _randn(g, (B, S, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        got = ops.flash_attention(q, k, v)
        err = assert_close(got, ref.flash_attention_ref(q, k, v), TOL[dt],
                           f"time flash {dt}")
        if dt == torch.bfloat16:
            check_flash_rows(got, q, k, v, {}, f"time flash {dt}")
        del got
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
        prof = profile_kernels(lambda: ops.flash_attention(q, k, v))
        dev_ms = kernel_ms(prof, *names)
        prep_ms = kernel_ms(prof, F32TC_FWD_PREP) if dt == torch.float32 else None
        flops = 4 * B * H * (S * (S + 1) // 2) * D   # kept (q, k) pairs, causal
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (flops / PEAK_FLOPS[dt] if dt == torch.bfloat16
                 else 3 * flops / TF32_FLOPS)
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        cc_bound_ms = max(flops / PEAK_FLOPS[torch.float32], t_bytes) * 1e3
        lib_ms = lib_math_ms = lib_backend = None
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if dt == torch.bfloat16:
            lib_ms = cuda_ms(lambda: _sdpa_flash(qt, kt, vt))
            libs = f", sdpa(enable_gqa) {lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f})"
        else:
            lib_ms = time_sdpa_expanded(qt, kt, vt, None, "f32 forward")
            lib_math_ms, lib_backend = time_sdpa(
                lambda: (lambda: _sdpa_flash(qt, kt, vt)), "f32 forward")
            libs = (f", sdpa on K/V repeated (EFFICIENT_ATTENTION) {_fmt(lib_ms)} ms"
                    f" (kernel/sdpa {_fmt(lib_ms and ms / lib_ms)}, its error "
                    f"{_fmt_err(sdpa_err.get('forward'))}), sdpa(enable_gqa, "
                    f"{lib_backend}) {lib_math_ms:.4f} ms")
        del qt, kt, vt
        log(f"time flash {str(dt)[6:]} ({variant}, {', '.join(names)}) "
            f"[{B},{S},{H},{D}] kv {KV} causal: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of "
            f"the bound), plain {plain_ms:.4f} ms{libs}, bound "
            f"{bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP"
            + (f" at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s" if dt == torch.bfloat16
               else f" x 3 TF32 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s; "
                    f"CUDA-core bound {cc_bound_ms * 1e3:.2f} us at "
                    f"{PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s")
            + f", {nbytes / 1e6:.2f} MB); kernel device time {_fmt(dev_ms)} ms"
            + (f" ({flops / dev_ms / 1e9:.1f} TFLOP/s, "
               f"{_share(bound_ms, dev_ms)} of the bound"
               + (f", {_share(cc_bound_ms, dev_ms)} of the CUDA-core bound"
                  if dt == torch.float32 else "") + ")" if dev_ms else "")
            + (f", of which prep {_fmt(prep_ms)} ms" if dt == torch.float32 else ""))
        res[dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_math_ms=lib_math_ms,
                       library_backend=lib_backend, bound_ms=bound_ms,
                       bound_by=by, cc_bound_ms=cc_bound_ms, device_ms=dev_ms,
                       prep_device_ms=prep_ms)
        del q, k, v
    out = res[torch.bfloat16]
    f32 = res[torch.float32]
    out.update(f32_source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
               f32_variant=ops.flash_variant(torch.float32, D),
               f32_ms=f32["ms"], f32_device_ms=f32["device_ms"],
               f32_prep_device_ms=f32["prep_device_ms"],
               f32_bound_ms=f32["bound_ms"], f32_bound_by=f32["bound_by"],
               f32_cuda_core_bound_ms=f32["cc_bound_ms"],
               f32_plain_ms=f32["plain_ms"],
               f32_library_ms=f32["library_ms"],
               f32_library_call="EFFICIENT_ATTENTION on K/V repeated to the q heads",
               f32_library_max_abs_err=sdpa_err.get("forward"),
               f32_library_math_ms=f32["library_math_ms"],
               f32_library_math_backend=f32["library_backend"],
               max_abs_err=max(out["max_abs_err"], f32["max_abs_err"]))
    return out


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def time_sdpa(make_fn, tag: str) -> tuple:
    """(ms, backend) of the fastest SDPA backend that takes the inputs of
    ``make_fn()``'s call, each backend alone (``sdpa_kernel``), with
    ``make_fn`` run inside the backend's context (so a backward follows its
    own forward). A yardstick only: a backend that refuses the inputs is
    logged and skipped; the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    best, seen = (None, None), []
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                fn = make_fn()
                fn()
                sync()
            except RuntimeError as e:   # the library's "no kernel for this"
                seen.append(f"{name} refused ({str(e).splitlines()[0][:60]})")
                continue
            ms = cuda_ms(fn, iters=10)
        seen.append(f"{name} {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, name)
    log(f"time sdpa {tag}: " + "; ".join(seen))
    check(best[0] is not None, f"sdpa {tag}: no backend took the inputs")
    return best


def time_sdpa_expanded(qt, kt, vt, dout, tag: str):
    """ms of memory-efficient SDPA on K/V repeated to q's heads (the repeat
    made outside the timed call): f32 SDPA's fused kernel, which refuses
    GQA, so not the same inputs as the kernel's. The forward alone, or its
    backward when ``dout`` is given. None (logged) if the backend refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = qt.shape[1] // kt.shape[1]
    ke, ve = (t.detach().repeat_interleave(rep, dim=1).requires_grad_(
        dout is not None) for t in (kt, vt))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        try:
            o = F.scaled_dot_product_attention(qt, ke, ve, is_causal=True)
        except RuntimeError as e:   # the library's "no kernel for this"
            log(f"time sdpa {tag}, K/V repeated: EFFICIENT_ATTENTION refused "
                f"({str(e).splitlines()[0][:60]})")
            return None
        if dout is None:
            fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, ke, ve, is_causal=True)
        else:
            fn = lambda: torch.autograd.grad(  # noqa: E731
                o, (qt, ke, ve), dout, retain_graph=True)
        ms = cuda_ms(fn, iters=10)
    log(f"time sdpa {tag}, K/V repeated to the q heads: EFFICIENT_ATTENTION "
        f"{ms:.4f} ms")
    return ms


def time_flash_backward(cfg, sdpa_err: dict) -> dict:
    """The f32 backward (split-f32, the train path's) at the train step's
    shape (causal, GQA), its plain version, SDPA's backward (memory-efficient
    on K/V repeated to the q heads, with its step-0 error, and the fastest
    backend that takes ``enable_gqa``) and its bound: five products of the
    kept pairs (S recomputed, dP, dq, dk, dv), three TF32 products each at
    495 TFLOP/s (the 67 TFLOP/s CUDA-core bound beside it), or q, k, v, o,
    dO, lse read and dq, dk, dv written once at the HBM rate."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    B, S, H, KV, D = FWD_B, FWD_S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = torch.float32
    q = _randn(g, (B, S, H, D), dt)
    k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
    dout = _randn(g, (B, S, H, D), dt)
    out, lse = ops.flash_attention_forward(q, k, v, True, None, None, want_lse=True)

    def fn():
        return ops.flash_attention_backward(q, k, v, out, lse, dout)
    err = max(max_err(a, b) for a, b in zip(
        fn(), ref.flash_attention_backward_ref(q, k, v, out, lse, dout)))
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(lambda: ref.flash_attention_backward_ref(
        q, k, v, out, lse, dout), iters=5)
    prof = profile_kernels(fn)
    dev_ms = kernel_ms(prof, *F32TC_BWD)
    by_kernel = {n: kernel_ms(prof, n) for n in F32TC_BWD}
    pairs = B * H * (S * (S + 1) // 2)
    flops = 10 * pairs * D
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel() + lse.numel()) * 4
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    cc_bound_ms = max(flops / PEAK_FLOPS[dt], t_bytes) * 1e3
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()

    def sdpa_backward():
        o = _sdpa_flash(qt, kt, vt)
        return lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                           retain_graph=True)
    math_ms, math_backend = time_sdpa(sdpa_backward, "f32 backward")
    lib_ms = time_sdpa_expanded(qt, kt, vt, dot, "f32 backward")
    del qt, kt, vt, dot
    log(f"time flash backward f32 ({ops.flash_variant(dt, D)}, "
        f"flash_attention_f32tc.cu) [{B},{S},{H},{D}] kv {KV} causal: kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
        f"of the bound), plain {plain_ms:.4f} ms, sdpa backward on K/V repeated "
        f"(EFFICIENT_ATTENTION) {_fmt(lib_ms)} ms (kernel/sdpa "
        f"{_fmt(lib_ms and ms / lib_ms)}, its error relative to max "
        f"{_fmt_err(sdpa_err.get('backward'))}), sdpa backward (enable_gqa, "
        f"{math_backend}) {math_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({by}: {flops / 1e9:.2f} GFLOP x 3 TF32 products at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB; CUDA-core "
        f"bound {cc_bound_ms * 1e3:.2f} us at {PEAK_FLOPS[dt] / 1e12:.0f} "
        f"TFLOP/s); kernel device time {_fmt(dev_ms)} ms ("
        + ", ".join(f"{n} {_fmt(t)}" for n, t in by_kernel.items())
        + f"), {_share(bound_ms, dev_ms)} of the bound, "
        f"{_share(cc_bound_ms, dev_ms)} of the CUDA-core bound; max_abs_err "
        f"{err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_call="EFFICIENT_ATTENTION on K/V repeated to the q heads",
                library_max_err_to_max=sdpa_err.get("backward"),
                library_math_ms=math_ms, library_math_backend=math_backend,
                bound_ms=bound_ms, bound_by=by, cuda_core_bound_ms=cc_bound_ms,
                device_ms=dev_ms, device_ms_by_kernel=by_kernel)


def _fmt_err(x) -> str:
    return "not measured" if x is None else f"{x:.3e}"


def _sdpa_mask(Sq, Sk, causal, window):
    """SDPA's boolean attn_mask (True = kept) for the kernels' mask rule."""
    if not causal:
        return None
    qpos = torch.arange(Sq, device=DEVICE)[:, None]
    kpos = torch.arange(Sk, device=DEVICE)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def sdpa_accuracy() -> dict:
    """Step 0: the error of memory-efficient SDPA (split-f32 products on the
    tensor cores, CUTLASS's OpMultiplyAddFastF32) on K/V repeated to the q
    heads, against the plain versions, at phase 2's f32 cases with D <= 128
    (SDPA has no softcap: those are skipped). The forward's max abs error
    (rtol = atol = 2e-5 as phase 2), the backward's largest gradient error
    relative to that gradient's max (2e-5). Logged, not checked: a yardstick
    of what 3xTF32 gives at these shapes, the evidence the split-f32 route
    rests on. {"forward": err, "backward": err, "within": bool}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    tol = TOL[torch.float32]
    fwd = [(B, S, S, H, KV, D, c, w, cap) for B, S, H, KV, D, dt, c, w, cap
           in FLASH_CASES if dt == torch.float32 and D <= 128]
    bwd = [case for case in BWD_CASES if case[5] <= 128]
    worst = {"forward": None, "backward": None}   # None: no case measured
    within = True
    for kind, cases in (("forward", fwd), ("backward", bwd)):
        for case in cases:
            B, Sq, Sk, H, KV, D, causal, window, softcap = case
            if softcap is not None:
                log(f"step 0 sdpa {kind} {case}: skipped (SDPA has no softcap)")
                continue
            q = _randn(g, (B, Sq, H, D), torch.float32)
            k, v = (_randn(g, (B, Sk, KV, D), torch.float32) for _ in range(2))
            dout = _randn(g, (B, Sq, H, D), torch.float32)
            kw = dict(causal=causal, window=window, softcap=None)
            mask = _sdpa_mask(Sq, Sk, causal, window)
            rep = H // KV
            qt = q.transpose(1, 2).contiguous().requires_grad_(kind == "backward")
            ke, ve = (t.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
                      .requires_grad_(kind == "backward") for t in (k, v))
            try:
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]), \
                        torch.set_grad_enabled(kind == "backward"):
                    o = F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask)
                    if kind == "backward":
                        grads = torch.autograd.grad(o, (qt, ke, ve),
                                                    dout.transpose(1, 2))
            except RuntimeError as e:   # the library's "no kernel for this"
                log(f"step 0 sdpa {kind} {case}: EFFICIENT_ATTENTION refused "
                    f"({str(e).splitlines()[0][:60]})")
                continue
            want_o = ref.flash_attention_ref(q, k, v, **kw)
            if kind == "forward":
                got = o.detach().transpose(1, 2)
                err = max_err(got, want_o)
                ok = bool(torch.allclose(got, want_o, rtol=tol, atol=tol))
            else:
                lse = ref.flash_attention_lse_ref(q, k, **kw)
                want = ref.flash_attention_backward_ref(q, k, v, want_o, lse,
                                                        dout, **kw)
                dq = grads[0].transpose(1, 2)
                dk, dv = (x.reshape(B, KV, rep, Sk, D).sum(2).transpose(1, 2)
                          for x in grads[1:])
                errs = []
                ok = True
                for a, b in zip((dq, dk, dv), want):
                    scale = b.abs().max().clamp_min(1e-30)
                    errs.append(max_err(a, b) / scale.item())
                    ok &= bool(torch.allclose(a / scale, b / scale, rtol=tol,
                                              atol=tol))
                err = max(errs)
            worst[kind] = max(worst[kind] or 0.0, err)
            within &= ok
            log(f"step 0 sdpa {kind} (EFFICIENT_ATTENTION, K/V repeated) "
                f"{case}: {'max_abs_err' if kind == 'forward' else 'error relative to max'} "
                f"{err:.3e}, {'within' if ok else 'OUTSIDE'} rtol=atol {tol}")
            del q, k, v, dout, qt, ke, ve, o
    log(f"step 0: memory-efficient SDPA (3xTF32) worst forward max_abs_err "
        f"{_fmt_err(worst['forward'])}, worst backward error relative to max "
        f"{_fmt_err(worst['backward'])}; "
        f"{'all measured within' if within else 'NOT all within'} {tol}")
    return {**worst, "within": within}


def make_flush(kind: str = "write"):
    """A call that moves 256 MB through the 50 MB L2, so that the next
    kernel's reads start cold. "write" (the flush of the earlier timings)
    leaves the L2 full of dirty lines, whose write-back then falls in the
    next kernel's time;
    "read" leaves it full of clean lines, as the serve step's weight reads
    do before an attention or scan kernel."""
    scratch = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)
    return scratch.zero_ if kind == "write" else scratch.sum


def _clean_l2_times(fn, names) -> tuple:
    """Event and device ms of fn() after a read flush (``make_flush``)."""
    flush = make_flush("read")
    ms = cuda_ms(fn, flush=flush)
    return ms, kernel_ms(profile_kernels(lambda: (flush(), fn())), *names)


def _share(bound_ms, ms) -> str:
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.1f}%"


def time_decode(q, k, v, lengths, tag: str) -> dict:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    mask = (torch.arange(S, device=DEVICE)[None, :] < lengths[:, None].long()
            )[:, None, None, :]                                   # [B,1,1,S]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    flush = make_flush()
    err = max_err(ops.decode_attention(q, k, v, lengths),
                  ref.decode_attention_ref(q, k, v, lengths))
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, lengths), flush=flush)
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, lengths),
                       flush=flush)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    names = DEVICE_KERNELS["decode_attention"][0][0]
    dev_ms = kernel_ms(profile_kernels(lambda: (flush(), ops.decode_attention(
        q, k, v, lengths))), *names)
    clean_ms, clean_dev = _clean_l2_times(
        lambda: ops.decode_attention(q, k, v, lengths), names)
    valid = lengths.clamp(max=S).sum().item()
    nbytes = (2 * valid * KV * D + 2 * q.numel()) * q.element_size() \
        + lengths.numel() * 4
    flops = 4 * valid * (H // KV) * KV * D
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    n_split = ops.decode_grid(B, KV, S, ops.sm_count(0))
    log(f"time decode {tag} {str(q.dtype)[6:]} B={B} S={S} H={H} KV={KV} D={D} "
        f"valid keys {valid}, cluster {n_split}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa(mask, enable_gqa) {lib_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.3f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound); after a read flush "
        f"(clean L2): kernel {clean_ms:.4f} ms ({_share(bound_ms, clean_ms)}), "
        f"device {_fmt(clean_dev)} ms ({_share(bound_ms, clean_dev)})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms,
                clean_l2_ms=clean_ms, clean_l2_device_ms=clean_dev)


def time_scan(a, b, h0, tag: str, cold: bool) -> dict:
    """The scan kernel at one shape, its plain loop and its bound (bytes:
    a and b read, h written, h0 read; 2 flops an element). No single PyTorch
    call computes a linear recurrence (S > 1), so there the library time is
    None; one step with h0 (S = 1) is ``torch.addcmul`` (``_scan_addcmul``),
    timed as the kernel is."""
    flush = make_flush() if cold else None
    B, S, DI, DS = a.shape
    variant = ops.scan_variant(a, b, h0)
    err = max_err(ops.selective_scan(a, b, h0), ref.selective_scan_ref(a, b, h0))
    ms = cuda_ms(lambda: ops.selective_scan(a, b, h0), flush=flush)
    plain_ms = cuda_ms(lambda: ref.selective_scan_ref(a, b, h0), iters=5,
                       flush=flush)
    prof = profile_kernels(lambda: (flush and flush(),
                                    ops.selective_scan(a, b, h0)), iters=20)
    dev_ms = kernel_ms(prof, SCAN_KERNEL[variant])
    clean_ms, clean_dev = (_clean_l2_times(lambda: ops.selective_scan(a, b, h0),
                                           (SCAN_KERNEL[variant],))
                           if cold else (None, None))
    lib = (lambda: _scan_addcmul(a, b, h0)) if S == 1 and h0 is not None \
        else None
    lib_ms = lib_dev = lib_clean_dev = None
    if lib is not None:
        lib_ms = cuda_ms(lib, flush=flush)
        lib_dev = kernel_ms(profile_kernels(lambda: (flush and flush(), lib()),
                                            iters=20), "addcmul")
        if cold:
            _, lib_clean_dev = _clean_l2_times(lib, ("addcmul",))
    if dev_ms is None:
        log(f"time scan {tag}: the profiler recorded no scan launch; it saw "
            f"{sorted(k[:60] for k in prof['kernels'])[:6]}")
    n = a.numel()
    nbytes = (3 * n + (0 if h0 is None else h0.numel())) * 4
    flops = 2 * n
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time scan {tag} f32 [{B},{S},{DI},{DS}] h0={h0 is not None}"
        f"{' cold L2' if cold else ''} ({variant}, {SCAN_KERNEL[variant]}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        + ("none" if lib is None else
           f"addcmul {lib_ms:.4f} ms (device {_fmt(lib_dev)} ms"
           + (f", after a read flush {_fmt(lib_clean_dev)} ms" if cold else "")
           + ")")
        + ", bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound)"
        + (f"; after a read flush (clean L2): kernel {clean_ms:.4f} ms "
           f"({_share(bound_ms, clean_ms)}), device {_fmt(clean_dev)} ms "
           f"({_share(bound_ms, clean_dev)})" if cold else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev,
                library_clean_l2_device_ms=lib_clean_dev,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms,
                variant=variant, clean_l2_ms=clean_ms,
                clean_l2_device_ms=clean_dev)


def time_scan_backward(a, h, dh, tag: str) -> dict:
    """The scan's backward kernel at one shape (no h0, as on the train path),
    its plain reverse loop and its bound (bytes: a, h and dh read, da and db
    written; 3 flops an element). No PyTorch call computes a reverse linear
    recurrence, so there is no library time."""
    B, S, DI, DS = a.shape
    fn = lambda: ops.selective_scan_backward(a, h, None, dh)  # noqa: E731
    plain = lambda: ref.selective_scan_backward_ref(a, h, None, dh)  # noqa: E731
    err = max(max_err(x, y) for x, y in zip(fn()[:2], plain()[:2]))
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    dev_ms = kernel_ms(profile_kernels(fn, iters=20), SCAN_BWD)
    n = a.numel()
    nbytes = 5 * n * 4
    t_ops = 3 * n / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time scan backward {tag} f32 [{B},{S},{DI},{DS}] ({SCAN_BWD}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none (no "
        f"PyTorch call computes a reverse linear recurrence), bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound); max_abs_err {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms)


# gemma2-9b's attention shape for the f32 CUDA-core flash pair (dh = 256):
# (B, S, H, KV, D, softcap), causal; 4096-key window of its local layers
# has no effect at S = 2048
D256_SHAPE = (2, 2048, 16, 8, 256, 50.0)


def time_flash_cuda_core() -> dict:
    """The f32 flash pair at dh = 256 (``ops.flash_variant``: the CUDA-core
    ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``), off
    the main paths, at ``D256_SHAPE``: event and device time, the plain
    versions, the bound (operations at the 67 TFLOP/s f32 CUDA-core rate:
    4 flops a kept (q, k) pair and dim forward, 10 backward; or bytes) and
    memory-efficient SDPA on K/V repeated to the q heads, without the
    softcap (SDPA has none). {"forward": row, "backward": row}."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    B, S, H, KV, D, softcap = D256_SHAPE
    dt = torch.float32
    check(ops.flash_variant(dt, D) == "cuda_core", "dh 256 is not cuda_core")
    q = _randn(g, (B, S, H, D), dt)
    k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
    dout = _randn(g, (B, S, H, D), dt)
    kw = dict(causal=True, window=None, softcap=softcap)
    out, lse = ops.flash_attention_forward(q, k, v, True, None, softcap,
                                           want_lse=True)
    pairs = B * H * (S * (S + 1) // 2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    res = {}
    for kind in ("forward", "backward"):
        if kind == "forward":
            fn = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
            plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
            names, flops = (FLASH_CC,), 4 * pairs * D
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
            got, want = (fn(),), (plain(),)
        else:
            fn = lambda: ops.flash_attention_backward(  # noqa: E731
                q, k, v, out, lse, dout, **kw)
            plain = lambda: ref.flash_attention_backward_ref(  # noqa: E731
                q, k, v, out, lse, dout, **kw)
            names, flops = FLASH_BWD, 10 * pairs * D
            nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()
                      + lse.numel()) * 4
            got, want = fn(), plain()
        err = max(max_err(x, y) for x, y in zip(got, want))
        del got, want
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        dev_ms = kernel_ms(profile_kernels(fn), *names)
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        grad_in = [t.detach().requires_grad_(kind == "backward")
                   for t in (qt, kt, vt)]
        lib_ms = time_sdpa_expanded(*grad_in, dot if kind == "backward"
                                    else None, f"f32 dh 256 {kind}")
        log(f"time flash {kind} f32 (cuda_core, {', '.join(names)}) "
            f"[{B},{S},{H},{D}] kv {KV} causal softcap {softcap}: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa on K/V repeated (EFFICIENT_ATTENTION, "
            f"no softcap) "
            + ("refused" if lib_ms is None else
               f"{lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f})")
            + f", bound {bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP "
            f"at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB); "
            f"kernel device time {_fmt(dev_ms)} ms "
            f"({_share(bound_ms, dev_ms)} of the bound); max_abs_err {err:.3e}")
        res[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         device_ms=dev_ms)
    return res


# ---------------------------------------------------------------------------
# phase 6 / 6b, 7 / 7b: training at full width, f32; the LOG.io-protected runs
# ---------------------------------------------------------------------------


def _train_batch(cfg, g):
    toks = torch.randint(0, cfg.vocab, (1, FWD_B, FWD_S + 1), generator=g,
                         device=DEVICE)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:].to(torch.int32)}


def _fresh_state(cfg, hp):
    return init_train_state(torch.Generator(device=DEVICE).manual_seed(SEED),
                            cfg, hp, torch.float32, DEVICE)


# The train path of each family: the wrappers it counts (forward, backward),
# the device kernels each counted launch must be recorded as (every one of
# them n_layers times a step) and those of another variant that must not run.
TRAIN_PATHS = {
    "attention": dict(wrappers=("flash_attention", "flash_attention_backward"),
                      forward=(F32TC_FWD_PREP, F32TC_FWD), backward=F32TC_BWD,
                      others=(FLASH_TC, FLASH_CC, *FLASH_BWD)),
    "scan": dict(wrappers=("selective_scan", "selective_scan_backward"),
                 forward=(SCAN_KERNEL["sequential"],), backward=(SCAN_BWD,),
                 others=(SCAN_KERNEL["step"],)),
}


def mamba_train_memory(cfg, depth: int, tokens: int) -> float:
    """Phase 7's peak device memory in GB, reckoned from the code: f32
    params, grads, m and v (16 bytes a param); per layer the two [N, DI, DS]
    f32 tensors autograd keeps (a, saved by ``exp``; h, saved by the
    ``h.C`` einsum and by ``ops.SelectiveScan``) and about a dozen [N, DI]
    ones; the logits and their loss (three [N, V]); the backward's
    [N, DI, DS] transients (dh, da, db, exp's gradient)."""
    one, two = (dataclasses.replace(cfg, n_layers=n).param_count()
                for n in (1, 2))
    per_layer = two - one
    state = 16 * (one - per_layer + depth * per_layer)
    big = tokens * cfg.d_inner * cfg.mamba.d_state * 4
    acts = depth * (2 * big + 12 * tokens * cfg.d_inner * 4)
    logits = 3 * tokens * cfg.eff_vocab * 4
    return (state + acts + logits + 4 * big) / 1e9


def phase_train(cfg, path: str, tag: str, reckoned_gb=None) -> dict:
    """``make_train_step`` at full width in f32 (``cfg.n_layers`` deep),
    tokens [1, 2, 2048], under the training's deterministic mode: the
    launches of ``TRAIN_PATHS[path]`` (counted and recorded), first loss,
    step time and breakdown with the kernel pair's share, bitwise repeat,
    peak memory (beside ``reckoned_gb`` where given) and the grads at depth
    GRAD_LAYERS against the plain path, and whether they are bitwise equal."""
    spec = TRAIN_PATHS[path]
    train_driver.deterministic(torch.device(DEVICE))
    hp = OptHParams()
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    step = make_train_step(cfg, hp)
    tag = f"{tag} {cfg.name} f32 [1,{FWD_B},{FWD_S}]"
    tokens = FWD_B * FWD_S
    state = _fresh_state(cfg, hp)
    n = sum(t.numel() for t in state["params"].parameters())
    log(f"{tag}: {cfg.n_layers} layers, {n / 1e9:.3f} B params; params + "
        f"grads + m + v {4 * n * 4 / 1e9:.1f} GB f32; AdamW {hp}")
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        first_s = time.perf_counter() - t0
    first = {k: ops.LAUNCHES[k] for k in spec["wrappers"]}
    check(first == {k: cfg.n_layers for k in spec["wrappers"]},
          f"{tag}: launches in one step {first}, want {cfg.n_layers} each")
    if path == "scan":   # S = 2048: every forward on the sequential kernel
        check(ops.SCAN_VARIANTS == {"step": 0, "sequential": cfg.n_layers},
              f"{tag}: scan launches by variant {ops.SCAN_VARIANTS}")
    nondet = [str(w.message)[:120] for w in caught
              if "determinis" in str(w.message).lower()]
    check(not nondet, f"{tag}: determinism warnings {nondet}")
    loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gn), f"{tag}: non-finite loss")
    check(abs(loss - math.log(cfg.vocab)) < 1.0,
          f"{tag}: first loss {loss:.4f} far from ln V {math.log(cfg.vocab):.4f}")
    log(f"{tag}: first step {first_s:.2f} s, loss {loss:.6f} (ln V "
        f"{math.log(cfg.vocab):.4f}), grad norm {gn:.4f}, launches {first}; "
        f"{len(caught)} warnings, none about determinism"
        + (f" (first: {str(caught[0].message)[:100]})" if caught else ""))
    host = [t.detach().to("cpu", copy=True) for t in state["params"].parameters()]
    times, losses = [], [loss]
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    step_ms = statistics.median(times)
    log(f"{tag}: steps {' / '.join(f'{x:.1f}' for x in times)} ms "
        f"({tokens / step_ms * 1e3:.0f} tok/s), losses {losses}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    prof = profile_kernels(lambda: step(state, batch), iters=1)
    log_breakdown(f"{tag} step", prof, step_ms, top=10)
    rec = {x: recorded(prof, x) for x in spec["forward"] + spec["backward"]}
    other = {x: recorded(prof, x) for x in spec["others"]}
    check(not any(other.values()), f"{tag}: launches of another variant {other}")
    check(all(x == cfg.n_layers for x in rec.values()),
          f"{tag}: recorded launches a step {rec}, want {cfg.n_layers} each")
    index = sorted({k[:50] for k in prof["kernels"] if "index" in k.lower()
                    or "sort" in k.lower()})
    fwd_ms = kernel_ms(prof, *spec["forward"])
    bwd_ms = kernel_ms(prof, *spec["backward"])
    busy = sum(ms for _, ms in prof["kernels"].values())
    pair = (cfg.n_layers * (fwd_ms + bwd_ms)
            if None not in (fwd_ms, bwd_ms) else None)
    log(f"{tag}: recorded a step {rec} (none of {list(other)}); the "
        f"embedding's backward ran {index}; {' + '.join(spec['wrappers'])}: "
        f"{cfg.n_layers} x ({_fmt(fwd_ms)} + {_fmt(bwd_ms)}) ms = "
        f"{_fmt(pair)} ms a step, "
        + ("not measured" if pair is None else
           f"{100 * pair / busy:.1f}% of device busy, "
           f"{100 * pair / step_ms:.1f}% of the step"))
    if busy:
        gemm = sum(ms for key, (_, ms) in prof["kernels"].items()
                   if "gemm" in key.lower() or "gemv" in key.lower())
        rest = busy - gemm - (pair or 0.0)
        log(f"{tag}: device busy {busy:.1f} ms a step by class: GEMMs and "
            f"GEMVs (cuBLAS, CUTLASS) {gemm:.1f} ms ({100 * gemm / busy:.1f}%)"
            f", the kernel pair {_fmt(pair)} ms, the rest (ATen elementwise, "
            f"reductions, copies, the embedding, AdamW) {rest:.1f} ms "
            f"({100 * rest / busy:.1f}%)")
    del state, metrics
    torch.cuda.empty_cache()
    log_memory(tag, reckoned_gb)
    # bitwise: the first step again from a fresh state of the same seed
    state = _fresh_state(cfg, hp)
    state, metrics = step(state, batch)
    sync()
    check(float(metrics["loss"]) == loss, f"{tag}: repeat loss differs")
    same = all(bool(torch.equal(a.detach().cpu(), b))
               for a, b in zip(state["params"].parameters(), host))
    check(same, f"{tag}: two steps from the same state differ")
    launches = {k: ops.LAUNCHES[k] for k in first}
    steps_run = 2 + TRAIN_STEPS + 2   # first, timed, profiled (2), repeat
    check(all(x == cfg.n_layers * steps_run for x in launches.values()),
          f"{tag}: launches {launches} over {steps_run} steps")
    log(f"{tag}: the repeated first step is bitwise equal (loss and all "
        f"{len(host)} param leaves); launches over the phase's {steps_run} "
        f"steps {launches}")
    del state, metrics, host
    torch.cuda.empty_cache()
    # the grads at full width, depth cut, against the plain path
    cfg2 = dataclasses.replace(cfg, n_layers=GRAD_LAYERS)
    params = M.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                           cfg2, torch.float32, DEVICE).requires_grad_(True)
    names = [name for name, _ in params.named_parameters()]
    leaves = list(params.parameters())
    mb = {"tokens": batch["tokens"][0], "labels": batch["labels"][0]}
    grads, secs = {}, {}
    for impl in ("kernel", "plain"):
        t0 = time.perf_counter()
        grads[impl] = torch.autograd.grad(
            loss_fn(params, mb, cfg2, runtime(impl))[0], leaves)
        sync()
        secs[impl] = time.perf_counter() - t0
    worst = max((assert_close_to_max(a, b, GRAD_TOL, f"{tag} grad {name}"), name)
                for name, a, b in zip(names, grads["kernel"], grads["plain"]))
    bitwise = all(bool(torch.equal(a, b))
                  for a, b in zip(grads["kernel"], grads["plain"]))
    log(f"{tag}: grads at depth {GRAD_LAYERS}, kernel vs plain path: worst "
        f"leaf {worst[1]} error {worst[0]:.3e} of its max (tol {GRAD_TOL}); "
        f"bitwise equal: {bitwise}; seconds kernel {secs['kernel']:.2f}, "
        f"plain {secs['plain']:.2f}")
    del params, grads, leaves
    torch.cuda.empty_cache()
    log_memory(f"{tag} grad check")
    return {"launches": launches, "steps": steps_run, "step_ms": step_ms,
            "fwd_device_ms": fwd_ms, "bwd_device_ms": bwd_ms,
            "grads_bitwise": bitwise}


def phase_logio(cfg, path: str) -> dict:
    """``run_training(arch=cfg.name, device="cuda")`` twice, as
    tests/test_train_e2e.py does: without kills, and with a worker kill (at
    batch 2) and a trainer kill (at step 7); losses and final state must be
    bit-identical, and each wrapper of ``TRAIN_PATHS[path]`` launched once
    per layer per step."""
    wrappers = TRAIN_PATHS[path]["wrappers"]
    red = reduced(cfg, d_model=LOGIO_RUN["d_model"],
                  n_layers=LOGIO_RUN["n_layers"], vocab=2048,
                  d_ff=4 * LOGIO_RUN["d_model"], n_heads=4)
    shape = (f"{red.n_heads} heads / {red.n_kv_heads} kv (dh {red.d_head}), "
             f"d_ff {red.d_ff}" if path == "attention" else
             f"d_inner {red.d_inner}, d_state {red.mamba.d_state}")
    log(f"logio {cfg.name}: cut to d_model {red.d_model}, {red.n_layers} "
        f"layers, {shape}, vocab {red.vocab} (a full-width checkpoint is "
        f"{12 * cfg.param_count() / 1e9:.1f} GB, written four times per pair "
        f"of runs); {LOGIO_RUN}")
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        a = train_driver.run_training(**LOGIO_RUN, arch=cfg.name,
                                      ckpt_dir=f"{tmp}/a", verbose=False,
                                      device=DEVICE)
        b = train_driver.run_training(**LOGIO_RUN, arch=cfg.name,
                                      ckpt_dir=f"{tmp}/b", verbose=False,
                                      device=DEVICE, kill_trainer_at=7,
                                      kill_worker_at=2)
    launches = {k: ops.LAUNCHES[k] for k in wrappers}
    check(b["losses"][:7] == a["losses"][:7], "logio: pre-crash losses differ")
    check(b["losses"][7:] == a["losses"][6:], "logio: replayed losses differ")
    check(b["engine"].failures >= 2, f"logio: {b['engine'].failures} failures")
    sa, sb = a["final_state"], b["final_state"]
    mods = [(sa["params"], sb["params"]), (sa["opt"]["m"], sb["opt"]["m"]),
            (sa["opt"]["v"], sb["opt"]["v"])]
    same = all(bool(torch.equal(x, y)) for ma, mb in mods
               for x, y in zip(ma.parameters(), mb.parameters()))
    check(same and int(sa["step"]) == int(sb["step"]),
          "logio: final states differ")
    n_steps = len(a["losses"]) + len(b["losses"])
    check(all(x == red.n_layers * n_steps for x in launches.values()),
          f"logio: launches {launches} over {n_steps} steps")
    log(f"logio {cfg.name}: {len(a['losses'])} + {len(b['losses'])} steps, "
        f"crash steps {b['crash_steps']}, pipeline failures "
        f"{b['engine'].failures} restarts {b['engine'].restarts}; losses and "
        f"final state bit-identical; launches {launches}; losses "
        f"{a['losses']}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg, mcfg = get_config(ARCH), get_config(MAMBA_ARCH)
    dev = phase_device()
    errs = phase_kernels()
    log_memory("kernels")
    # internlm2: flash (forward) and decode attention
    fwd = phase_forward(cfg, "flash_attention")
    serve = phase_serve(cfg, "decode_attention")
    sdpa_err = sdpa_accuracy()   # step 0 of the split-f32 route
    with torch.inference_mode():
        flash_t = time_flash(cfg, sdpa_err)
        q = torch.randn((SLOTS, cfg.n_heads, cfg.d_head), device=DEVICE)
        k, v = serve["cache"][0]["k"][0], serve["cache"][0]["v"][0]
        decode_t = time_decode(q, k, v, (serve["pos"] + 1).to(torch.int32),
                               tag="serve shape")
        full = torch.full((SLOTS,), MAX_LEN, device=DEVICE, dtype=torch.int32)
        decode_full = time_decode(q, torch.randn_like(k), torch.randn_like(v),
                                  full, tag="full cache")
        del q, k, v, serve["cache"]
    flash_bwd_t = time_flash_backward(cfg, sdpa_err)
    d256_t = time_flash_cuda_core()
    log_memory("attention timings")
    torch.cuda.empty_cache()
    # falcon-mamba: the selective scan, in forward and in each decode step
    fwd_m = phase_forward(mcfg, "selective_scan")
    serve_m = phase_serve(mcfg, "selective_scan")
    with torch.inference_mode():
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
        di, ds = mcfg.d_inner, mcfg.mamba.d_state
        a, b, _ = _scan_operands(g, FWD_B, FWD_S, di, ds, None)
        scan_t = time_scan(a, b, None, "forward shape", cold=False)
        a, b, _ = _scan_operands(g, SLOTS, 1, di, ds, None)
        scan_dec = time_scan(a, b, serve_m["cache"][0]["ssm"][0],
                             "decode shape", cold=True)
        del a, b, serve_m["cache"]
        # the backward at phase 7's shape, from the forward kernel's h
        a, b, _ = _scan_operands(g, FWD_B, FWD_S, di, ds, None)
        h = ops.selective_scan(a, b)
        del b
        dh = torch.randn(a.shape, generator=g, device=DEVICE)
        scan_bwd_t = time_scan_backward(a, h, dh, "train shape")
        del a, h, dh
    log_memory("scan timings")
    torch.cuda.empty_cache()
    # internlm2 training: the f32 flash kernel and its backward
    train = phase_train(cfg, "attention", "train-f32")
    logio = phase_logio(cfg, "attention")
    # falcon-mamba training: the scan kernel and its backward, depth cut
    mcfg_cut = dataclasses.replace(mcfg, n_layers=MAMBA_TRAIN_LAYERS)
    tokens = FWD_B * FWD_S
    reckoned = mamba_train_memory(mcfg, MAMBA_TRAIN_LAYERS, tokens)
    log(f"mamba-train-f32: depth cut to {MAMBA_TRAIN_LAYERS} of "
        f"{mcfg.n_layers} layers, for device memory: full depth is "
        f"{mcfg.param_count() / 1e9:.3f} B params, "
        f"{16 * mcfg.param_count() / 1e9:.1f} GB of f32 params, grads, m and "
        f"v; reckoned peak at depth {MAMBA_TRAIN_LAYERS} {reckoned:.1f} GB, at "
        f"depth {2 * MAMBA_TRAIN_LAYERS} "
        f"{mamba_train_memory(mcfg, 2 * MAMBA_TRAIN_LAYERS, tokens):.1f} GB "
        f"(card: {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}"
        f" GB)")
    mtrain = phase_train(mcfg_cut, "scan", "mamba-train-f32", reckoned)
    mlogio = phase_logio(mcfg, "scan")
    launches = {"flash_attention": fwd["launches"],
                "flash_attention_backward": train["launches"][
                    "flash_attention_backward"],
                "decode_attention": serve["launches"],
                "selective_scan": fwd_m["launches"] + serve_m["launches"]
                + mtrain["launches"]["selective_scan"],
                "selective_scan_backward": mtrain["launches"][
                    "selective_scan_backward"]}
    timed = {"flash_attention": flash_t,
             "flash_attention_backward": flash_bwd_t,
             "decode_attention": decode_t, "selective_scan": scan_t,
             "selective_scan_backward": scan_bwd_t}
    rows = []
    for name, meta in KERNELS.items():
        t = timed[name]
        rows.append({"name": name, **meta, "launches": launches[name],
                     "max_abs_err": max(errs[name], t["max_abs_err"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_us": t["bound_ms"] * 1e3,
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"]})
    # flash: the bf16 tensor-core variant above (the forward's); the f32
    # split-f32 one beside it, on the train path (phases 6 and 6b)
    flash_row = next(r for r in rows if r["name"] == "flash_attention")
    flash_row.update({key: val for key, val in flash_t.items()
                      if key.startswith("f32_")})
    flash_row.update(
        f32_launches_train=train["launches"]["flash_attention"],
        f32_launches_logio=logio["launches"]["flash_attention"],
        f32_device_ms_in_step=train["fwd_device_ms"],
        **{f"f32_d256_{key}": val for key, val in d256_t["forward"].items()},
        f32_d256_shape=list(D256_SHAPE),
        f32_d256_source="src/repro_torch/kernels/csrc/flash_attention.cu",
        f32_d256_library_call="EFFICIENT_ATTENTION on K/V repeated, no softcap")
    bwd_row = next(r for r in rows if r["name"] == "flash_attention_backward")
    bwd_row.update(
        launches_per_step=train["launches"]["flash_attention_backward"]
        // train["steps"],
        launches_logio=logio["launches"]["flash_attention_backward"],
        device_ms_by_kernel=flash_bwd_t["device_ms_by_kernel"],
        device_ms_in_step=train["bwd_device_ms"],
        train_step_ms=train["step_ms"],
        **{f"d256_{key}": val for key, val in d256_t["backward"].items()},
        d256_source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        **{key: flash_bwd_t[key] for key in (
            "library_call", "library_max_err_to_max", "library_math_ms",
            "library_math_backend", "cuda_core_bound_ms")})
    # decode attention: the serve shape above (the main path's), a full
    # cache beside it
    decode_row = next(r for r in rows if r["name"] == "decode_attention")
    decode_row.update(
        max_abs_err=max(decode_row["max_abs_err"], decode_full["max_abs_err"]),
        clean_l2_ms=decode_t["clean_l2_ms"],
        clean_l2_device_ms=decode_t["clean_l2_device_ms"],
        full_cache_ms=decode_full["ms"],
        full_cache_device_ms=decode_full["device_ms"],
        full_cache_bound_ms=decode_full["bound_ms"],
        full_cache_clean_l2_ms=decode_full["clean_l2_ms"],
        full_cache_clean_l2_device_ms=decode_full["clean_l2_device_ms"])
    # the scan runs on both paths: its forward-shape numbers above, the
    # decode step's (and the variant it ran) and the launches of each path
    scan_row = next(r for r in rows if r["name"] == "selective_scan")
    scan_row.update(
        launches_forward=fwd_m["launches"], launches_serve=serve_m["launches"],
        max_abs_err=max(scan_row["max_abs_err"], scan_dec["max_abs_err"]),
        variant=scan_t["variant"], decode_variant=scan_dec["variant"],
        decode_kernel=SCAN_KERNEL[scan_dec["variant"]],
        decode_ms=scan_dec["ms"], decode_plain_ms=scan_dec["plain_ms"],
        decode_bound_ms=scan_dec["bound_ms"],
        decode_device_ms=scan_dec["device_ms"],
        decode_clean_l2_ms=scan_dec["clean_l2_ms"],
        decode_clean_l2_device_ms=scan_dec["clean_l2_device_ms"],
        decode_library_ms=scan_dec["library_ms"],
        decode_library_device_ms=scan_dec["library_device_ms"],
        decode_library_clean_l2_device_ms=scan_dec[
            "library_clean_l2_device_ms"],
        decode_in_serve_step_device_ms=serve_m["scan_in_step"],
        launches_train=mtrain["launches"]["selective_scan"],
        launches_train_logio=mlogio["launches"]["selective_scan"],
        device_ms_in_train_step=mtrain["fwd_device_ms"])
    scan_bwd_row = next(r for r in rows if r["name"] == "selective_scan_backward")
    scan_bwd_row.update(
        launches_per_step=mtrain["launches"]["selective_scan_backward"]
        // mtrain["steps"],
        launches_logio=mlogio["launches"]["selective_scan_backward"],
        device_ms_in_step=mtrain["bwd_device_ms"],
        train_step_ms=mtrain["step_ms"],
        train_depth=MAMBA_TRAIN_LAYERS,
        grads_bitwise_equal_to_plain=mtrain["grads_bitwise"],
        library_note="none: no PyTorch call computes a reverse linear "
                     "recurrence")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {dev['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
