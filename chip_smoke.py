#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Model: internlm2-1.8b at full width (24 layers, d=2048, 16 heads, 8 kv
heads, dh=128, d_ff=8192, V=92544), random weights from a seed. Phases:

1. device: name, power limit, kernel build (nvcc, sm_90a) and its seconds;
2. each CUDA kernel, launched directly, against its plain PyTorch version
   on the card (tolerance 2e-5 for f32, 2e-2 for bf16, as the JAX package's
   kernel tests use);
3. ``forward`` in bf16 on tokens [2, 2048] with the flash kernel against the
   plain path, and the flash launch count (one per layer);
4. ``SlotServer`` with f32 weights and its f32 cache (4 slots, max_len 4096,
   8 requests x 64 tokens) through the decode kernel: every request gets its
   tokens, a lockstep kernel/plain ``serve_step`` run holds the logits, the
   greedy streams agree, and the decode launch count is n_layers x steps;
5. timings (CUDA-event medians) of each kernel, its plain version and one
   PyTorch library call at the shapes of phases 3-4, with the kernel's bound.

f32 products run in full f32 (``allow_tf32`` off for matmul and cuDNN).
Any failure raises and exits non-zero; nothing is turned into success. The
last line is ``{"ok": true, "device": {...}}``. Needs one card; exits
non-zero without one, or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import SlotServer, serve_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SEED = 0
DEVICE = "cuda"   # the phases take their device from here
ARCH = "internlm2-1.8b"
FWD_B, FWD_S = 2, 2048
SLOTS, MAX_LEN, REQUESTS, TOKENS = 4, 4096, 8, 64

KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:79"),
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
    {name: (launches recorded / iters, ms recorded / iters)}. Empty when the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = _dev_time_us(ev)
            if t > 0:
                out[ev.key] = (ev.count / iters, t / iters / 1e3)
    return out


def kernel_ms(prof: dict, *names: str):
    """Device ms per launch, summed over the kernels whose names contain one
    of names (each launched once per call); per launch recorded, so a launch
    the profiler dropped does not dilute it."""
    hits = [ms / n for key, (n, ms) in prof.items()
            if n and any(x in key for x in names)]
    return sum(hits) if hits else None


def log_breakdown(tag: str, prof: dict, wall_ms: float, top: int = 6) -> None:
    """Device busy time against host wall time per call, and the top kernels."""
    if not prof:
        log(f"breakdown {tag}: profiler saw no device time (not measured)")
        return
    busy = sum(ms for _, ms in prof.values())
    log(f"breakdown {tag}: wall {wall_ms:.3f} ms/call, device busy "
        f"{busy:.3f} ms/call ({100 * busy / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy / wall_ms):.1f}%)")
    for key, (n, ms) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {100 * ms / busy:5.1f}% {ms:8.4f} ms x{n:g} {key[:90]}")


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
    log(f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} registers, "
        f"{sum(1 for x in spills if x)} with spills (max {max(spills, default=0)}"
        f" bytes)")
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
]


def phase_kernels() -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
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
        log(f"decode B={B} S={S} H={H} KV={KV} D={D} {str(dt)[6:]} "
            f"window={window} softcap={softcap} lengths={lengths.tolist()}: "
            f"max_abs_err {err:.3e} (tol {TOL[dt]})")
    for B, S, H, KV, D, dt, causal, window, softcap in FLASH_CASES:
        q = _randn(g, (B, S, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = ops.flash_attention(q, k, v, **kw)
        sync()
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = assert_close(out, want, TOL[dt], f"flash {B,S,H,KV,D,dt,causal}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"flash B={B} S={S} H={H} KV={KV} D={D} {str(dt)[6:]} causal={causal} "
            f"window={window} softcap={softcap}: max_abs_err {err:.3e} "
            f"(tol {TOL[dt]})")
    return errs


# ---------------------------------------------------------------------------
# phase 3: forward at full width, bf16
# ---------------------------------------------------------------------------


def phase_forward(cfg) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = M.init_params(g, cfg, torch.bfloat16, DEVICE)
    tokens = torch.randint(0, cfg.vocab, (FWD_B, FWD_S), generator=g,
                           device=DEVICE)
    batch = {"tokens": tokens}
    with torch.inference_mode():
        ops.reset_launches()
        logits_k, _ = M.forward(params, batch, cfg, M.Runtime("kernel"))
        sync()
        launches = ops.LAUNCHES["flash_attention"]
        logits_p, _ = M.forward(params, batch, cfg, M.Runtime("plain"))
        sync()
    check(launches == cfg.n_layers,
          f"flash launches {launches} != n_layers {cfg.n_layers}")
    check(tuple(logits_k.shape) == (FWD_B, FWD_S, cfg.vocab), "logits shape")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    # bf16 activations round at every one of the 24 layers, so two bf16 paths
    # that differ only in attention's summation order drift apart by about
    # what bf16 itself costs. The stated tolerance is relative to that cost:
    # against an f32 forward of the same weights (the plain path in full f32),
    # the kernel path's max and mean errors may be at most 2x and 1.25x the
    # plain bf16 path's.
    with torch.inference_mode():
        p32 = copy.deepcopy(params).float()
        logits_r, _ = M.forward(p32, batch, cfg, M.Runtime("plain"))
        del p32
    e_k, e_p = max_err(logits_k, logits_r), max_err(logits_p, logits_r)
    m_k = (logits_k - logits_r).abs().mean().item()
    m_p = (logits_p - logits_r).abs().mean().item()
    top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"forward bf16 [{FWD_B},{FWD_S}]: flash launches {launches}; vs f32 "
        f"forward: kernel max {e_k:.3e} mean {m_k:.3e}, plain max {e_p:.3e} "
        f"mean {m_p:.3e}; kernel vs plain max {max_err(logits_k, logits_p):.3e}"
        f", max|logit| {logits_r.abs().max().item():.3f}, top-1 agreement "
        f"{top1:.4f}")
    check(e_k <= 2 * e_p and m_k <= 1.25 * m_p,
          "forward logits: the kernel path is less accurate than the plain "
          "path beyond the stated tolerance")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                           M.Runtime("kernel")), iters=5,
                         warmup=1)
        fwd_plain_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                                 M.Runtime("plain")), iters=3,
                               warmup=1)
        log_breakdown("forward kernel", profile_kernels(
            lambda: M.forward(params, batch, cfg, M.Runtime("kernel")), 2),
            fwd_ms)
    log(f"forward bf16 [{FWD_B},{FWD_S}]: kernel {fwd_ms:.2f} ms "
        f"({FWD_B * FWD_S / fwd_ms * 1e3:.0f} tok/s), plain path "
        f"{fwd_plain_ms:.2f} ms ({FWD_B * FWD_S / fwd_plain_ms * 1e3:.0f} tok/s)")
    del params, logits_k, logits_p, logits_r
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 4: serving at full width, f32
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


def phase_serve(cfg) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = M.init_params(g, cfg, torch.float32, DEVICE)
    tol = TOL[torch.float32]
    with torch.inference_mode():
        # (a) lockstep: the same tokens into both paths at every step
        caches = {impl: M.init_cache(cfg, SLOTS, MAX_LEN, torch.float32, DEVICE)
                  for impl in ("kernel", "plain")}
        tokens = torch.arange(2, 2 + SLOTS, device=DEVICE, dtype=torch.int32)
        worst = 0.0
        for t in range(TOKENS):
            pos = torch.full((SLOTS,), t, device=DEVICE, dtype=torch.int32)
            nk, lk, _ = serve_step(params, caches["kernel"], tokens, pos,
                                   cfg=cfg, rt=M.Runtime("kernel"))
            _, lp, _ = serve_step(params, caches["plain"], tokens, pos,
                                  cfg=cfg, rt=M.Runtime("plain"))
            worst = max(worst, assert_close(lk, lp, tol, f"lockstep step {t}"))
            tokens = nk
        log(f"serve lockstep {TOKENS} steps x {SLOTS} slots: "
            f"max|dlogit| {worst:.3e} (tol {tol})")
        lock_q = torch.randn((SLOTS, cfg.n_heads, cfg.d_head), device=DEVICE)
        lock_lengths = (pos + 1).to(torch.int32)
        decode_shape = (lock_q, caches["kernel"][0]["k"][0],
                        caches["kernel"][0]["v"][0], lock_lengths)
        # one decode step of each path, timed in turns (plain, kernel,
        # kernel, plain) at the last lockstep position, then profiled
        step = {impl: (lambda impl=impl: serve_step(
            params, caches[impl], tokens, pos, cfg=cfg, rt=M.Runtime(impl)))
            for impl in ("kernel", "plain")}
        step_ms = {"kernel": [], "plain": []}
        for impl in ("plain", "kernel", "kernel", "plain"):
            step_ms[impl].append(host_ms(step[impl], 10))
        for impl in ("kernel", "plain"):
            ms = statistics.mean(step_ms[impl])
            log(f"serve_step {impl} B={SLOTS} pos={TOKENS - 1}: "
                f"{'/'.join(f'{x:.3f}' for x in step_ms[impl])} ms "
                f"({SLOTS / ms * 1e3:.1f} tok/s)")
            log_breakdown(f"serve_step {impl}", profile_kernels(step[impl], 5), ms)
        # (b) the servers: kernel (counted) and plain
        gaps_k, gaps_p = [], []
        ops.reset_launches()
        out_k, steps, secs_k = _serve(
            SlotServer(params, cfg, M.Runtime("kernel"), SLOTS, MAX_LEN), gaps_k)
        launches = ops.LAUNCHES["decode_attention"]
        out_p, steps_p, secs_p = _serve(
            SlotServer(params, cfg, M.Runtime("plain"), SLOTS, MAX_LEN), gaps_p)
    check(launches == cfg.n_layers * steps,
          f"decode launches {launches} != n_layers x steps "
          f"{cfg.n_layers} x {steps}")
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
            log(f"serve: request {req} diverges at token {t}; plain top-2 "
                f"gap there {gap:.3e} (tol {tol})")
            check(gap < tol, f"request {req}: streams diverge at a clear "
                             f"top-2 gap {gap:.3e}")
    tok = REQUESTS * TOKENS
    log(f"serve f32 {REQUESTS} req x {TOKENS} tok, {SLOTS} slots, max_len "
        f"{MAX_LEN}: {steps} steps, decode launches {launches}; kernel "
        f"{secs_k:.2f} s ({tok / secs_k:.1f} tok/s), plain path {secs_p:.2f} s "
        f"({tok / secs_p:.1f} tok/s); diverged requests: {len(diverged)}")
    check(steps == steps_p, "plain server took another number of steps")
    return {"launches": launches, "decode_shape": decode_shape}


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _sdpa_flash(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def time_flash(cfg) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    B, S, H, KV, D, dt = FWD_B, FWD_S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, torch.bfloat16
    q = _randn(g, (B, S, H, D), dt)
    k = _randn(g, (B, S, KV, D), dt)
    v = _randn(g, (B, S, KV, D), dt)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err = max_err(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
    lib_ms = cuda_ms(lambda: _sdpa_flash(qt, kt, vt))
    dev_ms = kernel_ms(profile_kernels(lambda: ops.flash_attention(q, k, v)),
                       "flash_fwd_kernel")
    pairs = S * (S + 1) // 2                     # kept (q, k) pairs, causal
    flops = 4 * B * H * pairs * D
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time flash bf16 [{B},{S},{H},{D}] kv {KV} causal: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa(enable_gqa) {lib_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s achieved; "
        f"kernel device time {_fmt(dev_ms)} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms)


def time_decode(q, k, v, lengths, tag: str) -> dict:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    mask = (torch.arange(S, device=DEVICE)[None, :] < lengths[:, None].long()
            )[:, None, None, :]                                   # [B,1,1,S]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)

    def flush():
        scratch.zero_()   # 256 MB through the 50 MB L2: the cache reads start cold

    err = max_err(ops.decode_attention(q, k, v, lengths),
                  ref.decode_attention_ref(q, k, v, lengths))
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, lengths), flush=flush)
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, lengths),
                       flush=flush)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    dev_ms = kernel_ms(profile_kernels(lambda: (flush(), ops.decode_attention(
        q, k, v, lengths))), "decode_split_kernel", "decode_combine_kernel")
    valid = lengths.clamp(max=S).sum().item()
    nbytes = (2 * valid * KV * D + 2 * q.numel()) * q.element_size() \
        + lengths.numel() * 4
    flops = 4 * valid * (H // KV) * KV * D
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time decode {tag} {str(q.dtype)[6:]} B={B} S={S} H={H} KV={KV} D={D} "
        f"valid keys {valid}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa(mask, enable_gqa) {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({by}: {nbytes / 1e6:.3f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved; kernel device time "
        f"{_fmt(dev_ms)} ms ({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = get_config(ARCH)
    dev = phase_device()
    errs = phase_kernels()
    fwd = phase_forward(cfg)
    serve = phase_serve(cfg)
    with torch.inference_mode():
        flash_t = time_flash(cfg)
        decode_t = time_decode(*serve["decode_shape"], tag="serve shape")
        q, k, v, _ = serve["decode_shape"]
        full = torch.full((SLOTS,), MAX_LEN, device=DEVICE, dtype=torch.int32)
        time_decode(q, torch.randn_like(k), torch.randn_like(v), full,
                    tag="full cache")
    launches = {"flash_attention": fwd["launches"],
                "decode_attention": serve["launches"]}
    timed = {"flash_attention": flash_t, "decode_attention": decode_t}
    rows = []
    for name, meta in KERNELS.items():
        t = timed[name]
        rows.append({"name": name, **meta, "launches": launches[name],
                     "max_abs_err": max(errs[name], t["max_abs_err"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_us": t["bound_ms"] * 1e3,
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {dev['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
