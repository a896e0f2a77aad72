#!/usr/bin/env python3
"""The bf16 flash pair (``csrc/flash_attention_tc.cu`` forward,
``csrc/flash_attention_tc_bwd.cu`` backward) of this tree against those of
other trees, on one card.

    python3 tools/flash_bf16_bench.py [--other DIR ...] [--rounds N]

At the attention shapes ``chip_smoke.py`` phase 5 times (internlm2-1.8b's
train step, gemma2-9b's at head dim 256 with softcap 50, seamless's non-causal
dh 64 and grok-1-314b's head group 6), it times each library's forward
(without and with ``lse``) and backward by device time per kernel from
``torch.profiler``, in turns (the others, this, this, the others in
reverse), beside the bound (two products of the kept pairs forward, five
backward, at 989 TFLOP/s) and SDPA's flash backend. It also checks that this
tree's backward is bitwise repeatable and prints how far it is from each
other tree's, and prints the ``ptxas -v`` report (registers, spill bytes, shared
memory, serialised ``wgmma``) of every bf16 flash kernel of each library.

Each ``--other DIR`` is the root of another checkout (for example the parent
commit unpacked with ``git archive``), named by its directory; its kernels
are built there by its own ``build.py`` and called through their C entry
points, with this tree's arguments (the operands' head dim, then the built
one): another tree needs the same C signature. Needs one card and
``nvcc``; exits non-zero without a card. Writes
``chiprun_out/flash_bf16_bench.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402

PEAK = 989e12   # dense bf16 tensor-core FLOP/s of an H100 SXM
# (name, B, S, H, KV, D, causal, softcap, backward too)
SHAPES = [
    ("internlm2", 2, 2048, 16, 8, 128, True, None, True),
    ("gemma2 dh 256", 2, 2048, 16, 8, 256, True, 50.0, True),
    ("seamless", 2, 2048, 16, 16, 64, False, None, True),
    ("grok", 2, 2048, 48, 8, 128, True, None, False),
]
KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_tc_delta_kernel",
           "flash_bwd_tc_dkdv_kernel", "flash_bwd_tc_dq_kernel")


def start_build(root: Path) -> subprocess.Popen:
    """Build another tree's kernels with its own build.py, in its own build
    directory, in a process of its own (the builds run side by side)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; p, _ = build.build(); "
            "print(p)")
    return subprocess.Popen([sys.executable, "-c", code, str(root / "src")],
                            stdout=subprocess.PIPE, text=True)


def load_other(proc: subprocess.Popen) -> tuple[ctypes.CDLL, str]:
    """The library a ``start_build`` made, loaded, and its ptxas log."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("the other tree's build failed")
    path = Path(out.strip().splitlines()[-1])
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    log = path.with_suffix(".log")
    return lib, log.read_text() if log.exists() else ""


def ptxas_report(text: str) -> list[str]:
    """One line per bf16 flash kernel of a build log: name<template
    arguments>, registers, spill bytes and whether ptxas serialised its
    wgmma (C7512)."""
    def key(line):
        m = re.search(r"(flash_(?:fwd|bwd)_tc(?:_[a-z]+)?_kernel)I((?:L[ib]\d+E)+)E",
                      line)
        if m is None:
            return None
        args = ", ".join(v if t == "i" else ("true" if v == "1" else "false")
                         for t, v in re.findall(r"L([ib])(\d+)E", m.group(2)))
        return f"{m.group(1)}<{args}>"

    rows, cur = {}, None
    for line in text.splitlines():
        if "serialized" in line:   # C7512 names its function
            k = key(line)
            if k:
                rows.setdefault(k, {})["C7512"] = True
            continue
        if "Compiling entry function" in line or "Function properties" in line:
            cur = key(line)
            if cur:
                rows.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            rows[cur]["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[cur]["regs"] = int(m.group(1))
    return [f"{k}: {v.get('regs')} registers, {v.get('spill')} bytes spill stores"
            + (", wgmma serialized (C7512)" if v.get("C7512") else "")
            for k, v in rows.items() if any(n in k for n in KERNELS[:1] + KERNELS[2:])]


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class Pair:
    """The bf16 flash entry points of one library on fixed operands."""

    def __init__(self, lib, q, k, v, dout, causal, softcap):
        self.lib, self.q, self.k, self.v, self.dout = lib, q, k, v, dout
        B, Sq, H, D = q.shape
        # the head dim twice: the operands' and the built instance's
        self.args = (B, Sq, k.shape[1], H, k.shape[2], D, D, int(causal), 0,
                     float(softcap or 0.0))
        self.out = torch.empty_like(q)
        self.lse = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
        self.delta = torch.empty_like(self.lse)

    def forward(self, lse: bool):
        lp = ptr(self.lse) if lse else ctypes.c_void_p(None)
        code = self.lib.repro_flash_attention_tc(
            ptr(self.q), ptr(self.k), ptr(self.v), ptr(self.out), lp,
            *self.args, stream())
        assert code == 0, f"forward: CUDA error {code}"

    def backward(self):
        grads = (torch.empty_like(self.q), torch.empty_like(self.k),
                 torch.empty_like(self.v))
        code = self.lib.repro_flash_attention_tc_bwd(
            ptr(self.q), ptr(self.k), ptr(self.v), ptr(self.out),
            ptr(self.dout), ptr(self.lse), ptr(self.delta),
            *(ptr(g) for g in grads), *self.args, stream())
        assert code == 0, f"backward: CUDA error {code}"
        return grads


def device_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of each bf16 flash kernel fn launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for k in KERNELS:
            if k in ev.key:
                t = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
                out[k] = out.get(k, 0.0) + t / iters / 1e3
    return out


def sdpa_ms(q, k, v, dout, causal, backward: bool) -> float | None:
    """SDPA's flash backend on the same bf16 operands (no softcap), event ms."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt, dt = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    leaves = [t.requires_grad_(backward) for t in (qt, kt, vt)]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        try:
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                               enable_gqa=True)
        except RuntimeError:
            return None
        if backward:
            fn = lambda: torch.autograd.grad(o, leaves, dt, retain_graph=True)  # noqa: E731
        else:
            fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *leaves, is_causal=causal, enable_gqa=True)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bf16_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    procs = {root.name: start_build(root.resolve()) for root in args.other}
    libs = {"this": build.load()}
    logs = {"this": build.build_log()}
    for tag, proc in procs.items():
        libs[tag], logs[tag] = load_other(proc)
    for tag, text in logs.items():
        for line in ptxas_report(text):
            print(f"ptxas {tag}: {line}")
    others = [tag for tag in libs if tag != "this"]
    order = (others + ["this", "this"] + others[::-1]) * (args.rounds // 2 or 1)
    results = []
    for name, B, S, H, KV, D, causal, softcap, bwd in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(7)
        q, dout = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(2))
        k, v = (torch.randn((B, S, KV, D), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        pairs = {tag: Pair(lib, q, k, v, dout, causal, softcap)
                 for tag, lib in libs.items()}
        kept = B * H * (S * (S + 1) // 2 if causal else S * S)
        bound_f, bound_b = 4 * kept * D / PEAK * 1e3, 10 * kept * D / PEAK * 1e3
        row = dict(shape=name, dims=[B, S, H, KV, D], causal=causal,
                   softcap=softcap, bound_fwd_ms=bound_f, bound_bwd_ms=bound_b,
                   times={})
        for p in pairs.values():
            p.forward(lse=True)
        torch.cuda.synchronize()
        if bwd:
            # this tree's backward: bitwise repeatable, and its distance from
            # the plain backward and from each other tree's
            a, b2 = pairs["this"].backward(), pairs["this"].backward()
            torch.cuda.synchronize()
            row["bitwise_repeatable"] = all(torch.equal(x, y) for x, y in zip(a, b2))
            f32 = [t.float() for t in (q, k, v, pairs["this"].out, dout)]
            want = ref.flash_attention_backward_ref(
                *f32[:4], pairs["this"].lse, f32[4], causal=causal,
                window=None, softcap=softcap)
            row["err_to_max_vs_plain"] = [
                ((x.float() - w.float()).abs().max() / w.float().abs().max()).item()
                for x, w in zip(a, want)]
            row["err_to_max_vs"] = {
                tag: [((x.float() - y.float()).abs().max()
                       / y.float().abs().max()).item()
                      for x, y in zip(a, pairs[tag].backward())]
                for tag in others}
        for tag in order:
            p = pairs[tag]
            t = {"fwd": device_ms(lambda: p.forward(False)).get(
                     "flash_fwd_tc_kernel", float("nan")),
                 "fwd_lse": device_ms(lambda: p.forward(True)).get(
                     "flash_fwd_tc_kernel", float("nan"))}
            if bwd:
                t["bwd"] = device_ms(p.backward)
                t["bwd_total"] = sum(t["bwd"].values())
            row["times"].setdefault(tag, []).append(t)
        row["sdpa_fwd_ms"] = sdpa_ms(q, k, v, dout, causal, False)
        if bwd:
            row["sdpa_bwd_ms"] = sdpa_ms(q, k, v, dout, causal, True)
        results.append(row)
        for tag, ts in row["times"].items():
            for t in ts:
                msg = (f"{name} {tag}: fwd {t['fwd']:.4f} ms "
                       f"({100 * bound_f / t['fwd']:.1f}% of {bound_f * 1e3:.1f} us), "
                       f"fwd+lse {t['fwd_lse']:.4f}")
                if bwd:
                    msg += (f", bwd {t['bwd_total']:.4f} ms ("
                            + ", ".join(f"{k.split('_')[3]} {v:.4f}"
                                        for k, v in t["bwd"].items())
                            + f"; {100 * bound_b / t['bwd_total']:.1f}% of "
                            f"{bound_b * 1e3:.1f} us)")
                print(msg, flush=True)
        print(f"{name}: sdpa fwd {row['sdpa_fwd_ms']}, bwd "
              f"{row.get('sdpa_bwd_ms')}; bitwise {row.get('bitwise_repeatable')}, "
              f"err vs plain {row.get('err_to_max_vs_plain')}, vs "
              f"{row.get('err_to_max_vs')}", flush=True)
        if bwd and not row["bitwise_repeatable"]:
            print(f"{name}: backward NOT bitwise repeatable", flush=True)
            return 1
    out = ROOT / "chiprun_out" / "flash_bf16_bench.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, results=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
