#!/usr/bin/env python3
"""What the cluster pair's exchange costs the f32 flash kernels at dh = 256.

    python3 tools/flash_exchange_cost.py

At head dim 256 the split-f32 kernels (``csrc/flash_attention_f32tc.cu``)
run a tile on a cluster of two blocks that add their half-D partial scores
through distributed shared memory, one cluster barrier a step. This script
builds ``flash_attention_f32tc.cu`` four times in a scratch copy of the
package under ``build/`` (the sources are patched there, never in place):

  exchange  as shipped;
  barrier   the cluster barrier, without the partial sums' stores and loads;
  none      a block barrier in its place (no cluster traffic a step);
  rings     "none" with the backward rings of dh = 128 (room freed by the
            exchange stages);

and times each at gemma2-9b's attention shape (``chip_smoke.D256_SHAPE``)
by device time per kernel from ``torch.profiler``, twice in turns. Only
"exchange" computes attention: the others print their error to show it.
Needs one card and ``nvcc``; exits non-zero without a card.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (variant, [(text in the shipped source, text in the variant)])
VARIANTS = {
    "exchange": [],
    "barrier": [
        ("      xch_put(stage, 0, s);\n      cluster_sync();",
         "      cluster_sync();"),
        ("    if constexpr (NS == 2) xch_add(stage, 0, rank ^ 1, s);", ""),
        ("      xch_put(stage, 0, s);\n      xch_put(stage, 2, dp);\n      cluster_sync();",
         "      cluster_sync();"),
        ("      xch_add(stage, 0, rank ^ 1, s);\n      xch_add(stage, 2, rank ^ 1, dp);", ""),
    ],
}
VARIANTS["none"] = [(a, b.replace("cluster_sync();", "__syncthreads();"))
                    for a, b in VARIANTS["barrier"]]
# without the exchange's 16 KB, BwdRing's rule gives the pair two transposed
# stages (NT), as at D = 128
VARIANTS["rings"] = VARIANTS["none"] + [
    ("static constexpr int XCH = xch_bytes<D, 16>();", "static constexpr int XCH = 0;"),
]


def patched_package(tmp: Path, edits) -> Path:
    """A copy of src/repro_torch under tmp with the edits applied to the
    split-f32 source; returns the copy's src directory."""
    src = tmp / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "kernels" / "csrc" / "flash_attention_f32tc.cu"
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"flash_exchange_cost: source changed, no {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def run_variant(name: str, src: Path) -> None:
    """Time one variant in a child process (each loads its own library)."""
    code = f"""
import sys
sys.path[:0] = [{str(src)!r}, {str(ROOT)!r}]
import torch
from repro_torch.kernels import build, ops, ref   # the patched copy's, before
import chip_smoke as cs                          # chip_smoke puts src/ first
build.sources = lambda: [build.CSRC / "flash_attention_f32tc.cu"]
build.SIGNATURES = {{k: v for k, v in build.SIGNATURES.items() if "f32tc" in k}}
B, S, H, KV, D, cap = cs.D256_SHAPE
g = torch.Generator(device="cuda").manual_seed(0)
q, do = (torch.randn((B, S, H, D), generator=g, device="cuda") for _ in range(2))
k, v = (torch.randn((B, S, KV, D), generator=g, device="cuda") for _ in range(2))
kw = dict(causal=True, window=None, softcap=cap)
out, lse = ops.flash_attention_forward(q, k, v, True, None, cap, want_lse=True)
fb = lambda: ops.flash_attention_backward(q, k, v, out, lse, do, **kw)
pf = cs.profile_kernels(lambda: ops.flash_attention(q, k, v, **kw))
pb = cs.profile_kernels(fb)
err = max(cs.max_err(a, b) / b.abs().max().item() for a, b in zip(
    fb(), ref.flash_attention_backward_ref(q, k, v, out, lse, do, **kw)))
ms = lambda p, n: cs._fmt(cs.kernel_ms(p, n))
print(f"{name}: device ms forward {{ms(pf, cs.F32TC_FWD_D256)}}, dk/dv "
      f"{{ms(pb, 'flash_f32tc_dkdv_d256_kernel')}}, dq "
      f"{{ms(pb, 'flash_f32tc_dq_d256_kernel')}}; backward error / max {{err:.2e}}",
      flush=True)
"""
    subprocess.run([sys.executable, "-c", code], check=True)


def main() -> int:
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("flash_exchange_cost: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; shape {chip_smoke.D256_SHAPE}", flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        srcs = {name: patched_package(Path(tmp) / name, edits)
                for name, edits in VARIANTS.items()}
        for _ in range(2):
            for name, src in srcs.items():
                run_variant(name, src)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
