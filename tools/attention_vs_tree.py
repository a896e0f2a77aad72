#!/usr/bin/env python3
"""Device ms of one tree's attention kernels at the main paths' shapes, so
that two trees (this one and another checkout, e.g. the parent commit
unpacked by ``git archive`` into ``build/parent``) can be timed in turns
in one call on one card:

    for t in parent this this parent; do
      r=$([ $t = parent ] && echo build/parent || echo .)
      python3 tools/attention_vs_tree.py $r $t; done

ROOT's own ``chip_smoke.py`` and kernels are imported (each tree builds
its library into its own ``build/kernels``), so the trees may differ in
their C signatures. Flash forward (with lse) and backward in bf16 and f32
at internlm2's, gemma2's (dh 256, softcap 50), seamless's (dh 64,
non-causal) and, bf16 only, grok's (head group 6) train shapes, and f32
decode at B=4 S=4096 kv 8 dh 128 over 64 and 4096 keys: device ms per
call from ``torch.profiler`` (``chip_smoke.profile_recorded``). Prints one
``COMPARE {json}`` line. Needs a card."""
import json
import sys
from pathlib import Path
root, tag = Path(sys.argv[1]).resolve(), sys.argv[2]
sys.path.insert(0, str(root))
import chip_smoke as cs   # noqa: E402  (puts root/src first on sys.path)
import torch               # noqa: E402
ops, ref = cs.ops, cs.ref
assert Path(ops.__file__).resolve().is_relative_to(root), ops.__file__
torch.backends.cuda.matmul.allow_tf32 = False
SHAPES = {"dh128": cs.TRAIN_SHAPE, "dh256 cap50": cs.D256_SHAPE,
          "dh64 non-causal": cs.SEAMLESS_SHAPE, "dh128 group6": cs.GROK_TRAIN_SHAPE}
res = {}
g = torch.Generator(device="cuda").manual_seed(0)
for name, (B, S, H, KV, D, cap) in SHAPES.items():
    causal = "non-causal" not in name
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32 and name == "dh128 group6":
            continue
        q = cs._randn(g, (B, S, H, D), dt)
        k, v = cs._randn(g, (B, S, KV, D), dt), cs._randn(g, (B, S, KV, D), dt)
        do = cs._randn(g, (B, S, H, D), dt)
        out, lse = ops.flash_attention_forward(q, k, v, causal, None, cap, want_lse=True)
        if dt == torch.bfloat16:
            fn, bn = (cs.FLASH_TC,), cs.FLASH_TC_BWD
        else:
            fn, bn = ((cs.F32TC_FWD_PREP, cs.F32TC_FWD_D256), cs.F32TC_BWD_D256) if D == 256 \
                else ((cs.F32TC_FWD_PREP, cs.F32TC_FWD), cs.F32TC_BWD)
        f = lambda: ops.flash_attention_forward(q, k, v, causal, None, cap, want_lse=True)
        b = lambda: ops.flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                                 softcap=cap)
        dn = "bf16" if dt == torch.bfloat16 else "f32"
        res[f"{dn} forward {name}"] = cs.kernel_ms(cs.profile_recorded(f, fn, 1, grow=5)[0], *fn)
        res[f"{dn} backward {name}"] = cs.kernel_ms(cs.profile_recorded(b, bn, 1, grow=5)[0], *bn)
        del q, k, v, do, out, lse
B, S, H, KV, D = 4, 4096, 16, 8, 128
q = cs._randn(g, (B, H, D), torch.float32)
k, v = cs._randn(g, (B, S, KV, D), torch.float32), cs._randn(g, (B, S, KV, D), torch.float32)
names = ("decode_attention_kernel",)
for keys in (64, 4096):
    L = torch.full((B,), keys, device="cuda", dtype=torch.int32)
    res[f"decode f32 dh128 {keys} keys"] = cs.kernel_ms(cs.profile_recorded(
        lambda: ops.decode_attention(q, k, v, L), names, 1, iters=50)[0], *names)
print("COMPARE " + json.dumps({"tag": tag, "ms": res}), flush=True)
