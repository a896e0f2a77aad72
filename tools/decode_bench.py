#!/usr/bin/env python3
"""Decode attention of this tree against another tree's, on one card.

    python3 tools/decode_bench.py [--other DIR] [--rounds N]

Each tree is run in a process of its own through its own wrapper
(``ops.decode_attention``) and its own ``chip_smoke.py`` helpers, so the
trees may differ in their C entries (the pattern of
``tools/attention_vs_tree.py``); ``--other DIR`` is the root of another
checkout, for example the parent commit unpacked with ``git archive``. The
two trees' kernels are built side by side first, then the trees run in
turns: other, this, this, other (per round). Each process times, by
``torch.profiler`` device ms per call after a 256 MB write flush
(``chip_smoke.make_flush``), every kernel with ``decode_`` in its name:

- the group route's four shapes (f32: B=4 S=4096 H=4 kv 2 at head dim 512
  over a full cache and over 64 keys a slot; 32 and 71 heads over one kv
  head at head dim 64 over a full cache), each held to the plain version
  (2e-5), beside its bound (``chip_smoke``'s bytes and f32 rates);
- the examples' servers' decode (4 slots, max_len 128, 16 keys a slot:
  ``launch.serve --d-model 2048`` and ``1280``, 4 heads over 2 kv heads,
  head dims 512 and 320; and 32 heads over one kv head at 2048, head dim
  64), and those servers' ms a step (``chip_smoke._examples_serve``: 8
  requests x 16 tokens, host wall time, lockstep with the plain path);
- the narrow route's outputs (out and lse) at the serve shape (B=4 S=4096
  H=16 kv 8 D=128, 64 keys), grok's head group 6 (H=48 kv 8) and
  seamless's cross cache (H=16 kv 16 D=64, full), which the first process
  of each tree saves and this one compares with ``torch.equal``;
- in this tree, for information, the group kernel at head groups 6, 8 and
  16 (head dims 128 and 256, 64 keys and a full cache) beside the narrow
  kernel, which keeps those groups (the plan swapped for
  ``ops.group_plan`` around the wrapper's call).

Prints one line per shape and writes ``chiprun_out/decode_bench.json``.
Needs one card and ``nvcc``; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
# (tag, B, S, H, KV, D, valid keys a slot), f32
SHAPES = [
    ("dh 512 full cache", 4, 4096, 4, 2, 512, 4096),
    ("dh 512 64 keys", 4, 4096, 4, 2, 512, 64),
    ("group 32 full cache", 4, 4096, 32, 1, 64, 4096),
    ("group 71 full cache", 4, 4096, 71, 1, 64, 4096),
    ("server d2048 16 keys", 4, 128, 4, 2, 512, 16),
    ("server d1280 16 keys", 4, 128, 4, 2, 320, 16),
    ("server mqa 16 keys", 4, 128, 32, 1, 64, 16),
]
# the examples' servers: (tag, d_model, build_server's heads)
SERVERS = [("launch.serve --d-model 2048", 2048, {}),
           ("launch.serve --d-model 1280", 1280, {}),
           ("launch.serve --d-model 2048, 32 heads / 1 kv head", 2048,
            dict(n_heads=32, n_kv_heads=1))]
# the narrow route: (tag, B, S, H, KV, D, valid keys a slot)
NARROW = [("serve shape", 4, 4096, 16, 8, 128, 64),
          ("grok group 6", 4, 4096, 48, 8, 128, 64),
          ("seamless cross", 4, 4096, 16, 16, 64, 4096)]
# the group kernel where the narrow one runs, for information: (H, KV, D)
INFO = [(48, 8, 128), (64, 8, 128), (128, 8, 128), (48, 8, 256),
        (64, 8, 256), (128, 8, 256)]


def measure(tree: Path, tag: str) -> dict:
    """One process's measurements of ``tree``'s decode (the module doc)."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs   # puts tree/src first on sys.path
    import torch
    ops, ref = cs.ops, cs.ref
    assert Path(ops.__file__).resolve().is_relative_to(tree), ops.__file__
    cs.phase_device()   # the tree's build (done before: loaded here)
    g = torch.Generator(device="cuda").manual_seed(11)
    flush = cs.make_flush()
    res = {"tag": tag, "device_ms": {}, "max_abs_err": {}, "bound_ms": {},
           "serve_ms_per_step": {}, "info": {}}

    def dev_ms(fn):
        prof, _ = cs.profile_recorded(lambda: (flush(), fn()), ("decode_",),
                                      1, iters=20)
        return cs.kernel_ms(prof, "decode_")

    for name, B, S, H, KV, D, keys in SHAPES:
        q = cs._randn(g, (B, H, D), torch.float32)
        k, v = (cs._randn(g, (B, S, KV, D), torch.float32) for _ in range(2))
        lengths = torch.full((B,), keys, device="cuda", dtype=torch.int32)
        res["max_abs_err"][name] = err = cs.max_err(
            ops.decode_attention(q, k, v, lengths),
            ref.decode_attention_ref(q, k, v, lengths))
        cs.check(err <= 2e-5, f"{tag} {name}: max_abs_err {err:.3e}")
        res["device_ms"][name] = dev_ms(
            lambda: ops.decode_attention(q, k, v, lengths))
        nbytes = (2 * B * keys * KV * D + 2 * B * H * D) * 4 + 4 * B
        res["bound_ms"][name] = 1e3 * max(
            nbytes / cs.HBM_BYTES_PER_S,
            4 * B * keys * H * D / cs.PEAK_FLOPS[torch.float32])
        del q, k, v

    saved = OUT / f"decode_bench_narrow_{tag}.pt"
    if not saved.exists():
        outs = {}
        for name, B, S, H, KV, D, keys in NARROW:
            q = cs._randn(g, (B, H, D), torch.float32)
            k, v = (cs._randn(g, (B, S, KV, D), torch.float32)
                    for _ in range(2))
            lengths = torch.full((B,), keys, device="cuda", dtype=torch.int32)
            o = ops.decode_attention(q, k, v, lengths)
            o2, lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
            outs[name] = [t.cpu() for t in (o, o2, lse)]
        OUT.mkdir(exist_ok=True)
        torch.save(outs, saved)

    for name, d_model, heads in SERVERS:
        res["serve_ms_per_step"][name] = cs._examples_serve(
            cs.launch_serve_at(d_model, **heads), "internlm2-1.8b",
            requests=8, tokens=16, tag=name)["ms_per_step"]

    if hasattr(ops, "group_plan"):
        def on_group_route(*a):
            return ops.group_plan(*a)
        for H, KV, D in INFO:
            B, S = 4, 4096
            q = cs._randn(g, (B, H, D), torch.float32)
            k, v = (cs._randn(g, (B, S, KV, D), torch.float32)
                    for _ in range(2))
            for keys in (64, S):
                lengths = torch.full((B,), keys, device="cuda",
                                     dtype=torch.int32)
                want = ref.decode_attention_ref(q, k, v, lengths)
                fn = lambda: ops.decode_attention(q, k, v, lengths)  # noqa: E731
                narrow = dev_ms(fn)
                with mock.patch.object(ops, "decode_plan", on_group_route):
                    cs.check(cs.max_err(fn(), want) <= 2e-5,
                             f"info group {H // KV} D {D}: group route error")
                    group = dev_ms(fn)
                res["info"][f"group {H // KV} D {D} {keys} keys"] = {
                    "narrow": narrow, "group": group}
    return res


def run(tree: Path, tag: str) -> dict:
    """``measure`` in a process of its own; its result."""
    out = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--tag", tag], capture_output=True, text=True)
    lines = [x for x in out.stdout.splitlines() if x.startswith("DECODE ")]
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
        raise RuntimeError(f"decode_bench: the {tag} tree's run failed")
    return json.loads(lines[-1][len("DECODE "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:   # one tree's process
        print("DECODE " + json.dumps(measure(args.tree.resolve(), args.tag)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tools"))
    from flash_bf16_bench import start_build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"this": ROOT}
    if args.other is not None:
        trees["other"] = args.other.resolve()
    for proc in [start_build(t) for t in trees.values()]:   # side by side
        proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("decode_bench: a tree's build failed")
    for tag in trees:
        (OUT / f"decode_bench_narrow_{tag}.pt").unlink(missing_ok=True)
    order = list(trees)[::-1]
    runs = [run(trees[t], t) for t in (order + order[::-1]) * args.rounds]
    result = {"card": smi, "runs": runs, "narrow_equal": None}
    if "other" in trees:
        a, b = (torch.load(OUT / f"decode_bench_narrow_{t}.pt")
                for t in ("this", "other"))
        result["narrow_equal"] = {n: all(torch.equal(x, y)
                                         for x, y in zip(a[n], b[n]))
                                  for n in a}
        for n, same in result["narrow_equal"].items():
            print(f"narrow {n}: this tree's out and lse "
                  f"{'torch.equal to' if same else 'NOT equal to'} the "
                  f"other tree's", flush=True)
    for key, fmt in (("device_ms", "{:.4f} ms"),
                     ("serve_ms_per_step", "{:.2f} ms a step")):
        for name in runs[0][key]:
            by = {}
            for r in runs:
                by.setdefault(r["tag"], []).append(r[key][name])
            bound = runs[0]["bound_ms"].get(name)
            print(f"{name}: " + "; ".join(
                f"{t} " + ", ".join(fmt.format(x) for x in xs)
                + (f" ({100 * bound / statistics.median(xs):.1f}% of "
                   f"{bound * 1e3:.2f} us)" if bound else "")
                for t, xs in by.items()), flush=True)
    for r in runs:
        for name, t in r["info"].items():
            print(f"info {r['tag']} {name}: narrow {t['narrow']:.4f} ms, "
                  f"group {t['group']:.4f} ms", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "decode_bench.json").write_text(json.dumps(result, indent=1))
    ok = result["narrow_equal"] is None or all(result["narrow_equal"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
