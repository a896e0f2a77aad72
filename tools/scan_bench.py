#!/usr/bin/env python3
"""The fused selective-scan pair of this tree against another tree's, on one
card.

    python3 tools/scan_bench.py [--other DIR] [--rounds N]

Each tree is run in a process of its own through its own wrappers
(``ops.selective_scan_fused_forward`` / ``_backward``) and its own
``chip_smoke.py`` helpers, so the trees may differ in their C entries and in
their state interval (the pattern of ``tools/decode_bench.py``); ``--other
DIR`` is the root of another checkout, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
The two trees' kernels are built side by side first, then the trees run in
turns: other, this, this, other (per round). Each process takes this
tree's ``chip_smoke.FUSED_CASES`` (falcon-mamba's train shape in f32 and
bf16, a ragged S, the reduced width, d_state 12 over DI 200 and d_state 32)
and, for each case:

- holds y and the states to the tree's plain chunked loop (2e-5) and the
  five gradients to its plain backward (2e-5 of each one's largest
  magnitude, 2e-2 in bf16);
- times by ``torch.profiler`` the device ms of the forward kernel
  (``ssf_fwd_kernel``) and of the backward's two (``ssf_bwd_kernel``,
  ``ssf_reduce_kernel``) per call, each call after a 256 MB read through
  the L2 (``chip_smoke.make_flush("read")``);
- gives each beside its bound: the bytes the function moves (u, dt, A, B,
  C read, y and the tree's states written; backward those, the states and
  dy read, du, ddt, dA, dB, dC written) at 3.35 TB/s.

It also prints each tree's ptxas report of its fused scan source
(registers and spills by kernel) and, where the tree has the query, the
dynamic shared memory of each instance. Prints one line per case and
writes ``chiprun_out/scan_bench.json``. Needs one card and ``nvcc``; exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
FWD = ("ssf_fwd_kernel",)
BWD = ("ssf_bwd_kernel", "ssf_reduce_kernel")


def ptxas_fused(log: str) -> dict:
    """{kernel<L,dtype>: "N registers, M bytes spill stores"} of the fused
    scan's source in a build log."""
    start = log.find("== selective_scan_fused.cu")
    if start < 0:
        return {}
    text = log[start:]
    end = text.find("\n== ", 5)
    text = text if end < 0 else text[:end]
    out, cur, spill = {}, None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?(ssf_\w+?kernel)"
                      r"(?:ILi(\d+)E(f|13__nv_bfloat16))?", line)
        if m:
            cur = (f"{m.group(1)}<{m.group(2)},"
                   f"{'f32' if m.group(3) == 'f' else 'bf16'}>"
                   if m.group(2) else m.group(1))
        elif "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[cur] = f"{regs} registers, {spill} bytes spill stores"
            cur = None
    return out


def measure(tree: Path, tag: str, cases: list) -> dict:
    """One process's measurements of ``tree``'s fused pair (the module
    doc)."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs   # puts tree/src first on sys.path
    import torch
    ops, ref, build = cs.ops, cs.ref, cs.build
    assert Path(ops.__file__).resolve().is_relative_to(tree), ops.__file__
    cs.phase_device()   # the tree's build (done before: loaded here)
    lib = build.load()
    smem = {}
    if hasattr(lib, "repro_selective_scan_fused_smem"):
        for L in (8, 16, 32):
            for dt, name in ((0, "f32"), (1, "bf16")):
                smem[f"<{L},{name}>"] = {
                    "forward": lib.repro_selective_scan_fused_smem(L, dt, 0),
                    "backward": lib.repro_selective_scan_fused_smem(L, dt, 1)}
    res = {"tag": tag, "ptxas": ptxas_fused(build.build_log()),
           "smem_bytes": smem, "cases": {}}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 34)
    flush = cs.make_flush("read")
    for B, S, DI, DS, dname in cases:
        dtype = getattr(torch, dname)
        u, dt, A, Bc, Cc, dy = cs._fused_operands(g, B, S, DI, DS, dtype)
        y, states = ops.selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                                     want_states=True)
        grads = ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states,
                                                  dy)
        want_y, want_st = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc,
                                                       want_states=True)
        tol = cs.TOL[torch.float32]
        err_f = max(cs.assert_close(y, want_y, tol, f"{tag} y"),
                    cs.assert_close(states, want_st, tol, f"{tag} states"))
        want = ref.selective_scan_fused_backward_ref(u, dt, A, Bc, Cc, states,
                                                     dy)
        err_b = max(cs.assert_close_to_max(x.float(), w.float(), cs.TOL[x.dtype],
                                           f"{tag} grad")
                    for x, w in zip(grads, want))
        fwd = lambda: ops.selective_scan_fused_forward(  # noqa: E731
            u, dt, A, Bc, Cc, want_states=True)
        bwd = lambda: ops.selective_scan_fused_backward(  # noqa: E731
            u, dt, A, Bc, Cc, states, dy)
        e, nst = u.element_size(), states.numel() * 4
        rows = 2 * B * S * DS * e
        read_f = B * S * DI * (e + 4) + DI * DS * 4 + rows
        bytes_f = read_f + B * S * DI * 4 + nst
        bytes_b = read_f + nst + B * S * DI * 4 + B * S * DI * (e + 4) \
            + DI * DS * 4 + rows
        times = {}
        for kind, fn, names in (("forward", fwd, FWD), ("backward", bwd, BWD)):
            prof = cs.profile_recorded(lambda: (flush(), fn()), names, 1,
                                       iters=10)[0]
            times[kind] = {x: cs.kernel_ms(prof, x) for x in names}
        key = f"[{B},{S},{DI},{DS}] {dname}"
        res["cases"][key] = {
            "forward_ms": times["forward"][FWD[0]],
            "backward_ms": sum(v or 0.0 for v in times["backward"].values()),
            "backward_ms_by_kernel": times["backward"],
            "bound_forward_ms": 1e3 * bytes_f / cs.HBM_BYTES_PER_S,
            "bound_backward_ms": 1e3 * bytes_b / cs.HBM_BYTES_PER_S,
            "states": list(states.shape), "err_forward": err_f,
            "err_backward": err_b}
        del u, dt, A, Bc, Cc, dy, y, states, grads, want, want_y, want_st
        torch.cuda.empty_cache()
    return res


def run(tree: Path, tag: str, cases: list) -> dict:
    """``measure`` in a process of its own; its result."""
    out = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--tag", tag, "--cases", json.dumps(cases)],
                         capture_output=True, text=True)
    lines = [x for x in out.stdout.splitlines() if x.startswith("SCAN ")]
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
        raise RuntimeError(f"scan_bench: the {tag} tree's run failed")
    return json.loads(lines[-1][len("SCAN "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    ap.add_argument("--cases", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:   # one tree's process
        res = measure(args.tree.resolve(), args.tag, json.loads(args.cases))
        print("SCAN " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ROOT))
    from flash_bf16_bench import start_build
    import chip_smoke
    cases = [(B, S, DI, DS, str(dt).removeprefix("torch."))
             for B, S, DI, DS, dt in chip_smoke.FUSED_CASES]
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
            raise RuntimeError("scan_bench: a tree's build failed")
    order = list(trees)[::-1]
    runs = [run(trees[t], t, cases) for t in (order + order[::-1]) * args.rounds]
    for r in runs[:len(trees)]:
        for k, v in r["ptxas"].items():
            print(f"ptxas {r['tag']} {k}: {v}", flush=True)
        for k, v in r["smem_bytes"].items():
            print(f"smem {r['tag']} {k}: forward {v['forward']} B, backward "
                  f"{v['backward']} B", flush=True)
    for key in runs[0]["cases"]:
        for kind in ("forward", "backward"):
            by = {}
            for r in runs:
                by.setdefault(r["tag"], []).append(r["cases"][key])
            parts = []
            for t, cs in by.items():
                ms = [c[f"{kind}_ms"] for c in cs]
                bound = cs[0][f"bound_{kind}_ms"]
                err = max(c[f"err_{kind}"] for c in cs)
                parts.append(
                    f"{t} " + ", ".join(f"{x:.4f}" for x in ms)
                    + f" ms ({100 * bound / statistics.median(ms):.1f}% of "
                    f"{bound * 1e3:.2f} us; states {cs[0]['states']}; max err "
                    f"{err:.2e})")
            print(f"{key} {kind}: " + "; ".join(parts), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "scan_bench.json").write_text(json.dumps(
        {"card": smi, "cases": cases, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
