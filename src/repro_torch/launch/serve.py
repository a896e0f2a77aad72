"""Serving driver: batched decode over a dense decoder architecture.

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
The model is the reduced same-family config of ``--arch`` at ``--d-model``,
with seeded random f32 weights. Mamba, MoE and encoder-decoder archs raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as M
from repro_torch.serving import SlotServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    # accepted as in repro.launch.serve; SlotServer decodes greedily there too
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = reduced(full, d_model=args.d_model,
                  n_layers=2 * len(full.block) if len(full.block) == 1
                  else len(full.block))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(gen, cfg, torch.float32, dev)
    server = SlotServer(params, cfg, M.Runtime(), n_slots=args.slots,
                        max_len=args.max_len)

    t0 = time.time()
    pending = list(range(args.requests))
    active, done = {}, {}
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            active[server.submit(prompt_token=req + 2)] = req
        server.step()
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= args.tokens:
                done[active.pop(rid)] = server.finish(rid)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total = args.requests * args.tokens
    print(f"served {args.requests} requests x {args.tokens} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s, {args.slots} slots, "
          f"arch={args.arch} reduced, device={dev})")
    return done


if __name__ == "__main__":
    main()
