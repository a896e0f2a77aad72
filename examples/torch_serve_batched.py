"""Batched serving demo on the PyTorch port: slot-based continuous batching
over decode_step.

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch gemma2-9b]
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Uses a reduced config of the chosen architecture (d_model 128, 4 heads and
2 kv heads of 32 dims), with seeded random f32 weights, on the card unless
``--device cpu`` is asked for; the identical ``serve_step`` is what the
port's dry-run traces for the decode_32k / long_500k cells.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as M
from repro_torch.serving import SlotServer

RUNTIME = M.Runtime(q_chunk=16, cross_len=16)
N_SLOTS, MAX_LEN = 4, 64


def build_server(arch: str, device: str, rt: M.Runtime = RUNTIME):
    """The reduced ``arch`` with weights seeded 0, served by a SlotServer
    of N_SLOTS slots and MAX_LEN positions on ``device``."""
    dev = resolve_device(device)
    full = get_config(arch)
    cfg = reduced(full, d_model=128,
                  n_layers=2 * len(full.block) if len(full.block) == 1
                  else len(full.block))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(gen, cfg, torch.float32, dev)
    return SlotServer(params, cfg, rt, n_slots=N_SLOTS, max_len=MAX_LEN)


def serve(server: SlotServer, requests: int, tokens: int):
    """Requests 0..requests-1 (prompt token request + 2) through the slots
    until each has ``tokens`` tokens; returns ({request: tokens}, steps)."""
    pending = list(range(requests))
    active, done, steps = {}, {}, 0
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            rid = server.submit(prompt_token=req + 2)
            active[rid] = req
        server.step()
        steps += 1
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= tokens:
                done[active.pop(rid)] = server.finish(rid)
    return done, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    server = build_server(args.arch, args.device)
    t0 = time.time()
    done, _ = serve(server, args.requests, args.tokens)
    if server.params.embed.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for req in sorted(done):
        print(f"request {req}: {done[req]}")
    total = args.requests * args.tokens
    print(f"{total} tokens across {args.requests} requests in {dt:.2f}s "
          f"({total/dt:.1f} tok/s batched, arch={args.arch} reduced, "
          f"device={server.params.embed.device})")
    return done


if __name__ == "__main__":
    main()
