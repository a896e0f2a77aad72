"""Serving entry point: batched decode over any architecture (dense, Mamba,
MoE, encoder-decoder).

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
The model is the reduced same-family config of ``--arch`` at ``--d-model``
(head dim d_model / 4; every head dim runs on the card, above 256 on
the wide route), with
seeded random f32 weights (``build_server``, driven by ``serve``);
grok-1-314b, arctic-480b and jamba-1.5-large-398b serve their MoE FFNs.
    PYTHONPATH=src python -m repro_torch.launch.serve --d-model 768   # dh 192
    PYTHONPATH=src python -m repro_torch.launch.serve --d-model 2048  # dh 512
The runtime's ``cross_len`` is
16, as in ``repro.launch.serve``: the encoder-decoder (seamless) decodes
with a cross K/V cache of 16 zero keys a slot (nothing fills it, as in the
JAX server).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as M
from repro_torch.serving import SlotServer


RUNTIME = M.Runtime(cross_len=16)


def build_server(arch: str, device, d_model: int = 128, slots: int = 4,
                 max_len: int = 128, rt: M.Runtime = RUNTIME,
                 n_heads: int = 4, n_kv_heads=None) -> SlotServer:
    """The server ``main`` runs: the reduced ``arch`` at ``d_model`` (head
    dim d_model / n_heads: 192 at d_model 768, 512 at 2048; ``n_heads`` /
    ``n_kv_heads`` as ``reduced`` takes them), seeded f32 weights, ``slots``
    slots of ``max_len`` positions on ``device``, decoding under ``rt``."""
    dev = resolve_device(device)
    full = get_config(arch)
    cfg = reduced(full, d_model=d_model,
                  n_layers=2 * len(full.block) if len(full.block) == 1
                  else len(full.block), n_heads=n_heads,
                  n_kv_heads=n_kv_heads)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(gen, cfg, torch.float32, dev)
    return SlotServer(params, cfg, rt, n_slots=slots, max_len=max_len)


def serve(server: SlotServer, requests: int, tokens: int):
    """Requests 0..requests-1 (prompt token request + 2) through the slots
    until each has ``tokens`` tokens; returns ({request: tokens}, steps)."""
    pending = list(range(requests))
    active, done, steps = {}, {}, 0
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            active[server.submit(prompt_token=req + 2)] = req
        server.step()
        steps += 1
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= tokens:
                done[active.pop(rid)] = server.finish(rid)
    return done, steps


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

    server = build_server(args.arch, args.device, args.d_model, args.slots,
                          args.max_len)
    dev = resolve_device(args.device)
    t0 = time.time()
    done, _ = serve(server, args.requests, args.tokens)
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
