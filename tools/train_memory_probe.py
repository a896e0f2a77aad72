#!/usr/bin/env python3
"""What one train step keeps for its backward, counted on the CPU, beside
``chip_smoke.train_units``'s reckoning of it.

    python3 tools/train_memory_probe.py [--arch NAME ...] [--S 256 512]

For each architecture at full width (its vocabulary cut to 512, so the
logits stay small) and each of f32 and bf16 and of remat "none", "block"
and "full", it runs ``loss_fn`` and ``torch.autograd.grad`` of one
microbatch [1, S] at one block and at two, on the CPU, under a
``TorchDispatchMode`` that watches the storage of every tensor an op makes.
The flash and scan kernels' plain versions are replaced by their
allocations alone (zeros of the shapes the card's kernels allocate), so the
count follows what the card holds and no attention score or scan loop is
computed. From the four runs at each setting (one block and two, at the two
sequence lengths) it prints, in bytes per token of one unit (a block of
``len(cfg.block)`` layers; an encoder-decoder's unit is an encoder layer and
a decoder block):

- kept: what the forward leaves alive for the backward;
- over: the largest amount the backward holds beside what is still kept,
  its weight gradients left out (they are ``train_memory``'s own term);

each beside the reckoning. On the card the split-f32 flash backward also
holds its hi/lo workspace (``ops._f32tc_workspace``), which the count here
cannot see: the reckoning's f32 "over" is printed without it. Runs on the
CPU; needs no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training.loss import loss_fn  # noqa: E402

ARCHS = ("internlm2-1.8b", "gemma2-9b", "falcon-mamba-7b",
         "seamless-m4t-large-v2")   # grok-1's layer (6.4 B params) is too
# large for the host: run it at a reduced width (``configs.reduced``)


# the plain versions the wrappers call on the CPU, as the outputs the card's
# kernels allocate (``main`` puts them in ``kernels.ref``)
ALLOCATIONS = {
    "flash_attention_ref": lambda q, k, v, **kw: torch.zeros_like(q),
    "flash_attention_lse_ref": lambda q, k, **kw: torch.zeros(
        q.shape[0], q.shape[2], q.shape[1]),
    "flash_attention_backward_ref": lambda q, k, v, o, lse, do, **kw: (
        torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)),
    "selective_scan_ref": lambda a, b, h0: torch.zeros_like(a),
    "selective_scan_backward_ref": lambda a, h, h0, dh: (
        torch.zeros_like(a), torch.zeros_like(a),
        None if h0 is None else torch.zeros_like(h0)),
    "selective_scan_fused_ref": lambda u, dt, A, Bc, Cc, want_states=False: (
        (torch.zeros(u.shape), torch.zeros(
            u.shape[0], ref.fused_chunks(u.shape[1]), *A.shape))
        if want_states else torch.zeros(u.shape)),
    "selective_scan_fused_backward_ref": lambda u, dt, A, Bc, Cc, st, dy:
        _fused_backward(u, A, Bc),
}


def _fused_backward(u, A, Bc):
    """What ``ops.selective_scan_fused_backward`` allocates on the card: its
    f32 outputs (du, ddt, dB, dC, dA), the scratch of the per-block partials
    (freed at its return), then du, dB and dC in the operands' dtype."""
    from repro_torch.kernels import ops
    (B, S, DI), DS = u.shape, A.shape[1]
    du, ddt = torch.zeros(B, S, DI), torch.zeros(B, S, DI)
    dB, dC, dA = torch.zeros(B, S, DS), torch.zeros(B, S, DS), torch.zeros(A.shape)
    scratch = [torch.zeros(ops.fused_blocks(DI, DS), B, S, DS)
               for _ in range(2)] + [torch.zeros(B, DI, DS)]
    del scratch
    return du.to(u.dtype), ddt, dA, dB.to(Bc.dtype), dC.to(Bc.dtype)


class LiveBytes(TorchDispatchMode):
    """Sums the bytes of the storages the ops make that are still alive;
    ``skip`` holds storages that are not counted (the params), ``grads``
    the weight gradients, left out of ``peak``."""

    def __init__(self, skip):
        super().__init__()
        self.made, self.skip, self.grads, self.peak = {}, skip, set(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                if s.data_ptr() in self.skip:
                    continue
                seen = self.made.get(s.data_ptr())
                if seen is None or seen[0].expired():   # new, or the address reused
                    self.made[s.data_ptr()] = (StorageWeakRef(s), s.nbytes())
        self.peak = max(self.peak, self.alive(self.grads))
        return out

    def alive(self, leave_out=()) -> int:
        for ptr in [p for p, (ref_, _) in self.made.items() if ref_.expired()]:
            del self.made[ptr]   # freed: the count stays as short as what lives
        return sum(n for ptr, (_, n) in self.made.items()
                   if ptr not in leave_out)


def measure(cfg, dtype, remat: str, S: int) -> tuple:
    """(kept, peak) in bytes: alive after the forward, and the most alive
    during the backward without the weight gradients."""
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dtype,
                           "cpu").requires_grad_(True)
    leaves = list(params.parameters())
    g = torch.Generator().manual_seed(1)
    mb = {"tokens": torch.randint(0, cfg.vocab, (1, S), generator=g),
          "labels": torch.randint(0, cfg.vocab, (1, S), generator=g)}
    if cfg.enc_dec:
        mb["frames"] = torch.randn(1, S, cfg.d_model, generator=g)
    mode = LiveBytes({t.untyped_storage().data_ptr()
                      for t in leaves + list(mb.values())})
    for t in leaves:
        t.register_hook(lambda gr: mode.grads.add(gr.untyped_storage().data_ptr()))
    rt = M.Runtime(attn_impl="kernel", scan_impl="kernel", remat=remat)
    with mode:
        loss = loss_fn(params, mb, cfg, rt)[0]
        kept = mode.alive()
        torch.autograd.grad(loss, leaves)
    return kept, mode.peak


def per_token(full, dtype, remat: str, s1: int, s2: int) -> tuple:
    """((kept, reckoned), (over, reckoned)) in bytes per token of one unit
    of ``full`` (its vocabulary cut to 512), from the counts at one unit
    and two, at S = ``s1`` and ``s2``."""
    nb, got = len(full.block), {}
    for units in (1, 2):
        cfg = dataclasses.replace(
            full, vocab=512, n_layers=units * nb,
            **({"n_enc_layers": units} if full.enc_dec else {}))
        for S in (s1, s2):
            got[units, S] = measure(cfg, dtype, remat, S)

    def slope(units, i):
        return (got[units, s2][i] - got[units, s1][i]) / (s2 - s1)
    # the reckoning by the same difference (an MoE layer's capacity is a
    # step function of the tokens)
    chain = {S: chip_smoke.train_units(cfg, nb, S, dtype, remat, seq=S)
             for S in (s1, s2)}
    r_kept = (sum(k for k, _, _ in chain[s2])
              - sum(k for k, _, _ in chain[s1])) / (s2 - s1)
    r_over = (chain[s2][0][1] - chain[s1][0][1]) / (s2 - s1)
    if dtype == torch.float32 and full.family != "ssm":
        r_over -= (8 * full.n_heads + 6 * full.n_kv_heads) * full.d_head * 4
    return ((slope(2, 0) - slope(1, 0), r_kept),
            (slope(2, 1) - slope(2, 0), r_over))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--S", nargs=2, type=int, default=(256, 512))
    args = ap.parse_args()
    for name, fn in ALLOCATIONS.items():
        setattr(ref, name, fn)
    s1, s2 = args.S
    print(f"bytes per token of one unit, from S = {s1} and {s2}: "
          "measured (reckoned)")
    for arch in args.arch:
        full = get_config(arch)
        for dtype in (torch.float32, torch.bfloat16):
            for remat in ("none", "block", "full"):
                (kept, r_kept), (over, r_over) = per_token(full, dtype, remat,
                                                           s1, s2)
                print(f"{arch:22s} {str(dtype)[6:]:8s} {remat:5s} kept "
                      f"{kept:10.0f} ({r_kept:10.0f}), over {over:10.0f} "
                      f"({r_over:10.0f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
