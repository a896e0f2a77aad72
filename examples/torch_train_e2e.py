"""End-to-end fault-tolerant training on the PyTorch port.

Trains an internlm2-family model on a LOG.io-protected data pipeline with
checkpoint write actions, kills a pipeline worker AND the trainer mid-run,
and verifies the run resumes bit-identically from the last checkpoint: the
two runs' final states (params, AdamW moments and counters) are compared
with ``torch.equal`` leaf by leaf.

On the card (the default device; deterministic cuBLAS must be pinned
before CUDA starts):
    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python examples/torch_train_e2e.py
On the CPU (the plain versions of the kernels):
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu
Larger (~100M params, d_model 768, 12 layers, head dim 192: the split-f32
flash kernels' pair instances at 192 on the card; each checkpoint, with
AdamW's m and v, is ~1.2 GB):
    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python examples/torch_train_e2e.py --big --steps 300
    PYTHONPATH=src python examples/torch_train_e2e.py --big --steps 300 --device cpu
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.launch.train import run_training
from repro_torch.training.optimizer import moment_leaves


def train(steps: int, big: bool, device: str, ckpt_dir: str,
          kills: bool = False) -> dict:
    """One ``run_training`` of the demo; with ``kills``, a pipeline worker
    dies at ~batch 4 and the trainer at step ``steps * 2 // 3``."""
    dim, layers = (768, 12) if big else (128, 2)
    kw = (dict(kill_worker_at=4, kill_trainer_at=steps * 2 // 3)
          if kills else {})
    return run_training(steps=steps, ckpt_every=6, seq_len=64, batch_size=4,
                        ckpt_dir=ckpt_dir, d_model=dim, n_layers=layers,
                        seed=7, log_every=6, device=device, **kw)


def state_leaves(state) -> list:
    """A train state's tensors: params, m, v, the optimizer's count and
    the step."""
    opt = state["opt"]
    return (list(state["params"].parameters()) + moment_leaves(opt["m"])
            + moment_leaves(opt["v"]) + [opt["count"], state["step"]])


def identical(a, b) -> bool:
    """Bitwise equality of two train states, leaf by leaf."""
    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(bool(torch.equal(x, y))
                                      for x, y in zip(la, lb))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (d_model=768, 12 layers)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    # bitwise on the CPU too: its embedding backward (an accumulating
    # index_put_) adds in any order otherwise. On the card run_training
    # turns this on itself, after checking the pinned cuBLAS workspace.
    torch.use_deterministic_algorithms(True)

    dir_a = tempfile.mkdtemp(prefix="logio_ta_")
    dir_b = tempfile.mkdtemp(prefix="logio_tb_")
    try:
        print("== run A: failure-free ==")
        a = train(args.steps, args.big, args.device, dir_a)
        print("\n== run B: kill a pipeline worker at ~batch 4 and the "
              "trainer at step {} ==".format(args.steps * 2 // 3))
        b = train(args.steps, args.big, args.device, dir_b, kills=True)
        same = identical(a["final_state"], b["final_state"])
        print(f"\npipeline failures in B: {b['engine'].failures}; "
              f"final states identical: {same}")
        assert same, "resume was not bit-identical!"
        print("OK: crash-recovery resumed the exact trajectory.")
    finally:
        shutil.rmtree(dir_a, ignore_errors=True)
        shutil.rmtree(dir_b, ignore_errors=True)
    return a, b


if __name__ == "__main__":
    main()
