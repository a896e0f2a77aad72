"""End-to-end training driver: LOG.io-protected data pipeline + train step
+ checkable checkpoint write actions, in PyTorch.

Counterpart of ``repro.launch.train``, with ``device`` (``cuda`` unless
``"cpu"`` is asked for). On the CPU, reduced configs:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 60 --kill-worker-at 15 --kill-trainer-at 30

On the card the run is deterministic: ``torch.use_deterministic_algorithms``
is turned on, and ``CUBLAS_WORKSPACE_CONFIG`` must be ``:4096:8`` or
``:16:8`` before CUDA starts (cuBLAS is otherwise free to reduce in another
order from run to run); the attention backward (``ops.FlashAttention``) and
the scan's backward (``ops.SelectiveScan``, for ``--arch falcon-mamba-7b``)
are deterministic kernels, with no atomics.

Exactly-once training semantics: consumed batches are acknowledged (their
Input Sets marked done, with the checkpoint as the covering *write action*)
only at checkpoint boundaries, so after ANY crash the pipeline re-delivers
exactly the batches after the last checkpoint, in order — the restarted
trainer replays the identical trajectory (asserted by tests).
  * --kill-worker-at N  : crash a pipeline worker group after ~N batches;
    LOG.io recovers it non-blocking while training keeps running.
  * --kill-trainer-at N : drop the train state at step N, restore from the
    latest checkpoint, and crash the feed group (simulating the trainer pod
    dying with its buffered batches).
"""
from __future__ import annotations

import argparse
import os
import queue as _queue
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import Engine, FailureInjector
from repro_torch.data import build_data_pipeline
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptHParams
from repro_torch.training.step import (init_train_state, make_train_step,
                                       train_state_from_host)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
CUBLAS_CONFIGS = (":4096:8", ":16:8")


def deterministic(device: torch.device) -> None:
    """On the card: refuse to run unless cuBLAS is pinned to a fixed
    reduction order, then make every PyTorch op take its deterministic
    implementation (or raise). Nothing to do on the CPU."""
    if device.type != "cuda":
        return
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_CONFIGS:
        raise RuntimeError(
            "repro_torch training on the card needs CUBLAS_WORKSPACE_CONFIG "
            f"set to one of {CUBLAS_CONFIGS} before CUDA starts (a resumed "
            "run must replay bit-identically)")
    torch.use_deterministic_algorithms(True)


def run_training(*, arch: str = "internlm2-1.8b", use_reduced: bool = True,
                 steps: int = 60, seq_len: int = 128, batch_size: int = 4,
                 ckpt_every: int = 10, ckpt_dir: str = DEFAULT_CKPT_DIR,
                 kill_worker_at: Optional[int] = None,
                 kill_trainer_at: Optional[int] = None,
                 lr: float = 1e-3, seed: int = 0, log_every: int = 10,
                 d_model: int = 256, n_layers: int = 4, verbose: bool = True,
                 device=None):
    dev = resolve_device(device)
    deterministic(dev)
    cfg = get_config(arch)
    if use_reduced:
        nl = n_layers - n_layers % len(cfg.block) or len(cfg.block)
        cfg = reduced(cfg, d_model=d_model, n_layers=nl, vocab=2048,
                      d_ff=4 * d_model, n_heads=4)
    hp = OptHParams(lr=lr, warmup=20)
    rt = M.Runtime()

    # ---- data pipeline (LOG.io-protected) --------------------------------
    pipeline, feed_id = build_data_pipeline(
        seq_len=seq_len, batch_size=batch_size, vocab=cfg.vocab,
        n_shards=2 * steps + 32,
        shard_tokens=(batch_size // 2) * (seq_len + 1),
        per_batch=2, seed=seed)
    plan = []
    if kill_worker_at is not None:
        plan.append(("pack", "post_log", 2 * kill_worker_at))
    engine = Engine(pipeline, injector=FailureInjector(plan),
                    mode="thread", restart_delay=0.01)
    store = CheckpointStore(ckpt_dir)

    # ---- train state (restore-or-init) -----------------------------------
    def fresh_state():
        g = torch.Generator(device=dev).manual_seed(seed)
        return init_train_state(g, cfg, hp, dtype=torch.float32, device=dev)

    _, restored = store.latest()
    state = (train_state_from_host(restored, cfg, dev)
             if restored is not None else fresh_state())
    train_step = make_train_step(cfg, hp, rt)

    def next_batch(deadline=30.0):
        t_end = time.time() + deadline
        while time.time() < t_end:
            feed = engine.ops[feed_id]
            feed.requeue()
            try:
                return feed, feed.buffer.get(timeout=0.2)
            except _queue.Empty:
                continue
        raise TimeoutError("no batch from the data pipeline")

    engine.start()
    losses, crash_steps = [], []
    pending_insets = []
    killed_trainer = False
    t0 = time.time()
    while int(state["step"]) < steps:
        feed, (inset, body) = next_batch()
        toks = torch.from_numpy(np.asarray(body["tokens"][:batch_size])
                                ).to(dev)
        batch = {"tokens": toks[None, :, :-1],
                 "labels": toks[None, :, 1:].to(torch.int32)}
        state, metrics = train_step(state, batch)
        step = int(state["step"])
        losses.append(float(metrics["loss"]))
        pending_insets.append(inset)

        if step % ckpt_every == 0 or step >= steps:
            ref = store.save(state, step)
            feed_now = engine.ops[feed_id]
            for ins in pending_insets:
                feed_now.complete(ins, step, ref)
            pending_insets = []

        if verbose and (step % log_every == 0 or step >= steps):
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)", flush=True)

        if (kill_trainer_at is not None and step >= kill_trainer_at
                and not killed_trainer):
            killed_trainer = True
            crash_steps.append(step)
            if verbose:
                print(f"!! trainer crash at step {step}: dropping state, "
                      f"restoring from checkpoint", flush=True)
            old_feed = engine.ops[feed_id]
            engine.kill_group(engine.pipeline.groups[feed_id])
            del state
            _, restored = store.latest()
            state = (train_state_from_host(restored, cfg, dev)
                     if restored is not None else fresh_state())
            pending_insets = []
            # wait for the feed group to be rebuilt (fresh buffer)
            t_end = time.time() + 10
            while engine.ops[feed_id] is old_feed and time.time() < t_end:
                time.sleep(0.01)

    engine.stop()
    return {"losses": losses, "crash_steps": crash_steps, "engine": engine,
            "final_state": state, "store": store,
            "steps": int(state["step"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    default=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--kill-worker-at", type=int, default=None)
    ap.add_argument("--kill-trainer-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run_training(arch=args.arch, use_reduced=args.reduced,
                       steps=args.steps, seq_len=args.seq_len,
                       batch_size=args.batch_size, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       kill_worker_at=args.kill_worker_at,
                       kill_trainer_at=args.kill_trainer_at,
                       d_model=args.d_model, n_layers=args.n_layers,
                       seed=args.seed, device=args.device)
    print(f"finished at step {out['steps']}; "
          f"pipeline failures={out['engine'].failures} "
          f"restarts={out['engine'].restarts}")
    return out


if __name__ == "__main__":
    main()
