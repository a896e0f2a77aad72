#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Models, at full width with random weights from a seed, depth not cut
except in phases 7, 8, 9, 11b and 12: internlm2-1.8b (24 layers, d=2048, 16 heads, 8
kv heads, dh=128, d_ff=8192, V=92544), falcon-mamba-7b (64 Mamba layers,
d=4096, d_inner=8192, d_state=16, d_conv=4, dt_rank=256, V=65024),
gemma2-9b (42 layers, alternating local (window 4096) and global attention,
d=3584, 16 heads, 8 kv heads, dh=256, d_ff=14336, V=256000 tied, softcaps
50 / 30) and grok-1-314b (64 layers, d=6144, 48 heads, 8 kv heads (head
group 6), dh=128, an MoE FFN of 8 experts top-2 with d_ff=32768,
V=131072 untied) and seamless-m4t-large-v2 (an encoder-decoder: 24
encoder and 24 decoder layers, d=1024, 16 heads, 16 kv heads (head group
1), dh=64, d_ff=8192, V=256206 untied; its encoder and cross-attention
non-causal). Phases:

1. device: name, power limit, kernel build (nvcc, sm_90a) and its seconds;
2. each CUDA kernel, launched directly, against its plain PyTorch version
   on the card (tolerance 2e-5 for f32, 2e-2 for bf16, as the JAX package's
   kernel tests use; bf16 flash also row by row against the f32 result of
   its inputs, ``ref.BF16_ROW_TOL``; the scan, in both its variants,
   bit-identical to the plain loop, and its backward bit-identical to the
   plain reverse loop and bitwise repeatable); flash and decode also at the
   head groups of grok (6: 48 / 8 heads) and arctic (7: 56 / 8), and at
   the examples phase's shapes (the f32 flash pair at [4, 64, 4, 32] kv 2
   causal, decode at D 32, head group 2, over 64 and 16 keys, the scan's
   step kernel at [4, 1, 256, 8] with h0); at head dim 192 (the --big
   trainer's [4, 64, 4, 192] kv 2 and [2, 2048, 16, 192] kv 8 causal with
   and without softcap 50, flash forward and backward in f32 and bf16;
   decode at B=4 S=4096 kv 8, head groups 2 and 6, 64 keys and a full
   cache, both dtypes, with lse and key offsets, and at the d_model 768
   server's [4, 128, 4, 2]); and on the padded route (head dims 16, 48
   and 80, run on the next built width: each launch's width checked
   against ``ops.built_head_dim``, each result held to the plain version
   at the true head dim); on the wide route (head dims above 256: flash
   up to 1024 on the cluster route, ``ops.flash_variant`` "cluster", at
   ``ops.flash_built_head_dim``, above it on the CUDA-core route; decode
   at the next multiple of 64: flash
   forward and backward in f32 and bf16 at [2, 256, 4, 512] kv 2 causal,
   with and without softcap 50 and a window, [1, 128, 4, 320] and 300 kv
   2, [1, 128, 2, 1024] kv 1 non-causal, head group 24, and at small S
   576 (ranks of 96 columns), a padded 704, head groups 17 at 512 and 24
   at 576, and 1088 on the CUDA-core route, the seconds these cases take
   printed; decode's group route at B=4
   S=4096 H=4 kv 2, D 512 (64 keys and a full cache), 320, 1024 and 300,
   with lse and key ranges); and at head groups above 16 (decode's group
   route at groups 24, 32, 48 and 71 over one kv head, D 64, and 32 at
   D 512, 17 at D 192; flash at groups 17 and 24); every decode launch at
   a group above 16 or a head dim above 256 recorded on the group route
   (``ops.DECODE_ROUTES``), bitwise repeatable and the same bits with lse;
   the fused scan (``csrc/selective_scan_fused.cu``: a and b built and h.C
   taken in the kernel) at falcon-mamba's train shape [2, 2048, 8192, 16]
   with u, Bc and Cc in f32 and in bf16, at a ragged S of 1000 and at a
   reduced width [2, 512, 1024, 8]: y and the chunk states within 2e-5 of
   the plain chunked loop, its backward's five gradients within 2e-5 of
   each one's largest magnitude (2e-2 for the bf16 ones), every output
   bitwise equal on a second call (``FUSED_CASES``);
3. internlm2 ``forward`` in bf16 on tokens [2, 2048] with the flash kernel
   (its tensor-core variant) against the plain path, and the flash launch
   count (one per layer, none of them an f32 variant);
   3b. falcon-mamba ``forward`` the same way through the fused scan (S =
   2048 takes JAX's chunked branch: one launch per layer, and no launch of
   the materialised route's scan);
4. internlm2 ``SlotServer`` with f32 weights and its f32 cache (4 slots,
   max_len 4096, 8 requests x 64 tokens) through the decode kernel: every
   request gets its tokens, a lockstep kernel/plain ``serve_step`` run holds
   the logits, the greedy streams agree, and the decode launch count is
   n_layers x steps (each one launch of the cluster kernel);
   4b. falcon-mamba ``SlotServer`` the same way through the scan kernel
   (f32 conv and SSM caches; n_layers x steps scan launches, every one of
   them the decode-step variant), and the scan's device time per launch
   inside the serve step beside the sequential kernel's and that of
   ``torch.addcmul`` in its place;
5. timings (CUDA-event medians and profiler device time) of each kernel,
   its plain version and, where one exists, one PyTorch library call at the
   shapes of phases 3-4, with the kernel's bound; flash at dh = 128 in both
   of its variants there (bf16 on the tensor cores against the bf16 peak;
   f32 split-f32, three TF32 products against the TF32 peak, with the f32
   CUDA-core bound beside it); decode attention at the serve shape and at a
   full cache; the scan at the forward shape and at the decode step; the f32
   flash backward beside its bounds; beside the f32 pair, memory-efficient
   SDPA on K/V repeated to the q heads and SDPA with ``enable_gqa`` (MATH),
   after step 0, which measures that SDPA's error against the plain
   versions at phase 2's f32 cases (the evidence for split-f32); the f32
   flash pair at gemma2-9b's attention shape (dh = 256, softcap 50; phase
   8's: split-f32, clusters of two blocks) beside its 3xTF32 and CUDA-core
   bounds and memory-efficient SDPA without the softcap, and the bf16
   forward there (off the main paths) beside its bound and SDPA's flash
   backend; the scan's backward at phase 7's shape beside its bound; after
   phase 9b, bf16 flash at grok's forward shape and decode at grok's serve
   shape, each beside its bound and SDPA; the flash set (f32 pair, bf16
   forward, bf16 backward) at [2, 2048, 16, 192] kv 8 causal (head dim
   192) and at [2, 2048, 16, 16] (the padded route, on the D = 32
   instances), and decode at B=4 S=4096 H=16 kv 8 at D 192 and 16 (64
   keys and a full cache), each beside its bound (the true head dim's
   work) and SDPA, with the ptxas report of the D = 192 instances; the
   wide route at [2, 2048, 4, 512] kv 2 causal (internlm2's width over
   the launchers' four heads: the cluster route, 4 ranks of 128 columns),
   forward and backward in f32 and bf16, beside the true head dim's bound
   (f32: 3xTF32 and CUDA-core; bf16: the bf16 peak and one TF32 product's
   ceiling), the same-call parent (the CUDA-core kernels, which compute
   the scores once per slice of 128 columns), the plain version and SDPA
   (``enable_gqa``, its fastest backend named), the cluster kernels'
   occupancy at head dims 320, 512, 576 and 1024, and decode's group
   route at B=4 S=4096 H=4 kv 2 D 512 (64 keys and a full cache) and at H
   32 and 71 kv 1 D 64 (multi-query groups of 32 and 71) over a full
   cache, with the ptxas report of the cluster and CUDA-core kernels and
   of the group route's; decode at the examples' group-route servers'
   caches (S 128, 16 keys a slot: D 512 and 320 over 4 / 2 heads, 32
   heads over one kv head at D 64) beside the plain version and SDPA; the
   fused scan pair at falcon-mamba's train shape in f32 (and its forward
   in bf16) beside its bound, its plain chunked loop and the same-call
   parent: the materialised route's whole scan part (a and b built at
   [B,S,DI,DS], the sequential kernel, the h.C einsum; its backward
   through autograd), by event and device time;
6. internlm2 ``make_train_step`` at full width in f32 (24 layers, tokens
   [accum 1, mb 2, S 2048], 30.2 GB of params, grads and AdamW moments):
   step ms, tokens/s, the device breakdown, 24 forward and 24 backward
   flash launches a step (counted, and recorded on the split-f32 kernels
   only: prep and forward, prep, dk/dv and dq), a first loss near ln V,
   two steps from the same state bitwise equal, and the grads at full width
   and depth cut to 2 layers against the ``attn_impl="plain"`` path;
   6b. ``run_training(device="cuda")`` (the LOG.io-protected feed, reduced
   to d_model 512 and 4 layers so dh = 128) with a trainer kill and a
   worker kill, whose losses and final state must equal, bit for bit, a run
   without kills;
7. falcon-mamba ``make_train_step`` (mamba-train-f32) at full width in f32,
   at its train preset's remat ("block") and cut to the deepest depth whose
   ``train_memory`` is within TRAIN_GB (``depth_for``; reckoned on its own
   line), tokens [1, 2, 2048]: the same checks and timings as phase 6, with
   2 x depth fused forward launches (the forward and its recompute) and
   depth fused backward launches a step, none of the materialised route's
   scan kernels, the fused pair's share of the step, the grads at depth 2
   against ``scan_impl="plain"`` (and whether they are bitwise equal), the
   peak at or below its reckoning, one step at depth 2 with remat bitwise
   equal to one without (``remat_equal``), and the step and peak at
   ``MAMBA_EARLIER_DEPTH`` (29, the depth the materialised route's memory
   allowed) held to their reckoning the same way (``step_at_depth``);
   7b. (mamba-train-logio) phase 6b's pair of runs on falcon-mamba, reduced
   to d_model 512 and 4 layers (d_inner 1024, d_state 8); S = 128 takes
   the materialised route (the scan kernel and its backward);
8. gemma2-9b ``make_train_step`` (gemma2-train-f32) at full width in f32,
   cut as phase 7 (remat "block"; an even depth: (local, global) pairs),
   tokens [1, 2, 2048]: the checks of phase 7, its flash launches recorded
   as the split-f32 kernels at dh = 256 (the *_d256_* pair kernels) and
   none of another variant; its first loss is held to the plain path's (a
   tied N(0, 1) embedding puts it far above ln V, see ``phase_train``);
9. grok-1-314b ``forward`` (grok-forward-bf16) at full width, depth cut to
   GROK_LAYERS (2 of 64: device memory, reckoned by ``serve_memory``), as
   phase 3 (2 tensor-core flash launches a forward, none f32; the error
   against an f32 forward within phase 3's limits; the f32 copy made leaf
   by leaf in place after the bf16 runs), with the MoE FFN's breakdown
   (expert GEMMs, dispatch and combine, attention, the rest), its routed
   counts per expert and its dropped assignments, and the MoE dispatch
   run twice (bitwise equal) and once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
   9b. grok ``SlotServer`` (grok-serve-f32) as phase 4, with the bytes a
   decode step must read beside its time, and the dispatch checks at the
   decode shape;
10. seamless-m4t-large-v2 ``forward`` (seamless-forward-bf16) at full width
    and depth on tokens [2, 2048] and frames [2, 2048, 1024] as phase 3:
    72 tensor-core flash launches a forward (24 encoder, 24 decoder, 24
    cross), the error against an f32 forward within phase 3's limits;
    10b. seamless ``SlotServer`` (seamless-serve-f32) as phase 4, with
    cross_len 4096: 48 decode launches a step (24 self, 24 cross over the
    whole cross cache, which serving leaves zero, as the JAX server does),
    the bytes a step must read beside its time, and one more step of each
    path with random cross K/V (kernel against plain within 2e-5); then
    phase 5's timings at seamless's shapes (flash non-causal at [2, 2048,
    16, 64] kv 16 in bf16 and the f32 pair; decode over the cross cache);
    10c. seamless ``make_train_step`` (seamless-train-f32) at full width,
    its preset's remat ("full": each encoder layer and each decoder block
    checkpointed) at the depth ``depth_for`` gives (24 + 24 of 24 + 24),
    tokens and frames [1, 2, 2048]: the checks of phase 7, with 2 x 72
    forward and 72 backward split-f32 flash launches a step and the grads
    at depth 2 + 2.
11. internlm2 ``make_train_step`` (internlm2-train-bf16) at full width and
    depth with bf16 params (``init_train_state``'s default dtype) and the
    default optimizer (f32 moments and accumulation), tokens [1, 2, 2048]:
    the checks of phase 6, with 24 forward and 24 backward flash launches a
    step recorded on the bf16 kernels at dh 128 only (the tensor-core
    forward; the bf16 backward's delta, dk/dv and dq) and the grads at depth
    2 held against the f32 grads of f32 copies of the weights (kernel path
    within 2x / 1.25x of the plain bf16 path's max / mean error, phase 3's
    rule); then one step of each optimizer variant (bf16 moments with bf16
    accumulation, int8 moments, ``compress_grads``), each twice from the same
    state and bitwise equal, with its time and peak memory; then internlm2's
    preset remat ("full") at full depth: its first step bitwise equal to
    one without remat, its step time and peak beside phase 11's;
    11b. gemma2-9b the same way (gemma2-train-bf16), cut as phase 8: its
    launches recorded on the dh 256 bf16 kernels, its first loss held to
    the plain path's (bf16 tolerance);
    11c. the dry-run (``repro_torch.launch.dryrun``) held against phase 11's
    step (no mesh, remat "none", the default optimizer): its trace on
    ``meta`` tensors counts the GEMM FLOPs that ``torch.profiler(with_flops
    =True)`` records for one step on the card, exactly; its kernel calls
    by name equal ``ops.LAUNCHES`` of that step; its peak of live bytes
    lies within ``DRYRUN_PEAK_TOL`` of the step's
    ``torch.cuda.max_memory_allocated``; its roofline's lower bound (H100
    constants) is at most the step's ms; and one production cell
    (``DRYRUN_CELL``, on the fake (16, 16) mesh) runs ``ok`` as a
    subprocess of the dry-run's command line within its timeout: the fake
    process group and DTensor on ``meta`` under this machine's torch. The
    phase within ``DRYRUN_PHASE_S``;
12. grok-1-314b ``make_train_step`` (grok-train-bf16) at full width, bf16
    params and JAX's grok preset (``_BIG``: bf16 moments and accumulation,
    remat "full", ``expert_split`` 2), depth 1 of 64 (device memory: 6.531
    B params x 8 bytes), tokens [1, 2, 2048]: the checks of phase 11, with
    2 forward launches a step recorded as the bf16 forward that writes lse
    (the forward and its recompute, head group 6) and 1 bf16 backward; the
    repeat holds m and v bitwise too, one step runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), and the
    grads at depth 1 stand against the f32 grads of f32 copies (phase 11's
    ratio rule; the f32 reference made first, in place, so that it fits).
examples. the port's examples (``examples/torch_*.py``, imported from this
    checkout and run in this process): ``torch_quickstart`` and
    ``torch_elastic_scaling`` with their own asserts (report #2's backward
    lineage is sales batches 16-23, batch 11 flows into window 1; 120
    committed values 2 i with one failure); ``torch_train_e2e`` at its
    defaults (internlm2 reduced to d_model 128, 2 layers, 4 heads / 2 kv of
    32 dims, 24 steps, a worker kill and a trainer kill at step 16): run B's
    final state bitwise equal to run A's leaf by leaf, one split-f32 flash
    forward and backward launch per layer for every step of the two runs
    and no plain attention call, the runs' wall seconds;
    ``torch_serve_batched`` for each of the ten archs of the configs
    (reduced, d_model 128, 6 requests x 12 tokens on 4 slots): its loop on
    the kernel path with a plain-path server of the same seeded weights
    stepped in lockstep (logits within 2e-5 at every step, greedy tokens
    equal or within 2e-5 of a plain top-2 tie), then the example's server
    alone, its streams the lockstep run's, ``decode_per_step`` decode and
    one step-kernel scan launch per Mamba layer a step, its ms a step;
    ``torch_train_e2e --big`` (d_model 768, 12 layers, head dim 192, 12
    steps, the trainer killed at step 8 after the checkpoint of step 6) as
    the default pair, with 12 + 12 split-f32 launches a step on the dh 192
    pair kernels; and ``repro_torch.launch.serve``'s server at
    ``--d-model 768`` (head dim 192, 8 requests x 16 tokens) as the
    example servers, in lockstep with a plain-path server; the wide route:
    ``repro_torch.launch.train`` at ``--d-model 2048`` (head dim 512,
    ``LAUNCH_TRAIN_WIDE``: 2 layers, 6 steps, a checkpoint every 3) with a
    worker kill and the trainer killed at step 4, bitwise equal to the run
    without (losses, params, m, v), 2 + 2 launches a step, all on the
    cluster route (``ops.FLASH_VARIANTS``), and no
    plain attention call; ``launch.serve --d-model 2048`` and ``1280`` and
    a multi-query server (``--d-model 2048``, 32 heads over one kv head)
    as the example servers. The phase within ``EXAMPLES_PHASE_S``, its
    seconds and the new runs' printed.
sharded. the sharded entry points (``Runtime(shard_activations=True)``,
    state, batch and cache distributed by ``repro_torch.parallel.sharding``'s
    default strategy) on a one-rank NCCL ``DeviceMesh`` (1, 1) ("data",
    "model"), each bitwise equal to the unsharded path with its launch
    counts: internlm2 train-f32 (one step, full width, depth
    ``SHARD_TRAIN_DEPTH``: loss, params, m, v), internlm2 ``serve_step``
    (f32, the serve shape, the cache's sequence on "model": 64 greedy
    steps' logits and the cache), grok forward-bf16 at depth 1 with EP and
    falcon-mamba forward-bf16 at depth ``SHARD_MAMBA_DEPTH`` with d_inner on
    "model"; each step's ms beside the unsharded one's, each state's local
    bytes (``bytes_of``) beside the device peak, within ``SHARD_PHASE_S``.
    One rank shows the DTensor path and its host cost, not the traffic
    between cards. Its process group is destroyed before phase 13 forks.
13. the LOG.io engine (logio-engine; host code, no kernel): the paper's UC1
    (``benchmarks/uc1.py:13-40``: OP1 source, OP2 map, OP3 count window of
    2, OP4 count window of 100 with one external write per output, OP5
    sink), 1,000 unpaced events of 10 KB, built from ``repro_torch.core``:
    every store stack of the tests' "all" set under a crash of OP3 (at
    ``post_log``) and of OP4 (at ``pre_write``), with wall ms, events/s,
    failures and restarts per stack; a full-process crash (``store.crash()``
    and a resumed engine) of sqlite+group and segment+group; ABS beside
    LOG.io with one failure each; lineage capture from OP1 to OP4 beside the
    memory run (best of 3 each), the backward query of an OP4 output (its
    200 source events), the forward query of a source event (one OP4
    output) and its replay (byte-identical); a dispatcher / replica / merger
    pipeline scaled up and down mid-run; UC1 under a live
    ``RecoveryController`` with its decisions. Every run's committed outputs
    are the failure-free ones, each once. Its times are host times, printed
    with the card's name and power limit and the host CPU.
    13b. (logio-process) the same engine in process mode: a worker process
    per operator group, every injected crash a real SIGKILL. After the
    earlier phases' host copies are freed (the host RSS printed), UC1 under
    phase 13's crash plan on each transport (routed, socket, tcp, shm),
    forked from this process, on the memory store, on routed and socket
    with the sqlite+sharded+group store (the sharded phase's seconds came
    out of its tcp and shm runs, which the CPU tests keep), and on routed
    with ``ctx="spawn"`` (sqlite+sharded+group), each beside a thread-mode
    run on the same store just before it (wall ms, events/s, failures,
    restarts, the overhead); OP3 as a paced straggler SIGKILLed mid-run (ms
    until it processes again, and the source events pushed meanwhile,
    which must be > 0); a ``kill -9`` of a whole engine session mid-run,
    resumed on sqlite+sharded+group and segment+group with a durable file
    external system (no row of an uncommitted epoch left); a two-node
    ``LocalCluster`` over tcp with node1 killed; ``replay(mode="process")``
    byte-identical to the thread-mode replay; a scale-up and a scale-down
    on live workers; a live ``RecoveryController`` switch, then a SIGKILL.
    Every run is exactly once. The spawn runs and the killed session run
    from ``chip_engine.py`` (its main script imports no torch). Host times,
    printed as phase 13's.

Phase 2 also holds the decode kernel's lse output and key offset (the
sequence-sharded cache's): at the serve shape, the full cache, grok's
group 6 and seamless's cross cache, its o the same bits with lse as
without, its lse within 1e-5 of the plain version's, and 2 and 4 key
ranges, each run with its offset and merged by their lse
(``ops.merge_attention_parts``), within 2e-5 of the uncut kernel and of
the plain version; phase 5 times each decode row with lse beside it.
Phase 2 also holds the f32 flash backward (``csrc/flash_attention_f32tc.cu``)
against its plain version at rtol = atol = 2e-5 relative to each
gradient's largest magnitude, bitwise repeatable, and the forward's lse;
and the bf16 backward (``csrc/flash_attention_tc_bwd.cu``) at 2e-2 of each
gradient's largest magnitude against the f32 backward of the f32 copies of
its bf16 operands, bitwise repeatable, with the bf16 forward's o the same
bits with and without lse and its lse within 1e-3 of the f32 one. Phase 5
also times the bf16 backward at internlm2's, gemma2's, grok's (head group
6, phase 12's) and seamless's shapes beside its bound and SDPA's bf16
backward, and the bf16 forward's device time with and without lse; it
prints each bf16 flash time beside the earlier design's
(``EARLIER_BF16_FLASH_MS``), and the ``ptxas -v`` report (registers, spill
bytes, serialised wgmma) and dynamic shared memory of each bf16 flash
kernel on a main path (``BF16_FLASH_MAIN``).
Training needs ``CUBLAS_WORKSPACE_CONFIG`` (set here before torch starts)
and runs under ``torch.use_deterministic_algorithms(True)`` from phase 6 on,
so phases 9-12 run under it too. The phases that drive a main path
(3-4b, 6-12) set the launch counts to 0 just before and read them just
after (the sharded phase and the examples phase likewise, around each of
their runs);
phases 13 and 13b launch no kernel.

Every breakdown prints the port's kernel launches the profiler recorded
beside those the wrappers counted, and reads its device busy time as a lower
bound when records are missing. Peak device memory is printed per phase.
f32 products run in full f32 (``allow_tf32`` off for matmul and cuDNN).
Any failure raises and exits non-zero; nothing is turned into success. The
last line is ``{"ok": true, "device": {...}}``. Needs one card; exits
non-zero without one, or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import platform
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path
from unittest import mock

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# deterministic cuBLAS for the training phases; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402
from repro_torch.parallel import sharding as PS  # noqa: E402
from repro_torch.launch import dryrun, train as train_driver  # noqa: E402
from repro_torch.launch.presets import Preset, preset_for  # noqa: E402
from repro_torch.serving import SlotServer, serve_step  # noqa: E402
from repro_torch.training import loss_fn, make_train_step  # noqa: E402
from repro_torch.training import OptHParams, init_train_state  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.optimizer import moment_leaves  # noqa: E402
from repro_torch.training.quant import is_qtensor  # noqa: E402
sys.path.insert(0, str(ROOT))
from chip_engine import (ENGINE_EVENTS, ENGINE_KB, ENGINE_PLAN,  # noqa: E402
                         ENGINE_WINDOWS, PROC_RATE, _proc_store, _uc1_ident,
                         _uc1_replica, crash_plan_run, exactly_once,
                         host_memory, phase_engine_kill9, uc1_pipeline,
                         uc1_run)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
TF32_FLOPS = 495e12   # dense TF32 on the tensor cores; split-f32 runs three products
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SEED = 0
DEVICE = "cuda"   # the phases take their device from here
ARCH = "internlm2-1.8b"
MAMBA_ARCH = "falcon-mamba-7b"
GEMMA_ARCH = "gemma2-9b"
FWD_B, FWD_S = 2, 2048
SLOTS, MAX_LEN, REQUESTS, TOKENS = 4, 4096, 8, 64
TRAIN_STEPS = 2          # timed full-width steps after the checked first one
GRAD_LAYERS = 2          # depth of the kernel-vs-plain gradient check
GRAD_TOL = 1e-4          # that check's tolerance, relative to each leaf's max
LOGIO_RUN = dict(steps=10, ckpt_every=3, seq_len=128, batch_size=4,
                 d_model=512, n_layers=4, seed=3)   # phases 6b and 7b
GROK_ARCH = "grok-1-314b"
GROK_LAYERS = 2          # phases 9 and 9b's depth (of 64): device memory
SEAMLESS_ARCH = "seamless-m4t-large-v2"
# the train cells cut for device memory (phases 7, 8, 10c, 11b, 12) run at
# their preset's remat, as deep as ``train_memory`` reckons within this
TRAIN_GB = 75.0
# and a train step's measured peak lies at most this share below its
# reckoning (``train_memory``; the largest gap, falcon-mamba's, was 3.7%)
TRAIN_MARGIN = 0.05
BF16_LSE_TOL = 1e-3          # the bf16 forward's lse against the f32 one
DECODE_LSE_TOL = 1e-5        # the decode kernel's lse against the plain one
# the sharded phase (one-rank NCCL mesh): internlm2 train-f32's depth (all
# 24 layers), falcon-mamba forward-bf16's depth cut (of 64) and the serve
# steps
SHARD_TRAIN_DEPTH = 24
SHARD_MAMBA_DEPTH = 16
SHARD_SERVE_STEPS = 64
SHARD_PHASE_S = 60.0         # the phase's time budget
# mamba-train-f32's depth when its Mamba layers built a and b at [N, DI, DS]
# (the materialised route): phase 7 also times its step there
MAMBA_EARLIER_DEPTH = 29
# the dry-run phase (11c): its peak against the card's, its production cell
# (a subprocess, with its timeout) and its time budget
DRYRUN_PEAK_TOL = 0.10
DRYRUN_CELL = ("internlm2-1.8b", "prefill_32k")
DRYRUN_CELL_TIMEOUT = 120
DRYRUN_PHASE_S = 45.0
# the examples phase: its time budget and the examples it imports
# 45 s for the examples at their defaults (about 9-10 s on an H100), and
# 60 s each for torch_train_e2e --big (four checkpoints of ~1.2 GB) and the
# launch.serve --d-model 768 pair; 60 s for the wide route's runs
# (launch.train --d-model 2048's pair, four checkpoints of ~1.6 GB, and
# three servers)
EXAMPLES_PHASE_S = 225.0
EXAMPLE_NAMES = ("quickstart", "elastic_scaling", "train_e2e", "serve_batched")
# the ops ``torch.profiler(with_flops=True)`` counts as matrix products
PROFILER_GEMMS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")

KERNELS = {
    # bf16 (the forward path) runs on the tensor cores; f32 (the train path)
    # on split-f32 tensor-core kernels (``ops.flash_variant``), timed beside
    # it in phase 5
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    # the Pallas kernel has no backward (JAX differentiates XLA attention);
    # this is the backward of the kernel that replaces it, on the f32 train
    # path (phases 6-8, 10c)
    "flash_attention_backward": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    # the backward of the bf16 forward, on the bf16 train path (phases 11,
    # 11b); it counts in ops.LAUNCHES["flash_attention_backward"] too, and
    # its row reads the bf16 phases' counts
    "flash_attention_backward_bf16": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_tc_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:79"),
    "selective_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:49"),
    # the Pallas scan has no backward (JAX differentiates its XLA scans,
    # models/layers.py:539-561); this is the backward of the kernel that
    # replaces it, on the Mamba train path
    "selective_scan_backward": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:49"),
    # JAX's default Mamba path, its chunked branch (models/layers.py:539, an
    # XLA lax.scan that builds a and b and takes h.C per chunk): the fused
    # scan keeps the blocking of the Pallas scan it names (the carried
    # state on chip, a chunk at a time), so that kernel is what it replaces
    # on the TPU side. Its backward has no counterpart (JAX differentiates
    # the XLA scan). Both on every full-sequence Mamba path at S > 256 with
    # S % 256 == 0 (phases 3b, 7, the sharded phase)
    "selective_scan_fused": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/selective_scan_fused.cu",
        replaces="src/repro/kernels/selective_scan.py:49",
        replaces_branch="src/repro/models/layers.py:539"),
    "selective_scan_fused_backward": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/selective_scan_fused.cu",
        replaces="src/repro/kernels/selective_scan.py:49",
        replaces_branch="src/repro/models/layers.py:539"),
    # head dims above 256 (either dtype): the flash pair on the
    # launch.train --d-model 2048 path (f32; bf16 timed beside it), on the
    # cluster route up to 1024 (``ops.flash_variant`` "cluster": the
    # split-f32 kernels over a cluster of N ranks, one TF32 product in
    # bf16), decode's group route on the launch.serve --d-model 2048 and
    # 1280 servers. They count in ops.LAUNCHES under their wrappers' names;
    # their rows read the launches recorded above head dim 256
    # (``ops.BUILT_WIDTHS``). Above 1024 flash takes the CUDA-core route
    # (``csrc/flash_attention_wide.cu``), which no model runs: phase 2
    # holds it to its plain version and phase 5 times it beside the cluster
    # route as the same-call parent
    "flash_attention_wide": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_f32tc_cluster.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    "flash_attention_backward_wide": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_f32tc_cluster.cu",
        replaces="src/repro/kernels/flash_attention.py:93"),
    "decode_attention_wide": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:79"),
}
# flash's device kernels by variant (``ops.flash_variant``: dtype and head
# dim), the scan's by ``ops.scan_variant``. Names are matched as substrings;
# no name of one variant contains another's.
FLASH_TC = "flash_fwd_tc_kernel"
FLASH_TC_BWD = ("flash_bwd_tc_delta_kernel", "flash_bwd_tc_dkdv_kernel",
                "flash_bwd_tc_dq_kernel")
F32TC_FWD_PREP, F32TC_FWD = "flash_f32tc_fwd_prep_kernel", "flash_f32tc_fwd_kernel"
F32TC_BWD_PREP = "flash_f32tc_bwd_prep_kernel"
F32TC_BWD = (F32TC_BWD_PREP, "flash_f32tc_dkdv_kernel", "flash_f32tc_dq_kernel")
# split-f32 at D = 256: the same prep launches, then kernels whose blocks form
# clusters of two (one per half of the head dim)
F32TC_FWD_D256 = "flash_f32tc_fwd_d256_kernel"
F32TC_BWD_D256 = (F32TC_BWD_PREP, "flash_f32tc_dkdv_d256_kernel",
                  "flash_f32tc_dq_d256_kernel")
# and at D = 192, pairs of 96-column blocks
F32TC_FWD_D192 = "flash_f32tc_fwd_d192_kernel"
F32TC_BWD_D192 = (F32TC_BWD_PREP, "flash_f32tc_dkdv_d192_kernel",
                  "flash_f32tc_dq_d192_kernel")
# above 256 and up to 1024 (the cluster route): the same prep launches, then
# kernels whose blocks form clusters of N ranks, in f32 and bf16 (the wide
# route's forward and backward)
F32TC_FWD_CLUSTER = "flash_f32tc_fwd_cluster_kernel"
WIDE_FWD = (F32TC_FWD_PREP, F32TC_FWD_CLUSTER)
WIDE_BWD = (F32TC_BWD_PREP, "flash_f32tc_dkdv_cluster_kernel",
            "flash_f32tc_dq_cluster_kernel")
# above 1024 (the CUDA-core route): its forward and its backward's two
# launches; and decode's group route (head groups above 16, head dims above
# 256: ``ops.decode_plan``) beside the decode kernel, with its second merge
# where the plan has several clusters per (slot, kv head, chunk)
CUDA_CORE_FWD = "flash_wide_fwd_kernel"
CUDA_CORE_BWD = ("flash_wide_dkdv_kernel", "flash_wide_dq_kernel")
DECODE_KERNEL, DECODE_GROUP = "decode_attention_kernel", "decode_group_kernel"
DECODE_GROUP_MERGE = "decode_group_merge_kernel"
SCAN_KERNEL = {"sequential": "selective_scan_kernel",
               "step": "selective_scan_step_kernel"}
SCAN_BWD = "selective_scan_bwd_kernel"
# the fused scan's forward, and its backward's two launches
SSF_FWD = "ssf_fwd_kernel"
SSF_BWD = ("ssf_bwd_kernel", "ssf_reduce_kernel")
# per wrapper, per variant: its device kernels and how many of them one
# counted launch runs
DEVICE_KERNELS = {
    "flash_attention": [((FLASH_TC,), 1),
                        ((F32TC_FWD_PREP, F32TC_FWD, F32TC_FWD_D256,
                          F32TC_FWD_D192, F32TC_FWD_CLUSTER), 2),
                        ((CUDA_CORE_FWD,), 1)],
    "flash_attention_backward": [(F32TC_BWD + F32TC_BWD_D256[1:]
                                  + F32TC_BWD_D192[1:] + WIDE_BWD[1:], 3),
                                 (FLASH_TC_BWD, 3), (CUDA_CORE_BWD, 2)],
    "decode_attention": [((DECODE_KERNEL,), 1), ((DECODE_GROUP,), 1)],
    "selective_scan": [(tuple(SCAN_KERNEL.values()), 1)],
    "selective_scan_backward": [((SCAN_BWD,), 1)],
    "selective_scan_fused": [((SSF_FWD,), 1)],
    "selective_scan_fused_backward": [(SSF_BWD, 2)],
}


def f32tc_names(D: int) -> tuple:
    """The split-f32 device kernels of head dim D: (forward's, backward's),
    those of the instance ``ops.flash_built_head_dim`` picks (the pair
    kernels at 192 and 256, the cluster kernels above)."""
    built = ops.flash_built_head_dim(torch.float32, D)
    if built > 256:
        return WIDE_FWD, WIDE_BWD
    if built == 256:
        return (F32TC_FWD_PREP, F32TC_FWD_D256), F32TC_BWD_D256
    if built == 192:
        return (F32TC_FWD_PREP, F32TC_FWD_D192), F32TC_BWD_D192
    return (F32TC_FWD_PREP, F32TC_FWD), F32TC_BWD


def decode_plan(B: int, H: int, KV: int, S: int, D: int, dtype):
    """``ops.decode_plan`` of a decode call on this card, at the built head
    dim of D."""
    return ops.decode_plan(B, H, KV, S, ops.built_head_dim(dtype, D),
                           ops.sm_count(0), dtype)


def decode_names(B: int, H: int, KV: int, S: int, D: int, dtype) -> tuple:
    """The device kernels of a decode call (``ops.decode_plan``): the narrow
    kernel, or the group kernel and, with several clusters per (slot, kv
    head, chunk), its second merge; each launched once a call."""
    plan = decode_plan(B, H, KV, S, D, dtype)
    if plan.route == "narrow":
        return (DECODE_KERNEL,)
    return (DECODE_GROUP,) + ((DECODE_GROUP_MERGE,) if plan.clusters > 1 else ())


def sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(got, want, tol, what) -> float:
    err = max_err(got, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return err


def check_flash_rows(got, q, k, v, kw, what) -> float:
    """The bf16 flash output against the f32 result of its own inputs,
    row by row (``ref.BF16_ROW_TOL``)."""
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    err = ref.row_error(got, exact)
    check(err <= ref.BF16_ROW_TOL,
          f"{what}: row error {err:.3e} > {ref.BF16_ROW_TOL}")
    return err


def cuda_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of fn() in ms; ``flush`` runs between launches
    outside the timed window (to start from a cold L2)."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _dev_time_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def profile_kernels(fn, iters: int = 10, warm: bool = False) -> dict:
    """Device time of fn() by kernel name, from torch.profiler (CUPTI):
    {"kernels": {name: (launches recorded / iters, ms recorded / iters)},
    "counted": {wrapper: launches ``ops.LAUNCHES`` counted / iters}}.
    "kernels" is empty when the profiler saw no device activity. One call
    runs first, outside the profile, unless ``warm`` (fn has run at these
    shapes just before). Only device activity is traced: the host's ops
    are read nowhere, and tracing them took most of a train step's profile
    (seamless's 24 + 24 layers: 20.7 s for one step)."""
    from torch.profiler import ProfilerActivity, profile
    if not warm:
        fn()
    sync()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    counted = {k: (ops.LAUNCHES[k] - before[k]) / iters for k in before
               if ops.LAUNCHES[k] != before[k]}
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = _dev_time_us(ev)
            if t > 0:
                out[ev.key] = (ev.count / iters, t / iters / 1e3)
    return {"kernels": out, "counted": counted}


def profile_recorded(fn, names, per_call: float, iters: int = 10,
                     grow: int = 1, tries: int = 3, warm: bool = False) -> tuple:
    """(profile, calls of fn made): ``profile_kernels(fn, iters)``, made
    again (up to ``tries`` profiles, ``iters`` times ``grow`` each time)
    while it recorded fewer than ``per_call`` launches a call of a device
    kernel in ``names``. CUPTI drops a record now and then: a launch the
    wrapper counted, whose kernel ran, missing from the profile. What
    follows holds the last profile to its counts all the same."""
    calls = 0
    for n in range(tries):
        prof = profile_kernels(fn, iters, warm)
        calls += iters + (0 if warm else 1)
        got = {x: recorded(prof, x) for x in names}
        if all(v >= per_call for v in got.values()) or n == tries - 1:
            return prof, calls
        log(f"profile: records missing ({got}, want {per_call:g} a call of "
            f"each); profiling again")
        iters *= grow


def kernel_ms(prof: dict, *names: str):
    """Device ms per launch, summed over the kernels whose names contain one
    of names (each launched once per call); per launch recorded, so a launch
    the profiler dropped does not dilute it."""
    hits = [ms / n for key, (n, ms) in prof["kernels"].items()
            if n and any(x in key for x in names)]
    return sum(hits) if hits else None


def recorded(prof: dict, name: str) -> float:
    """Launches per call the profiler recorded of the device kernel ``name``."""
    return sum(n for key, (n, _) in prof["kernels"].items() if name in key)


def log_breakdown(tag: str, prof: dict, wall_ms: float, top: int = 6) -> None:
    """Device busy time against host wall time per call, and the top kernels.

    Busy time is the sum of the milliseconds the profiler recorded, per call.
    Beside it stand the port's kernel launches the profiler recorded and
    those the wrappers counted for the same calls: when fewer were recorded,
    records were dropped and the busy total is a lower bound (drops among
    library kernels cannot be seen this way)."""
    kernels = prof["kernels"]
    if not kernels:
        log(f"breakdown {tag}: profiler saw no device time (not measured)")
        return
    busy = sum(ms for _, ms in kernels.values())
    short = []
    for name, per_call in sorted(prof["counted"].items()):
        variants = DEVICE_KERNELS[name]
        by_name = {x: recorded(prof, x) for names, _ in variants for x in names}
        # counted launches the records account for, each variant's kernels
        # divided by how many one launch runs
        seen = sum(sum(by_name[x] for x in names) / per_launch
                   for names, per_launch in variants)
        ran = [x for names, _ in variants for x in names if by_name[x]]
        log(f"breakdown {tag}: {name} launches recorded {seen:g} / counted "
            f"{per_call:g} per call ("
            + ", ".join(f"{x} {by_name[x]:g}" for x in ran)
            + f"), {_fmt(kernel_ms(prof, *ran))} ms per launch")
        if seen < per_call:
            short.append(name)
    bound = ">= " if short else ""
    note = (f" (lower bound: launch records of {', '.join(short)} missing)"
            if short else "")
    log(f"breakdown {tag}: wall {wall_ms:.3f} ms/call, device busy "
        f"{bound}{busy:.3f} ms/call ({bound}{100 * busy / wall_ms:.1f}%, idle "
        f"{'<= ' if short else ''}{100 * (1 - busy / wall_ms):.1f}%){note}")
    for key, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {100 * ms / busy:5.1f}% {ms:8.4f} ms x{n:g} {key[:90]}")


def log_memory(tag: str, reckoned_gb=None):
    """Peak device memory since the last reset (beside what was reckoned
    for it, where given), then reset it; and the seconds since the script
    started, which time each phase. Returns the peak in GB (None off the
    card)."""
    if torch.device(DEVICE).type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        log(f"memory {tag}: peak {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)"
            f" allocated" + (f", reckoned {reckoned_gb:.1f} GB"
                             if reckoned_gb is not None else "")
            + f" (at {time.perf_counter() - T_START:.1f} s)")
        torch.cuda.reset_peak_memory_stats()
        return peak / 1e9
    return None


def runtime(impl: str, remat: str = "none") -> M.Runtime:
    """The kernel path or the plain path, for attention and scan alike,
    with ``remat`` named (the port's default is JAX's "block")."""
    return M.Runtime(attn_impl=impl, scan_impl=impl, remat=remat)


def host_ms(fn, iters: int) -> float:
    """Host wall time per call of fn(), synchronised at both ends."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    _, secs = build.build()
    build.load()
    log(f"build: {secs:.1f} s ({build.library_path().name})")
    text = build.build_log()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
    serial = len(re.findall(r"wgmma.mma_async instructions are serialized", text))
    log(f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} registers, "
        f"{sum(1 for x in spills if x)} with spills (max {max(spills, default=0)}"
        f" bytes), {serial} with wgmma serialized")
    return {"name": name, "smi": smi.splitlines()[0]}


# the bf16 flash kernels on a main path: (kernel, template arguments) as the
# source declares them (D, softcap[, lse])
BF16_FLASH_MAIN = [
    ("flash_fwd_tc_kernel", (256, True, True)),        # gemma2-train-bf16
    ("flash_bwd_tc_dkdv_kernel", (128, False)),        # internlm2-train-bf16
    ("flash_bwd_tc_dq_kernel", (128, False)),
    ("flash_bwd_tc_dkdv_kernel", (256, True)),         # gemma2-train-bf16
    ("flash_bwd_tc_dq_kernel", (256, True)),
]


def _kernel_key(mangled: str):
    """(name, template arguments) of a flash kernel's mangled name, e.g.
    ``...flash_bwd_tc_dq_kernelILi128ELb0EE...`` -> ("flash_bwd_tc_dq_kernel",
    (128, False)); None for any other function."""
    m = re.search(r"(flash_(?:fwd|bwd)_tc(?:_[a-z]+)?_kernel)I((?:L[ib]\d+E)+)E",
                  mangled)
    if m is None:
        return None
    args = tuple(int(v) if t == "i" else v == "1"
                 for t, v in re.findall(r"L([ib])(\d+)E", m.group(2)))
    return m.group(1), args


def ptxas_kernels(text: str, key=_kernel_key) -> dict:
    """The build's ``-Xptxas -v`` report by flash kernel: {(name, template
    arguments): {"registers", "stack", "spill_stores", "spill_loads",
    "serialized"}} ("serialized": ptxas's C7512, wgmma serialised); or by
    ``key(mangled name)`` of any kernel it does not map to None."""
    out, cur = {}, None
    for line in text.splitlines():
        if "serialized" in line:   # C7512 names its function
            m = re.search(r"function '(\w+)'", line)
            k = key(m.group(1)) if m else None
            if k:
                out.setdefault(k, {})["serialized"] = True
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = key(m.group(1))
            if cur:
                out.setdefault(cur, {}).setdefault("serialized", False)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# the bf16 flash kernels at head dim 192 (native instances, off the main
# paths: the --big trainer and the d_model 768 server run f32)
BF16_FLASH_D192 = [
    ("flash_fwd_tc_kernel", (192, False, True)),
    ("flash_fwd_tc_kernel", (192, True, True)),
    ("flash_bwd_tc_dkdv_kernel", (192, False)),
    ("flash_bwd_tc_dq_kernel", (192, False)),
    ("flash_bwd_tc_dkdv_kernel", (192, True)),
    ("flash_bwd_tc_dq_kernel", (192, True)),
]


def log_ptxas_kernels(needle: str) -> dict:
    """ptxas's registers and spill bytes of every kernel whose mangled name
    contains ``needle`` (e.g. the split-f32 pair kernels at D = 192):
    {mangled name: record of ``ptxas_kernels``}."""
    out = ptxas_kernels(build.build_log(),
                        key=lambda name: name if needle in name else None)
    for name, rec in sorted(out.items()):
        log(f"ptxas {name}: {rec.get('registers', 'not reported')} registers, "
            f"{rec.get('spill_stores', 'not reported')} bytes spill stores, "
            f"{rec.get('spill_loads', 'not reported')} bytes spill loads")
    return out


def log_decode_group() -> dict:
    """ptxas's registers and spill bytes of the decode group route's
    kernels (every instance), and the dynamic shared memory a block of the
    group kernel takes at phase 5's shapes in f32 (the C side's
    ``repro_decode_group_smem`` of their plans). Fails unless the plan's
    copy of the layout (``ops.group_smem``) gives the same bytes over the
    plans of a grid of shapes, in both dtypes."""
    lib = build.load()
    grid = 0
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        el = torch.empty((), dtype=dtype).element_size()
        for B in (1, 4, 64):
            for H, KV in ((17, 1), (32, 1), (71, 1), (4, 2), (48, 8)):
                for D in (64, 128, 256, 320, 512, 1024, 16384):
                    p = ops.group_plan(B, H, KV, 4096, D, ops.sm_count(0),
                                       dtype)
                    for n in range(1, p.cluster + 1):
                        c = lib.repro_decode_group_smem(
                            p.head_chunk, D, p.tile_keys, p.panel_cols, n,
                            code)
                        check(c == ops.group_smem(p.head_chunk, D,
                                                  p.tile_keys, p.panel_cols,
                                                  n, el),
                              f"decode group layout: C {c} bytes against "
                              f"ops.group_smem at {p}, cluster {n}")
                        grid += 1
    log(f"decode group route: the plan's layout copy equals the C side's at "
        f"{grid} (plan, cluster) points")
    smem = {}
    for B, S, H, KV, D in (DECODE_D512_SHAPE, DECODE_GROUP32_SHAPE,
                           DECODE_GROUP71_SHAPE):
        p = decode_plan(B, H, KV, S, D, torch.float32)
        key = f"[{B},{S},{H},{KV},{D}]"
        smem[key] = lib.repro_decode_group_smem(
            p.head_chunk, D, p.tile_keys, p.panel_cols, p.cluster, 0)
        log(f"decode group route {key} f32: {p}, {smem[key]} bytes of "
            f"dynamic shared memory a block")
    return {"ptxas": log_ptxas_kernels("decode_group"),
            "dynamic_smem_bytes": smem, "layout_points": grid}


def log_ptxas_bf16_flash(kernels=None) -> dict:
    """ptxas's registers, spill bytes, stack, C7512 and the block's dynamic
    shared memory (from the library) of each bf16 flash kernel on a main
    path, or of ``kernels`` ({"name<args>": record})."""
    report = ptxas_kernels(build.build_log())
    lib = build.load()
    rows = {}
    for name, targs in kernels or BF16_FLASH_MAIN:
        rec = dict(report.get((name, targs), {}))
        smem = (lib.repro_flash_tc_smem(targs[0]) if "fwd" in name
                else lib.repro_flash_tc_bwd_smem(targs[0], int("dq" in name)))
        rec["dynamic_smem_bytes"] = smem
        label = name + "<" + ", ".join(
            str(a).lower() for a in targs) + ">"
        log(f"ptxas {label}: {rec.get('registers', 'not reported')} registers, "
            f"{rec.get('spill_stores', 'not reported')} bytes spill stores, "
            f"{rec.get('spill_loads', 'not reported')} bytes spill loads, "
            f"{rec.get('stack', 'not reported')} bytes stack, wgmma "
            + ("serialized (C7512)" if rec.get("serialized") else "not serialized")
            + f"; {smem} bytes of dynamic shared memory a block")
        rows[label] = rec
    return rows


# Device ms of the earlier design of the bf16 flash pair (the backward: one
# consumer warpgroup a 64-row block, no producer warp; at dh 256 both
# warpgroups recomputing the scores; the forward at dh 256: 64-key tiles in
# two stages), chip_smoke.py phase 5 on an NVIDIA H100 80GB HBM3 at 700.00 W;
# printed beside this run's
EARLIER_BF16_FLASH_MS = {
    "forward dh 128 (internlm2)": 0.0901,
    "forward dh 128 group 6 (grok)": 0.2710,
    "forward dh 64 non-causal (seamless)": 0.1180,
    "forward dh 256 softcap 50 (gemma2)": 0.3523,
    "backward dh 128 (internlm2)": 0.4739,
    "backward dh 256 softcap 50 (gemma2)": 1.7566,
    "backward dh 64 non-causal (seamless)": 0.6173,
}


def log_against_earlier(now: dict) -> None:
    for key, was in EARLIER_BF16_FLASH_MS.items():
        t = now.get(key)
        log(f"bf16 flash {key}: device "
            + (f"{t:.4f} ms ({t / was:.3f}x)" if t else "not measured")
            + f"; the earlier design {was:.4f} ms")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device=DEVICE).to(dtype)


DECODE_CASES = [
    # (B, S, H, KV, D, dtype, window, softcap, lengths) ; None -> random in [1,S]
    (4, 4096, 16, 8, 128, torch.float32, None, None, None),
    (4, 4096, 16, 8, 128, torch.bfloat16, None, None, None),
    (2, 8192, 16, 8, 256, torch.float32, 4096, 50.0, None),
    (4, 1024, 16, 8, 128, torch.float32, None, None, [1025, 2048, 1500, 3072]),
    # with a window, lengths > S + window leave no valid key (uniform softmax)
    (4, 1024, 16, 8, 128, torch.float32, 512, None, [1100, 1535, 1536, 2048]),
    # the serve path's lengths (64 keys a slot: most splits of each cluster
    # get none), most splits empty, S a multiple of neither the split count
    # nor the ring tile, head group 16 at D = 256, bf16 with window and
    # softcap
    (4, 4096, 16, 8, 128, torch.float32, None, None, [64, 64, 64, 64]),
    (4, 4096, 16, 8, 128, torch.float32, None, None, [1, 64, 1, 4096]),
    (2, 2047, 16, 8, 128, torch.float32, None, None, [2047, 1999]),
    (2, 4096, 32, 2, 256, torch.float32, None, None, [4096, 3000]),
    (4, 4096, 16, 8, 128, torch.bfloat16, 1000, 30.0, None),
    # head groups 6 (grok's serve shape) and 7 (arctic's heads): the kernel
    # takes them in its group-of-8 instance, two or one lanes of it idle
    (4, 4096, 48, 8, 128, torch.float32, None, None, [64, 64, 64, 64]),
    (4, 4096, 48, 8, 128, torch.float32, None, None, None),
    (4, 4096, 48, 8, 128, torch.bfloat16, 1000, 30.0, None),
    (4, 4096, 56, 8, 128, torch.float32, None, None, None),
    (2, 2047, 56, 8, 128, torch.float32, None, None, [2047, 64]),
    # seamless's serve shape (D = 64, head group 1): self-attention at 64
    # keys a slot, cross-attention over the whole cross cache (every split
    # of a cluster holds keys), random lengths
    (4, 4096, 16, 16, 64, torch.float32, None, None, [64] * 4),
    (4, 4096, 16, 16, 64, torch.float32, None, None, [4096] * 4),
    (4, 4096, 16, 16, 64, torch.float32, None, None, None),
    (4, 4096, 16, 16, 64, torch.bfloat16, None, None, [64] * 4),
    (4, 4096, 16, 16, 64, torch.bfloat16, None, None, [4096] * 4),
    (4, 4096, 16, 16, 64, torch.bfloat16, None, None, None),
    # the examples phase's servers (reduced, d_model 128: 4 heads, 2 kv, D
    # 32, a 64-position cache): ragged lengths; gemma2's window 8 and
    # softcap 50; seamless's cross cache of 16 zero-filled keys
    (4, 64, 4, 2, 32, torch.float32, None, None, [1, 17, 64, 40]),
    (4, 64, 4, 2, 32, torch.float32, 8, 50.0, [1, 17, 64, 40]),
    (4, 16, 4, 2, 32, torch.float32, None, None, [16] * 4),
    # D = 192 (launch.serve --d-model 768: 4 heads / 2 kv, max_len 128;
    # then B=4 S=4096 kv 8 at head groups 2 and 6, 64 valid keys and a full
    # cache) in f32 and bf16
    (4, 128, 4, 2, 192, torch.float32, None, None, [1, 17, 128, 40]),
    (4, 4096, 16, 8, 192, torch.float32, None, None, [64] * 4),
    (4, 4096, 16, 8, 192, torch.float32, None, None, [4096] * 4),
    (4, 4096, 48, 8, 192, torch.float32, None, None, [64] * 4),
    (4, 4096, 48, 8, 192, torch.float32, None, None, [4096] * 4),
    (4, 4096, 16, 8, 192, torch.bfloat16, None, None, [64] * 4),
    (4, 4096, 16, 8, 192, torch.bfloat16, None, None, [4096] * 4),
    (4, 4096, 48, 8, 192, torch.bfloat16, None, None, [64] * 4),
    (4, 4096, 48, 8, 192, torch.bfloat16, 1000, 30.0, [4096] * 4),
    # the padded route (``ops.built_head_dim``): D 16 (the tests'
    # reduced(d_model=64)), 48 and 80, each run on the next built width
    (4, 64, 4, 2, 16, torch.float32, None, None, [1, 17, 64, 40]),
    (4, 64, 4, 2, 16, torch.bfloat16, 8, 50.0, [1, 17, 64, 40]),
    (4, 4096, 16, 8, 48, torch.float32, None, None, None),
    (4, 4096, 48, 8, 48, torch.bfloat16, None, None, [64] * 4),
    (4, 4096, 16, 8, 80, torch.float32, 1000, 30.0, None),
    (4, 4096, 16, 8, 80, torch.bfloat16, None, None, [4096] * 4),
    # the group route (head dims above 256, head groups above 16): B=4
    # S=4096 H=4 kv 2 at D 512 (64 keys and a full cache, both dtypes), 320
    # (window, softcap), 1024 and a padded 300; head groups 24, 32, 48 and
    # 71 over one kv head at D 64 (Falcon-7B's layout), 32 at D 512, 17 at
    # D 192
    (4, 4096, 4, 2, 512, torch.float32, None, None, [64] * 4),
    (4, 4096, 4, 2, 512, torch.float32, None, None, [4096] * 4),
    (4, 4096, 4, 2, 512, torch.bfloat16, None, None, [64] * 4),
    (4, 4096, 4, 2, 512, torch.bfloat16, 1000, 30.0, [4096] * 4),
    (4, 4096, 4, 2, 320, torch.float32, 1000, 30.0, None),
    (4, 4096, 4, 2, 1024, torch.float32, None, None, [64, 4096, 3, 1000]),
    (4, 1024, 4, 2, 300, torch.float32, None, None, None),
    (4, 4096, 24, 1, 64, torch.float32, None, None, None),
    (4, 4096, 32, 1, 64, torch.float32, None, None, [4096] * 4),
    (4, 4096, 48, 1, 64, torch.bfloat16, 1000, 30.0, None),
    (4, 4096, 71, 1, 64, torch.float32, None, None, [64, 4096, 3, 1000]),
    (4, 4096, 71, 1, 64, torch.bfloat16, None, None, [4096] * 4),
    (4, 4096, 32, 1, 512, torch.float32, None, None, None),
    (2, 1024, 34, 2, 192, torch.float32, None, None, [1000, 64]),
]

# the decode kernel's lse and key offset (the sequence-sharded cache): each
# shape cut into 2 and 4 key ranges, each range run with its offset and
# its lse, merged (``ops.merge_attention_parts``): (tag, B, S, H, KV, D,
# lengths); f32
DECODE_SPLIT_CASES = [
    ("serve shape", 4, 4096, 16, 8, 128, [64] * 4),
    ("full cache", 4, 4096, 16, 8, 128, [4096] * 4),
    ("grok group 6", 4, 4096, 48, 8, 128, [64] * 4),
    ("seamless cross", 4, 4096, 16, 16, 64, [4096] * 4),
    # D = 192 at head groups 2 and 6, and the padded D = 80
    ("dh 192 serve shape", 4, 4096, 16, 8, 192, [64] * 4),
    ("dh 192 group 6 full cache", 4, 4096, 48, 8, 192, [4096] * 4),
    ("dh 80 (padded to 128)", 4, 4096, 16, 8, 80, [4096] * 4),
    # the group route at D 512, 320 and 1024, and head groups 32 and 71
    # over one kv head, 32 at D 512
    ("dh 512 serve shape", 4, 4096, 4, 2, 512, [64] * 4),
    ("dh 512 full cache", 4, 4096, 4, 2, 512, [4096] * 4),
    ("dh 320", 4, 4096, 4, 2, 320, [1, 17, 4096, 2000]),
    ("dh 1024", 4, 4096, 4, 2, 1024, [64, 4096, 3, 1000]),
    ("group 32", 4, 4096, 32, 1, 64, [4096] * 4),
    ("group 71", 4, 4096, 71, 1, 64, [64, 4096, 3, 1000]),
    ("group 32 dh 512", 4, 4096, 32, 1, 512, [64, 4096, 3, 1000]),
]

FLASH_CASES = [
    # (B, S, H, KV, D, dtype, causal, window, softcap)
    (2, 2048, 16, 8, 128, torch.bfloat16, True, None, None),
    (2, 2048, 16, 8, 128, torch.float32, True, None, None),
    (1, 2048, 16, 8, 256, torch.bfloat16, True, 512, 50.0),
    (1, 1024, 16, 8, 256, torch.float32, True, 300, 50.0),
    (2, 2048, 16, 8, 256, torch.float32, True, None, 50.0),   # gemma2's train step
    (2, 1024, 16, 8, 128, torch.bfloat16, False, None, None),
    (2, 1000, 16, 8, 128, torch.float32, True, None, None),
    (1, 1000, 8, 2, 64, torch.bfloat16, True, 128, 30.0),
    (2, 2048, 16, 8, 32, torch.bfloat16, True, None, None),
    (2, 1024, 8, 2, 64, torch.bfloat16, True, None, None),
    (2, 1000, 16, 8, 128, torch.bfloat16, False, None, None),   # ragged, no mask
    # head groups 6 (grok's forward shape) and 7 (arctic's heads)
    (2, 2048, 48, 8, 128, torch.bfloat16, True, None, None),
    (1, 1000, 48, 8, 128, torch.float32, True, None, None),
    (2, 1024, 56, 8, 128, torch.bfloat16, True, None, None),
    (1, 1000, 56, 8, 128, torch.bfloat16, False, None, None),
    # seamless (dh 64, head group 1): its encoder and cross-attention
    # (non-causal) and its decoder (causal)
    (2, 2048, 16, 16, 64, torch.bfloat16, False, None, None),
    (2, 2048, 16, 16, 64, torch.float32, False, None, None),
    (2, 2048, 16, 16, 64, torch.bfloat16, True, None, None),
    (2, 2048, 16, 16, 64, torch.float32, True, None, None),
    # dh 256 in bf16 at the edges of its 32-key tiles: S a multiple of
    # neither 32 nor 128, a window that ends inside a tile, softcap
    (1, 1000, 16, 8, 256, torch.bfloat16, True, None, 50.0),
    (1, 1100, 16, 8, 256, torch.bfloat16, True, 300, 50.0),
    (2, 1000, 16, 8, 256, torch.bfloat16, False, None, 30.0),
    # the examples phase's trainer (run_training reduced to d_model 128:
    # 4 heads, 2 kv, D 32), split-f32
    (4, 64, 4, 2, 32, torch.float32, True, None, None),
    # D = 192: torch_train_e2e --big's shape (d_model 768, 4 heads, 2 kv),
    # then [2, 2048, 16, 192] kv 8 causal without and with softcap 50, in
    # both dtypes
    (4, 64, 4, 2, 192, torch.float32, True, None, None),
    (4, 64, 4, 2, 192, torch.bfloat16, True, None, None),
    (2, 2048, 16, 8, 192, torch.float32, True, None, None),
    (2, 2048, 16, 8, 192, torch.float32, True, None, 50.0),
    (2, 2048, 16, 8, 192, torch.bfloat16, True, None, None),
    (2, 2048, 16, 8, 192, torch.bfloat16, True, None, 50.0),
    (1, 1000, 16, 8, 192, torch.bfloat16, True, 300, 30.0),
    # the padded route: D 16 (reduced(d_model=64)), 48 and 80
    (4, 64, 4, 2, 16, torch.float32, True, None, None),
    (4, 64, 4, 2, 16, torch.bfloat16, True, None, None),
    (2, 1024, 16, 8, 16, torch.float32, True, None, None),
    (1, 1000, 8, 2, 48, torch.float32, True, 128, 30.0),
    (1, 1000, 8, 2, 48, torch.bfloat16, True, 128, 30.0),
    (2, 1024, 16, 8, 80, torch.float32, False, None, None),
    (2, 1024, 16, 8, 80, torch.bfloat16, True, None, None),
    # above head dim 256, on the cluster route (ranks of 128 columns at 512
    # and 1024, 64 at 320, 96 at 576): [2, 256, 4, 512] kv 2 causal, plain,
    # with softcap 50 and with a window; [1, 128, 4, 320] kv 2 and a padded
    # 300 (built 320); [1, 128, 2, 1024] kv 1 non-causal; each in f32 and
    # bf16; head groups 24 and 17 (the cluster route, tensor_core,
    # split_f32); then at small S: 576 in both dtypes, a padded 704 (built
    # 768), head groups 17 at 512 and 24 at 576, and the CUDA-core route at
    # 1088 (above the cluster's reach)
    (2, 256, 4, 2, 512, torch.float32, True, None, None),
    (2, 256, 4, 2, 512, torch.float32, True, None, 50.0),
    (2, 256, 4, 2, 512, torch.float32, True, 100, None),
    (2, 256, 4, 2, 512, torch.bfloat16, True, None, None),
    (2, 256, 4, 2, 512, torch.bfloat16, True, None, 50.0),
    (2, 256, 4, 2, 512, torch.bfloat16, True, 100, None),
    (1, 128, 4, 2, 320, torch.float32, True, None, None),
    (1, 128, 4, 2, 320, torch.bfloat16, True, None, None),
    (1, 128, 4, 2, 300, torch.float32, True, 40, 30.0),
    (1, 128, 4, 2, 300, torch.bfloat16, True, None, None),
    (1, 128, 2, 1, 1024, torch.float32, False, None, None),
    (1, 128, 2, 1, 1024, torch.bfloat16, False, None, None),
    (1, 300, 48, 2, 320, torch.float32, True, None, None),
    (1, 300, 34, 2, 128, torch.bfloat16, True, None, None),
    (1, 300, 34, 2, 64, torch.float32, True, None, None),
    (1, 128, 4, 2, 576, torch.float32, True, 40, 30.0),
    (1, 128, 4, 2, 576, torch.bfloat16, True, None, None),
    (1, 100, 4, 2, 704, torch.float32, False, None, None),
    (1, 100, 4, 2, 704, torch.bfloat16, True, None, 50.0),
    (1, 130, 34, 2, 512, torch.float32, True, None, None),
    (1, 130, 48, 2, 576, torch.bfloat16, True, 50, None),
    (1, 96, 2, 1, 1088, torch.float32, True, None, None),
    (1, 96, 2, 1, 1088, torch.bfloat16, True, None, 30.0),
]

FLASH_CROSS_CASES = [
    # Sq != Sk without a mask, as seamless's cross-attention runs it with a
    # memory shorter than the decoder's tokens: (B, Sq, Sk, H, KV, D, dtype)
    (2, 2048, 1500, 16, 16, 64, torch.bfloat16),
    (2, 2048, 1500, 16, 16, 64, torch.float32),
    (1, 1100, 1000, 16, 8, 256, torch.bfloat16),
]

BWD_CASES = [
    # f32 flash backward: (B, Sq, Sk, H, KV, D, causal, window, softcap); the
    # train step's shape first, then D = 64 / 256, groups 1 / 4, window and
    # softcap, ragged S, Sq != Sk without a mask; at D = 256 (the pair kernels)
    # gemma2's train step, a window that bites with softcap, ragged S and
    # Sq != Sk without a mask
    (2, 2048, 2048, 16, 8, 128, True, None, None),
    (2, 1024, 1024, 16, 8, 64, True, None, None),
    (1, 1024, 1024, 16, 8, 256, True, None, None),
    (2, 2048, 2048, 16, 8, 256, True, None, 50.0),
    (1, 1024, 1024, 16, 8, 256, True, 300, 50.0),
    (1, 1000, 1000, 16, 8, 256, True, None, 50.0),
    (1, 700, 1000, 16, 4, 256, False, None, None),
    (1, 1024, 1024, 16, 16, 64, True, None, None),
    (1, 1024, 1024, 16, 4, 128, True, None, None),
    (1, 1024, 1024, 16, 8, 128, True, 256, 50.0),
    (2, 1000, 1000, 16, 8, 128, True, None, None),
    (1, 700, 1000, 16, 8, 128, False, None, None),
    # seamless's train step: its encoder's shape, and Sq != Sk at group 1
    (2, 2048, 2048, 16, 16, 64, False, None, None),
    (1, 700, 1000, 16, 16, 64, False, None, None),
    # the examples phase's trainer: D 32, head group 2
    (4, 64, 64, 4, 2, 32, True, None, None),
    # D = 192 (the pair kernels at 96 columns a block): torch_train_e2e
    # --big's shape, [2, 2048, 16, 192] kv 8 causal with and without
    # softcap 50, ragged S with a window, Sq != Sk without a mask
    (4, 64, 64, 4, 2, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0),
    (1, 1000, 1000, 16, 8, 192, True, 300, 50.0),
    (1, 700, 1000, 16, 4, 192, False, None, None),
    # the padded route: D 16, 48 and 80 (odd widths of a row, masks)
    (4, 64, 64, 4, 2, 16, True, None, None),
    (1, 1000, 1000, 16, 8, 48, True, None, None),
    (1, 700, 1000, 16, 4, 80, False, None, None),
    (1, 1024, 1024, 16, 8, 80, True, 256, 50.0),
    # above 256 (dk/dv and dq): phase 2's forward shapes on the cluster
    # route, head groups 24 and 17, Sq != Sk, 576 and a padded 704; the
    # CUDA-core route at 1088
    (2, 256, 256, 4, 2, 512, True, None, None),
    (2, 256, 256, 4, 2, 512, True, None, 50.0),
    (2, 256, 256, 4, 2, 512, True, 100, None),
    (1, 128, 128, 4, 2, 320, True, None, None),
    (1, 128, 128, 4, 2, 300, True, 40, 30.0),
    (1, 128, 128, 2, 1, 1024, False, None, None),
    (1, 200, 200, 48, 2, 320, True, None, None),
    (1, 100, 150, 4, 2, 512, False, None, None),
    (1, 128, 128, 4, 2, 576, True, 40, 30.0),
    (1, 100, 100, 4, 2, 704, True, None, None),
    (1, 130, 130, 34, 2, 512, True, None, None),
    (1, 96, 96, 2, 1, 1088, True, None, None),
]


def check_decode_split(g) -> float:
    """``DECODE_SPLIT_CASES``: the kernel's o the same bits with its lse as
    without, the lse within ``DECODE_LSE_TOL`` of the plain version's, and
    the merge of 2 and 4 key ranges (each launched with its key offset)
    within 2e-5 of the uncut kernel and of the plain version; every launch
    on the case's route (``decode_route``). Returns the largest error of
    each kernel row (``decode_row``)."""
    worst = {"decode_attention": 0.0, "decode_attention_wide": 0.0}
    for tag, B, S, H, KV, D, lens in DECODE_SPLIT_CASES:
        route = decode_route(H, KV, D)
        on_route = ops.DECODE_ROUTES[route]
        q = _randn(g, (B, H, D), torch.float32)
        k = _randn(g, (B, S, KV, D), torch.float32)
        v = _randn(g, (B, S, KV, D), torch.float32)
        lengths = torch.tensor(lens, device=DEVICE, dtype=torch.int32)
        o = ops.decode_attention(q, k, v, lengths)
        o2, lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
        sync()
        check(bool(torch.equal(o, o2)),
              f"decode lse {tag}: o is not the same bits with lse")
        want, want_lse = ref.decode_attention_ref(q, k, v, lengths,
                                                  return_lse=True)
        lse_err = assert_close(lse, want_lse, DECODE_LSE_TOL,
                               f"decode lse {tag}: lse")
        errs = []
        for parts in (2, 4):
            n = S // parts
            outs = [ops.decode_attention(
                q, k[:, r * n:(r + 1) * n].contiguous(),
                v[:, r * n:(r + 1) * n].contiguous(), lengths, offset=r * n,
                return_lse=True) for r in range(parts)]
            merged = ops.merge_attention_parts(
                torch.stack([x for x, _ in outs]),
                torch.stack([x for _, x in outs]))
            sync()
            e1 = assert_close(merged, o, TOL[torch.float32],
                              f"decode split {tag} x{parts} vs the kernel")
            e2 = assert_close(merged, want, TOL[torch.float32],
                              f"decode split {tag} x{parts} vs plain")
            errs.append((parts, e1, e2))
            worst[decode_row(D)] = max(worst[decode_row(D)], e1, e2)
        check(ops.DECODE_ROUTES[route] == on_route + 8,
              f"decode split {tag}: not every launch on the {route} route "
              f"({dict(ops.DECODE_ROUTES)})")
        log(f"decode lse/offset {tag} B={B} S={S} H={H} KV={KV} D={D} "
            f"lengths={lens}: o bitwise the same with lse, lse max_abs_err "
            f"{lse_err:.3e} (tol {DECODE_LSE_TOL}); "
            + "; ".join(f"{p} key ranges merged: {e1:.3e} vs the uncut "
                        f"kernel, {e2:.3e} vs plain" for p, e1, e2 in errs)
            + f" (tol {TOL[torch.float32]})")
    return worst


def decode_row(D: int) -> str:
    """The kernel row of decode at head dim D."""
    return "decode_attention_wide" if D > ops.HEAD_DIMS[-1] else "decode_attention"


def flash_row_of(name: str, D: int):
    """The kernel row of a flash wrapper's launch at head dim D in
    ``errs``: the f32 and bf16 backward rows are the caller's; above 256 the
    wide route's (the cluster kernels); None on the CUDA-core route (above
    1024), which no model runs and which has no row."""
    if D <= ops.HEAD_DIMS[-1]:
        return name
    if ops.flash_variant(torch.float32, D) == "cuda_core":
        return None
    return ("flash_attention_wide" if name == "flash_attention"
            else "flash_attention_backward_wide")


def note_err(errs: dict, key, err: float) -> None:
    """The largest error of the kernel row ``key`` (none: no row)."""
    if key is not None:
        errs[key] = max(errs[key], err)


def assert_close_to_max(got, want, tol, what) -> float:
    """rtol = atol = tol after dividing both by max|want|: a gradient's
    tolerance relative to its own scale. Returns the largest error over
    max|want|."""
    scale = want.abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return max_err(got, want) / scale.item()


def built_call(name: str, D: int, dtype, fn, route=None):
    """fn()'s result, after checking that it launched the ``name`` kernel
    once and recorded that launch at ``ops.built_head_dim(dtype, D)``
    (``ops.flash_built_head_dim`` for flash): D itself where a kernel
    instance is built for it, else the next built head dim, the operands
    padded to it; a flash launch also under its variant, above 256 the
    cluster route up to 1024 and the CUDA-core route above; a decode launch
    under ``route`` (``ops.DECODE_ROUTES``), where given."""
    before_route = ops.DECODE_ROUTES[route]
    flash = name.startswith("flash")
    built = (ops.flash_built_head_dim if flash else ops.built_head_dim)(dtype, D)
    variant = ops.flash_variant(dtype, D) if flash else None
    if flash and D > ops.HEAD_DIMS[-1]:
        want = "cluster" if built <= ops.CLUSTER_WIDTHS[-1] else "cuda_core"
        check(variant == want, f"{name} D={D}: variant {variant}, not {want}")
    before = ops.BUILT_WIDTHS[name, D, built]
    by_variant = ops.FLASH_VARIANTS[name, variant]
    n = ops.LAUNCHES[name]
    out = fn()
    check(ops.LAUNCHES[name] == n + 1
          and ops.BUILT_WIDTHS[name, D, built] == before + 1,
          f"{name} D={D}: its launch was not recorded at the built head "
          f"dim {built} ({dict(ops.BUILT_WIDTHS)})")
    check(not flash or ops.FLASH_VARIANTS[name, variant] == by_variant + 1,
          f"{name} D={D}: its launch was not recorded as {variant} "
          f"({dict(ops.FLASH_VARIANTS)})")
    check(route is None or ops.DECODE_ROUTES[route] == before_route + 1,
          f"{name} D={D}: its launch was not recorded on the {route} route "
          f"({dict(ops.DECODE_ROUTES)})")
    return out


def decode_route(H: int, KV: int, D: int) -> str:
    """The decode route a call must take: the group route at a head group
    above 16 or a head dim above 256, else the narrow kernel."""
    return "group" if H // KV > 16 or D > ops.HEAD_DIMS[-1] else "narrow"


def check_flash_backward(g, case) -> float:
    """One backward case: the forward's o with and without lse (bitwise),
    its lse against the plain one, the backward kernel against the plain
    backward, and a second backward call bitwise equal to the first."""
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    q = _randn(g, (B, Sq, H, D), torch.float32)
    k = _randn(g, (B, Sk, KV, D), torch.float32)
    v = _randn(g, (B, Sk, KV, D), torch.float32)
    dout = _randn(g, (B, Sq, H, D), torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    what = f"flash backward {case}"
    out_plain = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_forward(q, k, v, causal, window, softcap,
                                  want_lse=True)
    check(bool(torch.equal(out, out_plain)), f"{what}: o moved with lse on")
    lse_err = assert_close(lse, ref.flash_attention_lse_ref(q, k, **kw),
                           TOL[torch.float32], f"{what} lse")
    before = ops.LAUNCHES["flash_attention_backward"]
    got = built_call("flash_attention_backward", D, torch.float32,
                     lambda: ops.flash_attention_backward(q, k, v, out, lse,
                                                          dout, **kw))
    sync()
    check(ops.LAUNCHES["flash_attention_backward"] == before + 1,
          f"{what}: the backward kernel did not launch")
    want = ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    errs = [assert_close_to_max(a, b, TOL[torch.float32], f"{what} {n}")
            for n, a, b in zip(("dq", "dk", "dv"), got, want)]
    abs_err = max(max_err(a, b) for a, b in zip(got, want))
    again = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    log(f"flash backward B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
        f"({ops.flash_variant(torch.float32, D)}, built D "
        f"{ops.flash_built_head_dim(torch.float32, D)}) "
        f"causal={causal} window={window} softcap={softcap}: dq/dk/dv error "
        f"relative to max {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} "
        f"(tol {TOL[torch.float32]}), bitwise repeatable, o unchanged by lse, "
        f"lse max_abs_err {lse_err:.3e}, grads max_abs_err {abs_err:.3e}")
    return abs_err


BF16_BWD_CASES = [
    # bf16 flash backward (csrc/flash_attention_tc_bwd.cu): (B, Sq, Sk, H,
    # KV, D, causal, window, softcap); internlm2's train step, gemma2's
    # (D = 256) and its local layers' window, seamless's encoder (non-causal,
    # group 1) and cross-attention (Sq != Sk), head groups 6 and 7, ragged
    # Sq / Sk, D = 32
    (2, 2048, 2048, 16, 8, 128, True, None, None),
    (2, 2048, 2048, 48, 8, 128, True, None, None),   # grok's train step
    (2, 2048, 2048, 16, 8, 256, True, None, 50.0),
    (1, 1024, 1024, 16, 8, 256, True, 256, 50.0),
    (2, 2048, 2048, 16, 16, 64, False, None, None),
    (2, 2048, 1500, 16, 16, 64, False, None, None),
    (1, 1024, 1024, 48, 8, 128, True, None, None),
    (1, 1000, 1000, 56, 8, 128, True, None, None),
    (1, 700, 1000, 16, 8, 128, False, None, None),
    (2, 1024, 1024, 16, 8, 32, True, None, None),
    # shapes that end inside a block (128 rows where a block's two
    # warpgroups own 64 rows each and skip steps with no kept pair: dk/dv
    # below D = 128, dq below 256; else 64 rows whose products the two
    # split): Sq and Sk multiples of neither 128 nor each other, a window
    # that cuts a 128-key block, head groups 6 and 7 there, D = 32; at D =
    # 256 an Sk that is not a multiple of 64, with and without the mask
    (1, 1000, 1000, 16, 8, 128, True, None, None),
    (1, 1100, 1000, 16, 8, 128, False, None, 30.0),
    (1, 1100, 1100, 16, 8, 128, True, 200, None),
    (1, 1100, 1100, 48, 8, 64, True, 300, None),
    (1, 1000, 1100, 56, 8, 64, False, None, None),
    (1, 1100, 1100, 8, 2, 32, True, 100, None),
    (1, 1000, 1100, 16, 8, 32, False, None, None),
    (1, 1000, 1000, 16, 8, 256, True, None, 50.0),
    (1, 1100, 1000, 16, 8, 256, False, None, 30.0),
    (1, 1100, 1100, 16, 8, 256, True, 200, 50.0),
    # D = 192 (dk/dv and dq both splitting the products of 64 rows):
    # torch_train_e2e --big's shape, [2, 2048, 16, 192] kv 8 causal with and
    # without softcap 50, ragged S with a window, head group 6
    (4, 64, 64, 4, 2, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0),
    (1, 1100, 1100, 48, 8, 192, True, 200, None),
    (1, 1000, 1100, 16, 8, 192, False, None, 30.0),
    # the padded route: D 16, 48 and 80
    (4, 64, 64, 4, 2, 16, True, None, None),
    (1, 1000, 1000, 16, 8, 48, True, None, None),
    (1, 1100, 1000, 16, 8, 80, False, None, 30.0),
    # above 256 in bf16: the f32 cases' shapes (the cluster route with one
    # TF32 product; the CUDA-core route at 1088)
    (2, 256, 256, 4, 2, 512, True, None, None),
    (2, 256, 256, 4, 2, 512, True, None, 50.0),
    (2, 256, 256, 4, 2, 512, True, 100, None),
    (1, 128, 128, 4, 2, 320, True, None, None),
    (1, 128, 128, 4, 2, 300, True, 40, 30.0),
    (1, 128, 128, 2, 1, 1024, False, None, None),
    (1, 200, 200, 48, 2, 320, True, None, None),
    (1, 128, 128, 4, 2, 576, True, None, 30.0),
    (1, 100, 100, 4, 2, 704, False, None, None),
    (1, 130, 130, 34, 2, 512, True, None, None),
    (1, 96, 96, 2, 1, 1088, True, None, None),
]


def check_flash_backward_bf16(g, case) -> float:
    """One bf16 backward case: the bf16 forward's o with and without lse
    (bitwise), its lse within BF16_LSE_TOL of the plain one of the f32
    copies, the backward kernel's dq, dk and dv within 2e-2 of each
    gradient's largest magnitude of the plain backward on the f32 copies of
    the same bf16 operands (given the plain f32 forward's o and lse), and a
    second call bitwise equal. Returns the largest absolute error."""
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    dt = torch.bfloat16
    q = _randn(g, (B, Sq, H, D), dt)
    k, v = _randn(g, (B, Sk, KV, D), dt), _randn(g, (B, Sk, KV, D), dt)
    dout = _randn(g, (B, Sq, H, D), dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    what = f"bf16 flash backward {case}"
    out_plain = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_forward(q, k, v, causal, window, softcap,
                                           want_lse=True)
    check(bool(torch.equal(out, out_plain)), f"{what}: o moved with lse on")
    f32 = [t.float() for t in (q, k, v, dout)]
    lse_want = ref.flash_attention_lse_ref(f32[0], f32[1], **kw)
    lse_err = assert_close(lse, lse_want, BF16_LSE_TOL, f"{what} lse")
    before = ops.LAUNCHES["flash_attention_backward"]
    got = built_call("flash_attention_backward", D, dt,
                     lambda: ops.flash_attention_backward(q, k, v, out, lse,
                                                          dout, **kw))
    sync()
    check(ops.LAUNCHES["flash_attention_backward"] == before + 1,
          f"{what}: the backward kernel did not launch")
    check(all(x.dtype == dt for x in got), f"{what}: grads not bf16")
    want = ref.flash_attention_backward_ref(
        *f32[:3], ref.flash_attention_ref(*f32[:3], **kw), lse_want, f32[3],
        **kw)
    errs = [assert_close_to_max(a.float(), b, TOL[dt], f"{what} {n}")
            for n, a, b in zip(("dq", "dk", "dv"), got, want)]
    means = [((a.float() - b).abs().mean() / b.abs().max()).item()
             for a, b in zip(got, want)]
    abs_err = max(max_err(a, b) for a, b in zip(got, want))
    again = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    log(f"bf16 flash backward B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
        f"({ops.flash_variant(dt, D)}, built D {ops.flash_built_head_dim(dt, D)}) "
        f"causal={causal} window={window} softcap={softcap}: dq/dk/dv error "
        f"relative to max: max {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e}, "
        f"mean {means[0]:.3e} / {means[1]:.3e} / {means[2]:.3e} (tol "
        f"{TOL[dt]}, against the f32 backward of the f32 copies), bitwise "
        f"repeatable, o unchanged by lse, lse max_abs_err {lse_err:.3e} (tol "
        f"{BF16_LSE_TOL}), grads max_abs_err {abs_err:.3e}")
    return abs_err


SCAN_CASES = [
    # (B, S, DI, DS, h0, variant); h0 None, "fresh" or "offset" (a view 4
    # bytes into its buffer, not 16-byte aligned): falcon-mamba's forward
    # shape, its decode step (with and without h0), a ragged F (8240 * 16 =
    # 515 blocks of 256 and a half), a small odd F, a decode step with
    # F % 4 != 0 and one with an unaligned h0
    (2, 2048, 8192, 16, None, "sequential"),
    (4, 1, 8192, 16, "fresh", "step"),
    (4, 1, 8192, 16, None, "step"),
    (3, 1000, 8192 + 48, 16, None, "sequential"),
    (2, 300, 7, 3, "fresh", "sequential"),
    (4, 1, 8191, 3, "fresh", "sequential"),
    (4, 1, 8192, 16, "offset", "sequential"),
    # the examples phase's Mamba servers (reduced: d_inner 256, d_state 8)
    (4, 1, 256, 8, "fresh", "step"),
]


def _scan_operands(g, B, S, DI, DS, h0):
    """a in [0.499, 0.999) (a decay, as exp(dt * A) is), b and h0 normal;
    h0 as in ``SCAN_CASES``."""
    a = torch.rand((B, S, DI, DS), generator=g, device=DEVICE) * 0.5 + 0.499
    b = torch.randn((B, S, DI, DS), generator=g, device=DEVICE)
    if h0 is not None:
        buf = torch.randn((B * DI * DS + 1,), generator=g, device=DEVICE)
        h0 = (buf[1:] if h0 == "offset" else buf[:-1]).view(B, DI, DS)
    return a, b, h0


SCAN_BWD_CASES = [
    # (B, S, DI, DS, h0) as in ``SCAN_CASES``: phase 7's shape (the train
    # path's, no h0), a ragged F with h0 and S one past a multiple of the
    # kernel's 8-step groups, a small odd F with h0, S below one group, an
    # h0 that is 4 bytes into its buffer, S = 1 with and without h0
    (2, 2048, 8192, 16, None),
    (3, 1001, 8192 + 48, 16, "fresh"),
    (2, 300, 7, 3, "fresh"),
    (2, 13, 24, 5, None),
    (2, 37, 64, 16, "offset"),
    (4, 1, 8192, 16, "fresh"),
    (4, 1, 8192, 16, None),
]


def check_scan_backward(g, case) -> float:
    """One backward case: the kernel against the plain reverse loop, bit for
    bit (dh0 too, with h0), from the forward kernel's h and a random dh; a
    second call bitwise equal to the first. Returns the max abs error (0)."""
    B, S, DI, DS, h0_kind = case
    a, b, h0 = _scan_operands(g, B, S, DI, DS, h0_kind)
    h = ops.selective_scan(a, b, h0)
    del b
    dh = torch.randn(a.shape, generator=g, device=DEVICE)
    what = f"scan backward {B, S, DI, DS, h0_kind}"
    before = ops.LAUNCHES["selective_scan_backward"]
    got = ops.selective_scan_backward(a, h, h0, dh)
    sync()
    check(ops.LAUNCHES["selective_scan_backward"] == before + 1,
          f"{what}: the backward kernel did not launch")
    want = ref.selective_scan_backward_ref(a, h, h0, dh)
    check((got[2] is None) == (h0 is None) == (want[2] is None),
          f"{what}: dh0 given without h0 or missing with it")
    pairs = [(x, y) for x, y in zip(got, want) if y is not None]
    err = max(max_err(x, y) for x, y in pairs)
    check(all(bool(torch.equal(x, y)) for x, y in pairs),
          f"{what}: not bit-identical to the plain reverse loop (max_abs_err "
          f"{err:.3e})")
    again = ops.selective_scan_backward(a, h, h0, dh)
    check(all(bool(torch.equal(x, y)) for x, y in zip(got, again)
              if x is not None), f"{what}: two calls differ")
    log(f"scan backward B={B} S={S} DI={DI} DS={DS} h0={h0_kind}: da, db"
        f"{', dh0' if h0 is not None else ''} bit-identical to the plain "
        f"reverse loop, bitwise repeatable")
    return err


FUSED_CASES = [
    # (B, S, DI, DS, dtype of u, Bc and Cc): falcon-mamba's train shape in
    # f32 (phase 7's) and bf16 (phase 3b's), a ragged S (not a multiple of
    # the kernels' 64-step chunks) and a reduced width (the reduced
    # configs' d_state 8, the 8-lane instance)
    (2, 2048, 8192, 16, torch.float32),
    (2, 2048, 8192, 16, torch.bfloat16),
    (2, 1000, 8192, 16, torch.float32),
    (2, 512, 1024, 8, torch.bfloat16),
]


def _fused_operands(g, B, S, DI, DS, dtype, dt_rank: int = 256):
    """u, dt, A, Bc, Cc and dy of the fused scan as the mixer hands them
    over: u and the rows in ``dtype``, Bc and Cc views of one [B, S, dt_rank
    + 2 DS] row (x_proj's split), dt in [0, 0.1), A = -exp(normal)."""
    u = torch.randn((B, S, DI), generator=g, device=DEVICE).to(dtype)
    rows = torch.randn((B, S, dt_rank + 2 * DS), generator=g,
                       device=DEVICE).to(dtype)
    Bc, Cc = rows[..., dt_rank:dt_rank + DS], rows[..., dt_rank + DS:]
    dt = torch.rand((B, S, DI), generator=g, device=DEVICE) * 0.1
    A = -torch.exp(torch.randn((DI, DS), generator=g, device=DEVICE))
    dy = torch.randn((B, S, DI), generator=g, device=DEVICE)
    return u, dt, A, Bc, Cc, dy


def check_fused(g, case) -> tuple:
    """One fused case: the forward (y and the chunk states) within 2e-5 of
    its plain version, the backward's five gradients within 2e-5 of each
    one's largest magnitude (2e-2 for a bf16 gradient: du, dB and dC in
    bf16 round after the sums), one counted launch each, and every output
    bitwise equal on a second call. Returns (forward, backward) errors."""
    B, S, DI, DS, dtype = case
    t0 = time.perf_counter()
    u, dt, A, Bc, Cc, dy = _fused_operands(g, *case)
    what = f"fused scan {B, S, DI, DS, DTYPE_NAME[dtype]}"
    before = dict(ops.LAUNCHES)
    y, states = ops.selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                                 want_states=True)
    grads = ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy)
    sync()
    check(ops.LAUNCHES["selective_scan_fused"]
          == before["selective_scan_fused"] + 1
          and ops.LAUNCHES["selective_scan_fused_backward"]
          == before["selective_scan_fused_backward"] + 1,
          f"{what}: the kernels did not launch once each")
    want_y, want_states = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc,
                                                       want_states=True)
    f32 = TOL[torch.float32]
    err_f = max(assert_close(y, want_y, f32, f"{what} y"),
                assert_close(states, want_states, f32, f"{what} states"))
    want = ref.selective_scan_fused_backward_ref(u, dt, A, Bc, Cc, states, dy)
    err_b = 0.0
    for name, x, w in zip(("du", "ddt", "dA", "dB", "dC"), grads, want):
        check(x.dtype == w.dtype and x.shape == w.shape,
              f"{what}: {name} {x.dtype} {tuple(x.shape)}")
        err_b = max(err_b, assert_close_to_max(
            x.float(), w.float(), TOL[x.dtype], f"{what} {name}"))
    y2, states2 = ops.selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                                   want_states=True)
    again = ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy)
    check(bool(torch.equal(y, y2)) and bool(torch.equal(states, states2))
          and all(bool(torch.equal(x, w)) for x, w in zip(grads, again)),
          f"{what}: two calls differ")
    sync()
    log(f"{what}: y and states max_abs_err {err_f:.3e} (tol {f32}), "
        f"du/ddt/dA/dB/dC {err_b:.3e} of each one's max (tol {f32}, "
        f"{TOL[torch.bfloat16]} in bf16); bitwise repeatable "
        f"({time.perf_counter() - t0:.1f} s)")
    return err_f, err_b


def phase_kernels() -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}
    for B, S, DI, DS, h0_kind, variant in SCAN_CASES:
        a, b, h0 = _scan_operands(g, B, S, DI, DS, h0_kind)
        what = f"scan {B, S, DI, DS, h0_kind}"
        check(ops.scan_variant(a, b, h0) == variant,
              f"{what}: variant {ops.scan_variant(a, b, h0)} != {variant}")
        before = ops.SCAN_VARIANTS[variant]
        out = ops.selective_scan(a, b, h0)
        sync()
        check(ops.SCAN_VARIANTS[variant] == before + 1,
              f"{what}: the {variant} kernel did not launch")
        want = ref.selective_scan_ref(a, b, h0)
        err = max_err(out, want)
        # one rounded product and one rounded sum per step, in both
        check(bool(torch.equal(out, want)),
              f"{what}: not bit-identical to the plain loop (max_abs_err "
              f"{err:.3e})")
        errs["selective_scan"] = max(errs["selective_scan"], err)
        log(f"scan B={B} S={S} DI={DI} DS={DS} h0={h0_kind} ({variant}): "
            f"bit-identical to the plain loop")
        del a, b, h0, out, want
    for case in SCAN_BWD_CASES:
        errs["selective_scan_backward"] = max(
            errs["selective_scan_backward"], check_scan_backward(g, case))
    for case in FUSED_CASES:
        err_f, err_b = check_fused(g, case)
        errs["selective_scan_fused"] = max(errs["selective_scan_fused"], err_f)
        errs["selective_scan_fused_backward"] = max(
            errs["selective_scan_fused_backward"], err_b)
    for B, S, H, KV, D, dt, window, softcap, lens in DECODE_CASES:
        q = _randn(g, (B, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        if lens is None:
            lengths = torch.randint(1, S + 1, (B,), generator=g, device=DEVICE)
            lengths[0], lengths[-1] = 1, S
        else:
            lengths = torch.tensor(lens, device=DEVICE)
        lengths = lengths.to(torch.int32)
        kw = dict(window=window, softcap=softcap)
        route = decode_route(H, KV, D)
        out = built_call("decode_attention", D, dt,
                         lambda: ops.decode_attention(q, k, v, lengths, **kw),
                         route)
        if route == "group":   # bitwise repeatable, the same bits with lse
            again = ops.decode_attention(q, k, v, lengths, **kw)
            with_lse, _ = ops.decode_attention(q, k, v, lengths, **kw,
                                               return_lse=True)
            sync()
            check(bool(torch.equal(out, again))
                  and bool(torch.equal(out, with_lse)),
                  f"decode {B,S,H,KV,D,dt}: not the same bits on a second "
                  f"call or with lse")
        sync()
        want = ref.decode_attention_ref(q, k, v, lengths, **kw)
        err = assert_close(out, want, TOL[dt], f"decode {B,S,H,KV,D,dt}")
        errs[decode_row(D)] = max(errs[decode_row(D)], err)
        log(f"decode B={B} S={S} H={H} KV={KV} D={D} {str(dt)[6:]} "
            f"(built D {ops.built_head_dim(dt, D)}) window={window} softcap={softcap} lengths={lengths.tolist()} "
            f"{decode_plan(B, H, KV, S, D, dt)}: max_abs_err {err:.3e} "
            f"(tol {TOL[dt]})" + ("; bitwise repeatable, the same bits with "
                                  "lse" if route == "group" else ""))
    for name, err in check_decode_split(g).items():
        errs[name] = max(errs[name], err)
    cases = [(B, S, S, H, KV, D, dt, causal, window, softcap)
             for B, S, H, KV, D, dt, causal, window, softcap in FLASH_CASES]
    cases += [case + (False, None, None) for case in FLASH_CROSS_CASES]
    wide_s = {"forward": 0.0, "backward": 0.0}   # the cases above 256
    for B, Sq, Sk, H, KV, D, dt, causal, window, softcap in cases:
        t0 = time.perf_counter()
        q = _randn(g, (B, Sq, H, D), dt)
        k = _randn(g, (B, Sk, KV, D), dt)
        v = _randn(g, (B, Sk, KV, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = built_call("flash_attention", D, dt,
                         lambda: ops.flash_attention(q, k, v, **kw))
        sync()
        want = ref.flash_attention_ref(q, k, v, **kw)
        what = f"flash {B,Sq,Sk,H,KV,D,dt,causal}"
        err = assert_close(out, want, TOL[dt], what)
        rows = (f", row error {check_flash_rows(out, q, k, v, kw, what):.3e} "
                f"(tol {ref.BF16_ROW_TOL})" if dt == torch.bfloat16 else "")
        note_err(errs, flash_row_of("flash_attention", D), err)
        log(f"flash B={B} S={Sq}" + (f" Sk={Sk}" if Sk != Sq else "")
            + f" H={H} KV={KV} D={D} {str(dt)[6:]} "
            f"({ops.flash_variant(dt, D)}, built D "
            f"{ops.flash_built_head_dim(dt, D)}) causal={causal} "
            f"window={window} softcap={softcap}: max_abs_err {err:.3e} "
            f"(tol {TOL[dt]}){rows}")
        if D > ops.HEAD_DIMS[-1]:
            sync()
            wide_s["forward"] += time.perf_counter() - t0
    for check_case, cases, row in (
            (check_flash_backward, BWD_CASES, "flash_attention_backward"),
            (check_flash_backward_bf16, BF16_BWD_CASES,
             "flash_attention_backward_bf16")):
        for case in cases:
            t0 = time.perf_counter()
            note_err(errs, flash_row_of(row, case[5]), check_case(g, case))
            if case[5] > ops.HEAD_DIMS[-1]:
                sync()
                wide_s["backward"] += time.perf_counter() - t0
    log(f"phase 2: the flash cases above head dim 256 (the cluster and "
        f"CUDA-core routes) took {wide_s['forward'] + wide_s['backward']:.1f}"
        f" s: forward {wide_s['forward']:.1f} s, backward "
        f"{wide_s['backward']:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# phase 3 / 3b: forward at full width, bf16
# ---------------------------------------------------------------------------


def to_f32_(params) -> None:
    """Turn every leaf of ``params`` into f32 in place, one leaf at a time:
    a leaf's bf16 storage is freed as soon as its f32 copy exists, so no
    second copy of the model is ever made."""
    with torch.no_grad():
        for t in params.parameters():
            t.data = t.data.float()


def flash_per_forward(cfg) -> int:
    """Flash launches of one forward: one per attention layer; an
    encoder-decoder adds one per encoder layer and a cross-attention per
    decoder layer."""
    n = sum(spec.mixer == "attn" for spec in cfg.layer_kinds())
    return n + (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)


def decode_per_step(cfg) -> int:
    """Decode launches of one decode step: one per attention layer, and a
    cross-attention per decoder layer of an encoder-decoder."""
    n = sum(spec.mixer == "attn" for spec in cfg.layer_kinds())
    return n + (cfg.n_layers if cfg.enc_dec else 0)


def at_depth(cfg, depth: int):
    """``cfg`` cut to ``depth`` layers; an encoder-decoder's encoder too."""
    return dataclasses.replace(cfg, n_layers=depth, **(
        {"n_enc_layers": depth} if cfg.enc_dec else {}))


def phase_forward(cfg, kernel: str, reckoned_gb=None) -> dict:
    """``forward`` in bf16 on tokens [FWD_B, FWD_S] (an encoder-decoder's
    frames [FWD_B, FWD_S, d] beside them, drawn in f32: ``forward`` casts
    them) through ``kernel`` (flash: ``flash_per_forward`` launches; the
    scan: one per layer), held against the plain path and an f32 forward of
    the same weights (made in place after the bf16 runs and timings). With
    an MoE FFN, ``moe_report`` adds its breakdown, routing and dispatch
    checks. Peak memory beside ``reckoned_gb`` where given."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = M.init_params(g, cfg, torch.bfloat16, DEVICE)
    tokens = torch.randint(0, cfg.vocab, (FWD_B, FWD_S), generator=g,
                           device=DEVICE)
    batch = {"tokens": tokens}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((FWD_B, FWD_S, cfg.d_model),
                                      generator=g, device=DEVICE)
    want = flash_per_forward(cfg) if kernel == "flash_attention" else cfg.n_layers
    tag = f"forward {cfg.name} bf16 [{FWD_B},{FWD_S}]"
    with torch.inference_mode():
        ops.reset_launches()
        logits_k, _ = M.forward(params, batch, cfg, runtime("kernel"))
        sync()
        launches = ops.LAUNCHES[kernel]
        variants = dict(ops.SCAN_VARIANTS)
        logits_p, _ = M.forward(params, batch, cfg, runtime("plain"))
        sync()
    check(launches == want, f"{kernel} launches {launches} != {want}")
    if kernel == "selective_scan":
        check(variants["sequential"] == launches,
              f"forward scan launches by variant {variants}")
    if kernel == "selective_scan_fused":   # S = 2048: JAX's chunked branch
        check(variants == {"step": 0, "sequential": 0},
              f"forward: materialised scan launches by variant {variants}")
    check(tuple(logits_k.shape) == (FWD_B, FWD_S, cfg.vocab), "logits shape")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                           runtime("kernel")), iters=5,
                         warmup=1)
        # one timed call: the plain path ran just above, so it is warm, and
        # falcon-mamba's plain scan loops take ~6.4 s a forward on an H100
        fwd_plain_ms = cuda_ms(lambda: M.forward(params, batch, cfg,
                                                 runtime("plain")), iters=1,
                               warmup=0)
        prof = profile_kernels(
            lambda: M.forward(params, batch, cfg, runtime("kernel")), 2)
        log_breakdown(f"{tag} kernel", prof, fwd_ms)
    if kernel == "flash_attention" and prof["kernels"]:
        # bf16 goes to the tensor-core variant; a dropped record cannot make
        # an f32 launch appear
        check(recorded(prof, F32TC_FWD) == 0
              and recorded(prof, F32TC_FWD_D256) == 0,
              "the bf16 forward launched an f32 flash kernel")
    log(f"{tag}: kernel {fwd_ms:.2f} ms "
        f"({FWD_B * FWD_S / fwd_ms * 1e3:.0f} tok/s), plain path "
        f"{fwd_plain_ms:.2f} ms ({FWD_B * FWD_S / fwd_plain_ms * 1e3:.0f} tok/s)")
    moe = (moe_report(params, batch, cfg, tag, fwd_ms, prof)
           if cfg.moe is not None else None)
    # bf16 activations round at every layer, so two bf16 paths that differ
    # only in a kernel's summation order drift apart by about what bf16
    # itself costs. The stated tolerance is relative to that cost: against
    # an f32 forward of the same weights (the plain path in full f32), the
    # kernel path's max and mean errors may be at most 2x and 1.25x the
    # plain bf16 path's.
    to_f32_(params)
    with torch.inference_mode():
        logits_r, _ = M.forward(params, batch, cfg, runtime("plain"))
    e_k, e_p = max_err(logits_k, logits_r), max_err(logits_p, logits_r)
    m_k = (logits_k - logits_r).abs().mean().item()
    m_p = (logits_p - logits_r).abs().mean().item()
    top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"{tag}: {kernel} launches {launches}; vs f32 forward: kernel max "
        f"{e_k:.3e} mean {m_k:.3e}, plain max {e_p:.3e} mean {m_p:.3e}; "
        f"kernel vs plain max {max_err(logits_k, logits_p):.3e}, "
        f"max|logit| {logits_r.abs().max().item():.3f}, top-1 agreement "
        f"{top1:.4f}")
    check(e_k <= 2 * e_p and m_k <= 1.25 * m_p,
          "forward logits: the kernel path is less accurate than the plain "
          "path beyond the stated tolerance")
    del logits_k, logits_p, logits_r, params
    log_memory(tag, reckoned_gb)
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": fwd_ms, "moe": moe}


def moe_inputs(params, batch, cfg) -> list:
    """The input of every MoE layer in one kernel-path forward (the
    ``apply_moe`` calls recorded; nothing is counted from this run)."""
    seen = []
    inner = L.apply_moe

    def record(p, x, c):
        seen.append(x)
        return inner(p, x, c)
    with mock.patch.object(L, "apply_moe", record), torch.inference_mode():
        M.forward(params, batch, cfg, runtime("kernel"))
    return seen


def moe_report(params, batch, cfg, tag: str, fwd_ms: float, prof: dict) -> dict:
    """The MoE FFN of the bf16 forward: per layer the routed count of each
    expert and the assignments that lost their expert (past capacity, and
    the rank-0 token of an overflowing expert, the reference's slot-0
    behaviour); the forward's time by part (CUDA events on layer 0's input:
    the MoE layer, its expert GEMMs alone, the dispatch and combine as the
    difference; attention from the profiler's flash device time; the rest);
    and the dispatch checks of ``check_moe_dispatch``."""
    m = cfg.moe
    E = m.n_experts * m.expert_split
    hs = moe_inputs(params, batch, cfg)
    moes = [layer.moe for layer in params.layers if hasattr(layer, "moe")]
    T, d = FWD_B * FWD_S, cfg.d_model
    C = L.moe_capacity(T, cfg)
    routed = []
    for i, (mp, h) in enumerate(zip(moes, hs)):
        with torch.inference_mode():
            top_e = L.moe_route(mp, h.reshape(T, d), cfg)[2]
            counts, _, _, _, kept = L.moe_slots(top_e, E, C)
        counts = counts.tolist()
        lost = int((~kept).sum())
        past = sum(max(0, c - C) for c in counts)
        routed.append({"counts": counts, "capacity": C, "lost": lost,
                       "past_capacity": past})
        log(f"{tag} moe layer {i}: routed per expert {counts} (C {C}, "
            f"expected {T * m.top_k * m.expert_split / E:.0f} an expert); "
            f"assignments without their expert {lost} of {T * top_e.shape[1]}"
            f" ({past} past capacity, {lost - past} the slot-0 token of an "
            f"overflowing expert)")
    mp, h = moes[0], hs[0]
    with torch.inference_mode():
        xf = h.reshape(T, d)
        top_e = L.moe_route(mp, xf, cfg)[2]
        _, slot_tok, slot_valid, _, _ = L.moe_slots(top_e, E, C)
        xe = torch.where(slot_valid[:, None], xf[slot_tok], 0).reshape(E, C, d)
        moe_ms = cuda_ms(lambda: L.apply_moe(mp, h, cfg), iters=10)
        exp_ms = cuda_ms(lambda: L.moe_experts(mp, xe, cfg.act), iters=10)
    f = mp.w1.shape[-1]
    flops = 2 * 3 * E * C * d * f
    attn = kernel_ms(prof, FLASH_TC)
    n_attn = sum(spec.mixer == "attn" for spec in cfg.layer_kinds())
    attn_ms = None if attn is None else n_attn * attn
    rest = fwd_ms - len(moes) * moe_ms - (attn_ms or 0.0)
    log(f"{tag} by part (CUDA events on layer 0's input; attention from the "
        f"profiler): {len(moes)} MoE layers x {moe_ms:.3f} ms = expert GEMMs "
        f"{len(moes)} x {exp_ms:.3f} ms ({flops / exp_ms / 1e9:.1f} TFLOP/s on "
        f"[{E},{C},{d}] x [{d},{f}] x 3, "
        f"{_share(flops / PEAK_FLOPS[torch.bfloat16] * 1e3, exp_ms)} of the "
        f"bf16 peak) + dispatch and combine {len(moes)} x "
        f"{moe_ms - exp_ms:.3f} ms; attention (flash device) {n_attn} x "
        f"{_fmt(attn)} ms; the rest (projections, norms, embedding, logits) "
        f"{rest:.3f} ms; forward {fwd_ms:.3f} ms")
    with torch.inference_mode():
        dispatch = check_moe_dispatch(mp, h, cfg, f"{tag} moe layer 0")
    del hs, xe
    return {"routed": routed, "moe_layer_ms": moe_ms, "expert_gemm_ms": exp_ms,
            "dispatch_combine_ms": moe_ms - exp_ms, "attention_ms": attn_ms,
            "rest_ms": rest, **dispatch}


def check_moe_dispatch(mp, h, cfg, tag: str) -> dict:
    """``layers.apply_moe`` on h twice under the deterministic mode (bitwise
    equal outputs and aux, no determinism warning), then once under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    sync, with the same bits."""
    check(torch.are_deterministic_algorithms_enabled(),
          f"{tag}: the deterministic mode is off")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = L.apply_moe(mp, h, cfg)
        b = L.apply_moe(mp, h, cfg)
        sync()
    nondet = [str(w.message)[:120] for w in caught
              if "determinis" in str(w.message).lower()]
    check(not nondet, f"{tag}: determinism warnings {nondet}")
    check(bool(torch.equal(a[0], b[0])) and bool(torch.equal(a[1], b[1])),
          f"{tag}: two MoE calls differ")
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c = L.apply_moe(mp, h, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    check(bool(torch.equal(a[0], c[0])), f"{tag}: the third MoE call differs")
    log(f"{tag}: MoE dispatch on {list(h.shape)} {str(h.dtype)[6:]}: two calls "
        f"bitwise equal (out and aux {float(a[1]):.6f}), no determinism "
        f"warning; a third under set_sync_debug_mode('error') made no host "
        f"sync and gave the same bits")
    return {"dispatch_bitwise": True, "dispatch_sync_free": True}


# ---------------------------------------------------------------------------
# phase 4 / 4b: serving at full width, f32
# ---------------------------------------------------------------------------


def _serve(server: SlotServer, gaps: list) -> tuple[dict, int, float]:
    """Drive ``server`` as repro_torch.launch.serve does; record per step the
    plain top-2 logit gap of each active request (rid -> gap)."""
    inner = server._step

    def recording(*a, **kw):
        nxt, logits, cache = inner(*a, **kw)
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        gaps.append({server._slot_req[s]: gap[s]
                     for s in range(server.n_slots) if server.active[s]})
        return nxt, logits, cache

    server._step = recording
    sync()
    t0 = time.perf_counter()
    pending = list(range(REQUESTS))
    active, done, steps = {}, {}, 0
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            active[server.submit(prompt_token=req + 2)] = req
        server.step()
        steps += 1
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= TOKENS:
                done[active.pop(rid)] = server.finish(rid)
    sync()
    secs = time.perf_counter() - t0
    # ``recording`` holds the server: unhook it, so the server and its
    # cache are freed when the caller drops them, not at the next GC
    server._step = inner
    return done, steps, secs


def phase_serve(cfg, kernel: str, reckoned_gb=None) -> dict:
    """``SlotServer`` with f32 weights and cache through ``kernel`` (decode:
    ``decode_per_step`` launches a step; the scan: one per layer a step):
    lockstep logits, greedy streams, launches; with an MoE FFN, the bytes a
    step must read beside its time and ``check_moe_dispatch`` at the decode
    shape; for an encoder-decoder, ``decode_cross``. Peak memory beside
    ``reckoned_gb`` where given. Returns the kernel path's lockstep cache
    and last positions, which phase 5 times the kernel on."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = M.init_params(g, cfg, torch.float32, DEVICE)
    tol = TOL[torch.float32]
    tag = f"serve {cfg.name} f32"
    with torch.inference_mode():
        # (a) lockstep: the same tokens into both paths at every step
        caches = {impl: M.init_cache(cfg, SLOTS, MAX_LEN, torch.float32, DEVICE)
                  for impl in ("kernel", "plain")}
        tokens = torch.arange(2, 2 + SLOTS, device=DEVICE, dtype=torch.int32)
        worst = 0.0
        for t in range(TOKENS):
            pos = torch.full((SLOTS,), t, device=DEVICE, dtype=torch.int32)
            nk, lk, _ = serve_step(params, caches["kernel"], tokens, pos,
                                   cfg=cfg, rt=runtime("kernel"))
            _, lp, _ = serve_step(params, caches["plain"], tokens, pos,
                                  cfg=cfg, rt=runtime("plain"))
            worst = max(worst, assert_close(lk, lp, tol, f"lockstep step {t}"))
            tokens = nk
        log(f"{tag} lockstep {TOKENS} steps x {SLOTS} slots: "
            f"max|dlogit| {worst:.3e} (tol {tol})")
        # one decode step of each path, timed in turns (plain, kernel,
        # kernel, plain) at the last lockstep position, then profiled
        step = {impl: (lambda impl=impl: serve_step(
            params, caches[impl], tokens, pos, cfg=cfg, rt=runtime(impl)))
            for impl in ("kernel", "plain")}
        step_ms = {"kernel": [], "plain": []}
        for impl in ("plain", "kernel", "kernel", "plain"):
            step_ms[impl].append(host_ms(step[impl], 10))
        for impl in ("kernel", "plain"):
            ms = statistics.mean(step_ms[impl])
            log(f"{tag} serve_step {impl} B={SLOTS} pos={TOKENS - 1}: "
                f"{'/'.join(f'{x:.3f}' for x in step_ms[impl])} ms "
                f"({SLOTS / ms * 1e3:.1f} tok/s)")
            log_breakdown(f"{tag} serve_step {impl}",
                          profile_kernels(step[impl], 5), ms)
        if cfg.moe is not None:
            decode_moe(params, cfg, tag, statistics.mean(step_ms["kernel"]))
        cross_err = (decode_cross(params, cfg, caches, tokens, pos, tag,
                                  statistics.mean(step_ms["kernel"]))
                     if cfg.enc_dec else None)
        in_step = (scan_in_step(step["kernel"], tag)
                   if kernel == "selective_scan" else None)
        # (b) the servers: kernel (counted) and plain
        gaps_k, gaps_p = [], []
        ops.reset_launches()
        out_k, steps, secs_k = _serve(
            SlotServer(params, cfg, runtime("kernel"), SLOTS, MAX_LEN), gaps_k)
        launches = ops.LAUNCHES[kernel]
        variants = dict(ops.SCAN_VARIANTS)
        out_p, steps_p, secs_p = _serve(
            SlotServer(params, cfg, runtime("plain"), SLOTS, MAX_LEN), gaps_p)
    per_step = decode_per_step(cfg) if kernel == "decode_attention" else cfg.n_layers
    check(launches == per_step * steps,
          f"{kernel} launches {launches} != {per_step} a step x {steps} steps")
    if kernel == "selective_scan":
        # every decode step of the server goes to the float4 step kernel
        check(variants["step"] == launches,
              f"server scan launches by variant {variants}")
        log(f"{tag}: scan launches by variant {variants}")
    check(sorted(out_k) == list(range(REQUESTS)), "missing requests")
    check(all(len(o) == TOKENS for o in out_k.values()), "short requests")
    diverged = []
    for req in range(REQUESTS):
        a, b = out_k[req], out_p[req]
        if a != b:
            t = next(i for i in range(TOKENS) if a[i] != b[i])
            # the request's t-th token came out of the t-th step it was active
            seen = [s for s in gaps_p if req in s]
            gap = seen[t][req]
            diverged.append((req, t, gap))
            log(f"{tag}: request {req} diverges at token {t}; plain top-2 "
                f"gap there {gap:.3e} (tol {tol})")
            check(gap < tol, f"request {req}: streams diverge at a clear "
                             f"top-2 gap {gap:.3e}")
    tok = REQUESTS * TOKENS
    log(f"{tag} {REQUESTS} req x {TOKENS} tok, {SLOTS} slots, max_len "
        f"{MAX_LEN}: {steps} steps, {kernel} launches {launches}; kernel "
        f"{secs_k:.2f} s ({tok / secs_k:.1f} tok/s), plain path {secs_p:.2f} s "
        f"({tok / secs_p:.1f} tok/s); diverged requests: {len(diverged)}")
    check(steps == steps_p, "plain server took another number of steps")
    del params
    log_memory(tag, reckoned_gb)
    return {"launches": launches, "cache": caches["kernel"], "pos": pos,
            "scan_in_step": in_step, "cross_err": cross_err}


def decode_moe(params, cfg, tag: str, step_ms: float) -> None:
    """An MoE decode step runs ``apply_moe`` on SLOTS tokens (C = 32, so no
    assignment is dropped) and its expert GEMMs read every expert's
    weights: the step must read every weight but the embedding table (only
    SLOTS rows of it). That, over the HBM rate, is the step's least time,
    printed beside the measured one; then ``check_moe_dispatch`` on a
    [SLOTS, 1, d] input."""
    nbytes = sum(t.numel() * t.element_size() for t in params.parameters()) \
        - params.embed.numel() * params.embed.element_size()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    C = L.moe_capacity(SLOTS, cfg)
    log(f"{tag} serve_step reads >= {nbytes / 1e9:.2f} GB a step (every "
        f"weight but the embedding table; MoE at T = {SLOTS}, C = {C}: every "
        f"expert's GEMMs run), >= {bound_ms:.2f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; measured {step_ms:.3f} ms "
        f"({100 * bound_ms / step_ms:.1f}% of that bound)")
    moe = next(layer.moe for layer in params.layers if hasattr(layer, "moe"))
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    h = torch.randn((SLOTS, 1, cfg.d_model), generator=g, device=DEVICE)
    check_moe_dispatch(moe, h, cfg, f"{tag} moe decode")


def decode_cross(params, cfg, caches, tokens, pos, tag: str,
                 step_ms: float) -> float:
    """An encoder-decoder's decode step: the bytes it must read (every
    weight but the encoder's and the embedding table, of which it reads
    SLOTS rows; the cross K/V whole; the self-attention K/V of pos + 1 keys
    a slot) over the HBM rate, beside its time. Then one more step of each
    path at the same tokens and positions with random cross K/V, the same
    in both (serving leaves xk/xv zero, as the JAX server does, so this is
    where the card holds the cross path with values): kernel against plain
    within 2e-5. Returns that error; the caches keep the random xk/xv."""
    weights = sum(t.numel() * t.element_size()
                  for name, t in params.named_parameters()
                  if not name.startswith(("encoder.", "embed")))
    cross = sum(c[x].numel() * c[x].element_size()
                for c in caches["kernel"] for x in ("xk", "xv"))
    key = cfg.n_kv_heads * cfg.d_head * 4
    own = 2 * cfg.n_layers * int((pos + 1).sum()) * key
    bound_ms = (weights + cross + own) / HBM_BYTES_PER_S * 1e3
    log(f"{tag} serve_step reads >= {weights / 1e9:.2f} GB of weights (the "
        f"decoder's and the unembedding) + {cross / 1e9:.2f} GB of cross K/V "
        f"(read whole, {caches['kernel'][0]['xk'].shape[2]} keys a slot) + "
        f"{own / 1e6:.2f} MB of self-attention K/V a step, >= {bound_ms:.2f} ms"
        f" at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; measured {step_ms:.3f} ms "
        f"({100 * bound_ms / step_ms:.1f}% of that bound)")
    zero = serve_step(params, caches["kernel"], tokens, pos, cfg=cfg,
                      rt=runtime("kernel"))[1]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    for ck, cp in zip(caches["kernel"], caches["plain"]):
        for x in ("xk", "xv"):
            ck[x].copy_(torch.randn(ck[x].shape, generator=g, device=DEVICE))
            cp[x].copy_(ck[x])
    got = {impl: serve_step(params, caches[impl], tokens, pos, cfg=cfg,
                            rt=runtime(impl))[1] for impl in ("kernel", "plain")}
    err = assert_close(got["kernel"], got["plain"], TOL[torch.float32],
                       f"{tag} step with random cross K/V")
    moved = max_err(got["kernel"], zero)
    check(moved > 0, f"{tag}: random cross K/V left the logits unchanged")
    log(f"{tag} one step with random cross K/V: kernel vs plain max|dlogit| "
        f"{err:.3e} (tol {TOL[torch.float32]}); the cross path moved the "
        f"logits by up to {moved:.3e} from the zero cache's")
    return err


def _scan_addcmul(a, b, h0=None):
    """One decode step of the scan as one library call (S = 1 and h0 only):
    h = a * h0 + b. Timed, never used by the port; CUDA may fuse its
    product and sum, so its bits may differ from the kernel's."""
    return torch.addcmul(b, a, h0.unsqueeze(1))


def scan_in_step(step, tag: str) -> dict:
    """Device ms per scan launch inside the Mamba serve step, where a and b
    were just written and sit in L2, three ways in turns: the step kernel
    (the path's), the sequential kernel at S = 1 (what took S = 1 before the
    step kernel; ``ops.scan_variant`` patched for the run) and one library
    call in the kernel's place (``_scan_addcmul``, ``ops.selective_scan``
    patched for the run). The patched runs only time; nothing is checked or
    counted from them."""
    ways = {
        "step": (contextlib.nullcontext, SCAN_KERNEL["step"]),
        "sequential": (lambda: mock.patch.object(
            ops, "scan_variant", lambda *_: "sequential"),
            SCAN_KERNEL["sequential"]),
        "addcmul": (lambda: mock.patch.object(
            ops, "selective_scan", _scan_addcmul), "addcmul"),
    }
    runs = {way: [] for way in ways}
    for way in ("step", "sequential", "addcmul", "addcmul", "sequential",
                "step"):
        patch, name = ways[way]
        with patch():
            prof = profile_kernels(step, 5)
        runs[way].append(kernel_ms(prof, name))
        busy = sum(ms for _, ms in prof["kernels"].values())
        log(f"{tag} serve_step scan in the step, {way} ({name}): "
            f"{_fmt(runs[way][-1])} ms per launch, {recorded(prof, name):g} "
            f"launches recorded a step, device busy {busy:.3f} ms a step")
    out = {way: (statistics.mean(t) if None not in t else None)
           for way, t in runs.items()}
    log(f"{tag} serve_step scan per launch (mean of 2): "
        + ", ".join(f"{way} {_fmt(ms)} ms" for way, ms in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _sdpa_flash(q, k, v, causal: bool = True):
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def time_flash(cfg, sdpa_err: dict,
               dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """The flash forward at the forward's shape (``cfg``'s heads) in the
    variants of ``dtypes`` at dh = 128: bf16 on the tensor cores (the
    forward path's) and f32 split-f32 (the train path's), each against its
    bound: bf16 at 989 TFLOP/s; f32 as
    three TF32 products at 495 TFLOP/s, with the 67 TFLOP/s CUDA-core bound
    beside it. Beside each, SDPA: ``enable_gqa`` for bf16; for f32 the
    memory-efficient backend on K/V repeated to the q heads, and the fastest
    backend that takes ``enable_gqa`` (MATH), each with its error from
    ``sdpa_err`` (step 0). The f32 prep launch's device time apart."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    B, S, H, KV, D = FWD_B, FWD_S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    res = {}
    for dt in dtypes:
        variant = ops.flash_variant(dt, D)
        names = (FLASH_TC,) if dt == torch.bfloat16 else (F32TC_FWD_PREP, F32TC_FWD)
        q = _randn(g, (B, S, H, D), dt)
        k = _randn(g, (B, S, KV, D), dt)
        v = _randn(g, (B, S, KV, D), dt)
        got = ops.flash_attention(q, k, v)
        err = assert_close(got, ref.flash_attention_ref(q, k, v), TOL[dt],
                           f"time flash {dt}")
        if dt == torch.bfloat16:
            check_flash_rows(got, q, k, v, {}, f"time flash {dt}")
        del got
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
        prof, _ = profile_recorded(lambda: ops.flash_attention(q, k, v),
                                   names, 1, grow=5)
        dev_ms = kernel_ms(prof, *names)
        prep_ms = kernel_ms(prof, F32TC_FWD_PREP) if dt == torch.float32 else None
        flops = 4 * B * H * (S * (S + 1) // 2) * D   # kept (q, k) pairs, causal
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (flops / PEAK_FLOPS[dt] if dt == torch.bfloat16
                 else 3 * flops / TF32_FLOPS)
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        cc_bound_ms = max(flops / PEAK_FLOPS[torch.float32], t_bytes) * 1e3
        lib_ms = lib_math_ms = lib_backend = None
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if dt == torch.bfloat16:
            lib_ms = cuda_ms(lambda: _sdpa_flash(qt, kt, vt))
            libs = f", sdpa(enable_gqa) {lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f})"
        else:
            lib_ms = time_sdpa_expanded(qt, kt, vt, None, "f32 forward")
            lib_math_ms, lib_backend = time_sdpa(
                lambda: (lambda: _sdpa_flash(qt, kt, vt)), "f32 forward")
            libs = (f", sdpa on K/V repeated (EFFICIENT_ATTENTION) {_fmt(lib_ms)} ms"
                    f" (kernel/sdpa {_fmt(lib_ms and ms / lib_ms)}, its error "
                    f"{_fmt_err(sdpa_err.get('forward'))}), sdpa(enable_gqa, "
                    f"{lib_backend}) {lib_math_ms:.4f} ms")
        del qt, kt, vt
        log(f"time flash {str(dt)[6:]} ({variant}, {', '.join(names)}) "
            f"[{B},{S},{H},{D}] kv {KV} causal: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of "
            f"the bound), plain {plain_ms:.4f} ms{libs}, bound "
            f"{bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP"
            + (f" at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s" if dt == torch.bfloat16
               else f" x 3 TF32 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s; "
                    f"CUDA-core bound {cc_bound_ms * 1e3:.2f} us at "
                    f"{PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s")
            + f", {nbytes / 1e6:.2f} MB); kernel device time {_fmt(dev_ms)} ms"
            + (f" ({flops / dev_ms / 1e9:.1f} TFLOP/s, "
               f"{_share(bound_ms, dev_ms)} of the bound"
               + (f", {_share(cc_bound_ms, dev_ms)} of the CUDA-core bound"
                  if dt == torch.float32 else "") + ")" if dev_ms else "")
            + (f", of which prep {_fmt(prep_ms)} ms" if dt == torch.float32 else ""))
        res[dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_math_ms=lib_math_ms,
                       library_backend=lib_backend, bound_ms=bound_ms,
                       bound_by=by, cc_bound_ms=cc_bound_ms, device_ms=dev_ms,
                       prep_device_ms=prep_ms)
        del q, k, v
    out = res[torch.bfloat16]
    if torch.float32 not in res:
        return out
    f32 = res[torch.float32]
    out.update(f32_source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
               f32_variant=ops.flash_variant(torch.float32, D),
               f32_ms=f32["ms"], f32_device_ms=f32["device_ms"],
               f32_prep_device_ms=f32["prep_device_ms"],
               f32_bound_ms=f32["bound_ms"], f32_bound_by=f32["bound_by"],
               f32_cuda_core_bound_ms=f32["cc_bound_ms"],
               f32_plain_ms=f32["plain_ms"],
               f32_library_ms=f32["library_ms"],
               f32_library_call="EFFICIENT_ATTENTION on K/V repeated to the q heads",
               f32_library_max_abs_err=sdpa_err.get("forward"),
               f32_library_math_ms=f32["library_math_ms"],
               f32_library_math_backend=f32["library_backend"],
               max_abs_err=max(out["max_abs_err"], f32["max_abs_err"]))
    return out


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def time_sdpa(make_fn, tag: str) -> tuple:
    """(ms, backend) of the fastest SDPA backend that takes the inputs of
    ``make_fn()``'s call, each backend alone (``sdpa_kernel``), with
    ``make_fn`` run inside the backend's context (so a backward follows its
    own forward). A yardstick only: a backend that refuses the inputs is
    logged and skipped; the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    best, seen = (None, None), []
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                fn = make_fn()
                fn()
                sync()
            except RuntimeError as e:   # the library's "no kernel for this"
                seen.append(f"{name} refused ({str(e).splitlines()[0][:60]})")
                continue
            ms = cuda_ms(fn, iters=10)
        seen.append(f"{name} {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, name)
    log(f"time sdpa {tag}: " + "; ".join(seen))
    check(best[0] is not None, f"sdpa {tag}: no backend took the inputs")
    return best


def time_sdpa_expanded(qt, kt, vt, dout, tag: str, causal: bool = True):
    """ms of memory-efficient SDPA on K/V repeated to q's heads (the repeat
    made outside the timed call): f32 SDPA's fused kernel, which refuses
    GQA, so not the same inputs as the kernel's. The forward alone, or its
    backward when ``dout`` is given. None (logged) if the backend refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = qt.shape[1] // kt.shape[1]
    ke, ve = (t.detach().repeat_interleave(rep, dim=1).requires_grad_(
        dout is not None) for t in (kt, vt))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        try:
            o = F.scaled_dot_product_attention(qt, ke, ve, is_causal=causal)
        except RuntimeError as e:   # the library's "no kernel for this"
            log(f"time sdpa {tag}, K/V repeated: EFFICIENT_ATTENTION refused "
                f"({str(e).splitlines()[0][:60]})")
            return None
        if dout is None:
            fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, ke, ve, is_causal=causal)
        else:
            fn = lambda: torch.autograd.grad(  # noqa: E731
                o, (qt, ke, ve), dout, retain_graph=True)
        ms = cuda_ms(fn, iters=10)
    log(f"time sdpa {tag}, K/V repeated to the q heads: EFFICIENT_ATTENTION "
        f"{ms:.4f} ms")
    return ms


def time_flash_backward(cfg, sdpa_err: dict) -> dict:
    """The f32 backward (split-f32, the train path's) at the train step's
    shape (causal, GQA), its plain version, SDPA's backward (memory-efficient
    on K/V repeated to the q heads, with its step-0 error, and the fastest
    backend that takes ``enable_gqa``) and its bound: five products of the
    kept pairs (S recomputed, dP, dq, dk, dv), three TF32 products each at
    495 TFLOP/s (the 67 TFLOP/s CUDA-core bound beside it), or q, k, v, o,
    dO, lse read and dq, dk, dv written once at the HBM rate."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    B, S, H, KV, D = FWD_B, FWD_S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = torch.float32
    q = _randn(g, (B, S, H, D), dt)
    k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
    dout = _randn(g, (B, S, H, D), dt)
    out, lse = ops.flash_attention_forward(q, k, v, True, None, None, want_lse=True)

    def fn():
        return ops.flash_attention_backward(q, k, v, out, lse, dout)
    err = max(max_err(a, b) for a, b in zip(
        fn(), ref.flash_attention_backward_ref(q, k, v, out, lse, dout)))
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(lambda: ref.flash_attention_backward_ref(
        q, k, v, out, lse, dout), iters=5)
    prof = profile_kernels(fn)
    dev_ms = kernel_ms(prof, *F32TC_BWD)
    by_kernel = {n: kernel_ms(prof, n) for n in F32TC_BWD}
    pairs = B * H * (S * (S + 1) // 2)
    flops = 10 * pairs * D
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel() + lse.numel()) * 4
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    cc_bound_ms = max(flops / PEAK_FLOPS[dt], t_bytes) * 1e3
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()

    def sdpa_backward():
        o = _sdpa_flash(qt, kt, vt)
        return lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                           retain_graph=True)
    math_ms, math_backend = time_sdpa(sdpa_backward, "f32 backward")
    lib_ms = time_sdpa_expanded(qt, kt, vt, dot, "f32 backward")
    del qt, kt, vt, dot
    log(f"time flash backward f32 ({ops.flash_variant(dt, D)}, "
        f"flash_attention_f32tc.cu) [{B},{S},{H},{D}] kv {KV} causal: kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
        f"of the bound), plain {plain_ms:.4f} ms, sdpa backward on K/V repeated "
        f"(EFFICIENT_ATTENTION) {_fmt(lib_ms)} ms (kernel/sdpa "
        f"{_fmt(lib_ms and ms / lib_ms)}, its error relative to max "
        f"{_fmt_err(sdpa_err.get('backward'))}), sdpa backward (enable_gqa, "
        f"{math_backend}) {math_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({by}: {flops / 1e9:.2f} GFLOP x 3 TF32 products at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB; CUDA-core "
        f"bound {cc_bound_ms * 1e3:.2f} us at {PEAK_FLOPS[dt] / 1e12:.0f} "
        f"TFLOP/s); kernel device time {_fmt(dev_ms)} ms ("
        + ", ".join(f"{n} {_fmt(t)}" for n, t in by_kernel.items())
        + f"), {_share(bound_ms, dev_ms)} of the bound, "
        f"{_share(cc_bound_ms, dev_ms)} of the CUDA-core bound; max_abs_err "
        f"{err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_call="EFFICIENT_ATTENTION on K/V repeated to the q heads",
                library_max_err_to_max=sdpa_err.get("backward"),
                library_math_ms=math_ms, library_math_backend=math_backend,
                bound_ms=bound_ms, bound_by=by, cuda_core_bound_ms=cc_bound_ms,
                device_ms=dev_ms, device_ms_by_kernel=by_kernel)


def _fmt_err(x) -> str:
    return "not measured" if x is None else f"{x:.3e}"


def _sdpa_mask(Sq, Sk, causal, window):
    """SDPA's boolean attn_mask (True = kept) for the kernels' mask rule."""
    if not causal:
        return None
    qpos = torch.arange(Sq, device=DEVICE)[:, None]
    kpos = torch.arange(Sk, device=DEVICE)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def sdpa_accuracy() -> dict:
    """Step 0: the error of memory-efficient SDPA (split-f32 products on the
    tensor cores, CUTLASS's OpMultiplyAddFastF32) on K/V repeated to the q
    heads, against the plain versions, at phase 2's f32 cases with D <= 128
    (SDPA has no softcap: those are skipped). The forward's max abs error
    (rtol = atol = 2e-5 as phase 2), the backward's largest gradient error
    relative to that gradient's max (2e-5). Logged, not checked: a yardstick
    of what 3xTF32 gives at these shapes, the evidence the split-f32 route
    rests on. {"forward": err, "backward": err, "within": bool}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    tol = TOL[torch.float32]
    fwd = [(B, S, S, H, KV, D, c, w, cap) for B, S, H, KV, D, dt, c, w, cap
           in FLASH_CASES if dt == torch.float32 and D in (32, 64, 128)]
    bwd = [case for case in BWD_CASES if case[5] in (32, 64, 128)]
    worst = {"forward": None, "backward": None}   # None: no case measured
    within = True
    for kind, cases in (("forward", fwd), ("backward", bwd)):
        for case in cases:
            B, Sq, Sk, H, KV, D, causal, window, softcap = case
            if softcap is not None:
                log(f"step 0 sdpa {kind} {case}: skipped (SDPA has no softcap)")
                continue
            q = _randn(g, (B, Sq, H, D), torch.float32)
            k, v = (_randn(g, (B, Sk, KV, D), torch.float32) for _ in range(2))
            dout = _randn(g, (B, Sq, H, D), torch.float32)
            kw = dict(causal=causal, window=window, softcap=None)
            mask = _sdpa_mask(Sq, Sk, causal, window)
            rep = H // KV
            qt = q.transpose(1, 2).contiguous().requires_grad_(kind == "backward")
            ke, ve = (t.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
                      .requires_grad_(kind == "backward") for t in (k, v))
            try:
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]), \
                        torch.set_grad_enabled(kind == "backward"):
                    o = F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask)
                    if kind == "backward":
                        grads = torch.autograd.grad(o, (qt, ke, ve),
                                                    dout.transpose(1, 2))
            except RuntimeError as e:   # the library's "no kernel for this"
                log(f"step 0 sdpa {kind} {case}: EFFICIENT_ATTENTION refused "
                    f"({str(e).splitlines()[0][:60]})")
                continue
            want_o = ref.flash_attention_ref(q, k, v, **kw)
            if kind == "forward":
                got = o.detach().transpose(1, 2)
                err = max_err(got, want_o)
                ok = bool(torch.allclose(got, want_o, rtol=tol, atol=tol))
            else:
                lse = ref.flash_attention_lse_ref(q, k, **kw)
                want = ref.flash_attention_backward_ref(q, k, v, want_o, lse,
                                                        dout, **kw)
                dq = grads[0].transpose(1, 2)
                dk, dv = (x.reshape(B, KV, rep, Sk, D).sum(2).transpose(1, 2)
                          for x in grads[1:])
                errs = []
                ok = True
                for a, b in zip((dq, dk, dv), want):
                    scale = b.abs().max().clamp_min(1e-30)
                    errs.append(max_err(a, b) / scale.item())
                    ok &= bool(torch.allclose(a / scale, b / scale, rtol=tol,
                                              atol=tol))
                err = max(errs)
            worst[kind] = max(worst[kind] or 0.0, err)
            within &= ok
            log(f"step 0 sdpa {kind} (EFFICIENT_ATTENTION, K/V repeated) "
                f"{case}: {'max_abs_err' if kind == 'forward' else 'error relative to max'} "
                f"{err:.3e}, {'within' if ok else 'OUTSIDE'} rtol=atol {tol}")
            del q, k, v, dout, qt, ke, ve, o
    log(f"step 0: memory-efficient SDPA (3xTF32) worst forward max_abs_err "
        f"{_fmt_err(worst['forward'])}, worst backward error relative to max "
        f"{_fmt_err(worst['backward'])}; "
        f"{'all measured within' if within else 'NOT all within'} {tol}")
    return {**worst, "within": within}


def make_flush(kind: str = "write"):
    """A call that moves 256 MB through the 50 MB L2, so that the next
    kernel's reads start cold. "write" (the flush of the earlier timings)
    leaves the L2 full of dirty lines, whose write-back then falls in the
    next kernel's time;
    "read" leaves it full of clean lines, as the serve step's weight reads
    do before an attention or scan kernel."""
    scratch = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)
    return scratch.zero_ if kind == "write" else scratch.sum


def _clean_l2_times(fn, names) -> tuple:
    """Event and device ms of fn() after a read flush (``make_flush``)."""
    flush = make_flush("read")
    ms = cuda_ms(fn, flush=flush)
    return ms, kernel_ms(profile_kernels(lambda: (flush(), fn())), *names)


def _share(bound_ms, ms) -> str:
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.1f}%"


def time_decode(q, k, v, lengths, tag: str) -> dict:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    mask = (torch.arange(S, device=DEVICE)[None, :] < lengths[:, None].long()
            )[:, None, None, :]                                   # [B,1,1,S]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    flush = make_flush()
    err = max_err(ops.decode_attention(q, k, v, lengths),
                  ref.decode_attention_ref(q, k, v, lengths))
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, lengths), flush=flush)
    plain_ms = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, lengths),
                       flush=flush)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    names = decode_names(B, H, KV, S, D, q.dtype)
    dev_ms = kernel_ms(profile_recorded(lambda: (flush(), ops.decode_attention(
        q, k, v, lengths)), names, 1)[0], *names)
    # the variant that writes lse (a rank's range of a sequence-sharded
    # cache runs it), timed the same way
    lse_ms = cuda_ms(lambda: ops.decode_attention(q, k, v, lengths,
                                                  return_lse=True), flush=flush)
    lse_dev = kernel_ms(profile_recorded(lambda: (flush(), ops.decode_attention(
        q, k, v, lengths, return_lse=True)), names, 1)[0], *names)
    clean_ms, clean_dev = _clean_l2_times(
        lambda: ops.decode_attention(q, k, v, lengths), names)
    valid = lengths.clamp(max=S).sum().item()
    nbytes = (2 * valid * KV * D + 2 * q.numel()) * q.element_size() \
        + lengths.numel() * 4
    flops = 4 * valid * (H // KV) * KV * D
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    plan = decode_plan(B, H, KV, S, D, q.dtype)
    log(f"time decode {tag} {str(q.dtype)[6:]} B={B} S={S} H={H} KV={KV} D={D} "
        f"valid keys {valid}, {plan}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa(mask, enable_gqa) {lib_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.3f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound); after a read flush "
        f"(clean L2): kernel {clean_ms:.4f} ms ({_share(bound_ms, clean_ms)}), "
        f"device {_fmt(clean_dev)} ms ({_share(bound_ms, clean_dev)}); with "
        f"lse: kernel {lse_ms:.4f} ms, device {_fmt(lse_dev)} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms,
                clean_l2_ms=clean_ms, clean_l2_device_ms=clean_dev,
                lse_ms=lse_ms, lse_device_ms=lse_dev,
                plan=dataclasses.asdict(plan), kernels=list(names))


def time_scan(a, b, h0, tag: str, cold: bool) -> dict:
    """The scan kernel at one shape, its plain loop and its bound (bytes:
    a and b read, h written, h0 read; 2 flops an element). No single PyTorch
    call computes a linear recurrence (S > 1), so there the library time is
    None; one step with h0 (S = 1) is ``torch.addcmul`` (``_scan_addcmul``),
    timed as the kernel is."""
    flush = make_flush() if cold else None
    B, S, DI, DS = a.shape
    variant = ops.scan_variant(a, b, h0)
    err = max_err(ops.selective_scan(a, b, h0), ref.selective_scan_ref(a, b, h0))
    ms = cuda_ms(lambda: ops.selective_scan(a, b, h0), flush=flush)
    plain_ms = cuda_ms(lambda: ref.selective_scan_ref(a, b, h0), iters=5,
                       flush=flush)
    prof = profile_kernels(lambda: (flush and flush(),
                                    ops.selective_scan(a, b, h0)), iters=20)
    dev_ms = kernel_ms(prof, SCAN_KERNEL[variant])
    clean_ms, clean_dev = (_clean_l2_times(lambda: ops.selective_scan(a, b, h0),
                                           (SCAN_KERNEL[variant],))
                           if cold else (None, None))
    lib = (lambda: _scan_addcmul(a, b, h0)) if S == 1 and h0 is not None \
        else None
    lib_ms = lib_dev = lib_clean_dev = None
    if lib is not None:
        lib_ms = cuda_ms(lib, flush=flush)
        lib_dev = kernel_ms(profile_kernels(lambda: (flush and flush(), lib()),
                                            iters=20), "addcmul")
        if cold:
            _, lib_clean_dev = _clean_l2_times(lib, ("addcmul",))
    if dev_ms is None:
        log(f"time scan {tag}: the profiler recorded no scan launch; it saw "
            f"{sorted(k[:60] for k in prof['kernels'])[:6]}")
    n = a.numel()
    nbytes = (3 * n + (0 if h0 is None else h0.numel())) * 4
    flops = 2 * n
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time scan {tag} f32 [{B},{S},{DI},{DS}] h0={h0 is not None}"
        f"{' cold L2' if cold else ''} ({variant}, {SCAN_KERNEL[variant]}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        + ("none" if lib is None else
           f"addcmul {lib_ms:.4f} ms (device {_fmt(lib_dev)} ms"
           + (f", after a read flush {_fmt(lib_clean_dev)} ms" if cold else "")
           + ")")
        + ", bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound)"
        + (f"; after a read flush (clean L2): kernel {clean_ms:.4f} ms "
           f"({_share(bound_ms, clean_ms)}), device {_fmt(clean_dev)} ms "
           f"({_share(bound_ms, clean_dev)})" if cold else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev,
                library_clean_l2_device_ms=lib_clean_dev,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms,
                variant=variant, clean_l2_ms=clean_ms,
                clean_l2_device_ms=clean_dev)


def time_scan_backward(a, h, dh, tag: str) -> dict:
    """The scan's backward kernel at one shape (no h0, as on the train path),
    its plain reverse loop and its bound (bytes: a, h and dh read, da and db
    written; 3 flops an element). No PyTorch call computes a reverse linear
    recurrence, so there is no library time."""
    B, S, DI, DS = a.shape
    fn = lambda: ops.selective_scan_backward(a, h, None, dh)  # noqa: E731
    plain = lambda: ref.selective_scan_backward_ref(a, h, None, dh)  # noqa: E731
    err = max(max_err(x, y) for x, y in zip(fn()[:2], plain()[:2]))
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    dev_ms = kernel_ms(profile_kernels(fn, iters=20), SCAN_BWD)
    n = a.numel()
    nbytes = 5 * n * 4
    t_ops = 3 * n / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time scan backward {tag} f32 [{B},{S},{DI},{DS}] ({SCAN_BWD}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none (no "
        f"PyTorch call computes a reverse linear recurrence), bound "
        f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved, {100 * bound_ms / ms:.1f}% of "
        f"the bound; kernel device time {_fmt(dev_ms)} ms "
        f"({_fmt(dev_ms and nbytes / dev_ms / 1e6)} GB/s, "
        f"{_share(bound_ms, dev_ms)} of the bound); max_abs_err {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms)


# the SFUs' exponentials a second on an H100 SXM: 16 a clock on each of 132
# SMs at the 1.98 GHz boost clock (data sheet)
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def time_fused(cfg) -> dict:
    """The fused scan pair at ``cfg``'s Mamba train shape ([FWD_B, FWD_S,
    d_inner, d_state] in f32, phase 7's), each kernel beside its plain
    version, its bound and the same-call parent: the materialised route's
    whole scan part (a and b built at [B,S,DI,DS], the sequential scan
    kernel, the h.C einsum; its backward through autograd, the reverse-scan
    kernel among it), by event and device time. The bound is the larger of
    the bytes the function moves (forward: u, dt, A, Bc, Cc read, y and the
    chunk states written; backward: those, the states and dy read, du, ddt,
    dA, dB and dC written) and its f32 operations (``ops.FUSED_FLOPS`` a
    state element); the SFUs' exponentials (one an element forward, 1.75
    backward) are printed beside it. No PyTorch call computes a linear
    recurrence, so there is no library time. Also the bf16 forward (phase
    3b's operands)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    B, S, DI, DS = FWD_B, FWD_S, cfg.d_inner, cfg.mamba.d_state
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        u, dt, A, Bc, Cc, dy = _fused_operands(g, B, S, DI, DS, dtype,
                                               cfg.dt_rank)
        fwd = lambda: ops.selective_scan_fused_forward(  # noqa: E731
            u, dt, A, Bc, Cc, want_states=True)
        y, states = fwd()
        bwd = lambda: ops.selective_scan_fused_backward(  # noqa: E731
            u, dt, A, Bc, Cc, states, dy)
        e, n, nc = u.element_size(), B * S * DI * DS, ref.fused_chunks(S)
        rows = 2 * B * S * DS * e
        read_f = B * S * DI * (e + 4) + DI * DS * 4 + rows
        bytes_f = read_f + B * S * DI * 4 + B * nc * DI * DS * 4
        bytes_b = (read_f + B * nc * DI * DS * 4 + B * S * DI * 4
                   + B * S * DI * (e + 4) + DI * DS * 4 + rows)
        kinds = [("forward", fwd, bytes_f, (SSF_FWD,), 1.0)]
        if dtype == torch.float32:
            kinds.append(("backward", bwd, bytes_b, SSF_BWD, 1.75))
        for kind, fn, nbytes, names, exps in kinds:
            name = ("selective_scan_fused" if kind == "forward"
                    else "selective_scan_fused_backward")
            if kind == "forward":
                plain = lambda: ref.selective_scan_fused_ref(  # noqa: E731
                    u, dt, A, Bc, Cc, want_states=True)
                err = max_err(y, plain()[0])
            else:
                plain = lambda: ref.selective_scan_fused_backward_ref(  # noqa: E731
                    u, dt, A, Bc, Cc, states, dy)
                err = max(max_err(x, w) / w.abs().max().item()
                          for x, w in zip(fn(), plain()))
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(plain, iters=2, warmup=1)
            prof = profile_recorded(fn, names, 1, iters=10)[0]
            dev_ms = kernel_ms(prof, *names)
            by_kernel = {x: kernel_ms(prof, x) for x in names}
            t_ops = ops.FUSED_FLOPS[name] * n / PEAK_FLOPS[torch.float32]
            t_bytes = nbytes / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            sfu_ms = exps * n / SFU_EXP_PER_S * 1e3
            out[f"{DTYPE_NAME[dtype]}_{kind}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms,
                device_ms_by_kernel=by_kernel, sfu_ms=sfu_ms,
                shape=[B, S, DI, DS], dtype=DTYPE_NAME[dtype])
            log(f"time fused scan {kind} {DTYPE_NAME[dtype]} [{B},{S},{DI},"
                f"{DS}] ({', '.join(names)}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.1f} ms, library none (no PyTorch call computes a "
                f"linear recurrence), bound {bound_ms * 1e3:.1f} us ({by}: "
                f"{nbytes / 1e6:.1f} MB, {ops.FUSED_FLOPS[name] * n / 1e9:.2f}"
                f" GFLOP f32), the SFUs' {exps:g} exponentials an element "
                f"{sfu_ms * 1e3:.1f} us; kernel device time {_fmt(dev_ms)} ms "
                f"({_share(bound_ms, dev_ms)} of the bound; by kernel "
                f"{ {k: _fmt(v) for k, v in by_kernel.items()} }); "
                f"max err {err:.3e}" + (" (of each gradient's max)"
                                        if kind == "backward" else ""))
        if dtype == torch.float32:
            # the same-call parent: the materialised route's scan part
            A_log = torch.log(-A)
            leaves = [t.detach().requires_grad_(True)
                      for t in (u, dt, A_log, Bc, Cc)]

            def mat(u_, dt_, A_log_, Bc_, Cc_):
                a, b = L._scan_inputs(A_log_, u_, dt_, Bc_)
                return torch.einsum("bsin,bsn->bsi", ops.selective_scan(a, b),
                                    Cc_.float())
            with torch.no_grad():
                pf_ms = cuda_ms(lambda: mat(u, dt, A_log, Bc, Cc), iters=5)
                prof = profile_kernels(lambda: mat(u, dt, A_log, Bc, Cc), 3)
            pf_dev = sum(ms for _, ms in prof["kernels"].values()) or None
            ym = mat(*leaves)
            grad = lambda: torch.autograd.grad(  # noqa: E731
                ym, leaves, dy, retain_graph=True)
            pb_ms = cuda_ms(grad, iters=3, warmup=1)
            prof = profile_kernels(grad, 2, warm=True)
            pb_dev = sum(ms for _, ms in prof["kernels"].values()) or None
            del ym, leaves
            torch.cuda.empty_cache()
            fk, bk = out["f32_forward"], out["f32_backward"]
            fk.update(parent="the materialised route: a and b built, "
                      "ops.selective_scan, the h.C einsum",
                      parent_ms=pf_ms, parent_device_ms=pf_dev)
            bk.update(parent="the materialised route's backward through "
                      "autograd (ops.SelectiveScan's reverse scan among it)",
                      parent_ms=pb_ms, parent_device_ms=pb_dev)
            log(f"time fused scan f32: same-call parent (the materialised "
                f"route's scan part) forward {pf_ms:.3f} ms (device "
                f"{_fmt(pf_dev)} ms), backward {pb_ms:.3f} ms (device "
                f"{_fmt(pb_dev)} ms); the fused pair {fk['ms']:.3f} + "
                f"{bk['ms']:.3f} ms (device {_fmt(fk['device_ms'])} + "
                f"{_fmt(bk['device_ms'])} ms)")
        del u, dt, A, Bc, Cc, dy, y, states
        torch.cuda.empty_cache()
    return out


# gemma2-9b's attention shape (dh = 256), as in phase 8's train step:
# (B, S, H, KV, D, softcap), causal; the 4096-key window of its local layers
# has no effect at S = 2048
D256_SHAPE = (2, 2048, 16, 8, 256, 50.0)
# head dim 192 (the pair kernels at 96 columns a block; d_model 768 over 4
# heads: torch_train_e2e --big, launch.serve --d-model 768) at a train
# step's shape, and the padded route at head dim 16 (the tests'
# reduced(d_model=64), run on the D = 32 instances): causal, no softcap
D192_SHAPE = (2, 2048, 16, 8, 192, None)
D16_SHAPE = (2, 2048, 16, 8, 16, None)
# decode at those head dims: (B, S, H, KV), f32
DECODE_WIDE_SHAPE = (4, 4096, 16, 8)
# seamless-m4t-large-v2's (dh = 64, head group 1), as its encoder runs it in
# phases 10 and 10c: non-causal, no softcap
SEAMLESS_SHAPE = (2, 2048, 16, 16, 64, None)


def time_flash_set(shape, causal: bool, seed: int, tag: str) -> dict:
    """The flash kernels at one attention shape (B, S, H, KV, D, softcap):
    the f32 pair of the train path (split-f32, ``ops.flash_variant``; at
    D = 192 and 256 the pair's kernels form clusters of two; any other head
    dim runs on the next built one, ``ops.built_head_dim``, and its bound
    is that of the true D's work) and the bf16 forward
    (tensor cores). Event and device time, the plain versions, the bounds
    (operations: 4 flops a kept (q, k) pair and dim forward, 10 backward;
    f32 as three TF32 products at 495 TFLOP/s with the 67 TFLOP/s CUDA-core
    bound beside it, bf16 at 989 TFLOP/s; or bytes) and SDPA (without a
    softcap, which SDPA has not): memory-efficient on K/V repeated to the q
    heads for f32, the flash backend with ``enable_gqa`` for bf16.
    {"forward": row, "backward": row, "bf16_forward": row}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S, H, KV, D, softcap = shape
    dt = torch.float32
    check(ops.flash_variant(dt, D) == "split_f32", f"dh {D} is not split_f32")
    q = _randn(g, (B, S, H, D), dt)
    k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
    dout = _randn(g, (B, S, H, D), dt)
    kw = dict(causal=causal, window=None, softcap=softcap)
    out, lse = ops.flash_attention_forward(q, k, v, causal, None, softcap,
                                           want_lse=True)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    fwd_names, bwd_names = f32tc_names(D)
    mask = "causal" if causal else "non-causal"
    no_cap = "" if softcap is None else ", no softcap"
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    res = {}
    for kind in ("forward", "backward", "bf16_forward"):
        if kind == "forward":
            fn = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
            plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
            names, flops = fwd_names, 4 * pairs * D
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
            got, want = (fn(),), (plain(),)
        elif kind == "backward":
            fn = lambda: ops.flash_attention_backward(  # noqa: E731
                q, k, v, out, lse, dout, **kw)
            plain = lambda: ref.flash_attention_backward_ref(  # noqa: E731
                q, k, v, out, lse, dout, **kw)
            names, flops = bwd_names, 10 * pairs * D
            nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()
                      + lse.numel()) * 4
            got, want = fn(), plain()
        else:
            qb, kb, vb = (t.bfloat16() for t in (q, k, v))
            fn = lambda: ops.flash_attention(qb, kb, vb, **kw)  # noqa: E731
            plain = lambda: ref.flash_attention_ref(qb, kb, vb, **kw)  # noqa: E731
            names, flops = (FLASH_TC,), 4 * pairs * D
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            got, want = (fn(),), (plain(),)
            assert_close(got[0], want[0], TOL[torch.bfloat16],
                         f"time flash bf16 {tag}")
            check_flash_rows(got[0], qb, kb, vb, kw, f"time flash bf16 {tag}")
        err = max(max_err(x, y) for x, y in zip(got, want))
        del got, want
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        prof, _ = profile_recorded(fn, names, 1, grow=5)
        dev_ms = kernel_ms(prof, *names)
        by_kernel = {n: kernel_ms(prof, n) for n in names}
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (flops / PEAK_FLOPS[torch.bfloat16] if kind == "bf16_forward"
                 else 3 * flops / TF32_FLOPS)
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        cc_bound_ms = max(flops / PEAK_FLOPS[dt], t_bytes) * 1e3
        if kind == "bf16_forward":
            qs, ks, vs = (t.bfloat16() for t in (qt, kt, vt))
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                try:
                    _sdpa_flash(qs, ks, vs, causal)
                    lib_ms = cuda_ms(lambda: _sdpa_flash(qs, ks, vs, causal))
                except RuntimeError as e:   # the library's "no kernel for this"
                    log(f"time sdpa bf16 {tag}: FLASH_ATTENTION refused "
                        f"({str(e).splitlines()[0][:60]})")
                    lib_ms = None
            del qs, ks, vs
            lib = f"sdpa (FLASH_ATTENTION, enable_gqa{no_cap})"
            bounds = (f"{flops / 1e9:.2f} GFLOP at "
                      f"{PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TFLOP/s")
        else:
            grad_in = [t.detach().requires_grad_(kind == "backward")
                       for t in (qt, kt, vt)]
            lib_ms = time_sdpa_expanded(*grad_in, dot if kind == "backward"
                                        else None, f"f32 {tag} {kind}", causal)
            lib = f"sdpa on K/V repeated (EFFICIENT_ATTENTION{no_cap})"
            bounds = (f"{flops / 1e9:.2f} GFLOP x 3 TF32 products at "
                      f"{TF32_FLOPS / 1e12:.0f} TFLOP/s; CUDA-core bound "
                      f"{cc_bound_ms * 1e3:.2f} us at "
                      f"{PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s")
        variant = ops.flash_variant(torch.bfloat16 if kind == "bf16_forward"
                                    else dt, D)
        log(f"time flash {kind} {tag} ({variant}, {', '.join(names)}) "
            f"[{B},{S},{H},{D}] kv {KV} {mask} softcap {softcap}: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, {lib} "
            + ("refused" if lib_ms is None else
               f"{lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f})")
            + f", bound {bound_ms * 1e3:.2f} us ({by}: {bounds}, "
            f"{nbytes / 1e6:.2f} MB); kernel device time {_fmt(dev_ms)} ms ("
            + ", ".join(f"{n} {_fmt(t)}" for n, t in by_kernel.items())
            + f"), {_share(bound_ms, dev_ms)} of the bound"
            + ("" if kind == "bf16_forward" else
               f", {_share(cc_bound_ms, dev_ms)} of the CUDA-core bound")
            + f"; max_abs_err {err:.3e}")
        res[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         cuda_core_bound_ms=cc_bound_ms, device_ms=dev_ms,
                         device_ms_by_kernel=by_kernel)
    res["bf16_forward"].pop("cuda_core_bound_ms")
    return res


# the wide route (head dims above 256): internlm2-1.8b's width over the
# launchers' four heads (d_model 2048, head dim 512, kv 2) at the forward's
# shape, causal: (B, S, H, KV, D, softcap); decode at B=4 S=4096 H=4 kv 2 at
# head dim 512 (64 keys and a full cache), and multi-query groups of 32
# and 71 (Falcon-7B's 71 heads over one kv head; H kv 1 D 64) over a full
# cache: (B, S, H, KV, D)
WIDE_SHAPE = (2, 2048, 4, 2, 512, None)
DECODE_D512_SHAPE = (4, 4096, 4, 2, 512)
DECODE_GROUP32_SHAPE = (4, 4096, 32, 1, 64)
DECODE_GROUP71_SHAPE = (4, 4096, 71, 1, 64)
# the examples phase's group-route servers' own caches, 16 valid keys a
# slot of 128: launch.serve --d-model 2048 and 1280, and 32 heads over one
# kv head at d_model 2048
DECODE_SERVER_SHAPES = {"d2048": (4, 128, 4, 2, 512),
                        "d1280": (4, 128, 4, 2, 320),
                        "mqa": (4, 128, 32, 1, 64)}
DECODE_SERVER_KEYS = 16


def time_wide_flash(shape, seed: int) -> dict:
    """The wide route's flash kernels at one causal shape (B, S, H, KV, D,
    softcap): the cluster route (``csrc/flash_attention_f32tc_cluster.cu``:
    the prep launch and the N-rank cluster kernels), forward and backward,
    in f32 (the launch.train --d-model 2048 path's: split-f32) and bf16 (one
    TF32 product): event and device time (each launch), the plain versions'
    times, the error (f32 against the plain version at 2e-5; bf16 against
    the plain f32 result of the f32 copies at 2e-2; gradients relative to
    each one's max), and the bound at the true head dim's work (4 flops a
    kept pair and dim forward, 10 backward, each score once: what the
    cluster kernels do, ``ops.attention_work``): f32 as three TF32 products
    at 495 TFLOP/s with the 67 TFLOP/s CUDA-core bound beside it, bf16 at
    989 TFLOP/s with its one TF32 product's 495 TFLOP/s ceiling beside it;
    or q, k, v (o, dO, lse) read and the outputs written once. Beside them
    the same-call parent: the CUDA-core kernels (``csrc/flash_attention_wide.cu``,
    the route above 1024) called directly on the same inputs, uncounted,
    timed parent, kernel, kernel, parent; the work they do (the scores once
    per slice of 128 columns). The library call: SDPA with ``enable_gqa``
    (``time_sdpa``: the fastest backend that takes the head dim, named;
    MATH where no other does). Also the cluster kernels' occupancy
    (``cudaOccupancyMaxActiveClusters``) at head dims 320, 512, 576 and
    1024. {"f32_forward": row, "f32_backward": row, "bf16_forward": row,
    "bf16_backward": row}."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S, H, KV, D, softcap = shape
    kw = dict(causal=True, window=None, softcap=softcap)
    pairs = B * H * (S * (S + 1) // 2)
    lib = build.load()
    for Dc in (320, 512, 576, 1024):
        ranks = lib.repro_flash_cluster_ranks(Dc)
        occ = {(dt, bwd): lib.repro_flash_cluster_occupancy(Dc, dt, bwd)
               for dt in (0, 1) for bwd in (0, 1)}
        log(f"cluster occupancy dh {Dc} ({ranks} ranks of {Dc // ranks} "
            f"columns): clusters the card holds at once, f32 forward "
            f"{occ[0, 0]} backward {occ[0, 1]}, bf16 forward {occ[1, 0]} "
            f"backward {occ[1, 1]}")
        check(all(n > 0 for n in occ.values()),
              f"cluster dh {Dc}: a kernel's cluster cannot be scheduled {occ}")
    n_slices = -(-D // ops.WIDE_FLASH_SLICE)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        check(ops.flash_variant(dt, D) == "cluster",
              f"dh {D} {dt} is not on the cluster route")
        q = _randn(g, (B, S, H, D), dt)
        k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
        dout = _randn(g, (B, S, H, D), dt)
        out, lse = ops.flash_attention_forward(q, k, v, True, None, softcap,
                                               want_lse=True)
        f32 = [t.float() for t in (q, k, v, dout)]
        want_o = ref.flash_attention_ref(*f32[:3], **kw)
        want_lse = ref.flash_attention_lse_ref(*f32[:2], **kw)
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, dout))
        name = DTYPE_NAME[dt]
        # the same-call parent's outputs (the CUDA-core kernels, uncounted)
        p_out, p_lse = torch.empty_like(q), torch.empty_like(lse)
        p_grads = [torch.empty_like(t) for t in (q, k, v)]
        p_args = (B, S, S, H, KV, D, D, ops._DTYPES[dt], 1, 0,
                  float(softcap or 0.0))
        for kind in ("forward", "backward"):
            if kind == "forward":
                fn = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
                plain = lambda: ref.flash_attention_ref(  # noqa: E731
                    q, k, v, **kw)

                def parent():
                    ops._raise_on(lib.repro_flash_attention_wide(
                        *map(ops._ptr, (q, k, v, p_out, p_lse)), *p_args,
                        ops._stream()),
                        "CUDA-core forward")
                names, flops = WIDE_FWD, 4 * pairs * D
                parent_work = (2 * n_slices + 2) * pairs * D
                nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                    * q.element_size()
                err = assert_close(fn(), want_o, TOL[dt],
                                   f"time wide {name} forward")
                parent()
                p_err = assert_close(p_out, want_o, TOL[dt],
                                     f"time wide {name} parent forward")

                def make_lib():
                    return lambda: _sdpa_flash(qt, kt, vt, True)
            else:
                fn = lambda: ops.flash_attention_backward(  # noqa: E731
                    q, k, v, out, lse, dout, **kw)
                plain = lambda: ref.flash_attention_backward_ref(  # noqa: E731
                    q, k, v, out, lse, dout, **kw)

                def parent():
                    ops._raise_on(lib.repro_flash_attention_wide_bwd(
                        *map(ops._ptr, (q, k, v, out, dout)), ops._ptr(lse),
                        *map(ops._ptr, p_grads), *p_args, ops._stream()),
                        "CUDA-core backward")
                names, flops = WIDE_BWD, 10 * pairs * D
                parent_work = (8 * n_slices + 6) * pairs * D
                nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
                    * q.element_size() + lse.numel() * 4
                want = ref.flash_attention_backward_ref(
                    *f32[:3], want_o, want_lse, f32[3], **kw)
                got = fn()
                err = max(assert_close_to_max(a.float(), b, TOL[dt],
                                              f"time wide {name} backward {n}")
                          for n, a, b in zip(("dq", "dk", "dv"), got, want))
                again = fn()
                check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                      f"time wide {name} backward: two calls differ")
                parent()
                p_err = max(assert_close_to_max(
                    a.float(), b, TOL[dt], f"time wide {name} parent {n}")
                    for n, a, b in zip(("dq", "dk", "dv"), p_grads, want))
                del got, again, want

                def make_lib():
                    leaves = [t.detach().requires_grad_(True)
                              for t in (qt, kt, vt)]
                    o = _sdpa_flash(*leaves, True)
                    return lambda: torch.autograd.grad(o, leaves, dot,
                                                       retain_graph=True)
            work = ops.attention_work(
                "flash_attention" if kind == "forward"
                else "flash_attention_backward", D) * pairs
            iters = 10 if kind == "forward" else 5
            p_iters = 3 if kind == "forward" else 2
            parent_ms = [cuda_ms(parent, iters=p_iters, warmup=1)]
            ms_runs = [cuda_ms(fn, iters=iters), cuda_ms(fn, iters=iters)]
            parent_ms.append(cuda_ms(parent, iters=p_iters, warmup=1))
            ms = statistics.median(ms_runs)
            parent_med = statistics.median(parent_ms)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            prof, _ = profile_recorded(fn, names, 1, iters=5, grow=2)
            dev_ms = kernel_ms(prof, *names)
            by_kernel = {n: kernel_ms(prof, n) for n in names}
            lib_ms, backend = time_sdpa(make_lib, f"wide {name} {kind} "
                                        f"[{B},{S},{H},{D}] kv {KV}")
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = (flops / PEAK_FLOPS[dt] if dt == torch.bfloat16
                     else 3 * flops / TF32_FLOPS)
            bound_ms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            cc_bound_ms = max(flops / PEAK_FLOPS[torch.float32], t_bytes) * 1e3
            tf32_bound_ms = max(flops / TF32_FLOPS, t_bytes) * 1e3
            log(f"time wide flash {kind} {name} (cluster, "
                f"{', '.join(names)}) [{B},{S},{H},{D}] kv {KV} causal "
                f"softcap {softcap}: kernel {ms:.4f} ms (runs "
                + ", ".join(f"{x:.4f}" for x in ms_runs)
                + f"; {flops / ms / 1e9:.1f} TFLOP/s of the true work, "
                f"which it does: {work / 1e9:.2f} GFLOP, {work / flops:.2f}x),"
                f" same-call parent (the CUDA-core kernels) {parent_med:.4f} "
                f"ms (runs " + ", ".join(f"{x:.4f}" for x in parent_ms)
                + f"; {parent_work / 1e9:.2f} GFLOP done, "
                f"{parent_work / flops:.2f}x; max error {p_err:.3e}; "
                f"parent/kernel {parent_med / ms:.2f}), plain "
                f"{plain_ms:.4f} ms, sdpa (enable_gqa, {backend}) "
                f"{lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f}), bound "
                f"{bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP "
                + (f"at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s; one TF32 "
                   f"product's ceiling {tf32_bound_ms * 1e3:.2f} us"
                   if dt == torch.bfloat16 else
                   f"x 3 TF32 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s")
                + f", {nbytes / 1e6:.2f} MB); CUDA-core bound "
                f"{cc_bound_ms * 1e3:.2f} us; kernel device time "
                f"{_fmt(dev_ms)} ms ("
                + ", ".join(f"{n} {_fmt(t)}" for n, t in by_kernel.items())
                + f"), {_share(bound_ms, dev_ms)} of the bound"
                + (f", {_share(tf32_bound_ms, dev_ms)} of the TF32 ceiling"
                   if dt == torch.bfloat16 else "")
                + f", {_share(cc_bound_ms, dev_ms)} of the CUDA-core bound; "
                f"max error {err:.3e} (tol {TOL[dt]})")
            res[f"{name}_{kind}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_backend=backend, bound_ms=bound_ms, bound_by=by,
                cuda_core_bound_ms=cc_bound_ms, tf32_bound_ms=tf32_bound_ms,
                device_ms=dev_ms, device_ms_by_kernel=by_kernel,
                gflop=flops / 1e9, gflop_done=work / 1e9,
                parent_ms=parent_med, parent_gflop_done=parent_work / 1e9,
                parent_max_abs_err=p_err, shape=list(shape[:5]), causal=True)
        del q, k, v, dout, out, lse, f32, qt, kt, vt, dot, want_o, want_lse
        del p_out, p_lse, p_grads
    return res


# internlm2-1.8b's attention shape as its train step runs it: (B, S, H, KV, D,
# softcap), causal
TRAIN_SHAPE = (2, 2048, 16, 8, 128, None)
GROK_TRAIN_SHAPE = (2, 2048, 48, 8, 128, None)   # phase 12's, head group 6


def time_sdpa_bf16_backward(qt, kt, vt, dot, causal: bool, tag: str):
    """(ms, call) of SDPA's bf16 backward on these inputs ([B, heads, S, D]):
    the flash backend with ``enable_gqa``, else on K/V repeated to the q
    heads (the repeat outside the timed call). A yardstick only; the port
    never calls SDPA. (None, reason) if the backend refuses both."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = qt.shape[1] // kt.shape[1]
    tries = [("FLASH_ATTENTION, enable_gqa", kt, vt, True)]
    if rep > 1:
        tries.append(("FLASH_ATTENTION on K/V repeated to the q heads",
                      *(t.repeat_interleave(rep, dim=1) for t in (kt, vt)),
                      False))
    refused = []
    for call, kk, vv, gqa in tries:
        leaves = [t.detach().requires_grad_(True) for t in (qt, kk, vv)]
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            try:
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                   enable_gqa=gqa)
                fn = lambda: torch.autograd.grad(  # noqa: E731
                    o, leaves, dot, retain_graph=True)
                fn()
                sync()
            except RuntimeError as e:   # the library's "no kernel for this"
                refused.append(f"{call} refused ({str(e).splitlines()[0][:60]})")
                continue
            ms = cuda_ms(fn, iters=10)
        log(f"time sdpa bf16 backward {tag}: {call} {ms:.4f} ms"
            + (f" ({'; '.join(refused)})" if refused else ""))
        return ms, call
    log(f"time sdpa bf16 backward {tag}: " + "; ".join(refused))
    return None, "; ".join(refused)


def time_flash_backward_bf16(shape, causal: bool, seed: int, tag: str) -> dict:
    """The bf16 backward (``csrc/flash_attention_tc_bwd.cu``) at one
    attention shape (B, S, H, KV, D, softcap): the wrapper's CUDA-event
    time, the device time of each of its launches (delta, dk/dv, dq), the
    plain backward's time, its bound (five products of the kept pairs, 2 x
    5 x pairs x D flops, at the 989 TFLOP/s dense bf16 peak; or q, k, v, o,
    dO and lse read and dq, dk, dv written once at the HBM rate) and SDPA's
    bf16 backward (``time_sdpa_bf16_backward``; without a softcap, which
    SDPA has not). Beside it, the bf16 forward's device time with and
    without lse."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S, H, KV, D, softcap = shape
    dt = torch.bfloat16
    q = _randn(g, (B, S, H, D), dt)
    k, v = _randn(g, (B, S, KV, D), dt), _randn(g, (B, S, KV, D), dt)
    dout = _randn(g, (B, S, H, D), dt)
    kw = dict(causal=causal, window=None, softcap=softcap)
    out, lse = ops.flash_attention_forward(q, k, v, causal, None, softcap,
                                           want_lse=True)

    def fn():
        return ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)

    def plain():
        return ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    err = max(max_err(a, b) for a, b in zip(fn(), plain()))
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, iters=5)
    prof, _ = profile_recorded(fn, FLASH_TC_BWD, 1, grow=5)
    dev_ms = kernel_ms(prof, *FLASH_TC_BWD)
    by_kernel = {n: kernel_ms(prof, n) for n in FLASH_TC_BWD}
    fwd = {}
    for want_lse in (False, True):
        p, _ = profile_recorded(lambda: ops.flash_attention_forward(
            q, k, v, causal, None, softcap, want_lse=want_lse), (FLASH_TC,), 1,
            grow=5)
        fwd[want_lse] = kernel_ms(p, FLASH_TC)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = 10 * pairs * D
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    lib_ms, lib_call = time_sdpa_bf16_backward(qt, kt, vt, dot, causal, tag)
    del qt, kt, vt, dot
    mask = "causal" if causal else "non-causal"
    log(f"time flash backward bf16 {tag} (tensor_core, "
        f"flash_attention_tc_bwd.cu) [{B},{S},{H},{D}] kv {KV} {mask} softcap "
        f"{softcap}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms, sdpa ({lib_call}"
        + ("" if softcap is None else ", no softcap") + ") "
        + (f"{lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f})" if lib_ms
           else "not measured")
        + f", bound {bound_ms * 1e3:.2f} us ({by}: {flops / 1e9:.2f} GFLOP at "
        f"{PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB); kernel "
        f"device time {_fmt(dev_ms)} ms ("
        + ", ".join(f"{n} {_fmt(t)}" for n, t in by_kernel.items())
        + f"), {_share(bound_ms, dev_ms)} of the bound; bf16 forward device "
        f"time without lse {_fmt(fwd[False])} ms, with lse {_fmt(fwd[True])} "
        f"ms; max_abs_err against the plain backward {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_call=lib_call, bound_ms=bound_ms, bound_by=by,
                device_ms=dev_ms, device_ms_by_kernel=by_kernel,
                forward_device_ms=fwd[False], forward_lse_device_ms=fwd[True],
                shape=list(shape[:5]), causal=causal, softcap=softcap)


# ---------------------------------------------------------------------------
# phase 6 / 6b, 7 / 7b: training at full width, f32; the LOG.io-protected runs
# ---------------------------------------------------------------------------


def _train_batch(cfg, g):
    """tokens/labels [1, FWD_B, FWD_S]; an encoder-decoder's frames [1,
    FWD_B, FWD_S, d] beside them."""
    toks = torch.randint(0, cfg.vocab, (1, FWD_B, FWD_S + 1), generator=g,
                         device=DEVICE)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].to(torch.int32)}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((1, FWD_B, FWD_S, cfg.d_model),
                                      generator=g, device=DEVICE)
    return batch


def _fresh_state(cfg, hp, dtype=torch.float32):
    return init_train_state(torch.Generator(device=DEVICE).manual_seed(SEED),
                            cfg, hp, dtype, DEVICE)


DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# bytes an element of AdamW's moments takes, by ``moment_dtype`` (int8: one
# byte and a 4-byte scale a row, about 1.25 at these rows' widths)
MOMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1.25}
ACCUM_BYTES = {"float32": 4, "bfloat16": 2}


# The train path of each family: the wrappers it counts (forward, backward),
# the device kernels each counted launch must be recorded as (every one of
# them n_layers times a step) and those of another variant that must not run.
def bf16_path(D: int) -> dict:
    """The bf16 train path at head dim D: the tensor-core forward and the
    bf16 backward's three kernels, their names carrying D (the profiler
    records ``flash_fwd_tc_kernel<128, false>``); any other head dim's and
    the split-f32 kernels must not run. (No head dim's decimal digits start
    another's, so ``<128`` matches D = 128 alone.)"""
    names = (FLASH_TC,) + FLASH_TC_BWD
    others = tuple(f"{n}<{d}" for d in (32, 64, 128, 256) if d != D
                   for n in names)
    return dict(wrappers=("flash_attention", "flash_attention_backward"),
                forward=(f"{FLASH_TC}<{D}",),
                backward=tuple(f"{n}<{D}" for n in FLASH_TC_BWD),
                others=others + (F32TC_FWD_PREP, F32TC_FWD, F32TC_FWD_D256,
                                 *F32TC_BWD, *F32TC_BWD_D256[1:]))


TRAIN_PATHS = {
    # bf16 (phases 11, 11b): internlm2's dh 128, gemma2's dh 256
    "attention_bf16": bf16_path(128),
    "attention_bf16_d256": bf16_path(256),
    "attention": dict(wrappers=("flash_attention", "flash_attention_backward"),
                      forward=(F32TC_FWD_PREP, F32TC_FWD), backward=F32TC_BWD,
                      others=(FLASH_TC, F32TC_FWD_D256, *F32TC_BWD_D256[1:])),
    # dh = 256 (gemma2-9b): the split-f32 kernels whose blocks form pairs
    "attention_d256": dict(wrappers=("flash_attention",
                                     "flash_attention_backward"),
                           forward=(F32TC_FWD_PREP, F32TC_FWD_D256),
                           backward=F32TC_BWD_D256,
                           others=(FLASH_TC, F32TC_FWD, *F32TC_BWD[1:])),
    # the Mamba train path at S > 256, S % 256 == 0 (phase 7): the fused
    # scan pair, none of the materialised route's kernels
    "scan": dict(wrappers=("selective_scan_fused",
                           "selective_scan_fused_backward"),
                 forward=(SSF_FWD,), backward=SSF_BWD,
                 others=(*SCAN_KERNEL.values(), SCAN_BWD)),
    # and at S = 128 (phase 7b's reduced runs): the materialised route
    "scan_materialised": dict(
        wrappers=("selective_scan", "selective_scan_backward"),
        forward=(SCAN_KERNEL["sequential"],), backward=(SCAN_BWD,),
        others=(SCAN_KERNEL["step"], SSF_FWD, *SSF_BWD)),
}


def state_bytes(dtype, hp) -> float:
    """Bytes a parameter takes in a train step: itself (``dtype``), its
    gradient accumulator (``hp.grad_accum_dtype``), m and v
    (``hp.moment_dtype``), and autograd's gradient beside the accumulator
    where the two dtypes differ (bf16 params, f32 accumulation). 16 in f32;
    14 + 2 for bf16 params with the default optimizer."""
    p, acc = (4 if dtype == torch.float32 else 2), ACCUM_BYTES[hp.grad_accum_dtype]
    return p + acc + 2 * MOMENT_BYTES[hp.moment_dtype] + (p if p != acc else 0)


def ffn_acts(cfg, tokens: int, e: int) -> float:
    """Bytes autograd keeps of one layer's FFN (``e`` bytes an element):
    dense, four [N, d_ff] (the gate, up, activation and product); MoE
    (``layers._moe_block``), the dispatched slots and the experts' outputs
    ([E C, d] each), four [E, C, d_ff / sp] in the experts, the K weighted
    products of the combine ([N, d] each) and the router's f32 logits and
    probs."""
    if cfg.moe is None:
        return tokens * 4 * cfg.d_ff * e
    m = cfg.moe
    E, K, f = m.n_experts * m.expert_split, m.top_k * m.expert_split, \
        cfg.d_ff // m.expert_split
    slots = E * L.moe_capacity(tokens, cfg)
    return ((2 * slots * cfg.d_model + 4 * slots * f + K * tokens * cfg.d_model)
            * e + 2 * tokens * m.n_experts * 4)


# bytes a train step holds beside what ``train_memory`` counts: cuBLAS's
# workspaces, the batch, RoPE's tables, the loss and the metrics
TRAIN_SLACK_GB = 0.25


def layer_memory(cfg, tokens: int, dtype, enc: bool = False,
                 seq: int = FWD_S) -> dict:
    """Bytes of one layer in a train step at N = ``tokens`` (``e`` bytes an
    activation): ``layer``, what autograd keeps of it without remat;
    ``saved``, what remat "block" keeps (``model._save_products``: the
    outputs of the products with no batch dimension); ``work``, what its
    backward adds beside them. ``enc``: an encoder layer. Each term is the
    code's own tensors (``tools/train_memory_probe.py`` measures them):

    - attention: four [N, d] (the inputs of both halves and their norms;
      bf16 adds the two norms' f32 copies), q before and after RoPE and the
      flash output [N, H dh], k before and after RoPE and v [N, KV dh], and
      the FFN's (``ffn_acts``); "block" keeps q, k, v and o and the dense
      MLP's gate, up and down (an MoE FFN's f32 router logits: its experts'
      products have the expert as batch); the backward adds the flash
      backward's dq, dk and dv (f32: and its hi/lo workspace, eight of q's
      size and six of k's). A decoder layer of an encoder-decoder adds its
      cross half: its input and norm [N, d], q and the flash output [N, H
      dh], k and v of the memory [N, KV dh] ("block": q, k, v, o), and its
      backward the memory's gradient [N, d] twice. An encoder layer is
      checkpointed with nothing saved under either remat.
    - mamba, at a sequence of ``seq`` (``layers.chunked``: JAX's chunked
      branch, the fused scan): eleven [N, DI] (seven f32, four in the
      activations' dtype), the input and the dt and B/C rows, and the
      fused scan's chunk states ([N / 64, DI, DS] f32, saved by
      ``ops.SelectiveScanFused``); the backward adds nothing beside what
      its recompute rebuilds in f32 (the fused backward's outputs and its
      partials take the place of the forward tensors it frees), one and a
      half [N, DI] of the dtype's difference from f32 in bf16 (du in f32
      beside its bf16 copy; ``tools/train_memory_probe.py`` at S 512 and
      1024: 0.06 of an [N, DI] f32 less in f32, 1.37 [N, DI] bf16 in bf16
      under "block"). Otherwise (the materialised route): the two [N, DI,
      DS] f32 tensors (a, saved by ``exp``; h, by the ``h.C`` einsum and
      ``ops.SelectiveScan``), twelve [N, DI] f32 and the input, dt and B/C
      rows; the backward adds three [N, DI, DS] (dh, da, db) and twelve
      [N, DI] f32. "block" keeps ``in_proj`` [N, 2 DI], ``x_proj`` [N,
      dt_rank + 2 DS], ``dt_proj`` [N, DI] and ``out_proj`` [N, d] on either
      route."""
    N, d, e = tokens, cfg.d_model, (4 if dtype == torch.float32 else 2)
    if cfg.family == "ssm" and not enc:
        di, ds, dr = cfg.d_inner, cfg.mamba.d_state, cfg.dt_rank
        saved = N * (3 * di + dr + 2 * ds + d) * e
        if L.chunked(seq):
            states = N * di * ds * 4 // ref.FUSED_CHUNK
            return {"layer": N * ((7 * 4 + 4 * e) * di + (d + dr + 2 * ds) * e)
                    + states, "saved": saved,
                    "work": 3 * N * di * (4 - e) // 2}
        big = N * di * ds * 4
        return {"layer": 2 * big + N * (12 * di + d + dr + 2 * ds) * 4,
                "saved": saved, "work": 3 * big + 12 * N * di * 4}
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    norms = 2 * N * d * 4 if e == 2 else 0
    out = {"layer": N * (4 * d + 3 * hd + 4 * kvd) * e + ffn_acts(cfg, N, e)
           + norms,
           "saved": 0 if enc else N * (hd + 2 * kvd + d) * e + (
               N * cfg.moe.n_experts * 4 if cfg.moe is not None
               else N * (2 * cfg.d_ff + d) * e),
           "work": N * (hd + 2 * kvd) * e
           + (N * (8 * hd + 6 * kvd) * 4 if e == 4 else 0)}
    if cfg.enc_dec and not enc:
        out["layer"] += N * (2 * d + 2 * hd + 2 * kvd) * e
        out["saved"] += N * (hd + 2 * kvd + d) * e
        out["work"] += 2 * N * d * e
    return out


def train_units(cfg, depth: int, tokens: int, dtype, remat: str,
                seq: int = FWD_S) -> list:
    """The units of a train step's backward at ``depth`` layers (an
    encoder-decoder's encoder cut to ``depth`` too), N = ``tokens``, in the
    order it runs them: each block of ``len(cfg.block)`` layers from the top,
    then each encoder layer. Each unit is (kept, over, params): the bytes
    the forward keeps for it (all its layers' ``layer_memory`` "layer"
    without remat; its input [N, d] and its layers' "saved" under "block";
    its input under "full"; an encoder layer, its input under either
    remat), the bytes its backward adds beside them (its recompute under
    remat and its layers' "work"), and its parameter count."""
    nb, N, d = len(cfg.block), tokens, cfg.d_model
    e = 4 if dtype == torch.float32 else 2
    cfg2 = at_depth(cfg, max(depth, nb))
    sizes = {name: t.numel() for name, t in M.DecoderParams(
        cfg2, torch.float32, "meta").named_parameters()}

    def units(prefix, n, enc):
        lm = layer_memory(cfg, N, dtype, enc, seq)
        per = sum(v for k, v in sizes.items() if k.startswith(prefix))
        mode = "full" if enc and remat != "none" else remat
        kept = {"none": n * lm["layer"], "block": N * d * e + n * lm["saved"],
                "full": N * d * e}[mode]
        over = lm["work"] + n * lm["layer"] + N * d * e - kept
        return [(kept, over, per * n / cfg2.n_layers)] * (depth // n)
    return units("layers.", nb, False) + (
        units("encoder.layers.", 1, True) if cfg.enc_dec else [])


def train_memory(cfg, depth: int, tokens: int, dtype=torch.float32,
                 hp: OptHParams = OptHParams(), remat: str = "none") -> float:
    """A train step's peak device memory in GB at ``depth`` layers (an
    encoder-decoder's encoder cut to ``depth`` too) under ``remat``,
    reckoned from the code, N = ``tokens``: the largest of

    - the loss's backward: the params and m and v (no grad exists yet),
      what the forward keeps for the backward, and five [N, V] f32 (the
      logits autograd keeps and the cross-entropy backward's temporaries;
      six under a final softcap: its tanh);
    - each unit's backward (``train_units``, from the top): the params and
      moments, the gradients made so far (the logits' weight's first), what
      is still kept, and what the unit's backward adds;
    - the gradients' cast to the accumulator (``state_bytes`` a param; a
      tied embedding's second gradient beside its first);
    - AdamW's: the state after the cast and the larger of
      ``global_norm``'s f32 temporaries of the largest leaf (its square;
      and its f32 copy where the accumulator is bf16) and the update's six
      f32 temporaries of a slice of ``optimizer.ADAMW_CHUNK`` elements;

    and TRAIN_SLACK_GB. Beside the units' and the loss's, the forward keeps
    three [N, d] f32 outside the blocks (the embedding's output and the
    final norm's; five with an encoder)."""
    p = 4 if dtype == torch.float32 else 2
    acc = ACCUM_BYTES[hp.grad_accum_dtype]
    opt = p + 2 * MOMENT_BYTES[hp.moment_dtype]   # a param, its m and v
    n_params = at_depth(cfg, depth).param_count()
    V, d, N = cfg.eff_vocab, cfg.d_model, tokens
    chain = train_units(cfg, depth, N, dtype, remat)
    kept_all = sum(k for k, _, _ in chain) + (3 + 2 * cfg.enc_dec) * N * d * 4
    logits = (5 + (cfg.final_softcap is not None)) * N * V * 4
    peaks = [opt * n_params + kept_all + logits]
    done, kept = V * d, kept_all
    for k, over, n in chain:
        peaks.append(opt * n_params + p * done + kept + over)
        done, kept = done + n, kept - k
    peaks.append(state_bytes(dtype, hp) * n_params
                 + (p * V * d if cfg.tie_embeddings else 0))
    largest = max(t.numel() for t in M.DecoderParams(
        at_depth(cfg, len(cfg.block)), torch.float32, "meta").parameters())
    norm_tmp = largest * 4 * (1 if acc == 4 else 2)
    peaks.append((opt + acc) * n_params + max(
        norm_tmp, 6 * min(largest, optimizer.ADAMW_CHUNK) * 4))
    return max(peaks) / 1e9 + TRAIN_SLACK_GB


def depth_for(tag: str, cfg, dtype, hp: OptHParams, remat: str) -> int:
    """The deepest depth, a multiple of ``len(cfg.block)`` and at most
    ``cfg.n_layers``, whose ``train_memory`` at ``tokens`` = FWD_B * FWD_S
    under ``remat`` is within TRAIN_GB."""
    tokens, nb = FWD_B * FWD_S, len(cfg.block)
    fits = [x for x in range(nb, cfg.n_layers + 1, nb)
            if train_memory(cfg, x, tokens, dtype, hp, remat) <= TRAIN_GB]
    check(bool(fits), f"{tag}: no depth fits {TRAIN_GB} GB")
    return fits[-1]


def depth_cut(tag: str, cfg, depth: int, dtype=torch.float32,
              hp: OptHParams = OptHParams(), remat: str = "none") -> float:
    """Log why ``tag`` trains ``cfg`` at ``depth`` layers (device memory,
    ``train_memory`` under ``remat`` at that depth and one block deeper,
    and without remat, beside TRAIN_GB and the card's memory) and return the
    reckoning at ``depth``."""
    tokens = FWD_B * FWD_S
    reckoned = train_memory(cfg, depth, tokens, dtype, hp, remat)
    deeper = depth + len(cfg.block)
    n = cfg.param_count()
    enc = (f" (and the encoder to {depth} of {cfg.n_enc_layers}; "
           f"{at_depth(cfg, depth).param_count() / 1e9:.3f} B params)"
           if cfg.enc_dec else "")
    more = (f"at depth {deeper} "
            f"{train_memory(cfg, deeper, tokens, dtype, hp, remat):.1f} GB"
            if deeper <= cfg.n_layers else "full depth")
    log(f"{tag}: depth {depth} of {cfg.n_layers} layers{enc}, remat "
        f"{remat!r}: full depth is {n / 1e9:.3f} B params, "
        f"{state_bytes(dtype, hp) * n / 1e9:.1f} GB of {DTYPE_NAME[dtype]} "
        f"params, grads, m and v ({state_bytes(dtype, hp):g} bytes a param); "
        f"reckoned peak at depth {depth} {reckoned:.1f} GB ({more}; without "
        f"remat {train_memory(cfg, depth, tokens, dtype, hp):.1f} GB), the "
        f"limit {TRAIN_GB} GB (card: "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB); "
        f"the repeat check keeps its reference on the host, so it adds no "
        f"device memory")
    return reckoned


def train_preset(arch: str):
    """(cfg, Runtime, OptHParams) of ``arch``'s train preset
    (``repro_torch.launch.presets``), as the JAX dry-run maps one
    (repro/launch/dryrun.py:57-63, 98-103): ``expert_split`` into
    ``cfg.moe``, ``remat`` into the Runtime (the kernel path),
    ``moment_dtype`` and ``grad_accum_dtype`` into the optimizer's
    hyper-parameters."""
    pre = preset_for(arch)
    cfg = get_config(arch)
    if pre.expert_split > 1 and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_split=pre.expert_split))
    return (cfg, runtime("kernel", pre.remat),
            OptHParams(moment_dtype=pre.moment_dtype,
                       grad_accum_dtype=pre.grad_accum_dtype))


def serve_memory(cfg, depth: int) -> dict:
    """Phases 9 and 9b's peak device memory in GB at ``depth`` layers,
    reckoned from the code, and the model's size (N = FWD_B * FWD_S):

    - forward: the f32 params after ``to_f32_`` (4 bytes a param), the
      kernel and plain paths' f32 logits kept for the comparison and the
      f32 path's ([N, V] each), and the larger of the f32 path's
      transients: an MoE layer's (xe and ye [E C, d]; four [E, C, f/sp]:
      the first GEMM's output while its activation is made, g, u and g*u)
      or plain attention's (three [B, H, S, S]);
    - serve: the f32 params and the larger of the f32 draw ``init_params``
      makes of its largest leaf (an expert weight, [E, d, f/sp]) before
      copying it in, and what serving adds: three f32 caches (the lockstep
      pair and a server's) and an MoE decode layer's four [E, 32, f/sp]."""
    n = dataclasses.replace(cfg, n_layers=depth).param_count()
    N, V, d = FWD_B * FWD_S, cfg.eff_vocab, cfg.d_model
    m = cfg.moe
    E, f = m.n_experts * m.expert_split, cfg.d_ff // m.expert_split
    C = L.moe_capacity(N, cfg)
    moe = (2 * E * C * d + 4 * E * C * f) * 4
    attn = 3 * FWD_B * cfg.n_heads * FWD_S ** 2 * 4
    cache = depth * 2 * SLOTS * MAX_LEN * cfg.n_kv_heads * cfg.d_head * 4
    serving = 3 * cache + 4 * E * L.moe_capacity(SLOTS, cfg) * f * 4
    return {"params": n,
            "forward_gb": (4 * n + 3 * N * V * 4 + max(moe, attn)) / 1e9,
            "serve_gb": (4 * n + max(E * d * f * 4, serving)) / 1e9}


def moe_depth_cut(tag: str, cfg, depth: int) -> dict:
    """Log why phases 9 and 9b run ``cfg`` at ``depth`` layers (device
    memory: ``serve_memory`` at that depth and at twice it, beside the
    card's) and return the reckoning at ``depth``."""
    full, here, twice = (serve_memory(cfg, x) for x in (cfg.n_layers, depth,
                                                       2 * depth))
    log(f"{tag}: depth cut to {depth} of {cfg.n_layers} layers, for device "
        f"memory: full depth is {full['params'] / 1e9:.3f} B params "
        f"({2 * full['params'] / 1e9:.1f} GB bf16); depth {depth} "
        f"{here['params'] / 1e9:.3f} B params, {2 * here['params'] / 1e9:.1f} "
        f"GB bf16, {4 * here['params'] / 1e9:.1f} GB f32; reckoned peak "
        f"forward {here['forward_gb']:.1f} GB (the f32 reference made in "
        f"place), serve {here['serve_gb']:.1f} GB; at depth {2 * depth} "
        f"{twice['forward_gb']:.1f} / {twice['serve_gb']:.1f} GB (card: "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)")
    return here


def encdec_memory(cfg) -> dict:
    """Phases 10 and 10b's peak device memory in GB at full depth, reckoned
    from the code, and the model's size (N = FWD_B * FWD_S):

    - forward: the f32 params after ``to_f32_`` (4 bytes a param), the
      kernel and plain paths' f32 logits kept for the comparison and the
      f32 path's ([N, V] each), and the larger of the f32 path's largest
      transient (plain attention's three [B, H, S, S]) and the
      comparison's (a difference and its absolute value, [N, V] each);
    - serve: the f32 params, three f32 caches (the lockstep pair and a
      server's), each with self K/V of MAX_LEN keys and cross K/V of
      ``Runtime().cross_len`` keys a slot in every layer, and the f32 draw
      ``init_params`` makes of its largest leaf (the embedding) before
      copying it in."""
    n = cfg.param_count()
    N, V = FWD_B * FWD_S, cfg.eff_vocab
    attn = 3 * FWD_B * cfg.n_heads * FWD_S ** 2 * 4
    key = SLOTS * cfg.n_kv_heads * cfg.d_head * 4
    cache = cfg.n_layers * 2 * (MAX_LEN + M.Runtime().cross_len) * key
    logits = N * V * 4
    return {"params": n,
            "forward_gb": (4 * n + 3 * logits + max(attn, 2 * logits)) / 1e9,
            "serve_gb": (4 * n + 3 * cache + V * cfg.d_model * 4) / 1e9}


def _host_leaves(state, moments: bool) -> list:
    """Host copies of a train state's params (and, with ``moments``, of its
    m and v leaves) for a bitwise comparison that costs no device memory."""
    leaves = (_state_leaves(state) if moments
              else [t.detach() for t in state["params"].parameters()])
    return [t.to("cpu", copy=True) for t in leaves]


def phase_train(cfg, path: str, tag: str, reckoned_gb=None,
                dtype=torch.float32, hp: OptHParams = OptHParams(),
                rt: M.Runtime = runtime("kernel"), grad_depth=GRAD_LAYERS,
                lse_kernel=None, moe: bool = False) -> dict:
    """``make_train_step`` at full width with ``dtype`` params, the
    optimizer ``hp`` and the runtime ``rt`` (``cfg.n_layers`` deep), tokens
    [1, 2, 2048], under the training's deterministic mode: the launches of
    ``TRAIN_PATHS[path]`` (counted and recorded; under remat each forward
    kernel twice a step, the forward and its recompute), first loss, step
    time and breakdown with the kernel pair's share, bitwise repeat, peak
    memory (beside ``reckoned_gb`` where given, and held at most
    TRAIN_MARGIN below it and never above)
    and the grads at depth ``grad_depth`` against the plain path
    (``grad_check``). ``lse_kernel``: a device kernel name (the forward
    variant that writes lse) that must be recorded as every forward launch
    of a step. ``moe``: the repeat also holds m and v bitwise (on the host),
    and one more step runs under ``torch.cuda.set_sync_debug_mode("error")``
    (no host sync).

    The first loss is held within 1 of ln V, where the init predicts near
    uniformly. A tied embedding is drawn N(0, 1) (as the JAX init), so its
    logits have std sqrt(d) before any final softcap (gemma2: ~60, capped
    at 30) and the first loss lies far above ln V (~41 at gemma2-9b's
    width, V 256000); there it is held to the plain path's loss of the same
    state and batch, within GRAD_TOL relative (bf16: TOL[bf16], the two
    paths round bf16 activations at other points)."""
    spec = TRAIN_PATHS[path]
    # launches of each wrapper a step: flash as many as a forward makes,
    # the forward's twice under remat
    per_step = (flash_per_forward(cfg) if spec["wrappers"][0] == "flash_attention"
                else cfg.n_layers)
    passes = 1 if rt.remat == "none" else 2
    want = dict(zip(spec["wrappers"], (passes * per_step, per_step)))
    want_rec = {**{x: passes * per_step for x in spec["forward"]},
                **{x: per_step for x in spec["backward"]}}
    train_driver.deterministic(torch.device(DEVICE))
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    step = make_train_step(cfg, hp, rt)
    tag = f"{tag} {cfg.name} {DTYPE_NAME[dtype]} [1,{FWD_B},{FWD_S}]"
    tokens = FWD_B * FWD_S
    state = _fresh_state(cfg, hp, dtype)
    n = sum(t.numel() for t in state["params"].parameters())
    enc = f" + {cfg.n_enc_layers} encoder layers" if cfg.enc_dec else ""
    log(f"{tag}: {cfg.n_layers} layers{enc}, {n / 1e9:.3f} B params; params + "
        f"grads + m + v {state_bytes(dtype, hp) * n / 1e9:.1f} GB "
        f"({DTYPE_NAME[dtype]} params, {state_bytes(dtype, hp):g} bytes a "
        f"param); remat {rt.remat!r}; AdamW {hp}")
    mb = {key: val[0] for key, val in batch.items()}
    plain_loss = None
    if cfg.tie_embeddings:
        with torch.no_grad():
            plain_loss = float(loss_fn(state["params"], mb, cfg,
                                       runtime("plain"))[0])
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        first_s = time.perf_counter() - t0
    first = {k: ops.LAUNCHES[k] for k in spec["wrappers"]}
    check(first == want, f"{tag}: launches in one step {first}, want {want}")
    if path == "scan":   # S = 2048: the fused route, no materialised scan
        check(ops.SCAN_VARIANTS == {"step": 0, "sequential": 0}
              and ops.LAUNCHES["selective_scan"] == 0
              and ops.LAUNCHES["selective_scan_backward"] == 0,
              f"{tag}: materialised scan launches {ops.SCAN_VARIANTS}, "
              f"backward {ops.LAUNCHES['selective_scan_backward']}")
    nondet = [str(w.message)[:120] for w in caught
              if "determinis" in str(w.message).lower()]
    check(not nondet, f"{tag}: determinism warnings {nondet}")
    loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gn), f"{tag}: non-finite loss")
    loss_tol = GRAD_TOL if dtype == torch.float32 else TOL[dtype]
    if plain_loss is None:
        check(abs(loss - math.log(cfg.vocab)) < 1.0,
              f"{tag}: first loss {loss:.4f} far from ln V "
              f"{math.log(cfg.vocab):.4f}")
    else:
        check(abs(loss - plain_loss) <= loss_tol * abs(plain_loss),
              f"{tag}: first loss {loss:.6f} vs the plain path's "
              f"{plain_loss:.6f}")
    vs = ("" if plain_loss is None else
          f"; tied N(0, 1) embedding: the plain path's loss {plain_loss:.6f}, "
          f"relative difference {abs(loss - plain_loss) / abs(plain_loss):.2e}"
          f" (tol {loss_tol})")
    log(f"{tag}: first step {first_s:.2f} s, loss {loss:.6f} (ln V "
        f"{math.log(cfg.vocab):.4f}{vs}), grad norm {gn:.4f}, launches {first}; "
        f"{len(caught)} warnings, none about determinism"
        + (f" (first: {str(caught[0].message)[:100]})" if caught else ""))
    t0 = time.perf_counter()
    host = _host_leaves(state, moe)
    host_s = time.perf_counter() - t0
    times, losses = [], [loss]
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    step_ms = statistics.median(times)
    log(f"{tag}: steps {' / '.join(f'{x:.1f}' for x in times)} ms "
        f"({tokens / step_ms * 1e3:.0f} tok/s), losses {losses}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    synced = 0
    if moe:   # the step makes no host sync (the mode needs the deterministic one)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync()
        synced = 1
        log(f"{tag}: one step under set_sync_debug_mode(\"error\"): no host "
            f"sync, loss {float(metrics['loss']):.6f}")
    t0 = time.perf_counter()
    prof, profiled = profile_recorded(lambda: step(state, batch),
                                      spec["forward"] + spec["backward"],
                                      per_step, iters=1, warm=True)
    prof_s = time.perf_counter() - t0
    log_breakdown(f"{tag} step", prof, step_ms, top=10)
    rec = {x: recorded(prof, x) for x in spec["forward"] + spec["backward"]}
    other = {x: recorded(prof, x) for x in spec["others"]}
    check(not any(other.values()), f"{tag}: launches of another variant {other}")
    check(rec == want_rec, f"{tag}: recorded launches a step {rec}, want "
          f"{want_rec}")
    if lse_kernel is not None:
        got = recorded(prof, lse_kernel)
        check(got == passes * per_step, f"{tag}: {lse_kernel} recorded {got} "
              f"a step, want {passes * per_step}")
        log(f"{tag}: every forward launch recorded as {lse_kernel} (lse "
            f"written): {got:g} a step")
    index = sorted({k[:50] for k in prof["kernels"] if "index" in k.lower()
                    or "sort" in k.lower()})
    fwd_ms = kernel_ms(prof, *spec["forward"])
    bwd_ms = kernel_ms(prof, *spec["backward"])
    busy = sum(ms for _, ms in prof["kernels"].values())
    pair = (passes * per_step * fwd_ms + per_step * bwd_ms
            if None not in (fwd_ms, bwd_ms) else None)
    log(f"{tag}: recorded a step {rec} (none of {list(other)}); the "
        f"embedding's backward ran {index}; {' + '.join(spec['wrappers'])}: "
        f"{passes * per_step} x {_fmt(fwd_ms)} + {per_step} x {_fmt(bwd_ms)} "
        f"ms = {_fmt(pair)} ms a step, "
        + ("not measured" if pair is None else
           f"{100 * pair / busy:.1f}% of device busy, "
           f"{100 * pair / step_ms:.1f}% of the step"))
    if busy:
        gemm = sum(ms for key, (_, ms) in prof["kernels"].items()
                   if any(x in key.lower() for x in ("gemm", "gemv", "nvjet")))
        rest = busy - gemm - (pair or 0.0)
        log(f"{tag}: device busy {busy:.1f} ms a step by class: GEMMs and "
            f"GEMVs (cuBLAS incl. its nvjet kernels, CUTLASS) {gemm:.1f} ms ({100 * gemm / busy:.1f}%)"
            f", the kernel pair {_fmt(pair)} ms, the rest (ATen elementwise, "
            f"reductions, copies, the embedding, AdamW) {rest:.1f} ms "
            f"({100 * rest / busy:.1f}%)")
    del state, metrics
    torch.cuda.empty_cache()
    peak = log_memory(tag, reckoned_gb)
    if None not in (peak, reckoned_gb):
        check((1 - TRAIN_MARGIN) * reckoned_gb <= peak <= reckoned_gb,
              f"{tag}: peak {peak:.2f} GB outside [{1 - TRAIN_MARGIN:g}, 1] "
              f"x the reckoned {reckoned_gb:.2f} GB")
    # bitwise: the first step again from a fresh state of the same seed
    state = _fresh_state(cfg, hp, dtype)
    state, metrics = step(state, batch)
    sync()
    check(float(metrics["loss"]) == loss, f"{tag}: repeat loss differs")
    again = _state_leaves(state) if moe else list(state["params"].parameters())
    t0 = time.perf_counter()
    same = all(bool(torch.equal(a.detach(), b.to(a.device)))
               for a, b in zip(again, host))
    host_s += time.perf_counter() - t0
    check(same, f"{tag}: two steps from the same state differ")
    launches = {k: ops.LAUNCHES[k] for k in first}
    # first, timed, sync-checked, profiled, repeat
    steps_run = 1 + TRAIN_STEPS + synced + profiled + 1
    check(launches == {k: x * steps_run for k, x in want.items()},
          f"{tag}: launches {launches} over {steps_run} steps")
    log(f"{tag}: the repeated first step is bitwise equal (loss and all "
        f"{len(host)} param{' and moment' if moe else ''} leaves); launches "
        f"over the phase's {steps_run} steps {launches}; seconds: the host "
        f"copy and its comparison {host_s:.1f}, the profile {prof_s:.1f}")
    del state, metrics, host, again
    torch.cuda.empty_cache()
    grads_bitwise = grad_check(cfg, mb, tag, dtype, grad_depth)
    return {"launches": launches, "steps": steps_run, "step_ms": step_ms,
            "per_step": per_step, "fwd_per_step": passes * per_step,
            "fwd_device_ms": fwd_ms, "bwd_device_ms": bwd_ms,
            "grads_bitwise": grads_bitwise, "first_loss": loss, "peak_gb": peak,
            "depth": cfg.n_layers, "remat": rt.remat}


def _leaf_errors(got, want) -> list:
    """(max, sum, count) of |got - want| / max|want| for each leaf, a
    slice of rows at a time (``optimizer._row_slices``), so an f32
    temporary stays small."""
    out = []
    for a, b in zip(got, want):
        top = b.abs().max().clamp_min(1e-30)
        worst, total, count = 0.0, 0.0, 0
        for sl in optimizer._row_slices(b):
            err = (a[sl].float() - b[sl]).abs() / top
            worst = max(worst, err.max().item())
            total += err.sum().item()
            count += err.numel()
        out.append((worst, total, count))
    return out


def grad_check(cfg, mb, tag: str, dtype, depth: int = GRAD_LAYERS):
    """The grads of one microbatch at full width, depth cut to ``depth``,
    kernel path against plain path. f32: each leaf within GRAD_TOL of its
    largest magnitude; returns whether they are bitwise equal.

    bf16: both paths against the f32 grads of f32 copies of the same
    weights (plain path); the kernel path's error, max and mean relative to
    each leaf's largest magnitude, may be at most 2x and 1.25x the plain
    bf16 path's (phase 3's rule for bf16 forwards: bf16 rounding alone
    moves two bf16 paths apart by about what it costs each). With an MoE
    FFN the 2x holds leaf by leaf (a token routed otherwise in bf16 than
    in f32 sets the largest error of both paths alike); the worst leaves,
    the attention's and the router's errors are logged. The f32
    reference comes first, from the bf16 weights turned into f32 in place
    leaf by leaf (``to_f32_``); then the bf16 weights are drawn again from
    the same seed (the same bits) for each bf16 path in turn, so at most
    the f32 grads and one bf16 path's weights and grads live at once (grok
    at depth 1: 26.1 + 13.1 + 13.1 GB). Returns None (the two bf16 paths
    round at other points, and are never held at once)."""
    cfg2 = at_depth(cfg, depth)

    def params(dt):
        return M.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                             cfg2, dt, DEVICE).requires_grad_(True)

    def grads(p, impl):
        t0 = time.perf_counter()
        out = torch.autograd.grad(loss_fn(p, mb, cfg2, runtime(impl))[0],
                                  list(p.parameters()))
        sync()
        secs[impl] = time.perf_counter() - t0
        return out
    secs = {}
    if dtype == torch.float32:
        p = params(dtype)
        names = [name for name, _ in p.named_parameters()]
        got = {impl: grads(p, impl) for impl in ("kernel", "plain")}
        bitwise = all(bool(torch.equal(a, b))
                      for a, b in zip(got["kernel"], got["plain"]))
        worst = max((assert_close_to_max(a, b, GRAD_TOL, f"{tag} grad {name}"),
                     name)
                    for name, a, b in zip(names, got["kernel"], got["plain"]))
        log(f"{tag}: grads at depth {depth}, kernel vs plain path: worst "
            f"leaf {worst[1]} error {worst[0]:.3e} of its max (tol {GRAD_TOL}); "
            f"bitwise equal: {bitwise}; seconds kernel {secs['kernel']:.2f}, "
            f"plain {secs['plain']:.2f}")
        del p, got
        torch.cuda.empty_cache()
        log_memory(f"{tag} grad check")
        return bitwise
    p = params(dtype)
    to_f32_(p)
    ref32 = grads(p, "plain")
    secs["f32"] = secs.pop("plain")
    del p
    torch.cuda.empty_cache()
    err = {}
    for impl in ("kernel", "plain"):
        p = params(dtype)
        g = grads(p, impl)
        err[impl] = _leaf_errors(g, ref32)
        del p, g
        torch.cuda.empty_cache()
    del ref32
    names = [name for name, _ in M.DecoderParams(cfg2, torch.float32,
                                                 "meta").named_parameters()]
    summary = {}
    for impl, leaves in err.items():
        worst = max(range(len(names)), key=lambda i: leaves[i][0])
        summary[impl] = (leaves[worst][0], names[worst],
                         sum(x[1] for x in leaves) / sum(x[2] for x in leaves))
    (k_max, k_name, k_mean), (p_max, p_name, p_mean) = (summary["kernel"],
                                                          summary["plain"])
    log(f"{tag}: grads at depth {depth} against the f32 grads of "
        f"f32 copies of the weights (plain path), relative to each leaf's "
        f"max: kernel path max {k_max:.3e} ({k_name}) mean {k_mean:.3e}, "
        f"plain bf16 path max {p_max:.3e} ({p_name}) mean {p_mean:.3e} "
        f"(kernel/plain {k_max / p_max:.2f} / {k_mean / p_mean:.2f}, limits "
        f"2 / 1.25); seconds f32 {secs['f32']:.2f}, kernel "
        f"{secs['kernel']:.2f}, plain {secs['plain']:.2f}")
    check(k_mean <= 1.25 * p_mean, f"{tag}: the kernel path's grads are less "
          f"accurate on the mean than the plain bf16 path's beyond 1.25x")
    if cfg.moe is None:
        check(k_max <= 2 * p_max, f"{tag}: the kernel path's grads are less "
              f"accurate than the plain bf16 path's beyond 2x")
    else:
        # a token whose top-k differs between bf16 and f32 moves every
        # gradient it reaches by a whole expert's share, on both bf16
        # paths alike (they route the same tokens): the largest error
        # overall is such a token's, whatever attention did. Each leaf is
        # held to 2x the plain path's on that leaf instead, so a fault of
        # the flash pair shows on the attention leaves beside theirs.
        ratio = [(k[0] / max(q[0], 1e-30), name) for name, k, q in
                 zip(names, err["kernel"], err["plain"])]
        attn = [(k[0], q[0]) for name, k, q in
                zip(names, err["kernel"], err["plain"]) if ".attn." in name]
        router = [(k[0], q[0]) for name, k, q in
                  zip(names, err["kernel"], err["plain"]) if ".router" in name]
        log(f"{tag}: MoE, each leaf's max error held to 2x the plain bf16 "
            f"path's on that leaf: worst ratio {max(ratio)[0]:.2f} "
            f"({max(ratio)[1]}); the attention leaves' max kernel "
            f"{max(k for k, _ in attn):.3e} / plain "
            f"{max(q for _, q in attn):.3e}, the router's kernel "
            f"{max(k for k, _ in router):.3e} / plain "
            f"{max(q for _, q in router):.3e}; the worst leaves (plain "
            f"path): " + ", ".join(
                f"{names[i]} {err['plain'][i][0]:.3e}" for i in sorted(
                    range(len(names)), key=lambda i: -err["plain"][i][0])[:4]))
        check(max(ratio)[0] <= 2, f"{tag}: the kernel path's grads of "
              f"{max(ratio)[1]} are less accurate than the plain bf16 "
              f"path's beyond 2x")
    torch.cuda.empty_cache()
    log_memory(f"{tag} grad check")
    return None


def remat_equal(cfg, tag: str, dtype, hp: OptHParams, remat: str,
                timed: bool = False) -> dict:
    """One ``make_train_step`` from a fresh state (seed SEED) with
    ``remat="none"`` and one with ``remat``: the loss, params and moments
    bitwise equal (the first step's state kept on the card for the
    comparison). With ``timed``, TRAIN_STEPS more steps with ``remat``
    after it (their median) and the peak device memory of those steps."""
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    first = {}
    state = _fresh_state(cfg, hp, dtype)
    sync()
    t0 = time.perf_counter()
    state, metrics = make_train_step(cfg, hp, runtime("kernel"))(state, batch)
    sync()
    first["none"] = (time.perf_counter() - t0) * 1e3
    loss = float(metrics["loss"])
    want = [t.clone() for t in _state_leaves(state)]
    del state, metrics
    torch.cuda.empty_cache()
    step = make_train_step(cfg, hp, runtime("kernel", remat))
    state = _fresh_state(cfg, hp, dtype)
    sync()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    sync()
    first[remat] = (time.perf_counter() - t0) * 1e3
    same = float(metrics["loss"]) == loss and all(
        bool(torch.equal(a, b)) for a, b in zip(want, _state_leaves(state)))
    check(same, f"{tag}: a step with remat {remat!r} differs from one with "
          f"\"none\" at depth {cfg.n_layers}")
    n_leaves = len(want)
    del want
    out = {"depth": cfg.n_layers, "bitwise": same, "loss": loss,
           "first_ms": first}
    if timed:
        torch.cuda.empty_cache()
        log_memory(f"{tag} remat {remat!r}, its bitwise check")
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = statistics.median(times)
    del state, metrics
    torch.cuda.empty_cache()
    out["peak_gb"] = log_memory(f"{tag} remat {remat!r}" + (
        " steps" if timed else ""))
    log(f"{tag}: depth {cfg.n_layers}, one step with remat {remat!r} bitwise "
        f"equal to one with \"none\" (loss {loss:.6f} and {n_leaves} param "
        f"and moment leaves); first steps {first[remat]:.1f} ms with it, "
        f"{first['none']:.1f} ms without" + (f"; steps with remat "
                                 f"{' / '.join(f'{x:.1f}' for x in times)} ms"
                                 if timed else ""))
    return out


def step_at_depth(arch: str, tag: str, depth: int, dtype) -> dict:
    """``arch``'s train preset (``train_preset``) at ``depth`` layers: a
    first step, then TRAIN_STEPS timed ones (their median ms) and the peak
    device memory of the steps, held as phase 7 holds its own: at most
    TRAIN_MARGIN below ``train_memory``'s reckoning at that depth and never
    above it."""
    cfg, rt, hp = train_preset(arch)
    cfg = at_depth(cfg, depth)
    reckoned = train_memory(cfg, depth, FWD_B * FWD_S, dtype, hp, rt.remat)
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    step = make_train_step(cfg, hp, rt)
    torch.cuda.empty_cache()
    log_memory(f"{tag} before the steps at depth {depth}")
    state = _fresh_state(cfg, hp, dtype)
    state, metrics = step(state, batch)
    sync()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(metrics["loss"])
    del state, metrics
    torch.cuda.empty_cache()
    peak = log_memory(f"{tag} at depth {depth}", reckoned)
    check(math.isfinite(loss), f"{tag} at depth {depth}: non-finite loss")
    if peak is not None:
        check((1 - TRAIN_MARGIN) * reckoned <= peak <= reckoned,
              f"{tag} at depth {depth}: peak {peak:.2f} GB outside "
              f"[{1 - TRAIN_MARGIN:g}, 1] x the reckoned {reckoned:.2f} GB")
    out = {"depth": depth, "step_ms": statistics.median(times),
           "peak_gb": peak, "reckoned_gb": reckoned, "remat": rt.remat}
    log(f"{tag} at depth {depth} (remat {rt.remat!r}): steps "
        f"{' / '.join(f'{x:.1f}' for x in times)} ms, median "
        f"{out['step_ms']:.1f} ms ({FWD_B * FWD_S / out['step_ms'] * 1e3:.0f}"
        f" tok/s), peak {_fmt(peak)} GB (reckoned {reckoned:.2f} GB)")
    return out


def phase_cut_train(arch: str, path: str, tag: str, dtype,
                    equal: bool = True, **kw) -> tuple:
    """A train cell cut for device memory: ``arch`` at its train preset
    (``train_preset``: its remat and optimizer), at the deepest depth
    ``train_memory`` reckons within TRAIN_GB (``depth_for``), through
    ``phase_train`` (``kw``: its ``grad_depth``, ``lse_kernel`` and ``moe``);
    then, with ``equal``, ``remat_equal`` at depth GRAD_LAYERS. Returns
    (phase_train's result, remat_equal's or None)."""
    cfg, rt, hp = train_preset(arch)
    depth = depth_for(tag, cfg, dtype, hp, rt.remat)
    reckoned = depth_cut(tag, cfg, depth, dtype, hp, rt.remat)
    out = phase_train(at_depth(cfg, depth), path, tag, reckoned, dtype=dtype,
                      hp=hp, rt=rt, **kw)
    same = (remat_equal(at_depth(cfg, GRAD_LAYERS), tag, dtype, hp, rt.remat)
            if equal else None)
    return out, same


# The optimizer-state variants of the JAX package's presets, each run at the
# bf16 train cell's width and depth: bf16 moments with bf16 accumulation
# (_BIG: grok, jamba), int8 moments (arctic) and int8 gradient compression.
TRAIN_VARIANTS = {
    "bf16 moments + bf16 accumulation": (
        dict(moment_dtype="bfloat16", grad_accum_dtype="bfloat16"), False),
    "int8 moments": (dict(moment_dtype="int8"), False),
    "compress_grads": ({}, True),
}


def _state_leaves(state) -> list:
    """A train state's params and moment leaves (an int8 moment's q and
    scale)."""
    leaves = [t.detach() for t in state["params"].parameters()]
    for key in ("m", "v"):
        for x in moment_leaves(state["opt"][key]):
            leaves += [x.q, x.scale] if is_qtensor(x) else [x]
    return leaves


def phase_train_variants(cfg, tag: str, dtype=torch.bfloat16) -> dict:
    """``make_train_step`` with each of TRAIN_VARIANTS at full width with
    ``dtype`` params, tokens [1, 2, 2048]: a first step from a fresh state,
    whose state is kept on the card (at most 10 bytes a param: a variant's
    params and moments), then the first step again from a fresh state of
    the same seed, its loss, params and moments (every int8 q and scale)
    held bitwise equal to the kept ones; then, the kept copy freed,
    TRAIN_STEPS timed steps (their median is the variant's step time), whose
    peak device memory stands beside ``train_memory``'s reckoning."""
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    tag = f"{tag} {cfg.name} {DTYPE_NAME[dtype]} [1,{FWD_B},{FWD_S}]"
    out = {}
    for name, (kw, compress) in TRAIN_VARIANTS.items():
        hp = OptHParams(**kw)
        step = make_train_step(cfg, hp, runtime("kernel"),
                               compress_grads=compress)
        reckoned = train_memory(cfg, cfg.n_layers, FWD_B * FWD_S, dtype, hp)
        state, metrics = step(_fresh_state(cfg, hp, dtype), batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        first = [t.clone() for t in _state_leaves(state)]
        del state, metrics
        state, metrics = step(_fresh_state(cfg, hp, dtype), batch)
        check(math.isfinite(loss) and math.isfinite(gn),
              f"{tag} {name}: non-finite loss")
        check(float(metrics["loss"]) == loss
              and all(bool(torch.equal(a, b))
                      for a, b in zip(first, _state_leaves(state))),
              f"{tag} {name}: two steps from the same state differ")
        n_leaves = len(first)
        del first   # its blocks stay cached for the timed steps
        log_memory(f"{tag} {name}, its bitwise check")   # and reset the peak
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        log(f"{tag} {name} ({state_bytes(dtype, hp):g} bytes a param, "
            f"compress_grads={compress}): steps {ms:.1f} ms "
            f"({FWD_B * FWD_S / ms * 1e3:.0f} tok/s), first loss {loss:.6f}, "
            f"grad norm {gn:.4f}; the first step twice from the same state "
            f"bitwise equal (loss and {n_leaves} param and moment leaves)")
        del state, metrics
        torch.cuda.empty_cache()
        log_memory(f"{tag} {name}", reckoned)
        out[name] = dict(step_ms=ms, loss=loss,
                         bytes_per_param=state_bytes(dtype, hp))
    return out


def _dryrun_against_card(cfg, dtype):
    """(the trace of phase 11's step, its seconds, that step on the card:
    {"step_ms", "peak", "launches", "prof_gemm": {op: (count, FLOPs)}})."""
    hp, rt = OptHParams(), runtime("kernel")
    t0 = time.perf_counter()
    tr = dryrun.trace_cell(cfg, ShapeSpec("internlm2-train-bf16", "train",
                                          FWD_S, FWD_B),
                           preset=Preset(microbatch=FWD_B, remat=rt.remat),
                           hp=hp, rt=rt)
    trace_s = time.perf_counter() - t0
    batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 5))
    step = make_train_step(cfg, hp, rt)
    state = _fresh_state(cfg, hp, dtype)
    state, metrics = step(state, batch)   # warm
    sync()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True, with_flops=True) as prof:
        state, metrics = step(state, batch)
        sync()
    prof_gemm = {ev.key: (ev.count, ev.flops) for ev in prof.key_averages()
                 if ev.key in PROFILER_GEMMS}
    del state, metrics
    torch.cuda.empty_cache()
    return tr, trace_s, {"step_ms": step_ms, "peak": peak,
                         "launches": launches, "prof_gemm": prof_gemm}


def phase_dryrun(cfg, dtype=torch.bfloat16) -> dict:
    """Phase 11c: the dry-run's trace of phase 11's step (full width and
    depth, bf16 params, the default optimizer, remat "none", tokens [1,
    FWD_B, FWD_S], no mesh) against that step on the card: a warm step,
    then one timed (launches, peak) and one profiled with FLOPs. Meanwhile
    one production cell of the dry-run runs as a subprocess (its own fake
    process group; no device)."""
    t_phase = time.perf_counter()
    tag = f"dry-run {cfg.name} {DTYPE_NAME[dtype]} [1,{FWD_B},{FWD_S}]"
    arch, shape = DRYRUN_CELL
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "cell.json")
    cell_run = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tr, trace_s, card = _dryrun_against_card(cfg, dtype)
    finally:   # the cell always ends here: waited for, or killed
        try:
            stdout, stderr = cell_run.communicate(
                timeout=max(0.0, DRYRUN_CELL_TIMEOUT
                            - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            cell_run.kill()
            stdout, stderr = cell_run.communicate()
        cell_s = time.perf_counter() - t_phase
        cell = json.loads(Path(out).read_text()) if os.path.exists(out) else {}
        tmp.cleanup()
    step_ms, peak, launches, prof_gemm = (card[k] for k in (
        "step_ms", "peak", "launches", "prof_gemm"))
    prof_flops = sum(f for _, f in prof_gemm.values())
    roof = dryrun.roofline(tr, tr["model_flops"], 1)
    lower_ms = roof["step_time_s_lower_bound"] * 1e3
    log(f"{tag}: traced on meta in {trace_s:.1f} s: GEMM {tr['gemm_flops']:.6e}"
        f" FLOP, kernels {tr['kernel_flops']:.6e} FLOP, bytes "
        f"{tr['memory_bytes']:.6e}, kernel calls {tr['kernel_calls']}, peak "
        f"{tr['peak_bytes'] / 1e9:.3f} GB (held {tr['argument_bytes'] / 1e9:.3f}"
        f" + temp {tr['temp_bytes'] / 1e9:.3f}); roofline (H100 SXM5) compute "
        f"{roof['compute_s'] * 1e3:.2f} ms, memory {roof['memory_s'] * 1e3:.2f}"
        f" ms, dominant {roof['dominant']}")
    log(f"{tag}: on the card: step {step_ms:.1f} ms, peak "
        f"{peak / 1e9:.3f} GB, launches {launches}; the profiler's GEMM FLOPs "
        f"{prof_flops:.6e} (by op: count, FLOP {prof_gemm})")
    check(tr["gemm_flops"] == prof_flops,
          f"{tag}: traced GEMM FLOPs {tr['gemm_flops']:.6e} != the "
          f"profiler's {prof_flops:.6e}")
    check(tr["kernel_calls"] == launches,
          f"{tag}: traced kernel calls {tr['kernel_calls']} != launches "
          f"{launches}")
    check(abs(tr["peak_bytes"] - peak) <= DRYRUN_PEAK_TOL * peak,
          f"{tag}: traced peak {tr['peak_bytes'] / 1e9:.3f} GB not within "
          f"{DRYRUN_PEAK_TOL:g} of the card's {peak / 1e9:.3f} GB")
    check(lower_ms <= step_ms, f"{tag}: lower bound {lower_ms:.2f} ms over "
          f"the step's {step_ms:.1f} ms")
    check(cell_run.returncode == 0 and cell.get("status") == "ok",
          f"{tag}: the cell {arch} x {shape} @ 16x16 exited "
          f"{cell_run.returncode} within {DRYRUN_CELL_TIMEOUT} s: "
          f"{cell.get('error')} {stdout[-800:]} {stderr[-800:]}")
    for line in stdout.splitlines():
        log(f"dry-run cell: {line}")
    phase_s = time.perf_counter() - t_phase
    log(f"{tag}: the cell done {cell_s:.1f} s into the phase (traced in "
        f"{cell.get('trace_s')} s); the phase {phase_s:.1f} s")
    check(phase_s <= DRYRUN_PHASE_S, f"{tag}: the phase took {phase_s:.1f} s,"
          f" over {DRYRUN_PHASE_S:g}")
    return {"gemm_flops": tr["gemm_flops"], "profiler_gemm_flops": prof_flops,
            "kernel_calls": tr["kernel_calls"], "launches": launches,
            "peak_bytes": tr["peak_bytes"], "card_peak_bytes": peak,
            "lower_bound_ms": lower_ms, "step_ms": step_ms,
            "roofline": roof, "trace_s": trace_s,
            "cell": {k: cell.get(k) for k in ("arch", "shape", "mesh",
                                               "status", "trace_s",
                                               "memory", "roofline")},
            "cell_s": cell_s, "phase_s": phase_s}


def phase_logio(cfg, path: str) -> dict:
    """``run_training(arch=cfg.name, device="cuda")`` twice, as
    tests/test_train_e2e.py does: without kills, and with a worker kill (at
    batch 2) and a trainer kill (at step 7); losses and final state must be
    bit-identical, and each wrapper of ``TRAIN_PATHS[path]`` launched once
    per layer per step."""
    wrappers = TRAIN_PATHS[path]["wrappers"]
    red = reduced(cfg, d_model=LOGIO_RUN["d_model"],
                  n_layers=LOGIO_RUN["n_layers"], vocab=2048,
                  d_ff=4 * LOGIO_RUN["d_model"], n_heads=4)
    shape = (f"{red.n_heads} heads / {red.n_kv_heads} kv (dh {red.d_head}), "
             f"d_ff {red.d_ff}" if path == "attention" else
             f"d_inner {red.d_inner}, d_state {red.mamba.d_state}")
    log(f"logio {cfg.name}: cut to d_model {red.d_model}, {red.n_layers} "
        f"layers, {shape}, vocab {red.vocab} (a full-width checkpoint is "
        f"{12 * cfg.param_count() / 1e9:.1f} GB, written four times per pair "
        f"of runs); {LOGIO_RUN}")
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        a = train_driver.run_training(**LOGIO_RUN, arch=cfg.name,
                                      ckpt_dir=f"{tmp}/a", verbose=False,
                                      device=DEVICE)
        b = train_driver.run_training(**LOGIO_RUN, arch=cfg.name,
                                      ckpt_dir=f"{tmp}/b", verbose=False,
                                      device=DEVICE, kill_trainer_at=7,
                                      kill_worker_at=2)
    launches = {k: ops.LAUNCHES[k] for k in wrappers}
    check(b["losses"][:7] == a["losses"][:7], "logio: pre-crash losses differ")
    check(b["losses"][7:] == a["losses"][6:], "logio: replayed losses differ")
    check(b["engine"].failures >= 2, f"logio: {b['engine'].failures} failures")
    sa, sb = a["final_state"], b["final_state"]
    mods = [(sa["params"], sb["params"]), (sa["opt"]["m"], sb["opt"]["m"]),
            (sa["opt"]["v"], sb["opt"]["v"])]
    same = all(bool(torch.equal(x, y)) for ma, mb in mods
               for x, y in zip(ma.parameters(), mb.parameters()))
    check(same and int(sa["step"]) == int(sb["step"]),
          "logio: final states differ")
    n_steps = len(a["losses"]) + len(b["losses"])
    check(all(x == red.n_layers * n_steps for x in launches.values()),
          f"logio: launches {launches} over {n_steps} steps")
    log(f"logio {cfg.name}: {len(a['losses'])} + {len(b['losses'])} steps, "
        f"crash steps {b['crash_steps']}, pipeline failures "
        f"{b['engine'].failures} restarts {b['engine'].restarts}; losses and "
        f"final state bit-identical; launches {launches}; losses "
        f"{a['losses']}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase examples: the port's four examples on the card
# ---------------------------------------------------------------------------


def _example(name: str):
    """``examples/torch_<name>.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def plain_attention_calls():
    """{name: calls} of the plain flash versions (``ref.flash_attention_ref``
    and its backward) made inside the block."""
    calls = {"flash_attention_ref": 0, "flash_attention_backward_ref": 0}

    def counted(name):
        inner = getattr(ref, name)

        def call(*a, **kw):
            calls[name] += 1
            return inner(*a, **kw)
        return call

    with mock.patch.object(ref, "flash_attention_ref",
                           counted("flash_attention_ref")), \
            mock.patch.object(ref, "flash_attention_backward_ref",
                              counted("flash_attention_backward_ref")):
        yield calls


def _examples_train(ex, big: bool = False) -> dict:
    """``torch_train_e2e``'s pair of runs on the card, at its defaults or
    with ``--big`` (d_model 768, 12 layers, head dim 192; 12 steps, so the
    trainer's kill at step 8 falls after the checkpoint of step 6): run B's
    final state bitwise equal to run A's leaf by leaf (the example's
    ``identical``), its losses A's before the crash and from the last
    checkpoint on, one flash forward and one flash backward launch per
    layer for every step the two runs take (resumed steps included), each
    at the model's head dim on its own kernel instance, and no call of a
    plain attention version."""
    steps = 12 if big else 24     # --big: 4 checkpoints of ~1.2 GB
    dh = (768 if big else 128) // 4   # the example's d_model over 4 heads
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp, \
            plain_attention_calls() as plain_calls:
        secs = []
        runs = []
        for kills in (False, True):
            t0 = time.perf_counter()
            runs.append(ex.train(steps, big, DEVICE, f"{tmp}/{int(kills)}",
                                 kills=kills))
            sync()
            secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    widths = dict(ops.BUILT_WIDTHS)
    a, b = runs
    kill = steps * 2 // 3
    n_layers = len(a["final_state"]["params"].layers)
    n_steps = len(a["losses"]) + len(b["losses"])
    tag = "examples train_e2e" + (" --big" if big else "")
    check(ex.identical(a["final_state"], b["final_state"]),
          f"{tag}: run B's final state is not run A's, bit for bit")
    check(b["losses"][:kill] == a["losses"][:kill],
          f"{tag}: pre-crash losses differ")
    resumed = (kill // 6) * 6     # the last checkpoint (ckpt_every 6)
    check(b["losses"][kill:] == a["losses"][resumed:],
          f"{tag}: replayed losses differ")
    check(b["engine"].failures >= 2, f"{tag}: {b['engine'].failures} failures")
    want = {"flash_attention": n_layers * n_steps,
            "flash_attention_backward": n_layers * n_steps}
    check({k: launches[k] for k in want} == want
          and launches["decode_attention"] == 0
          and launches["selective_scan"] == 0,
          f"{tag}: launches {launches}, want {want}")
    check(not any(plain_calls.values()),
          f"{tag}: plain attention ran: {plain_calls}")
    check(widths == {(name, dh, dh): n for name, n in want.items()},
          f"{tag}: launches by head dim {widths}, want all at {dh}")
    log(f"{tag}: {len(a['losses'])} + {len(b['losses'])} steps (crash at "
        f"{b['crash_steps']}, resumed from step {resumed}), "
        f"{n_layers} layers, dh {dh}, pipeline failures "
        f"{b['engine'].failures}; final states bit-identical; launches "
        f"{want} ({want['flash_attention'] // n_steps} + "
        f"{want['flash_attention_backward'] // n_steps} a step, all on the "
        f"dh {dh} instances), plain attention calls 0; wall {secs[0]:.2f} s "
        f"(A) and {secs[1]:.2f} s (B)")
    return {"launches": want, "steps": n_steps, "wall_s": secs,
            "head_dim": dh}


def _examples_serve(ex, arch: str, requests: int = 6, tokens: int = 12,
                    tag: str = "examples serve") -> dict:
    """``torch_serve_batched``'s server for ``arch`` (or any module with its
    ``RUNTIME``, ``build_server`` and ``serve``): (a) its serve loop on
    the kernel path with a server on the plain path (the example's runtime
    with plain attention and scan, the same seeded weights) stepped beside it in lockstep, fed the same
    tokens and positions: logits within TOL at every step, and each active
    slot's greedy token the plain one's or within TOL of a plain top-2 tie;
    (b) the example's server alone, timed and counted: its streams (a)'s,
    decode launches ``decode_per_step`` a step, each on the instance of
    ``ops.built_head_dim`` and on its route (``decode_route``), scan
    launches one per Mamba layer a step, all on the step kernel. ``requests`` x ``tokens``: the example's
    defaults."""
    tag = f"{tag} {arch}"
    tol = TOL[torch.float32]
    plain_rt = dataclasses.replace(ex.RUNTIME, attn_impl="plain",
                                   scan_impl="plain")
    with torch.inference_mode():
        k = ex.build_server(arch, DEVICE)
        p = ex.build_server(arch, DEVICE, plain_rt)
        cfg = k.cfg
        check(all(bool(torch.equal(x, y)) for x, y in
                  zip(k.params.parameters(), p.params.parameters())),
              f"{tag}: the two servers' weights differ")
        seen = {"worst": 0.0, "ties": 0}
        inner = k._step

        def lockstep(params, cache, toks, pos):
            nxt, logits, cache = inner(params, cache, toks, pos)
            p_nxt, p_logits, p.cache = p._step(p.params, p.cache, toks, pos)
            seen["worst"] = max(seen["worst"], assert_close(
                logits, p_logits, tol, f"{tag} lockstep"))
            top2 = p_logits.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).tolist()
            for s, (x, y) in enumerate(zip(nxt.tolist(), p_nxt.tolist())):
                if k.active[s] and x != y:
                    check(gap[s] < tol, f"{tag}: slot {s} picks {x}, the "
                          f"plain path {y}, at a clear top-2 gap {gap[s]:.3e}")
                    seen["ties"] += 1
            return nxt, logits, cache

        k._step = lockstep
        locked, steps = ex.serve(k, requests, tokens)
        k._step = inner
        del k, p
        server = ex.build_server(arch, DEVICE)
        ops.reset_launches()
        sync()
        t0 = time.perf_counter()
        done, steps_b = ex.serve(server, requests, tokens)
        sync()
        secs = time.perf_counter() - t0
        launches = {name: ops.LAUNCHES[name]
                    for name in ("decode_attention", "selective_scan")}
        variants = dict(ops.SCAN_VARIANTS)
        widths = dict(ops.BUILT_WIDTHS)
        routes = dict(ops.DECODE_ROUTES)
    n_mamba = sum(spec.mixer == "mamba" for spec in cfg.layer_kinds())
    want = {"decode_attention": decode_per_step(cfg) * steps_b,
            "selective_scan": n_mamba * steps_b}
    check(sorted(done) == list(range(requests))
          and all(len(t) == tokens for t in done.values()),
          f"{tag}: requests {sorted(done)} short of {tokens} tokens")
    check(steps_b == steps and done == locked,
          f"{tag}: the example's run differs from the lockstep run")
    check(launches == want and variants["step"] == want["selective_scan"],
          f"{tag}: launches {launches} (scan variants {variants}), want {want}")
    dh = cfg.d_head   # 0 for an attention-free model (no decode launch)
    built = ops.built_head_dim(torch.float32, dh) if dh else None
    check(widths == ({("decode_attention", dh, built): want["decode_attention"]}
                     if want["decode_attention"] else {}),
          f"{tag}: decode launches by head dim {widths}, want all at "
          f"{dh} on the {built} instance")
    route = decode_route(cfg.eff_heads, cfg.n_kv_heads, dh) if dh else None
    check(routes == ({route: want["decode_attention"]}
                     if want["decode_attention"] else {}),
          f"{tag}: decode launches by route {routes}, want all on {route}")
    ms = secs / steps_b * 1e3
    log(f"{tag} ({cfg.n_layers} layers{', enc-dec' if cfg.enc_dec else ''}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, dh {cfg.d_head}): "
        f"{requests} req x {tokens} tok in {steps_b} steps, {ms:.2f} ms a "
        f"step; lockstep max|dlogit| {seen['worst']:.3e} (tol {tol}), "
        f"greedy near-ties {seen['ties']}; launches {launches}")
    return {"launches": launches, "steps": steps_b, "ms_per_step": ms,
            "max_abs_err": seen["worst"], "head_dim": dh}


# repro_torch.launch.train at --d-model 2048 (internlm2-1.8b's width over
# the launcher's four heads: head dim 512, the cluster route), its depth, steps
# and checkpoint cadence cut so that the pair of runs fits the examples
# phase (at its defaults, 4 layers, a checkpoint is ~3.1 GB: ~260 M f32
# params, m and v; at 2 layers ~1.6 GB, four of them a pair), and the step
# at which the second run's trainer is killed (after the checkpoint of
# step 3) and its worker killed (batch 2)
LAUNCH_TRAIN_WIDE = dict(d_model=2048, n_layers=2, steps=6, ckpt_every=3,
                         seq_len=128, batch_size=4, seed=5)
LAUNCH_TRAIN_KILL = 4


def launch_train_wide() -> dict:
    """``repro_torch.launch.train.run_training`` at ``LAUNCH_TRAIN_WIDE``
    (--d-model 2048: head dim 512, f32) twice: without kills, and with a
    worker kill and the trainer killed at step ``LAUNCH_TRAIN_KILL`` (after
    a checkpoint); run B's losses A's before the crash and from the last
    checkpoint on, its final state (params, m, v) bitwise A's; one flash
    forward and one backward launch per layer for every step of the two
    runs, all on the cluster route at head dim 512, and no plain attention
    call."""
    run = LAUNCH_TRAIN_WIDE
    tag = f"launch.train --d-model {run['d_model']}"
    ops.reset_launches()
    secs, runs = [], []
    with tempfile.TemporaryDirectory() as tmp, plain_attention_calls() as plain:
        for kills in (False, True):
            extra = (dict(kill_trainer_at=LAUNCH_TRAIN_KILL, kill_worker_at=2)
                     if kills else {})
            t0 = time.perf_counter()
            runs.append(train_driver.run_training(
                **run, ckpt_dir=f"{tmp}/{int(kills)}", verbose=False,
                device=DEVICE, **extra))
            sync()
            secs.append(time.perf_counter() - t0)
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention",
                                             "flash_attention_backward")}
    widths = dict(ops.BUILT_WIDTHS)
    variants = dict(ops.FLASH_VARIANTS)
    a, b = runs
    kill = LAUNCH_TRAIN_KILL
    resumed = kill // run["ckpt_every"] * run["ckpt_every"]
    check(b["losses"][:kill] == a["losses"][:kill],
          f"{tag}: pre-crash losses differ")
    check(b["losses"][kill:] == a["losses"][resumed:],
          f"{tag}: replayed losses differ")
    check(b["engine"].failures >= 2, f"{tag}: {b['engine'].failures} failures")
    sa, sb = a["final_state"], b["final_state"]
    mods = [(sa["params"], sb["params"]), (sa["opt"]["m"], sb["opt"]["m"]),
            (sa["opt"]["v"], sb["opt"]["v"])]
    check(all(bool(torch.equal(x, y)) for ma, mb in mods
              for x, y in zip(ma.parameters(), mb.parameters()))
          and int(sa["step"]) == int(sb["step"]),
          f"{tag}: final states differ")
    n_layers = len(sa["params"].layers)
    dh = run["d_model"] // 4
    n_steps = len(a["losses"]) + len(b["losses"])
    want = {name: n_layers * n_steps for name in launches}
    check(launches == want and ops.LAUNCHES["decode_attention"] == 0,
          f"{tag}: launches {launches}, want {want}")
    check(widths == {(name, dh, ops.flash_built_head_dim(torch.float32, dh)): n
                     for name, n in want.items()}
          and variants == {(name, "cluster"): n for name, n in want.items()},
          f"{tag}: launches by head dim {widths} and by variant {variants}, "
          f"want all at {dh} on the cluster route")
    check(not any(plain.values()), f"{tag}: plain attention ran: {plain}")
    params = sum(p.numel() for p in sa["params"].parameters())
    log(f"{tag}: {n_layers} layers, dh {dh} (cluster route, "
        f"{build.load().repro_flash_cluster_ranks(dh)} ranks), "
        f"{params / 1e6:.1f} M "
        f"params (a checkpoint {12 * params / 1e9:.2f} GB); {len(a['losses'])}"
        f" + {len(b['losses'])} steps (crash at {b['crash_steps']}, resumed "
        f"from step {resumed}), pipeline failures {b['engine'].failures}; "
        f"losses and final state (params, m, v) bit-identical; launches "
        f"{want} ({n_layers} + {n_layers} a step, all on the cluster route "
        f"at dh {dh}), "
        f"plain attention calls 0; wall {secs[0]:.2f} s (A) and "
        f"{secs[1]:.2f} s (B); losses {a['losses']}")
    return {"launches": want, "steps": n_steps, "wall_s": secs,
            "head_dim": dh, "layers": n_layers, "params": params}


def phase_examples() -> dict:
    """The port's examples (``examples/torch_*.py``), imported from this
    checkout and run in this process: the engine ones with their own
    asserts and their answers checked; ``torch_train_e2e`` at its defaults
    and with ``--big`` (``_examples_train``); ``torch_serve_batched`` for
    every arch of the configs (``_examples_serve``); the server of
    ``repro_torch.launch.serve --d-model 768`` (head dim 192) at its
    defaults, the same way. Within ``EXAMPLES_PHASE_S``."""
    t0 = time.perf_counter()
    ex = {name: _example(name) for name in EXAMPLE_NAMES}
    q = ex["quickstart"].main()
    check(q["contributors"] == list(range(16, 24)),
          f"examples quickstart: report #2 from {q['contributors']}")
    check(q["flowed"] == [("agg", "out", 1)],
          f"examples quickstart: sales batch #11 flowed into {q['flowed']}")
    e = ex["elastic_scaling"].main()
    check(e["got"] == [2 * i for i in range(120)]
          and e["engine"].failures == 1,
          f"examples elastic_scaling: {len(e['got'])} values, "
          f"{e['engine'].failures} failures")
    log(f"examples quickstart and elastic_scaling: {q['engine'].failures} and"
        f" {e['engine'].failures} failures, outputs and lineage as expected")
    train = _examples_train(ex["train_e2e"])
    t_big = time.perf_counter()
    train_big = _examples_train(ex["train_e2e"], big=True)
    big_s = time.perf_counter() - t_big
    serve = {arch: _examples_serve(ex["serve_batched"], arch)
             for arch in sorted(ARCHS)}
    t_768 = time.perf_counter()
    serve_768 = _examples_serve(launch_serve_at(768), "internlm2-1.8b",
                                requests=8, tokens=16,
                                tag="launch.serve --d-model 768")
    serve_768_s = time.perf_counter() - t_768
    # the wide route: launch.train and launch.serve at --d-model 2048 (head
    # dim 512), launch.serve at 1280 (320), and a multi-query server (32
    # heads over one kv head: decode's group route)
    t_wide = time.perf_counter()
    train_2048 = launch_train_wide()
    serve_wide = {
        d: _examples_serve(launch_serve_at(d), "internlm2-1.8b", requests=8,
                           tokens=16, tag=f"launch.serve --d-model {d}")
        for d in (2048, 1280)}
    serve_mqa = _examples_serve(
        launch_serve_at(2048, n_heads=32, n_kv_heads=1), "internlm2-1.8b",
        requests=8, tokens=16,
        tag="launch.serve --d-model 2048, 32 heads / 1 kv head")
    wide_s = time.perf_counter() - t_wide
    phase_s = time.perf_counter() - t0
    log(f"examples: phase {phase_s:.1f} s (budget {EXAMPLES_PHASE_S:g} s), "
        f"of which train_e2e --big {big_s:.1f} s, launch.serve --d-model "
        f"768 {serve_768_s:.1f} s and the wide route's runs (launch.train "
        f"--d-model 2048, launch.serve --d-model 2048 and 1280, the "
        f"multi-query server) {wide_s:.1f} s")
    check(phase_s <= EXAMPLES_PHASE_S,
          f"examples: phase {phase_s:.1f} s over {EXAMPLES_PHASE_S:g} s")
    return {"train": train, "train_big": train_big, "serve": serve,
            "serve_d768": serve_768, "phase_s": phase_s,
            "train_big_s": big_s, "serve_d768_s": serve_768_s,
            "train_d2048": train_2048, "serve_d2048": serve_wide[2048],
            "serve_d1280": serve_wide[1280], "serve_mqa": serve_mqa,
            "wide_s": wide_s}


def launch_serve_at(d_model: int, **heads):
    """``repro_torch.launch.serve``'s server at ``--d-model d_model`` (its
    other flags at their defaults: 4 slots, max_len 128; ``heads``:
    ``build_server``'s n_heads / n_kv_heads), with the names
    ``_examples_serve`` reads off an example module."""
    from repro_torch.launch import serve as S
    return types.SimpleNamespace(
        RUNTIME=S.RUNTIME, serve=S.serve,
        build_server=lambda arch, device, rt=S.RUNTIME: S.build_server(
            arch, device, d_model=d_model, rt=rt, **heads))


# ---------------------------------------------------------------------------
# phase sharded: the sharded entry points on a one-rank NCCL mesh
# ---------------------------------------------------------------------------


def _one_rank_mesh():
    """A (1, 1) ("data", "model") mesh on this card: the process group
    from the env this sets (a free localhost port, rank 0 of 1)."""
    import socket
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    return init_device_mesh(DEVICE, (1, 1), mesh_dim_names=("data", "model"))


def _sharded_runtime(cfg, mesh):
    """(rules, Runtime) of the default strategy on ``mesh``."""
    strat = PS.ShardingStrategy.for_mesh(mesh)
    return PS.make_rules(cfg, mesh, strat), PS.runtime(cfg, mesh, strat,
                                                       remat="none")


def _local(t):
    return t.to_local() if type(t).__name__ == "DTensor" else t


def _timed(fn):
    """(fn(), its wall ms, the launches it counted), launch counts set to 0
    just before."""
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: v for k, v in ops.LAUNCHES.items() if v}


def _same_launches(tag: str, plain: dict, sharded: dict, want) -> None:
    check(sharded == plain and all(sharded.get(k, 0) > 0 for k in want),
          f"sharded {tag}: launches {sharded} against the unsharded path's "
          f"{plain} (each of {want} must launch)")


def _state_leaves_of(state) -> list:
    """params, m and v leaves of a train state (local shards)."""
    return [_local(t) for t in list(state["params"].parameters())
            + moment_leaves(state["opt"]["m"]) + moment_leaves(state["opt"]["v"])]


def phase_sharded(smi: str) -> dict:
    """The sharded entry points (``Runtime(shard_activations=True)``, params,
    state, batch and cache distributed by ``repro_torch.parallel.sharding``'s
    specs) on a one-rank NCCL ``DeviceMesh`` (1, 1), each held bitwise to
    the unsharded path and to its kernel launch counts: internlm2 train-f32
    (one step at full width, ``SHARD_TRAIN_DEPTH`` layers: loss, params, m,
    v), internlm2 ``serve_step`` (the serve shape, f32, the cache's sequence
    on "model": the logits of ``SHARD_SERVE_STEPS`` greedy steps and the
    cache), grok forward-bf16 at depth 1 with EP (the experts on "model")
    and falcon-mamba forward-bf16 at ``SHARD_MAMBA_DEPTH`` layers with
    d_inner on "model" (the fused scan on each rank's channels). One rank exercises the DTensor path, its
    collectives (each over one rank) and the decode kernel's lse and merge;
    it shows nothing of the communication of more than one card."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    mesh = _one_rank_mesh()
    out = {"card": smi, "mesh": [list(mesh.mesh_dim_names),
                                 list(mesh.shape)]}
    try:
        # 1. internlm2 train-f32, one step: the sharded step first, its
        # state kept on the card, then the unsharded step beside it (22.7
        # GB kept + phase 6's 50.6 GB peak), compared on the card
        cfg = at_depth(get_config(ARCH), SHARD_TRAIN_DEPTH)
        rules, rt = _sharded_runtime(cfg, mesh)
        hp = OptHParams()
        batch = _train_batch(cfg, torch.Generator(device=DEVICE).manual_seed(
            SEED + 21))
        state = PS.distribute(_fresh_state(cfg, hp),
                              PS.state_pspecs(cfg, rules), mesh)
        dp = PS.spec(None, rules["batch"], None)
        sbatch = PS.distribute(batch, {k: dp for k in batch}, mesh)
        torch.cuda.reset_peak_memory_stats()
        sstep = make_train_step(cfg, hp, rt)
        (state, met), ms_s, n_s = _timed(lambda: sstep(state, sbatch))
        peak = torch.cuda.max_memory_allocated() / 1e9
        local_gb = PS.bytes_of(state) / 1e9
        loss_s = _local(met["loss"]).item()
        leaves = _state_leaves_of(state)
        del state, sbatch, met
        torch.cuda.empty_cache()
        step = make_train_step(cfg, hp, runtime("kernel"))
        (state, met), ms_u, n_u = _timed(lambda: step(_fresh_state(cfg, hp),
                                                      batch))
        loss_u = met["loss"].item()
        plain = _state_leaves_of(state)
        same = len(leaves) == len(plain) and all(
            bool(torch.equal(a, b)) for a, b in zip(leaves, plain))
        check(loss_s == loss_u and same,
              f"sharded train-f32: loss {loss_s!r} against {loss_u!r}, "
              f"params/m/v bitwise {same}")
        _same_launches("train-f32", n_u, n_s,
                       ("flash_attention", "flash_attention_backward"))
        out["train"] = dict(depth=SHARD_TRAIN_DEPTH, loss=loss_s,
                            ms=ms_s, plain_ms=ms_u, launches=n_s,
                            local_state_gb=local_gb, peak_gb=peak)
        log(f"sharded internlm2 train-f32 (depth {SHARD_TRAIN_DEPTH}, tokens "
            f"[1, {FWD_B}, {FWD_S}]): loss {loss_s:.6f}, loss, params, m and "
            f"v bitwise equal to the unsharded step; step {ms_s:.1f} ms "
            f"sharded against {ms_u:.1f} ms unsharded (first step of each); "
            f"launches {n_s}; local state {local_gb:.2f} GB (bytes_of), "
            f"device peak {peak:.2f} GB; card {smi}")
        del state, leaves, plain, met
        torch.cuda.empty_cache()

        # 2. internlm2 serve_step, the cache on kv_seq
        cfg = get_config(ARCH)
        rules, rt = _sharded_runtime(cfg, mesh)
        params = M.init_params(torch.Generator(device=DEVICE).manual_seed(
            SEED + 22), cfg, torch.float32, DEVICE)
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
        first = torch.randint(0, cfg.vocab, (SLOTS,), generator=g,
                              device=DEVICE, dtype=torch.int32)

        def serve(p, cache, tok, to_dt=lambda t: t):
            logits = []
            for i in range(SHARD_SERVE_STEPS):
                pos = torch.full((SLOTS,), i, device=DEVICE, dtype=torch.int32)
                tok, lg, cache = serve_step(p, cache, tok, to_dt(pos), cfg=cfg,
                                            rt=srt)
                logits.append(_local(lg))
            return logits, cache

        srt = runtime("kernel")
        with torch.no_grad():
            (lg_u, cache_u), sms_u, sn_u = _timed(lambda: serve(
                params, M.init_cache(cfg, SLOTS, MAX_LEN, torch.float32,
                                     DEVICE), first))
        tok_spec = PS.spec(rules["batch"])
        params = PS.distribute(params, PS.param_pspecs(cfg, rules), mesh)
        cache = PS.distribute(M.init_cache(cfg, SLOTS, MAX_LEN, torch.float32,
                                           DEVICE),
                              PS.cache_pspecs(cfg, rules, True), mesh)
        srt = rt
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            (lg_s, cache), sms_s, sn_s = _timed(lambda: serve(
                params, cache, PS.distribute(first, tok_spec, mesh),
                lambda t: PS.distribute(t, tok_spec, mesh)))
        peak = torch.cuda.max_memory_allocated() / 1e9
        local_gb = (PS.bytes_of(params) + PS.bytes_of(cache)) / 1e9
        same = all(bool(torch.equal(a, b)) for a, b in zip(lg_s, lg_u)) and \
            all(bool(torch.equal(_local(c[k]), cu[k]))
                for c, cu in zip(cache, cache_u) for k in c)
        check(same, "sharded serve: logits or cache differ from the "
              "unsharded steps'")
        _same_launches("serve", sn_u, sn_s, ("decode_attention",))
        out["serve"] = dict(steps=SHARD_SERVE_STEPS, ms_per_step=sms_s /
                            SHARD_SERVE_STEPS,
                            plain_ms_per_step=sms_u / SHARD_SERVE_STEPS,
                            launches=sn_s, local_gb=local_gb, peak_gb=peak,
                            kv_seq=rules["kv_seq"])
        log(f"sharded internlm2 serve_step (f32, {SLOTS} slots, cache "
            f"{MAX_LEN} on {rules['kv_seq']!r}): logits of "
            f"{SHARD_SERVE_STEPS} greedy steps and the cache bitwise equal "
            f"to the unsharded steps'; {sms_s / SHARD_SERVE_STEPS:.2f} ms a "
            f"step sharded against {sms_u / SHARD_SERVE_STEPS:.2f} ms; "
            f"launches {sn_s}; local params + cache {local_gb:.2f} GB, "
            f"device peak {peak:.2f} GB")
        del params, cache, cache_u, lg_u, lg_s
        torch.cuda.empty_cache()

        # 3. grok forward-bf16 at depth 1 under EP; 4. falcon-mamba
        for arch, depth, want, key in (
                (GROK_ARCH, 1, ("flash_attention",), "grok_forward"),
                (MAMBA_ARCH, SHARD_MAMBA_DEPTH, ("selective_scan_fused",),
                 "mamba_forward")):
            cfg = at_depth(get_config(arch), depth)
            rules, rt = _sharded_runtime(cfg, mesh)
            params = M.init_params(torch.Generator(device=DEVICE).manual_seed(
                SEED + 24), cfg, torch.bfloat16, DEVICE)
            toks = torch.randint(0, cfg.vocab, (FWD_B, FWD_S), device=DEVICE,
                                 generator=torch.Generator(
                                     device=DEVICE).manual_seed(SEED + 25))
            with torch.no_grad():
                (lg_u, _), fms_u, fn_u = _timed(lambda: M.forward(
                    params, {"tokens": toks}, cfg, runtime("kernel")))
                params = PS.distribute(params, PS.param_pspecs(cfg, rules),
                                       mesh)
                stoks = PS.distribute(toks, PS.spec(rules["batch"], None), mesh)
                torch.cuda.reset_peak_memory_stats()
                (lg_s, _), fms_s, fn_s = _timed(lambda: M.forward(
                    params, {"tokens": stoks}, cfg, rt))
            peak = torch.cuda.max_memory_allocated() / 1e9
            local_gb = PS.bytes_of(params) / 1e9
            check(bool(torch.equal(_local(lg_s), lg_u)),
                  f"sharded {arch}: logits differ from the unsharded "
                  f"forward's (max {max_err(_local(lg_s), lg_u):.3e})")
            _same_launches(f"{arch} forward", fn_u, fn_s, want)
            moe = ({"expert": rules["expert"],
                    "expert_mlp": rules["expert_mlp"], "ep": rt.ep}
                   if cfg.moe is not None else {"inner": rules["inner"]})
            out[key] = dict(depth=depth, ms=fms_s, plain_ms=fms_u,
                            launches=fn_s, local_params_gb=local_gb,
                            peak_gb=peak, **moe)
            log(f"sharded {arch} forward-bf16 (depth {depth}, tokens "
                f"[{FWD_B}, {FWD_S}], {moe}): logits bitwise equal to the "
                f"unsharded forward's; {fms_s:.1f} ms sharded against "
                f"{fms_u:.1f} ms (first call of each); launches {fn_s}; "
                f"local params {local_gb:.2f} GB, device peak {peak:.2f} GB")
            del params, lg_u, lg_s
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()   # before any fork (phases 13, 13b)
        for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "LOCAL_RANK"):
            os.environ.pop(key, None)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded: phase {out['phase_s']:.1f} s (budget {SHARD_PHASE_S:g} s); "
        f"card {smi}")
    check(out["phase_s"] <= SHARD_PHASE_S,
          f"sharded: phase {out['phase_s']:.1f} s over {SHARD_PHASE_S:g} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the LOG.io engine on the card's host (the paper's UC1)
# ---------------------------------------------------------------------------

# UC1 (``chip_engine.uc1_pipeline``, benchmarks/uc1.py:13-40), 1,000 events
# of 10 KB. Unpaced and without processing delays: the phase times the
# protocols' own cost, not the paper's figures.
# the "all" set of tests/conftest.py:27-35
ENGINE_STACKS = ["memory", "memory+sharded", "memory+group",
                 "memory+sharded+group", "sqlite", "sqlite+group", "segment",
                 "segment+group", "sqlite+sharded+group",
                 "segment+sharded+group"]
ENGINE_REPEATS = 3      # best of, for the lineage overhead
# a full-process crash lands after the first run of this many step-mode
# steps that leaves OP4 past half of its inputs
ENGINE_CRASH_STEPS = 50


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo's first processor names it (its model
    name, and its vendor, family, model and clock where the name is not
    given, as under gVisor), and the core count."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip():
                break
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    model = info.get("model name", "unknown")
    if model == "unknown":
        model = " ".join([platform.machine(), model] + [
            f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model",
                                       "cpu MHz") if k in info])
    return f"{model}, {os.cpu_count()} cores"


def phase_engine(smi: str) -> dict:
    """The in-process LOG.io engine at UC1's size: every store stack of the
    "all" set under a crash of OP3 and of OP4, a full-process crash of the
    group-commit durable stacks, ABS beside LOG.io, lineage capture with
    its queries and replay, scaling and the recovery controller. Host code:
    its times are the host's, printed with the card and the host CPU."""
    from repro_torch import core
    from repro_torch.core import scaling
    from repro_torch.core.controller import ControllerConfig, RecoveryController
    t_phase = time.perf_counter()
    n = ENGINE_EVENTS
    build, expected = uc1_pipeline(core)
    host = host_cpu()
    where = f"card {smi}; host {host}"
    log(f"engine: UC1 ({n} events of {ENGINE_KB:g} KB, windows "
        f"{ENGINE_WINDOWS}, {len(expected)} OP4 outputs), unpaced; {where}")
    out = {"host": host, "card": smi, "events": n, "stacks": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. every stack under the failure plan
        for i, spec in enumerate(ENGINE_STACKS):
            store = core.build_store(spec, path=f"{tmp}/s{i}") \
                if spec.startswith(("sqlite", "segment")) \
                else core.build_store(spec)
            wall, eng = uc1_run(core, build, expected, spec, store=store,
                                plan=ENGINE_PLAN)
            store.close()
            out["stacks"][spec] = {"wall_ms": wall * 1e3,
                                   "events_per_s": n / wall,
                                   "failures": eng.failures,
                                   "restarts": eng.restarts}
            log(f"engine {spec}: {wall * 1e3:.1f} ms, {n / wall:.0f} ev/s, "
                f"failures {eng.failures}, restarts {eng.restarts}")
        # 2. a full-process crash: step mode cut mid-run, store.crash(),
        #    a resumed engine on the same store and external system
        for spec in ("sqlite+group", "segment+group"):
            store = core.build_store(spec, path=f"{tmp}/crash-{spec}",
                                     interval=60.0)
            eng = core.Engine(build(), mode="step", store=store)
            steps, half = 0, n // ENGINE_WINDOWS[0] // 2
            while eng.metrics().ops["OP4"].events_in < half:
                check(not eng.run_to_completion(max_steps=ENGINE_CRASH_STEPS),
                      f"engine crash {spec}: the run ended before the crash")
                steps += ENGINE_CRASH_STEPS
            before = len(eng.external.committed())
            store.crash()
            wall, eng2 = uc1_run(core, build, expected, f"{spec} resumed",
                                 store=store, external=eng.external,
                                 resume=True)
            store.close()
            out[f"crash_{spec}"] = {"committed_before": before,
                                    "resume_ms": wall * 1e3}
            log(f"engine {spec} full-process crash after {steps} steps "
                f"(OP4 past {half} of its {2 * half} inputs, {before} of "
                f"{2 * len(expected)} commits made): resumed in "
                f"{wall * 1e3:.1f} ms, exactly once")
    # 3. ABS beside LOG.io, one failure each, on the memory stack
    abs_wall, abs_eng = uc1_run(core, build, expected, "abs",
                                plan=[("OP3", "abs_input", 300)],
                                protocol="abs")
    log_wall, _ = uc1_run(core, build, expected, "logio",
                          plan=[("OP3", "post_log", 300)])
    out["abs_ms"], out["logio_ms"] = abs_wall * 1e3, log_wall * 1e3
    log(f"engine abs (epoch_events {abs_eng._abs.epoch_events}): "
        f"{abs_wall * 1e3:.1f} ms, restarts {abs_eng.restarts}; logio "
        f"{log_wall * 1e3:.1f} ms; the same committed outputs")
    # 4. lineage: capture overhead (failure-free memory runs with and
    #    without it, in turns: the host's speed drifts), then the queries
    #    and replay
    scope = [core.LineageScope(("OP1", "out"), ("OP4", "out"))]
    base, lin = [], []
    for _ in range(ENGINE_REPEATS):
        base.append(uc1_run(core, build, expected, "memory")[0])
        wall, leng = uc1_run(core, build, expected, "lineage",
                             lineage_scopes=scope)
        lin.append(wall)
    best, lbest = min(base), min(lin)
    out.update(memory_ms=best * 1e3, lineage_ms=lbest * 1e3,
               lineage_overhead=lbest / best - 1)
    log(f"engine lineage: best of {ENGINE_REPEATS} {lbest * 1e3:.1f} ms "
        f"against {best * 1e3:.1f} ms without, failure-free "
        f"({100 * (lbest / best - 1):+.1f}%); runs in turns "
        f"{[round(x * 1e3, 1) for x in lin]} and "
        f"{[round(x * 1e3, 1) for x in base]} ms")
    q = core.LineageQuery(leng.store)
    span = ENGINE_WINDOWS[0] * ENGINE_WINDOWS[1]
    k = 2
    target = ("OP4", "out", k)
    t0 = time.perf_counter()
    srcs = sorted(e for e in q.backward(target).keys() if e[0] == "OP1")
    back_ms = (time.perf_counter() - t0) * 1e3
    check(srcs == [("OP1", "out", j) for j in range(k * span, (k + 1) * span)],
          f"engine lineage: backward of {target} gives {len(srcs)} source "
          f"events, not its window's {span}")
    j = k * span + 17
    t0 = time.perf_counter()
    fwd = [e for e in q.forward(("OP1", "out", j), "OP2").keys()
           if e[0] == "OP4"]
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(fwd == [target], f"engine lineage: forward of OP1 {j} gives {fwd}")
    t0 = time.perf_counter()
    rep = leng.replay([target], check=True)
    replay_ms = (time.perf_counter() - t0) * 1e3
    check(rep.ok and rep.matches[core.EventKey(*target)] is True
          and rep.executed_ops == frozenset({"OP2", "OP3", "OP4"}),
          f"engine replay of {target}: {rep}")
    out.update(backward_ms=back_ms, forward_ms=fwd_ms, replay_ms=replay_ms)
    log(f"engine lineage queries: backward of {target} {back_ms:.1f} ms "
        f"({span} source events), forward of OP1 {j} {fwd_ms:.1f} ms (one "
        f"OP4 output), replay {replay_ms:.1f} ms (executed "
        f"{sorted(rep.executed_ops)}, byte-identical)")
    # 5. scaling mid-run, then UC1 under a live recovery controller
    out.update(phase_engine_scaling(core, scaling))
    eng = core.Engine(build(), mode="thread", restart_delay=0.01,
                      injector=core.FailureInjector([("OP3", "post_log", 300)]))
    ctl = RecoveryController(eng, ControllerConfig(sample_interval=0.01,
                                                   switch_hysteresis=2))
    t0 = time.perf_counter()
    eng.start()
    ctl.start()
    try:
        ok = eng.wait(120)
    finally:
        ctl.stop()
        eng.stop()
    wall = time.perf_counter() - t0
    check(ok and eng.failures == 1, "engine controller: the run did not "
          f"complete with its one failure ({eng.failures})")
    exactly_once(eng, expected, "controller")
    decisions = [d[1:] for d in ctl.decisions]
    check(not any(d[0] == "error" for d in decisions),
          f"engine controller: sensing failed: {decisions}")
    out.update(controller_ms=wall * 1e3, controller_decisions=decisions)
    log(f"engine controller: {wall * 1e3:.1f} ms, decisions {decisions}, "
        f"final modes {eng.metrics().recovery_modes}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"engine: phase {out['phase_s']:.1f} s; {where}")
    return out


def phase_engine_scaling(core, scaling, mode: str = "thread") -> dict:
    """A dispatcher / replica / merger pipeline (tests/test_scaling_abs.py's
    shape) on UC1's events, scaled up and then down mid-run, each step
    timed by the outputs committed so far; in ``mode="process"`` on live
    worker processes (the dispatcher and merger workers pause and
    warm-restart around each step)."""
    n = ENGINE_EVENTS
    blob = bytes(int(ENGINE_KB * 1024))
    p = core.Pipeline()
    p.add(functools.partial(core.GeneratorSource, "src", core.ReadSource(
        [{"i": i, "data": blob} for i in range(n)]), rate=0.0005))
    p.add(functools.partial(scaling.DispatcherOperator, "disp", ["r0", "r1"]))
    for r in ("r0", "r1"):
        p.add(functools.partial(core.MapOperator, r, fn=_uc1_ident))
    p.add(functools.partial(scaling.MergerOperator, "mrg", ["r0", "r1"]))
    p.add(functools.partial(core.TerminalSink, "sink", target=n))
    p.connect("src", "out", "disp", "in")
    for r in ("r0", "r1"):
        p.connect("disp", f"to_{r}", r, "in")
        p.connect(r, "out", "mrg", f"from_{r}")
    p.connect("mrg", "out", "sink", "in")
    eng = core.Engine(p, mode=mode, restart_delay=0.01)
    ctrl = scaling.Controller(eng, "disp", "mrg",
                              replica_factory=_uc1_replica)

    def committed():
        return len(eng.external.committed())

    def reach(count):
        deadline = time.monotonic() + 60
        while committed() < count:
            check(time.monotonic() < deadline,
                  f"engine scaling: {committed()} of {count} outputs")
            time.sleep(0.001)
        return committed()

    t0 = time.perf_counter()
    eng.start()
    at_up = reach(n // 4)
    ctrl.scale_up("r2")
    at_down = reach(n // 2)
    check(at_down < n, "engine scaling: the run ended before the scale-down")
    ctrl.scale_down("r0")
    ok = eng.wait(120)
    eng.stop()
    wall = time.perf_counter() - t0
    got = sorted(b["i"] for b in eng.external.committed())
    check(ok and got == list(range(n)),
          f"engine scaling {mode}: {len(got)} outputs, exactly once: "
          f"{got == list(range(n))}")
    replicas = sorted(g for g in eng.pipeline.groups if g.startswith("r"))
    log(f"engine scaling {mode}: {wall * 1e3:.1f} ms; r2 up after {at_up} "
        f"outputs, r0 down after {at_down}; replicas {replicas}; {n} "
        f"outputs exactly once")
    tag = "" if mode == "thread" else f"_{mode}"
    return {f"scaling{tag}_ms": wall * 1e3, f"scale_up_at{tag}": at_up,
            f"scale_down_at{tag}": at_down}


# ---------------------------------------------------------------------------
# phase 13b: process mode on the card's host (``chip_engine.py`` holds UC1)
# ---------------------------------------------------------------------------

PROC_TRANSPORTS = ("routed", "socket", "tcp", "shm")
# every transport on the memory stack; the durable stack on routed and
# socket (its tcp and shm runs gave their seconds to the sharded phase)
PROC_STORES = {"memory": PROC_TRANSPORTS,
               "sqlite+sharded+group": ("routed", "socket")}
# the straggler: OP3 at 4 ms an output (2 ms an event, half the source's
# rate), restarted after benchmarks/process_mode.py's warm-restart delay
PROC_OP3_PT, PROC_RESTART_DELAY = 0.004, 0.25
PROC_KILL_STACKS = ("sqlite+sharded+group", "segment+group")


def engine_spawn_runs(tmp: str) -> dict:
    """``chip_engine.py spawn-runs``: its lines are relayed, its result
    parsed; it fails the phase if it fails."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_engine.py"),
                           "spawn-runs", tmp], capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("RESULT "):
            log(line)
    check(proc.returncode == 0 and lines and lines[-1].startswith("RESULT "),
          f"engine spawn runs: exit {proc.returncode}: {proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def phase_engine_process(smi: str) -> dict:
    """Process mode of the LOG.io engine at UC1's size: a worker process
    per operator group, every injected crash a real SIGKILL. UC1 under the
    crash plan on each transport and two stores beside thread mode (in
    turns), a straggler's non-blocking recovery, a kill -9 of the whole
    engine tree with its resume, a two-node ``LocalCluster`` with a node
    killed, replay in process mode, scaling on live workers and a live
    switch of the recovery controller followed by a SIGKILL. Host code: its
    times are the host's, printed with the card and the host CPU."""
    import gc
    from repro_torch import core
    from repro_torch.core import scaling
    from repro_torch.core.controller import ControllerConfig, RecoveryController
    t_phase = time.perf_counter()
    gc.collect()          # the earlier phases' host copies go before forking
    with contextlib.suppress(OSError, AttributeError):
        import ctypes
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    n = ENGINE_EVENTS
    build, expected = uc1_pipeline(core)
    host = host_cpu()
    where = f"card {smi}; host {host}"
    mem = host_memory()
    log(f"engine process: UC1 ({n} events of {ENGINE_KB:g} KB), a worker "
        f"process per group, crashes of OP3 and OP4 as real SIGKILLs; host "
        f"{mem} at the start; {where}")
    out = {"host": host, "card": smi, "host_memory": mem, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the crash plan on each transport and store, thread mode in turns
        for spec, transports in PROC_STORES.items():
            for transport in transports:
                out["runs"][f"{spec} {transport} fork"] = crash_plan_run(
                    core, spec, transport, "fork", tmp)
        # 2. non-blocking recovery: OP3 the straggler, its worker SIGKILLed
        #    mid-run; the source keeps pushing while OP3 is dead
        sbuild, _ = uc1_pipeline(core, rate=PROC_RATE, op3_pt=PROC_OP3_PT)
        eng = core.Engine(sbuild(), mode="process", transport="socket",
                          store=_proc_store(core, "sqlite+sharded+group",
                                            f"{tmp}/straggler"),
                          restart_delay=PROC_RESTART_DELAY)
        eng.start()
        deadline = time.monotonic() + 60
        while eng.metrics().op("OP3").processed < n // 8:
            check(time.monotonic() < deadline,
                  "engine process straggler: OP3 never reached n/8")
            time.sleep(0.005)
        at_kill = eng.metrics()
        t_kill = time.perf_counter()
        eng.kill_group("OP3")
        recovered = None
        while time.perf_counter() - t_kill < 60:
            m = eng.metrics()
            if m.op("OP3").processed > at_kill.op("OP3").processed:
                recovered = time.perf_counter() - t_kill
                src_during = m.op("OP1").processed - at_kill.op("OP1").processed
                break
            time.sleep(0.002)
        ok = eng.wait(120)
        eng.stop()
        eng.store.close()
        check(ok and recovered is not None and eng.failures >= 1,
              f"engine process straggler: ok {ok}, recovered {recovered}, "
              f"failures {eng.failures}")
        check(src_during > 0, "engine process straggler: the source pushed "
              "no event while OP3 was dead (recovery blocked the pipeline)")
        exactly_once(eng, expected, "process straggler")
        out.update(recovery_ms=recovered * 1e3, src_events_during=src_during)
        log(f"engine process non-blocking recovery: OP3 (the straggler, "
            f"{PROC_OP3_PT * 1e3:g} ms an output; source {PROC_RATE * 1e3:g} "
            f"ms an event) SIGKILLed after {at_kill.op('OP3').processed} "
            f"events, processing again {recovered * 1e3:.1f} ms later "
            f"(restart delay {PROC_RESTART_DELAY * 1e3:g} ms); the source "
            f"pushed {src_during} events meanwhile; exactly once")
        # 3. kill -9 of the whole engine tree, resumed on the durable files
        for spec in PROC_KILL_STACKS:
            res = phase_engine_kill9(core, spec, tmp, build, expected)
            out[f"kill9_{spec}"] = res
            log(f"engine process kill -9 {spec}: the whole session killed "
                f"with {res['committed_before']} of {2 * len(expected)} "
                f"external records made"
                + (f", {res['uncommitted_rows_at_kill']} WAL rows of "
                   f"uncommitted epochs rolled back at the reopen, "
                   f"{res['epoch_rows']} rows left, all in the "
                   f"{res['epochs']} committed epochs"
                   if "sharded" in spec else "")
                + f"; resumed in {res['resume_ms']:.1f} ms, exactly once")
        # 4. the spawn-context runs (ctx="spawn", then a two-node
        #    LocalCluster over tcp with node1 killed mid-run) in an
        #    interpreter whose main script is chip_engine.py: a spawned
        #    process re-executes its parent's main script, and this one's
        #    imports torch
        res = engine_spawn_runs(tmp)
        out["runs"]["sqlite+sharded+group routed spawn"] = res["run"]
        cl = res["cluster"]
        out["cluster"] = cl
        log(f"engine process LocalCluster (2 nodes, tcp, spawn; node1 holds "
            f"OP3-OP5): {cl['wall_ms']:.1f} ms, of which {cl['boot_ms']:.1f} "
            f"ms until OP3 passed {n // 5} events (agents and workers boot); "
            f"node1 killed at {cl['source_at_kill']} source events, "
            f"{cl['failures']} groups warm-restarted on a fresh agent; "
            f"exactly once")
        # 5. lineage in process mode, and replay(mode="process") against the
        #    thread-mode replay of the same output
        scope = [core.LineageScope(("OP1", "out"), ("OP4", "out"))]
        wall, leng = uc1_run(core, build, expected, "process lineage",
                             mode="process", transport="routed",
                             lineage_scopes=scope)
        span = ENGINE_WINDOWS[0] * ENGINE_WINDOWS[1]
        k = 2
        target = ("OP4", "out", k)
        srcs = sorted(e for e in core.LineageQuery(leng.store).backward(
            target).keys() if e[0] == "OP1")
        check(srcs == [("OP1", "out", j)
                       for j in range(k * span, (k + 1) * span)],
              f"engine process lineage: backward of {target} gives "
              f"{len(srcs)} source events")
        import pickle
        t0 = time.perf_counter()
        prep = leng.replay([target], mode="process", timeout=120)
        preplay_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        trep = leng.replay([target])
        treplay_ms = (time.perf_counter() - t0) * 1e3
        key = core.EventKey(*target)
        check(prep.ok and prep.matches[key] is True and trep.ok
              and pickle.dumps(prep.rederived[key])
              == pickle.dumps(trep.rederived[key])
              and prep.executed_ops == trep.executed_ops,
              f"engine process replay of {target}: {prep} against {trep}")
        out.update(lineage_process_ms=wall * 1e3, replay_process_ms=preplay_ms,
                   replay_thread_ms=treplay_ms)
        log(f"engine process lineage: UC1 with capture {wall * 1e3:.1f} ms; "
            f"backward of {target} = its {span} source events; "
            f"replay(mode='process') {preplay_ms:.1f} ms, byte-identical to "
            f"the thread-mode replay ({treplay_ms:.1f} ms), executed "
            f"{sorted(prep.executed_ops)}")
        # 6. scaling on live workers: up at n/4 outputs, down at n/2
        out.update(phase_engine_scaling(core, scaling, mode="process"))
        # 7. a live switch of the recovery controller (OP3 from epoch to
        #    log: a paced group is no high-rate group), then a SIGKILL of
        #    OP3 under the mode it switched to
        pbuild, _ = uc1_pipeline(core, rate=PROC_RATE)
        eng = core.Engine(pbuild(), mode="process", transport="socket",
                          store="memory", restart_delay=0.01,
                          recovery_modes={"OP3": "epoch"}, epoch_interval=8)
        ctl = RecoveryController(eng, ControllerConfig(
            sample_interval=0.02, switch_hysteresis=2), mode_groups=("OP3",))
        t0 = time.perf_counter()
        eng.start()
        ctl.start()
        try:
            # the decision is recorded once the switch (a warm restart of
            # OP3's worker under the new mode) returned; the kill waits for
            # the restarted worker's progress
            deadline = time.monotonic() + 60
            while not any(d[1] == "mode" for d in ctl.decisions):
                check(time.monotonic() < deadline,
                      f"engine controller: no switch ({ctl.decisions})")
                time.sleep(0.002)
            at_switch = eng.metrics().op("OP3").processed
            while eng.metrics().op("OP3").processed < at_switch + 20:
                check(time.monotonic() < deadline,
                      "engine controller: OP3 stalled after the switch")
                time.sleep(0.002)
            check(eng.metrics().op("OP1").processed < n,
                  "engine controller: the source ended before the kill")
            eng.kill_group("OP3")
            ok = eng.wait(120)
        finally:
            ctl.stop()
            eng.stop()
        wall = time.perf_counter() - t0
        decisions = [d[1:] for d in ctl.decisions]
        check(ok and eng.failures == 1 and eng.recovery_mode_of("OP3") == "log"
              and not any(d[0] == "error" for d in decisions),
              f"engine controller process: ok {ok}, failures {eng.failures}, "
              f"mode {eng.recovery_mode_of('OP3')}, decisions {decisions}")
        exactly_once(eng, expected, "process controller")
        out.update(controller_ms=wall * 1e3, controller_decisions=decisions)
        log(f"engine process controller: OP3 switched epoch -> log live "
            f"after {at_switch} events ({decisions}), then SIGKILLed and "
            f"recovered under log mode; {wall * 1e3:.1f} ms, exactly once")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"engine process: phase {out['phase_s']:.1f} s; host "
        f"{host_memory()} at the end; {where}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg, mcfg = get_config(ARCH), get_config(MAMBA_ARCH)
    dev = phase_device()
    errs = phase_kernels()
    log_memory("kernels")
    # internlm2: flash (forward) and decode attention
    fwd = phase_forward(cfg, "flash_attention")
    serve = phase_serve(cfg, "decode_attention")
    sdpa_err = sdpa_accuracy()   # step 0 of the split-f32 route
    with torch.inference_mode():
        flash_t = time_flash(cfg, sdpa_err)
        q = torch.randn((SLOTS, cfg.n_heads, cfg.d_head), device=DEVICE)
        k, v = serve["cache"][0]["k"][0], serve["cache"][0]["v"][0]
        decode_t = time_decode(q, k, v, (serve["pos"] + 1).to(torch.int32),
                               tag="serve shape")
        full = torch.full((SLOTS,), MAX_LEN, device=DEVICE, dtype=torch.int32)
        decode_full = time_decode(q, torch.randn_like(k), torch.randn_like(v),
                                  full, tag="full cache")
        del q, k, v, serve["cache"]
    flash_bwd_t = time_flash_backward(cfg, sdpa_err)
    d256_t = time_flash_set(D256_SHAPE, True, SEED + 7, "dh 256")
    # the bf16 backward at the bf16 train cells' shapes (phases 11, 11b)
    bwd16_t = time_flash_backward_bf16(TRAIN_SHAPE, True, SEED + 11, "internlm2")
    bwd16_d256 = time_flash_backward_bf16(D256_SHAPE, True, SEED + 12,
                                          "gemma2 dh 256")
    # and at grok's (phase 12), head group 6
    bwd16_k = time_flash_backward_bf16(GROK_TRAIN_SHAPE, True, SEED + 14,
                                       "grok group 6")
    bf16_ptxas = log_ptxas_bf16_flash()
    # head dim 192's instances (native: the split-f32 pair kernels, the
    # bf16 pair, decode) and the padded route at 16, as phase 5 times the
    # other head dims
    d192_t = time_flash_set(D192_SHAPE, True, SEED + 15, "dh 192")
    bwd16_d192 = time_flash_backward_bf16(D192_SHAPE, True, SEED + 16,
                                          "dh 192")
    d16_t = time_flash_set(D16_SHAPE, True, SEED + 17, "dh 16 (built 32)")
    bwd16_d16 = time_flash_backward_bf16(D16_SHAPE, True, SEED + 18,
                                         "dh 16 (built 32)")
    with torch.inference_mode():
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
        B, S, H, KV = DECODE_WIDE_SHAPE
        decode_wide = {}
        for D in (192, 16):
            q = _randn(g, (B, H, D), torch.float32)
            k = _randn(g, (B, S, KV, D), torch.float32)
            v = _randn(g, (B, S, KV, D), torch.float32)
            for keys in (64, S):
                lengths = torch.full((B,), keys, device=DEVICE,
                                     dtype=torch.int32)
                what = "serve shape" if keys == 64 else "full cache"
                decode_wide[D, keys] = time_decode(
                    q, k, v, lengths, tag=f"dh {D} {what}"
                    + ("" if D == 192 else " (built 32)"))
            del q, k, v
    d192_ptxas = {"bf16": log_ptxas_bf16_flash(BF16_FLASH_D192),
                  "split_f32": log_ptxas_kernels("d192"),
                  "decode": log_ptxas_kernels("decode_attention_kernelIfLi192")}
    # the wide route (head dims above 256: internlm2's width over the
    # launchers' four heads) and decode's group route at head dim 512 and at
    # multi-query groups of 32 and 71
    wide_t = time_wide_flash(WIDE_SHAPE, SEED + 20)
    with torch.inference_mode():
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
        decode_d512 = {}
        for shape, tag in ((DECODE_D512_SHAPE, "dh 512"),
                           (DECODE_GROUP32_SHAPE, "group 32"),
                           (DECODE_GROUP71_SHAPE, "group 71")):
            B, S, H, KV, D = shape
            q = _randn(g, (B, H, D), torch.float32)
            k = _randn(g, (B, S, KV, D), torch.float32)
            v = _randn(g, (B, S, KV, D), torch.float32)
            for keys in ((64, S) if D > 256 else (S,)):
                lengths = torch.full((B,), keys, device=DEVICE,
                                     dtype=torch.int32)
                what = "serve shape" if keys == 64 else "full cache"
                decode_d512[tag, keys] = time_decode(q, k, v, lengths,
                                                     tag=f"{tag} {what}")
            del q, k, v
        decode_servers = {}
        for tag, (B, S, H, KV, D) in DECODE_SERVER_SHAPES.items():
            q = _randn(g, (B, H, D), torch.float32)
            k = _randn(g, (B, S, KV, D), torch.float32)
            v = _randn(g, (B, S, KV, D), torch.float32)
            lengths = torch.full((B,), DECODE_SERVER_KEYS, device=DEVICE,
                                 dtype=torch.int32)
            decode_servers[tag] = time_decode(q, k, v, lengths,
                                              tag=f"server {tag} S {S}")
            del q, k, v
    decode_g32 = decode_d512.pop(("group 32", DECODE_GROUP32_SHAPE[1]))
    decode_g71 = decode_d512.pop(("group 71", DECODE_GROUP71_SHAPE[1]))
    wide_ptxas = {"cluster": log_ptxas_kernels("cluster"),
                  "cuda_core": log_ptxas_kernels("flash_wide")}
    decode_group_ptxas = log_decode_group()
    log_memory("attention timings")
    torch.cuda.empty_cache()
    # falcon-mamba: the selective scan, in forward and in each decode step
    fwd_m = phase_forward(mcfg, "selective_scan_fused")
    serve_m = phase_serve(mcfg, "selective_scan")
    with torch.inference_mode():
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
        di, ds = mcfg.d_inner, mcfg.mamba.d_state
        a, b, _ = _scan_operands(g, FWD_B, FWD_S, di, ds, None)
        scan_t = time_scan(a, b, None, "forward shape", cold=False)
        a, b, _ = _scan_operands(g, SLOTS, 1, di, ds, None)
        scan_dec = time_scan(a, b, serve_m["cache"][0]["ssm"][0],
                             "decode shape", cold=True)
        del a, b, serve_m["cache"]
        # the backward at phase 7's shape, from the forward kernel's h
        a, b, _ = _scan_operands(g, FWD_B, FWD_S, di, ds, None)
        h = ops.selective_scan(a, b)
        del b
        dh = torch.randn(a.shape, generator=g, device=DEVICE)
        scan_bwd_t = time_scan_backward(a, h, dh, "train shape")
        del a, h, dh
    # the fused pair at the train shape, the materialised route beside it
    fused_t = time_fused(mcfg)
    log_memory("scan timings")
    torch.cuda.empty_cache()
    # internlm2 training: the f32 flash kernel and its backward (full
    # depth, no remat)
    train = phase_train(cfg, "attention", "train-f32",
                        train_memory(cfg, cfg.n_layers, FWD_B * FWD_S))
    logio = phase_logio(cfg, "attention")
    # falcon-mamba training: the fused scan pair (S = 2048, JAX's chunked
    # branch), at its preset's remat and the depth device memory allows
    mtrain, mremat = phase_cut_train(MAMBA_ARCH, "scan", "mamba-train-f32",
                                     torch.float32)
    # and at the depth the materialised route's memory allowed, its step
    # beside that route's
    m_earlier = step_at_depth(MAMBA_ARCH, "mamba-train-f32",
                              MAMBA_EARLIER_DEPTH, torch.float32)
    # its reduced LOG.io runs (S = 128): the materialised route
    mlogio = phase_logio(mcfg, "scan_materialised")
    # gemma2-9b training: the split-f32 flash pair at dh = 256, the same way
    gtrain, gremat = phase_cut_train(GEMMA_ARCH, "attention_d256",
                                     "gemma2-train-f32", torch.float32)
    torch.cuda.empty_cache()
    # grok-1-314b: the MoE FFN on the forward's flash kernel (head group 6)
    # and the server's decode kernel, depth cut
    kcfg = get_config(GROK_ARCH)
    mem = moe_depth_cut("grok", kcfg, GROK_LAYERS)
    kcfg = dataclasses.replace(kcfg, n_layers=GROK_LAYERS)
    fwd_k = phase_forward(kcfg, "flash_attention", mem["forward_gb"])
    serve_k = phase_serve(kcfg, "decode_attention", mem["serve_gb"])
    with torch.inference_mode():
        flash_k = time_flash(kcfg, sdpa_err, dtypes=(torch.bfloat16,))
        q = torch.randn((SLOTS, kcfg.n_heads, kcfg.d_head), device=DEVICE)
        k, v = serve_k["cache"][0]["k"][0], serve_k["cache"][0]["v"][0]
        decode_k = time_decode(q, k, v, (serve_k["pos"] + 1).to(torch.int32),
                               tag="grok serve shape")
        del q, k, v, serve_k["cache"]
    log_memory("grok timings")
    torch.cuda.empty_cache()
    # seamless-m4t-large-v2: the encoder-decoder at full width and depth
    # (head dim 64, head group 1; encoder and cross-attention non-causal)
    # through the forward's flash kernel and the server's decode kernel,
    # then its f32 train step through the split-f32 pair, depth cut
    scfg = get_config(SEAMLESS_ARCH)
    smem = encdec_memory(scfg)
    log(f"seamless: full depth ({scfg.n_enc_layers} + {scfg.n_layers} "
        f"layers), {smem['params'] / 1e9:.3f} B params "
        f"({2 * smem['params'] / 1e9:.1f} GB bf16, "
        f"{4 * smem['params'] / 1e9:.1f} GB f32); reckoned peak forward "
        f"{smem['forward_gb']:.1f} GB (the f32 reference made in place), "
        f"serve {smem['serve_gb']:.1f} GB")
    fwd_s = phase_forward(scfg, "flash_attention", smem["forward_gb"])
    serve_s = phase_serve(scfg, "decode_attention", smem["serve_gb"])
    with torch.inference_mode():
        # decode over the whole cross cache (its random K/V from decode_cross)
        xk, xv = serve_s["cache"][0]["xk"][0], serve_s["cache"][0]["xv"][0]
        q = torch.randn((SLOTS, scfg.n_heads, scfg.d_head), device=DEVICE)
        full = torch.full((SLOTS,), xk.shape[1], device=DEVICE, dtype=torch.int32)
        decode_s = time_decode(q, xk, xv, full, tag="seamless cross")
        del q, xk, xv, serve_s["cache"]
    flash_s = time_flash_set(SEAMLESS_SHAPE, False, SEED + 10, "seamless")
    bwd16_s = time_flash_backward_bf16(SEAMLESS_SHAPE, False, SEED + 13,
                                       "seamless")
    log_against_earlier({
        "forward dh 128 (internlm2)": flash_t["device_ms"],
        "forward dh 128 group 6 (grok)": flash_k["device_ms"],
        "forward dh 64 non-causal (seamless)":
            flash_s["bf16_forward"]["device_ms"],
        "forward dh 256 softcap 50 (gemma2)":
            d256_t["bf16_forward"]["device_ms"],
        "backward dh 128 (internlm2)": bwd16_t["device_ms"],
        "backward dh 256 softcap 50 (gemma2)": bwd16_d256["device_ms"],
        "backward dh 64 non-causal (seamless)": bwd16_s["device_ms"]})
    log_memory("seamless timings")
    torch.cuda.empty_cache()
    strain, sremat = phase_cut_train(SEAMLESS_ARCH, "attention",
                                     "seamless-train-f32", torch.float32)
    torch.cuda.empty_cache()
    # bf16 training (phases 11, 11b): internlm2 at full width and depth, its
    # optimizer-state variants, then gemma2-9b at a depth cut, through the
    # bf16 flash forward and the bf16 backward
    bf16 = torch.bfloat16
    reckoned = train_memory(cfg, cfg.n_layers, FWD_B * FWD_S, bf16)
    log(f"internlm2-train-bf16: full depth ({cfg.n_layers} layers), "
        f"{cfg.param_count() / 1e9:.3f} B params x "
        f"{state_bytes(bf16, OptHParams()):g} bytes (bf16 params, f32 "
        f"accumulator, f32 m and v, bf16 grads beside the accumulator); "
        f"reckoned peak {reckoned:.1f} GB")
    itrain = phase_train(cfg, "attention_bf16", "internlm2-train-bf16",
                         reckoned, dtype=bf16)
    ivariants = phase_train_variants(cfg, "internlm2-train-bf16")
    # its preset's remat ("full") at full depth, beside the step without
    _, irt, _ = train_preset(ARCH)
    iremat = remat_equal(cfg, "internlm2-train-bf16", bf16, OptHParams(),
                         irt.remat, timed=True)
    ireck = train_memory(cfg, cfg.n_layers, FWD_B * FWD_S, bf16,
                         remat=irt.remat)
    log(f"internlm2-train-bf16: remat {irt.remat!r} steps "
        f"{iremat['step_ms']:.1f} ms, peak {_fmt(iremat['peak_gb'])} GB "
        f"(reckoned {ireck:.2f}); without remat {itrain['step_ms']:.1f} ms, "
        f"peak {_fmt(itrain['peak_gb'])} GB (reckoned {reckoned:.2f})")
    check(iremat["peak_gb"] is None
          or (1 - TRAIN_MARGIN) * ireck <= iremat["peak_gb"] <= ireck,
          f"internlm2-train-bf16 remat {irt.remat!r}: peak "
          f"{_fmt(iremat['peak_gb'])} GB outside [{1 - TRAIN_MARGIN:g}, 1] x "
          f"the reckoned {ireck:.2f} GB")
    torch.cuda.empty_cache()
    dry = phase_dryrun(cfg)
    log(f"dry-run json: {json.dumps(dry)}")
    gtrain16, gremat16 = phase_cut_train(GEMMA_ARCH, "attention_bf16_d256",
                                         "gemma2-train-bf16", bf16)
    gdepth = gtrain16["depth"]
    torch.cuda.empty_cache()
    # grok-1-314b training (phase 12): the MoE FFN's backward and the bf16
    # flash pair at head group 6, at JAX's grok preset, depth cut
    # (no remat_equal: grok at depth GRAD_LAYERS reckons 104.7 GB)
    ktrain, _ = phase_cut_train(
        GROK_ARCH, "attention_bf16", "grok-train-bf16", bf16, equal=False,
        grad_depth=1, lse_kernel=f"{FLASH_TC}<128, false, true>", moe=True)
    torch.cuda.empty_cache()
    # the port's four examples, every arch's reduced server among them
    examples = phase_examples()
    log(f"examples json: {json.dumps(examples)}")
    torch.cuda.empty_cache()
    # the sharded entry points on a one-rank NCCL mesh (its process group
    # destroyed before phases 13 and 13b fork)
    sharded = phase_sharded(dev["smi"])
    log(f"sharded json: {json.dumps(sharded)}")
    torch.cuda.empty_cache()
    # the LOG.io engine (phase 13): host code, no kernel
    engine = phase_engine(dev["smi"])
    log(f"engine json: {json.dumps(engine)}")
    # process mode of the engine (phase 13b): host code, no kernel
    engine_proc = phase_engine_process(dev["smi"])
    log(f"engine process json: {json.dumps(engine_proc)}")
    log(f"phase times: dry-run {dry['phase_s']:.1f} s, examples "
        f"{examples['phase_s']:.1f} s, sharded {sharded['phase_s']:.1f} s, "
        f"engine process (13b) {engine_proc['phase_s']:.1f} s")
    ex_train = examples["train"]["launches"]
    ex_big = examples["train_big"]["launches"]
    ex_768 = examples["serve_d768"]["launches"]["decode_attention"]
    ex_wide = examples["train_d2048"]["launches"]
    ex_wide_serve = {d: examples[f"serve_d{d}"]["launches"]["decode_attention"]
                     for d in (2048, 1280)}
    ex_mqa = examples["serve_mqa"]["launches"]["decode_attention"]
    ex_serve = {name: {arch: run["launches"][name]
                       for arch, run in examples["serve"].items()
                       if run["launches"][name]}
                for name in ("decode_attention", "selective_scan")}
    launches = {"flash_attention": fwd["launches"] + fwd_k["launches"]
                + fwd_s["launches"] + itrain["launches"]["flash_attention"]
                + gtrain16["launches"]["flash_attention"]
                + ktrain["launches"]["flash_attention"]
                + ex_train["flash_attention"] + ex_big["flash_attention"],
                "flash_attention_backward": train["launches"][
                    "flash_attention_backward"]
                + gtrain["launches"]["flash_attention_backward"]
                + strain["launches"]["flash_attention_backward"]
                + ex_train["flash_attention_backward"]
                + ex_big["flash_attention_backward"],
                "decode_attention": serve["launches"] + serve_k["launches"]
                + serve_s["launches"]
                + sum(ex_serve["decode_attention"].values()) + ex_768
                + ex_mqa,
                "selective_scan": serve_m["launches"]
                + mlogio["launches"]["selective_scan"]
                + sum(ex_serve["selective_scan"].values()),
                "selective_scan_backward": mlogio["launches"][
                    "selective_scan_backward"],
                "selective_scan_fused": fwd_m["launches"]
                + mtrain["launches"]["selective_scan_fused"],
                "selective_scan_fused_backward": mtrain["launches"][
                    "selective_scan_fused_backward"],
                "flash_attention_backward_bf16": itrain["launches"][
                    "flash_attention_backward"]
                + gtrain16["launches"]["flash_attention_backward"]
                + ktrain["launches"]["flash_attention_backward"],
                "flash_attention_wide": ex_wide["flash_attention"],
                "flash_attention_backward_wide": ex_wide[
                    "flash_attention_backward"],
                "decode_attention_wide": sum(ex_wide_serve.values())}
    timed = {"flash_attention": flash_t,
             "flash_attention_backward": flash_bwd_t,
             "flash_attention_backward_bf16": bwd16_t,
             "decode_attention": decode_t, "selective_scan": scan_t,
             "selective_scan_backward": scan_bwd_t,
             "selective_scan_fused": fused_t["f32_forward"],
             "selective_scan_fused_backward": fused_t["f32_backward"],
             "flash_attention_wide": wide_t["f32_forward"],
             "flash_attention_backward_wide": wide_t["f32_backward"],
             "decode_attention_wide": decode_d512["dh 512", 64]}
    rows = []
    for name, meta in KERNELS.items():
        t = timed[name]
        rows.append({"name": name, **meta, "launches": launches[name],
                     "max_abs_err": max(errs[name], t["max_abs_err"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_us": t["bound_ms"] * 1e3,
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"]})
    # flash: the bf16 tensor-core variant above (the forward's); the f32
    # split-f32 one beside it, on the train path (phases 6 and 6b)
    flash_row = next(r for r in rows if r["name"] == "flash_attention")
    flash_row.update({key: val for key, val in flash_t.items()
                      if key.startswith("f32_")})
    flash_row.update(
        f32_launches_train=train["launches"]["flash_attention"],
        f32_launches_logio=logio["launches"]["flash_attention"],
        f32_device_ms_in_step=train["fwd_device_ms"],
        **{f"f32_d256_{key}": val for key, val in d256_t["forward"].items()},
        f32_d256_shape=list(D256_SHAPE),
        f32_d256_source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
        f32_d256_library_call="EFFICIENT_ATTENTION on K/V repeated, no softcap",
        f32_d256_launches_train=gtrain["launches"]["flash_attention"],
        f32_d256_launches_per_step=gtrain["launches"]["flash_attention"]
        // gtrain["steps"],
        f32_d256_device_ms_in_step=gtrain["fwd_device_ms"],
        **{f"bf16_d256_{key}": val
           for key, val in d256_t["bf16_forward"].items()},
        bf16_d256_library_call="FLASH_ATTENTION (enable_gqa), no softcap",
        bf16_d256_launches_train=gtrain16["launches"]["flash_attention"],
        bf16_d256_launches_per_step=gtrain16["fwd_per_step"],
        bf16_d256_device_ms_in_step=gtrain16["fwd_device_ms"],
        bf16_d256_train_depth=gdepth,
        bf16_d256_forward_lse_device_ms=bwd16_d256["forward_lse_device_ms"],
        bf16_d256_forward_no_lse_device_ms=bwd16_d256["forward_device_ms"],
        launches_internlm2_train_bf16=itrain["launches"]["flash_attention"],
        device_ms_in_internlm2_bf16_step=itrain["fwd_device_ms"],
        forward_lse_device_ms=bwd16_t["forward_lse_device_ms"],
        forward_no_lse_device_ms=bwd16_t["forward_device_ms"],
        launches_internlm2_forward=fwd["launches"],
        launches_grok_forward=fwd_k["launches"],
        launches_grok_train_bf16=ktrain["launches"]["flash_attention"],
        grok_launches_per_train_step=ktrain["fwd_per_step"],
        grok_device_ms_in_train_step=ktrain["fwd_device_ms"],
        **{f"grok_{key}": val for key, val in flash_k.items()},
        grok_shape=[FWD_B, FWD_S, kcfg.n_heads, kcfg.n_kv_heads, kcfg.d_head],
        grok_forward_ms=fwd_k["ms"],
        grok_moe={key: val for key, val in fwd_k["moe"].items()
                  if key != "routed"},
        grok_moe_routed=fwd_k["moe"]["routed"])
    flash_row.update(
        launches_seamless_forward=fwd_s["launches"],
        seamless_shape=list(SEAMLESS_SHAPE[:5]), seamless_causal=False,
        seamless_forward_ms=fwd_s["ms"],
        **{f"seamless_{key}": val
           for key, val in flash_s["bf16_forward"].items()},
        seamless_library_call="FLASH_ATTENTION (enable_gqa), non-causal",
        **{f"seamless_f32_{key}": val
           for key, val in flash_s["forward"].items()},
        seamless_f32_library_call="EFFICIENT_ATTENTION on K/V repeated, "
                                  "non-causal",
        f32_launches_seamless_train=strain["launches"]["flash_attention"],
        f32_seamless_launches_per_step=strain["fwd_per_step"],
        f32_seamless_device_ms_in_step=strain["fwd_device_ms"])
    flash_row["launches_examples_train"] = ex_train["flash_attention"]
    # head dim 192 (the split-f32 pair kernels at 96 columns a block on the
    # --big trainer's path; the bf16 forward beside it) and the padded
    # route at 16 (built 32)
    big_steps = examples["train_big"]["steps"]
    flash_row.update(
        **{f"f32_d192_{key}": val for key, val in d192_t["forward"].items()},
        f32_d192_shape=list(D192_SHAPE[:5]),
        f32_d192_launches_train_big=ex_big["flash_attention"],
        f32_d192_launches_per_step=ex_big["flash_attention"] // big_steps,
        **{f"bf16_d192_{key}": val
           for key, val in d192_t["bf16_forward"].items()},
        bf16_d192_forward_lse_device_ms=bwd16_d192["forward_lse_device_ms"],
        **{f"f32_d16_{key}": val for key, val in d16_t["forward"].items()},
        f32_d16_shape=list(D16_SHAPE[:5]), f32_d16_built_head_dim=32,
        **{f"bf16_d16_{key}": val for key, val in d16_t["bf16_forward"].items()},
        ptxas_d192=d192_ptxas)
    flash_row["max_abs_err"] = max(flash_row["max_abs_err"],
                                   d192_t["forward"]["max_abs_err"],
                                   d192_t["bf16_forward"]["max_abs_err"],
                                   d16_t["forward"]["max_abs_err"],
                                   d16_t["bf16_forward"]["max_abs_err"],
                                   flash_k["max_abs_err"],
                                   flash_s["bf16_forward"]["max_abs_err"],
                                   flash_s["forward"]["max_abs_err"])
    bwd_row = next(r for r in rows if r["name"] == "flash_attention_backward")
    bwd_row.update(
        launches_per_step=train["launches"]["flash_attention_backward"]
        // train["steps"],
        launches_logio=logio["launches"]["flash_attention_backward"],
        device_ms_by_kernel=flash_bwd_t["device_ms_by_kernel"],
        device_ms_in_step=train["bwd_device_ms"],
        train_step_ms=train["step_ms"],
        **{f"d256_{key}": val for key, val in d256_t["backward"].items()},
        d256_source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
        d256_launches_train=gtrain["launches"]["flash_attention_backward"],
        d256_launches_per_step=gtrain["launches"]["flash_attention_backward"]
        // gtrain["steps"],
        d256_device_ms_in_step=gtrain["bwd_device_ms"],
        d256_train_step_ms=gtrain["step_ms"],
        d256_train_depth=gtrain["depth"], d256_train_remat=gtrain["remat"],
        d256_train_remat_check=gremat, seamless_train_remat_check=sremat,
        **{key: flash_bwd_t[key] for key in (
            "library_call", "library_max_err_to_max", "library_math_ms",
            "library_math_backend", "cuda_core_bound_ms")},
        **{f"seamless_{key}": val for key, val in flash_s["backward"].items()},
        seamless_shape=list(SEAMLESS_SHAPE[:5]), seamless_causal=False,
        seamless_library_call="EFFICIENT_ATTENTION backward on K/V repeated, "
                              "non-causal",
        seamless_launches_train=strain["launches"]["flash_attention_backward"],
        seamless_launches_per_step=strain["per_step"],
        seamless_device_ms_in_step=strain["bwd_device_ms"],
        seamless_train_step_ms=strain["step_ms"],
        seamless_train_depth=[strain["depth"], strain["depth"]],
        seamless_train_remat=strain["remat"])
    bwd_row["launches_examples_train"] = ex_train["flash_attention_backward"]
    bwd_row.update(
        **{f"d192_{key}": val for key, val in d192_t["backward"].items()},
        d192_shape=list(D192_SHAPE[:5]),
        d192_launches_train_big=ex_big["flash_attention_backward"],
        d192_launches_per_step=ex_big["flash_attention_backward"] // big_steps,
        d192_train_big_wall_s=examples["train_big"]["wall_s"],
        **{f"d16_{key}": val for key, val in d16_t["backward"].items()},
        d16_shape=list(D16_SHAPE[:5]), d16_built_head_dim=32)
    bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"],
                                 d192_t["backward"]["max_abs_err"],
                                 d16_t["backward"]["max_abs_err"],
                                 flash_s["backward"]["max_abs_err"])
    # the bf16 backward: internlm2's shape above (phase 11's), gemma2's dh
    # 256 (phase 11b's) and seamless's dh 64 non-causal beside it
    bwd16_row = next(r for r in rows
                     if r["name"] == "flash_attention_backward_bf16")
    bwd16_row.update(
        shape=bwd16_t["shape"], causal=True,
        library_call=bwd16_t["library_call"],
        device_ms_by_kernel=bwd16_t["device_ms_by_kernel"],
        launches_internlm2_train=itrain["launches"]["flash_attention_backward"],
        launches_per_step=itrain["per_step"],
        device_ms_in_step=itrain["bwd_device_ms"],
        train_step_ms=itrain["step_ms"],
        train_first_loss=itrain["first_loss"],
        train_variants=ivariants,
        **{f"d256_{key}": val for key, val in bwd16_d256.items()},
        d256_launches_train=gtrain16["launches"]["flash_attention_backward"],
        d256_launches_per_step=gtrain16["per_step"],
        d256_device_ms_in_step=gtrain16["bwd_device_ms"],
        d256_train_step_ms=gtrain16["step_ms"],
        d256_train_depth=gdepth,
        d256_train_first_loss=gtrain16["first_loss"],
        d256_train_remat=gtrain16["remat"], d256_train_remat_check=gremat16,
        **{f"grok_{key}": val for key, val in bwd16_k.items()},
        grok_launches_train=ktrain["launches"]["flash_attention_backward"],
        grok_launches_per_step=ktrain["per_step"],
        grok_device_ms_in_step=ktrain["bwd_device_ms"],
        grok_train_step_ms=ktrain["step_ms"],
        grok_train_depth=ktrain["depth"], grok_train_remat=ktrain["remat"],
        grok_train_first_loss=ktrain["first_loss"],
        grok_train_peak_gb=ktrain["peak_gb"],
        train_remat_variant=iremat,
        ptxas=bf16_ptxas,
        **{f"seamless_{key}": val for key, val in bwd16_s.items()})
    bwd16_row.update(**{f"d192_{key}": val for key, val in bwd16_d192.items()},
                     **{f"d16_{key}": val for key, val in bwd16_d16.items()},
                     d16_built_head_dim=32)
    bwd16_row["max_abs_err"] = max(bwd16_row["max_abs_err"],
                                   bwd16_d192["max_abs_err"],
                                   bwd16_d16["max_abs_err"],
                                   bwd16_d256["max_abs_err"],
                                   bwd16_s["max_abs_err"],
                                   bwd16_k["max_abs_err"])
    # the sharded phase's launches (its own main path), per kernel
    for name, n in (
            ("flash_attention", sharded["train"]["launches"]["flash_attention"]
             + sharded["grok_forward"]["launches"]["flash_attention"]),
            ("flash_attention_backward",
             sharded["train"]["launches"]["flash_attention_backward"]),
            ("decode_attention",
             sharded["serve"]["launches"]["decode_attention"]),
            ("selective_scan_fused",
             sharded["mamba_forward"]["launches"]["selective_scan_fused"])):
        next(r for r in rows if r["name"] == name)["launches_sharded"] = n
    # decode attention: the serve shape above (the main path's), a full
    # cache beside it
    decode_row = next(r for r in rows if r["name"] == "decode_attention")
    decode_row.update(
        lse_ms=decode_t["lse_ms"], lse_device_ms=decode_t["lse_device_ms"],
        full_cache_lse_ms=decode_full["lse_ms"],
        full_cache_lse_device_ms=decode_full["lse_device_ms"])
    decode_row.update(
        max_abs_err=max(decode_row["max_abs_err"], decode_full["max_abs_err"]),
        clean_l2_ms=decode_t["clean_l2_ms"],
        clean_l2_device_ms=decode_t["clean_l2_device_ms"],
        full_cache_ms=decode_full["ms"],
        full_cache_device_ms=decode_full["device_ms"],
        full_cache_bound_ms=decode_full["bound_ms"],
        full_cache_clean_l2_ms=decode_full["clean_l2_ms"],
        full_cache_clean_l2_device_ms=decode_full["clean_l2_device_ms"],
        launches_internlm2_serve=serve["launches"],
        launches_grok_serve=serve_k["launches"],
        **{f"grok_{key}": val for key, val in decode_k.items()},
        launches_seamless_serve=serve_s["launches"],
        **{f"seamless_cross_{key}": val for key, val in decode_s.items()},
        seamless_random_cross_step_max_abs_err=serve_s["cross_err"])
    decode_row["launches_examples_serve"] = ex_serve["decode_attention"]
    # head dim 192 (launch.serve --d-model 768's server) and the padded
    # route at 16 (built 32), at DECODE_WIDE_SHAPE
    decode_row["launches_launch_serve_d768"] = ex_768
    decode_row["launch_serve_d768"] = examples["serve_d768"]
    for (D, keys), row in decode_wide.items():
        tag = f"d{D}_" + ("serve_shape_" if keys == 64 else "full_cache_")
        decode_row.update({tag + key: val for key, val in row.items()})
        decode_row["max_abs_err"] = max(decode_row["max_abs_err"],
                                        row["max_abs_err"])
    decode_row["d192_shape"] = list(DECODE_WIDE_SHAPE) + [192]
    decode_row["max_abs_err"] = max(decode_row["max_abs_err"],
                                    decode_k["max_abs_err"],
                                    decode_s["max_abs_err"],
                                    serve_s["cross_err"])
    # decode at multi-query groups of 32 and 71 (the group route): their
    # full-cache timings and the multi-query server's launches
    decode_row.update(
        **{f"group32_full_cache_{key}": val for key, val in decode_g32.items()},
        group32_shape=list(DECODE_GROUP32_SHAPE),
        **{f"group71_full_cache_{key}": val for key, val in decode_g71.items()},
        group71_shape=list(DECODE_GROUP71_SHAPE),
        launches_launch_serve_mqa=ex_mqa,
        launch_serve_mqa=examples["serve_mqa"])
    decode_row["max_abs_err"] = max(decode_row["max_abs_err"],
                                    decode_g32["max_abs_err"],
                                    decode_g71["max_abs_err"])
    # the wide route (the cluster kernels): f32 (launch.train --d-model
    # 2048's) in the rows, bf16 beside it, and the same-call parent (the
    # CUDA-core kernels); decode's group route at head dim 512 at the serve
    # shape, a full cache beside it, the launches of the servers at
    # --d-model 2048 and 1280, and the group kernels' ptxas report
    train_wide = examples["train_d2048"]
    for name, kind in (("flash_attention_wide", "forward"),
                       ("flash_attention_backward_wide", "backward")):
        row = next(r for r in rows if r["name"] == name)
        f32, bf16 = wide_t[f"f32_{kind}"], wide_t[f"bf16_{kind}"]
        row.update(
            dtype="float32", shape=f32["shape"], causal=True,
            library_call=f"sdpa (enable_gqa, {f32['library_backend']})",
            cuda_core_bound_ms=f32["cuda_core_bound_ms"],
            gflop=f32["gflop"], gflop_done=f32["gflop_done"],
            device_ms_by_kernel=f32["device_ms_by_kernel"],
            parent="the CUDA-core kernels (csrc/flash_attention_wide.cu)",
            parent_ms=f32["parent_ms"],
            parent_gflop_done=f32["parent_gflop_done"],
            **{f"bf16_{key}": val for key, val in bf16.items()},
            launches_per_step=row["launches"] // train_wide["steps"],
            launch_train_d2048=train_wide, ptxas=wide_ptxas)
        row["max_abs_err"] = max(row["max_abs_err"], bf16["max_abs_err"])
    dwide_row = next(r for r in rows if r["name"] == "decode_attention_wide")
    dwide_row.update(
        shape=list(DECODE_D512_SHAPE),
        **{f"full_cache_{key}": val for key, val in
           decode_d512["dh 512", DECODE_D512_SHAPE[1]].items()},
        launches_launch_serve_d2048=ex_wide_serve[2048],
        launches_launch_serve_d1280=ex_wide_serve[1280],
        launch_serve_d2048=examples["serve_d2048"],
        launch_serve_d1280=examples["serve_d1280"],
        group_route=decode_group_ptxas,
        **{f"server_{tag}_{key}": val for tag, row in decode_servers.items()
           for key, val in row.items()},
        server_shapes={tag: list(shape) + [DECODE_SERVER_KEYS]
                       for tag, shape in DECODE_SERVER_SHAPES.items()})
    dwide_row["max_abs_err"] = max(
        dwide_row["max_abs_err"],
        decode_d512["dh 512", DECODE_D512_SHAPE[1]]["max_abs_err"])
    # the scan runs on both paths: its forward-shape numbers above, the
    # decode step's (and the variant it ran) and the launches of each path
    scan_row = next(r for r in rows if r["name"] == "selective_scan")
    scan_row.update(
        launches_examples_serve=ex_serve["selective_scan"],
        launches_serve=serve_m["launches"],
        max_abs_err=max(scan_row["max_abs_err"], scan_dec["max_abs_err"]),
        variant=scan_t["variant"], decode_variant=scan_dec["variant"],
        decode_kernel=SCAN_KERNEL[scan_dec["variant"]],
        decode_ms=scan_dec["ms"], decode_plain_ms=scan_dec["plain_ms"],
        decode_bound_ms=scan_dec["bound_ms"],
        decode_device_ms=scan_dec["device_ms"],
        decode_clean_l2_ms=scan_dec["clean_l2_ms"],
        decode_clean_l2_device_ms=scan_dec["clean_l2_device_ms"],
        decode_library_ms=scan_dec["library_ms"],
        decode_library_device_ms=scan_dec["library_device_ms"],
        decode_library_clean_l2_device_ms=scan_dec[
            "library_clean_l2_device_ms"],
        decode_in_serve_step_device_ms=serve_m["scan_in_step"],
        launches_train_logio=mlogio["launches"]["selective_scan"])
    scan_bwd_row = next(r for r in rows if r["name"] == "selective_scan_backward")
    scan_bwd_row.update(
        launches_logio=mlogio["launches"]["selective_scan_backward"],
        library_note="none: no PyTorch call computes a reverse linear "
                     "recurrence")
    # the fused pair: phase 3b's forward and phase 7's train step, the bf16
    # forward's timing, the materialised route as the same-call parent, and
    # the step at the materialised route's depth
    fused_row = next(r for r in rows if r["name"] == "selective_scan_fused")
    fused_row.update(
        shape=fused_t["f32_forward"]["shape"], dtype="float32",
        launches_forward=fwd_m["launches"],
        launches_train=mtrain["launches"]["selective_scan_fused"],
        launches_per_train_step=mtrain["fwd_per_step"],
        device_ms_in_train_step=mtrain["fwd_device_ms"],
        sfu_ms=fused_t["f32_forward"]["sfu_ms"],
        parent=fused_t["f32_forward"]["parent"],
        parent_ms=fused_t["f32_forward"]["parent_ms"],
        parent_device_ms=fused_t["f32_forward"]["parent_device_ms"],
        **{f"bf16_{key}": val for key, val in fused_t["bf16_forward"].items()
           if key != "dtype"})
    fused_row["max_abs_err"] = max(fused_row["max_abs_err"],
                                   fused_t["bf16_forward"]["max_abs_err"])
    fused_bwd_row = next(r for r in rows
                         if r["name"] == "selective_scan_fused_backward")
    fused_bwd_row.update(
        shape=fused_t["f32_backward"]["shape"], dtype="float32",
        device_ms_by_kernel=fused_t["f32_backward"]["device_ms_by_kernel"],
        sfu_ms=fused_t["f32_backward"]["sfu_ms"],
        parent=fused_t["f32_backward"]["parent"],
        parent_ms=fused_t["f32_backward"]["parent_ms"],
        parent_device_ms=fused_t["f32_backward"]["parent_device_ms"],
        launches_per_step=mtrain["per_step"],
        device_ms_in_step=mtrain["bwd_device_ms"],
        train_step_ms=mtrain["step_ms"], train_peak_gb=mtrain["peak_gb"],
        train_depth=mtrain["depth"], train_remat=mtrain["remat"],
        train_remat_check=mremat,
        grads_bitwise_equal_to_plain=mtrain["grads_bitwise"],
        train_at_earlier_depth=m_earlier,
        library_note="none: no PyTorch call computes a linear recurrence")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {dev['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
