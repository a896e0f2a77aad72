"""One rank of the sharded runs of ``tests/test_torch_sharded_run.py``.

Torch and the port only (the spawned ranks load no JAX): the job file holds
each case's config, mesh, numpy weights, state, batches and cache (made
from seeds by the test), and each rank runs the case's sharded ``forward``,
``train_step`` (twice from the same state) and 8 ``serve_step``s on a CPU
``DeviceMesh`` over gloo, then rank 0 writes every result gathered to full
numpy arrays. A case that raises records its traceback and the others go
on. The test starts the ranks with ``torch.multiprocessing.start_processes``
(``main(rank, world, job_dir)``).
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as S
from repro_torch.serving import serve_step
from repro_torch.training import step as TS
from repro_torch.training.optimizer import OptHParams


def _np(t):
    return bridge.to_numpy(t.full_tensor() if type(t).__name__ == "DTensor"
                           else t)


def _state(case, cfg, mesh, rules, hp):
    state = bridge.train_state_from_jax(case["state"], cfg, "cpu")
    return S.distribute(state, S.state_pspecs(cfg, rules, hp.moment_dtype),
                        mesh)


def _state_to_np(state, cfg):
    return bridge.train_state_to_jax(S.full(state), cfg,
                                     qtensor=lambda q, s: {"q": q, "scale": s})


def run_case(case) -> dict:
    """The case with ``MOE_TOKEN_CHUNK`` set to its ``moe_chunk`` (when it
    has one)."""
    from repro_torch.models import layers as TL
    old = TL.MOE_TOKEN_CHUNK
    TL.MOE_TOKEN_CHUNK = case.get("moe_chunk") or old
    try:
        return _run_case(case)
    finally:
        TL.MOE_TOKEN_CHUNK = old


def _run_case(case) -> dict:
    cfg = case["cfg"]
    mesh = init_device_mesh("cpu", case["mesh"], mesh_dim_names=case["axes"])
    strat = S.ShardingStrategy.for_mesh(mesh, ep=case.get("ep", True))
    rules = S.make_rules(cfg, mesh, strat)
    rt = S.runtime(cfg, mesh, strat, remat="none")
    dp = strat.dp_axes
    out = {"rules": rules, "ep": rt.ep}

    # forward
    params = S.distribute(bridge.params_from_jax(case["params"], cfg, "cpu"),
                          S.param_pspecs(cfg, rules), mesh)
    out["local_param_bytes"] = S.bytes_of(params)
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    bspec = {"tokens": S.spec(dp, None)}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(case["frames"])
        bspec["frames"] = S.spec(dp, None, None)
    with torch.no_grad():
        logits, aux = TM.forward(params, S.distribute(batch, bspec, mesh),
                                 cfg, rt)
    out["logits_placements"] = [p.dim if p.is_shard() else None
                                for p in logits.placements]
    out["logits"], out["aux"] = _np(logits), float(_np(aux))
    if case.get("flip_ep"):
        with torch.no_grad():
            flipped, _ = TM.forward(params, S.distribute(batch, bspec, mesh),
                                    cfg, dataclasses.replace(rt, ep=not rt.ep))
        out["logits_ep_flipped"] = _np(flipped)

    # train: one step, twice from the same state
    hp = OptHParams(**case["hp"])
    tspec = {k: S.spec(None, dp, *([None] * (v.ndim - 2)))
             for k, v in case["train_batch"].items()}
    runs = []
    for _ in range(2):
        state = _state(case, cfg, mesh, rules, hp)
        tb = S.distribute({k: torch.from_numpy(v) for k, v
                           in case["train_batch"].items()}, tspec, mesh)
        state, metrics = TS.train_step(state, tb, cfg=cfg, hp=hp, rt=rt)
        runs.append(({k: _np(v) for k, v in metrics.items()},
                     _state_to_np(state, cfg)))
    out["train"] = runs[0]
    out["train_repeat"] = runs[1]

    # serve: 8 steps on a cache split on kv_seq over the tensor axis
    B = case["serve_tokens"].shape[0]
    shardable = B % int(np.prod([S.mesh_sizes(mesh)[a] for a in dp])) == 0
    cache = S.distribute(bridge.cache_from_jax(case["cache"], "cpu"),
                         S.cache_pspecs(cfg, rules, shardable), mesh)
    tok_spec = S.spec(dp if shardable else None)
    # a batch the data axes do not divide stays whole (JAX's dry-run:
    # long_500k's B = 1), and so do the activations
    srt = rt if shardable else dataclasses.replace(rt, dp_axes=())
    logits_seq, toks_seq = [], []
    with torch.no_grad():
        for i in range(case["serve_tokens"].shape[1]):
            tok = S.distribute(torch.from_numpy(case["serve_tokens"][:, i]),
                               tok_spec, mesh)
            pos = S.distribute(torch.from_numpy(case["serve_pos"][i]),
                               tok_spec, mesh)
            nxt, lg, cache = serve_step(params, cache, tok, pos, cfg=cfg,
                                        rt=srt)
            logits_seq.append(_np(lg))
            toks_seq.append(_np(nxt))
    out["serve_logits"] = np.stack(logits_seq)
    out["serve_next"] = np.stack(toks_seq)
    out["cache"] = bridge.cache_to_jax(S.full(cache))
    return out


def run_layout_checks() -> dict:
    """What needs real ranks but no model: a ("pod", "data") spec entry
    shards pod-major, the mesh builders, and which of JAX and ``repro`` this
    rank has loaded (none)."""
    from repro_torch.launch import make_local_mesh, make_production_mesh
    out = {}
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    x = torch.arange(8 * 3).reshape(8, 3)
    d = S.distribute(x, (("pod", "data"), None), mesh)
    out["pod_major"] = bridge.to_numpy(d.to_local())
    out["coords"] = (mesh.get_local_rank("pod"), mesh.get_local_rank("data"))
    local = make_local_mesh(device_type="cpu")
    out["local_mesh"] = (tuple(local.mesh_dim_names), tuple(local.shape))
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    try:
        make_production_mesh(device_type="cpu")
        out["production"] = "built"
    except RuntimeError as e:
        out["production"] = str(e)
    return out


def main(rank: int, world: int, path: str) -> None:
    torch.set_num_threads(1)
    root = Path(path)
    job = pickle.loads((root / "job.pkl").read_bytes())
    store = dist.FileStore(str(root / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    try:
        results["layout"] = run_layout_checks()
        for case in job["cases"]:
            try:
                results[case["name"]] = run_case(case)
            except Exception:
                results[case["name"]] = {"error": traceback.format_exc()}
        if rank == 0:
            (root / "out.pkl").write_bytes(pickle.dumps(results))
        else:
            (root / f"layout{rank}.pkl").write_bytes(
                pickle.dumps(results["layout"]))
    finally:
        dist.destroy_process_group()
