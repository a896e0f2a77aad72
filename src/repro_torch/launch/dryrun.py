"""Multi-pod dry-run on the port: trace every (arch x shape x mesh) cell and
reckon its roofline against H100 constants. The counterpart of
``repro.launch.dryrun``.

Nothing runs on a device. A cell's state, batch and cache are ``meta``
tensors (``launch.input_specs``), laid out as DTensors by the cell's specs
(``parallel.sharding``) on the production mesh, (16, 16) or (2, 16, 16),
built over a fake process group of that many ranks. One call is traced:
``train_step`` for a train shape, ``forward`` for a prefill, ``serve_step``
for a decode. The kernel wrappers take their shape-only route on ``meta``
(``kernels.ops``). Per cell this prints and records, for one rank:

  * the peak of live bytes: the state and inputs a rank holds plus the peak
    of what the call allocates (``fits_80GB``);
  * the trace analysis (``parallel.trace_analysis``): GEMM and kernel
    FLOPs, bytes moved, collective bytes by kind and by link;
  * the three roofline terms against the constants below, of an H100 SXM5
    80GB at 700 W, one GPU a rank, eight GPUs a node.

JAX's ``compiled.memory_analysis()`` and ``cost_analysis()`` have no
counterpart (there is no compiled program), nor do its ``XLA_FLAGS``: the
fake group has as many ranks as the mesh asks for.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch   # full sweep
"""
import argparse
import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
import traceback

# NVIDIA H100 SXM5 80GB datasheet, per GPU: dense tensor-core peaks (bf16,
# TF32), the f32 CUDA-core peak (the port turns TF32 off, so its f32 GEMMs
# run there), HBM3, NVLink 4 (900 GB/s both directions) inside one node of
# eight GPUs, and one 400 Gb/s NIC a GPU between nodes
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s a direction, inside one node
NIC_BW = 50e9              # bytes/s a GPU, between nodes
NODE_GPUS = 8
HBM_BYTES = 80e9

# seconds a flop takes on the units ``parallel.trace_analysis`` files it
# under: the split-f32 flash kernels do three TF32 products for each f32 one,
# the cluster route's bf16 kernels one
SECONDS_PER_FLOP = {"bf16": 1 / PEAK_FLOPS["bf16"],
                    "tf32x3": 3 / PEAK_FLOPS["tf32"],
                    "tf32": 1 / PEAK_FLOPS["tf32"],
                    "f32": 1 / PEAK_FLOPS["f32"]}


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0 (its
    collectives send nothing and return at once), destroyed on exit. A
    process group that is already there raises: the trace must not reach
    a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process of its own: a "
                           "process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def roofline(trace: dict, model_flops: float, n_chips: int) -> dict:
    """The three terms of one rank's call against the constants above."""
    compute_s = sum(f * SECONDS_PER_FLOP[r]
                    for r, f in trace["flops_by_rate"].items())
    memory_s = trace["memory_bytes"] / HBM_BW
    link = trace["collective_bytes_by_link"]
    collective_s = link["nvlink"] / NVLINK_BW + link["nic"] / NIC_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms.values())
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max(terms, key=terms.get),
            "step_time_s_lower_bound": bound,
            "mfu_upper_bound": (model_flops / n_chips / PEAK_FLOPS["bf16"]
                                / bound if bound > 0 else None)}


def trace_cell(cfg, shape, *, mesh=None, strat=None, preset=None, hp=None,
               rt=None, compress_grads: bool = False, dump=None) -> dict:
    """Trace the call of ``shape``'s kind on ``meta`` tensors for ``cfg``:
    sharded on ``mesh`` by ``strat`` (DTensors over the mesh's process
    group, which must exist), or unsharded when ``mesh`` is None (one rank
    holding everything, as one card runs it). ``preset`` sets the train
    batch's microbatch (``input_specs.train_batch_layout``), ``hp`` the
    optimizer, ``rt`` the runtime. Returns the trace summary with the
    bytes the rank holds before the call (``argument_bytes``), the peak of
    live bytes, the model FLOPs and the seconds the trace took."""
    import torch

    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.presets import Preset
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.trace_analysis import OpTrace
    from repro_torch.serving.decode import serve_step
    from repro_torch.training.optimizer import OptHParams
    from repro_torch.training.step import train_step

    preset = preset or Preset()
    hp = hp or OptHParams()
    rt = rt or M.Runtime(remat=preset.remat)
    strat = strat or S.ShardingStrategy()
    layout = mesh if mesh is not None else S.MeshShape(("data", "model"),
                                                       (1, 1))

    def place(tree, specs):
        return tree if mesh is None else S.distribute(tree, specs, mesh)

    if shape.kind == "train":
        state, batch, st_sp, b_sp = ispec.train_specs(cfg, shape, layout,
                                                      strat, preset, hp)
        state, batch = place(state, st_sp), place(batch, b_sp)
        held = (state, batch)

        def call():
            return train_step(state, batch, cfg=cfg, hp=hp, rt=rt,
                              compress_grads=compress_grads)
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * cfg.active_param_count() * tokens
    elif shape.kind == "prefill":
        params, batch, p_sp, b_sp = ispec.prefill_specs(cfg, shape, layout,
                                                        strat)
        params, batch = place(params, p_sp), place(batch, b_sp)
        held = (params, batch)

        def call():
            with torch.no_grad():
                return M.forward(params, batch, cfg, rt)[0]
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * cfg.active_param_count() * tokens
    else:   # decode: one new token a slot
        params, cache, toks, p_sp, c_sp, t_sp = ispec.decode_specs(
            cfg, shape, layout, strat)
        params, cache, toks = (place(params, p_sp), place(cache, c_sp),
                               place(toks, t_sp))
        held = (params, cache, toks)

        def call():
            with torch.no_grad():
                return serve_step(params, cache, toks["tokens"], toks["pos"],
                                  cfg=cfg, rt=rt)
        tokens = shape.global_batch
        model_flops = 2.0 * cfg.active_param_count() * tokens
    argument = sum(S.bytes_of(t) for t in held)
    t0 = time.time()
    with OpTrace(dump=dump, node_size=NODE_GPUS) as tr:
        out = call()
    del out
    res = tr.summary()
    res.update(argument_bytes=argument,
               peak_bytes=argument + res["temp_bytes"],
               model_flops=model_flops, trace_s=time.time() - t0)
    return res


def layout_for(cfg, shape, mesh, preset, overrides: dict):
    """JAX's dry-run layout of a cell: (cfg, strategy, runtime). The
    preset's expert split; the dp-only layout (small models' train shapes:
    no TP, FSDP over every mesh axis, the batch over the largest suffix of
    axes that divides it); TP padding; EP where the split experts divide
    the tensor axis; an unshardable prefill or decode batch replicated."""
    from repro_torch.launch.input_specs import dp_total
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    esplit = overrides.get("expert_split") or preset.expert_split
    if esplit and esplit > 1 and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_split=esplit))
    sizes = S.mesh_sizes(mesh)
    if overrides.get("dp_only") or (preset.dp_only_train
                                    and shape.kind == "train"):
        flat = tuple(mesh.mesh_dim_names)
        bt = flat
        while bt:
            n = 1
            for a in bt:
                n *= sizes[a]
            if shape.global_batch % n == 0:
                break
            bt = bt[1:]
        strat = S.ShardingStrategy(fsdp=True, tp=False, ep=False,
                                   seq_shard_decode=False,
                                   fsdp_axes=flat, dp_axes=bt or ("data",))
    else:
        strat = S.ShardingStrategy.for_mesh(
            mesh, fsdp=preset.fsdp, ep=preset.ep,
            fsdp_over_pod=overrides.get("fsdp_over_pod", False))
    if strat.tp:
        cfg = cfg.padded_for_tp(sizes[strat.tp_axis])
    ep_active = (cfg.moe is not None and strat.ep and strat.tp
                 and (cfg.moe.n_experts * cfg.moe.expert_split)
                 % sizes[strat.tp_axis] == 0)
    dp_axes = strat.dp_axes
    if shape.kind in ("prefill", "decode"):
        if shape.global_batch % dp_total(mesh, strat) != 0:
            dp_axes = ()     # long_500k B=1: batch unshardable
    rt = M.Runtime(remat=preset.remat, q_chunk=preset.q_chunk,
                   shard_activations=True, dp_axes=dp_axes, ep=ep_active,
                   tp_axis=(strat.tp_axis if strat.tp else ""))
    return cfg, strat, rt


def _cell_result(arch_name: str, shape_name: str, multi_pod: bool,
                 overrides: dict):
    from repro_torch.configs import ALL_SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.presets import preset_for
    from repro_torch.training.optimizer import OptHParams

    # DTensor warns of every redistribute it does in several collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    cfg = get_config(arch_name)
    shape = ALL_SHAPES[shape_name]
    preset = preset_for(arch_name)
    for k, v in (overrides or {}).items():
        if v is not None and hasattr(preset, k):
            preset = dataclasses.replace(preset, **{k: v})
    n_chips = 512 if multi_pod else 256
    hp = OptHParams(moment_dtype=preset.moment_dtype,
                    grad_accum_dtype=preset.grad_accum_dtype)
    with fake_world(n_chips):
        # a CUDA mesh, as the cards run it (nothing touches a device: the
        # tensors are meta); on a CPU mesh DTensor swaps every all-to-all
        # for an all-gather
        mesh = make_production_mesh(multi_pod=multi_pod)
        cfg, strat, rt = layout_for(cfg, shape, mesh, preset, overrides)
        dump = overrides.get("dump_ops")
        with (open(dump, "w") if dump else contextlib.nullcontext()) as f:
            tr = trace_cell(cfg, shape, mesh=mesh, strat=strat, preset=preset,
                            hp=hp, rt=rt, dump=f,
                            compress_grads=overrides.get("compress_grads",
                                                         False))
    roof = roofline(tr, tr["model_flops"], n_chips)
    total_flops = tr["dot_flops"] * n_chips
    return {
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "status": "ok",
        "trace_s": round(tr["trace_s"], 2),
        "memory": {
            "argument_bytes": tr["argument_bytes"],
            "temp_bytes": tr["temp_bytes"],
            "peak_bytes": tr["peak_bytes"],
            "fits_80GB": tr["peak_bytes"] < HBM_BYTES,
        },
        "trace": {k: tr[k] for k in (
            "dot_flops", "gemm_flops", "kernel_flops", "flops_by_rate",
            "memory_bytes", "kernel_bytes", "collective_bytes",
            "collective_count", "collectives", "collective_bytes_by_link",
            "kernel_calls", "ops")},
        "model_flops": tr["model_flops"],
        "useful_flops_ratio": (tr["model_flops"] / total_flops
                               if total_flops else None),
        "roofline": roof,
        "preset": dataclasses.asdict(preset),
        "overrides": {k: v for k, v in (overrides or {}).items()
                      if v not in (None, False)},
    }


def run_cell(arch, shape, multi_pod, out_path=None, **overrides):
    try:
        res = _cell_result(arch, shape, multi_pod, overrides)
    except Exception as e:   # a failing cell is a bug — record it loudly
        res = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    return res


def all_cells():
    from repro_torch.configs import ARCHS, shapes_for
    for name, cfg in ARCHS.items():
        for shp in shapes_for(cfg):
            for multi in (False, True):
                yield name, shp.name, multi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    # hillclimb overrides
    ap.add_argument("--remat", choices=["none", "block", "full"])
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false", default=None)
    ap.add_argument("--no-ep", dest="ep", action="store_false", default=None)
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--moment-dtype", dest="moment_dtype",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--grad-accum-dtype", dest="grad_accum_dtype",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--compress-grads", action="store_true", default=False)
    ap.add_argument("--fsdp-over-pod", action="store_true", default=False)
    ap.add_argument("--dump-ops", dest="dump_ops", default=None,
                    help="write one JSON line for every counted op here")
    ap.add_argument("--dp-only", dest="dp_only", action="store_true",
                    default=False)
    ap.add_argument("--expert-split", dest="expert_split", type=int,
                    default=None)
    args = ap.parse_args()
    overrides = {k: getattr(args, k) for k in
                 ("remat", "fsdp", "ep", "microbatch", "moment_dtype",
                  "grad_accum_dtype", "compress_grads", "fsdp_over_pod",
                  "dump_ops", "dp_only", "expert_split")}

    if args.all:
        outdir = args.out or "results/dryrun_torch"
        os.makedirs(outdir, exist_ok=True)
        for arch, shp, multi in all_cells():
            tag = f"{arch}__{shp}__{'2x16x16' if multi else '16x16'}"
            path = os.path.join(outdir, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"SKIP {tag} (exists)")
                continue
            # subprocess per cell: a fresh process group and a bounded time
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shp, "--out", path]
            if multi:
                cmd.append("--multi-pod")
            print(f"RUN  {tag}", flush=True)
            try:
                subprocess.run(cmd, timeout=args.timeout, check=False)
            except subprocess.TimeoutExpired:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shp,
                               "mesh": "2x16x16" if multi else "16x16",
                               "status": "timeout"}, f)
        return

    res = run_cell(args.arch, args.shape, args.multi_pod, args.out, **overrides)
    if res["status"] == "ok":
        m, r, t = res["memory"], res["roofline"], res["trace"]
        print(f"== {res['arch']} x {res['shape']} @ {res['mesh']} "
              f"(traced in {res['trace_s']} s) ==")
        print(f"memory (per rank): held={m['argument_bytes']/1e9:.2f}GB "
              f"temp={m['temp_bytes']/1e9:.2f}GB "
              f"peak={m['peak_bytes']/1e9:.2f}GB fits_80GB={m['fits_80GB']}")
        print(f"trace (per rank): flops={t['dot_flops']:.3e} "
              f"(gemm {t['gemm_flops']:.3e}, kernels {t['kernel_flops']:.3e}) "
              f"bytes={t['memory_bytes']:.3e} "
              f"coll_bytes={t['collective_bytes']:.3e} "
              f"in {t['collective_count']} collectives; "
              f"kernel calls {t['kernel_calls']}")
        print(f"roofline (H100 SXM5): compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"dominant={r['dominant']} "
              f"MFU_ub={r['mfu_upper_bound'] and round(r['mfu_upper_bound'],3)}")
        print(f"useful_flops_ratio(6ND/traced)="
              f"{res['useful_flops_ratio'] and round(res['useful_flops_ratio'],3)}")
    else:
        print(f"FAILED {res['arch']} x {res['shape']}: {res.get('error')}")
        print(res.get("traceback", "")[-2000:])
        sys.exit(1)


if __name__ == "__main__":
    main()
