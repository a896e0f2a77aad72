"""Per-rank op-trace analysis for the roofline: the port's counterpart of
``repro.parallel.hlo_analysis``.

JAX's module parses the compiled, post-SPMD HLO of one device. The port has
no compiled program: it runs eagerly. ``OpTrace`` (a ``TorchDispatchMode``)
watches one call run on ``meta`` tensors (shapes only, nothing computed)
and counts each aten op as it is dispatched. It declines every op on a
tensor subclass, so DTensor runs it on this rank's local shards (and
``AsyncCollectiveTensor`` waits), and those local ops come back to the mode
and are counted at their local shapes, as are the ops inside ``local_map``
and the collectives DTensor issues. So every number is one rank's: rank 0
of the fake process group the dry-run traces on. The ops that DTensor's
sharding propagation runs on fake tensors at global shapes are not counted.

  * ``gemm_flops``   2 * M * N * K of every ``mm`` / ``addmm`` and
                     2 * B * M * N * K of every ``bmm`` / ``baddbmm``: the
                     matrix products ``torch.profiler(with_flops=True)``
                     counts (elementwise flops are ignored, as JAX's are).
  * ``kernel_flops`` the products of the hand-written kernels, from their
                     wrappers' shape-only route (``kernels.ops.COST_HOOK``):
                     flash attention over the pairs its masks keep (five
                     products in the backward for two in the forward),
                     decode attention over the whole cache, the scan none.
  * ``dot_flops``    their sum, the counterpart of JAX's (whose attention,
                     on its XLA path, is dots over the full square).
  * ``memory_bytes`` operand + result bytes of every op that moves data,
                     plus the bytes each kernel reads and writes (its
                     operands and outputs once, never the scores). Views,
                     metadata and allocations move none: the counterparts
                     of ``_SKIP_OPS`` / ``_NO_TRAFFIC``. There is no fusion
                     model (JAX's ``_FUSABLE``): eager PyTorch writes every
                     op's result to memory and reads it back in the next
                     op, so the count is the port's own traffic.
  * ``collective_bytes`` wire bytes per rank with ``hlo_analysis``'s ring
                     factors (``COLLECTIVES``, ``_RING``), n the size of the
                     op's process group, over the functional collectives
                     (``_c10d_functional``), the in-place ``c10d`` ones
                     that ``parallel.dtensor`` issues and DTensor's
                     all-to-all (``_dtensor.shard_dim_alltoall``, on a
                     CUDA mesh; a CPU mesh gathers instead); split by the link
                     the group spans (``by_link``: "nvlink" when every rank
                     is in one node of ``node_size`` ranks, else "nic"). A
                     collective of another kind raises.
  * ``temp_bytes``   the peak of the bytes held by storages made during the
                     call (each tracked by a weakref finalizer on its
                     storage, so it counts until its last view dies). The
                     caller adds the bytes of the state and inputs that
                     exist before it: the state is updated in place, the
                     counterpart of JAX's argument + temp - alias.

``n_whiles`` and ``trips`` have no counterpart: eager tracing runs every
layer and microbatch, unrolled, so there is no loop to multiply. The
split-f32 flash kernels' workspace (the hi/lo operand copies, sized by the
built library) is not allocated on ``meta`` and is missing from the peak;
the bf16 kernels have none.
"""
from __future__ import annotations

import json
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ring-wire factor given group size n (``repro.parallel.hlo_analysis``'s)
_RING = {
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1) / max(n, 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}

# op name -> (kind, which bytes the ring factor multiplies): the gathered
# (result) size, the scattered (input) size, or the larger of the two
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "out"),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", "out"),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", "out"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "in"),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", "in"),
    ("_c10d_functional", "all_reduce"): ("all-reduce", "max"),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "max"),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", "max"),
    ("_c10d_functional", "all_reduce_coalesced_"): ("all-reduce", "max"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "out"),
    ("c10d", "allreduce_"): ("all-reduce", "max"),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", "max"),
    ("c10d", "allgather_"): ("all-gather", "out"),
    ("c10d", "_allgather_base_"): ("all-gather", "out"),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", "out"),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", "in"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "in"),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", "in"),
    ("c10d", "alltoall_"): ("all-to-all", "out"),
    ("c10d", "alltoall_base_"): ("all-to-all", "out"),
    # DTensor's shard-to-shard redistribute on a CUDA mesh
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", "out"),
}
# the argument names of the in-place c10d ops' inputs and outputs (an
# all-reduce's ``tensors`` are both)
_C10D_IN = ("input_tensors", "input_tensor", "input", "tensors")
_C10D_OUT = ("output_tensors", "output_tensor", "output", "tensors")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")
# ops of those namespaces that move nothing over the wire
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}

# allocations: a new storage, no traffic
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}

# the matrix products: name -> flops from the (lhs, rhs) operand shapes
_GEMMS = {
    "mm": (0, lambda a, b: 2 * a[0] * a[1] * b[1]),
    "addmm": (1, lambda a, b: 2 * a[0] * a[1] * b[1]),
    "bmm": (0, lambda a, b: 2 * a[0] * a[1] * a[2] * b[2]),
    "baddbmm": (1, lambda a, b: 2 * a[0] * a[1] * a[2] * b[2]),
}
# the units a product of each dtype runs on (the port turns TF32 off, so an
# f32 product runs on the CUDA cores)
GEMM_RATE = {torch.bfloat16: "bf16", torch.float16: "bf16",
             torch.float32: "f32"}


def _tensors(x):
    """The tensors in an op's argument or result (lists and tuples
    flattened)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storage_key(t: torch.Tensor) -> int:
    return id(t.untyped_storage())


def group_ranks(group) -> tuple:
    """The global ranks of a process group, given as the group or its name
    (the functional collectives pass the name)."""
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):   # a c10d op's boxed group
        from torch._C._distributed_c10d import ProcessGroup
        group = ProcessGroup.unbox(group)
    return tuple(dist.get_process_group_ranks(group))


def _dispatches(t: type) -> bool:
    """Whether tensor type ``t`` has a ``__torch_dispatch__`` of its own (a
    DTensor, an AsyncCollectiveTensor; not a plain tensor or a Parameter)."""
    return t.__torch_dispatch__ is not torch._C._disabled_torch_dispatch_impl


class OpTrace(TorchDispatchMode):
    """Counts one call's per-rank work (the module's docstring). Use as a
    context manager around the call; ``summary()`` afterwards. ``dump``: a
    text file that gets one JSON line for every counted op. ``node_size``:
    the ranks of one node, whose collectives stay on NVLink."""

    def __init__(self, dump=None, node_size: int = 8):
        super().__init__()
        self.dump, self.node_size = dump, node_size
        self.flops_by_rate: Dict[str, float] = defaultdict(float)
        self.gemm_flops = 0.0
        self.kernel_flops = 0.0
        self.memory_bytes = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.by_link = {"nvlink": 0.0, "nic": 0.0}
        self.collective_count = 0
        self.ops = 0
        self.live = 0
        self.temp_peak = 0
        self._live: Dict[int, int] = {}
        self._prev_hook = None
        self._fake = None

    # -- context -----------------------------------------------------------
    def __enter__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from repro_torch.kernels import ops
        self._fake = FakeTensor
        self._prev_hook, ops.COST_HOOK = ops.COST_HOOK, self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.COST_HOOK = self._prev_hook
        return super().__exit__(*exc)

    def _line(self, **rec) -> None:
        if self.dump is not None:
            self.dump.write(json.dumps(rec) + "\n")

    # -- kernels (ops.COST_HOOK) -------------------------------------------
    def _kernel(self, name: str, flops: float, rate: str, read: int,
                written: int) -> None:
        self.kernel_calls[name] += 1
        self.kernel_flops += flops
        self.flops_by_rate[rate] += flops
        self.kernel_bytes += read + written
        self.memory_bytes += read + written
        self._line(op=f"kernel.{name}", flops=flops, rate=rate,
                   bytes=read + written)

    # -- storages ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> bool:
        """Start tracking the new storages among ``outs`` (those that are no
        input's); whether there was one."""
        held = {_storage_key(t) for t in ins}
        new = False
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
            new = True
        self.temp_peak = max(self.temp_peak, self.live)
        return new

    # -- ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._fake) for t in types):
            return func(*args, **kwargs)   # sharding propagation's shapes
        if any(_dispatches(t) for t in types):
            return NotImplemented          # a subclass: its local ops come back
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(isinstance(t, self._fake) for t in outs):
            return out
        ns, name = func.namespace, func.overloadpacket.__name__
        new = self._track(outs, ins)
        if (ns, name) in _COLLECTIVE_OPS or (
                ns in _COLLECTIVE_NAMESPACES and name not in _NOT_COLLECTIVES):
            self._collective(func, ns, name, args, kwargs, ins, outs)
            return out
        if name in _ALLOCS:
            return out
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if not (new or writes):
            return out                     # a view or metadata: no traffic
        nbytes = _nbytes(ins) + _nbytes(outs)
        self.memory_bytes += nbytes
        self.ops += 1
        rec = dict(op=str(func), shapes=[list(t.shape) for t in ins],
                   dtype=str(outs[0].dtype) if outs else None, bytes=nbytes)
        if ns == "aten" and name in _GEMMS:
            first, flops = _GEMMS[name]
            a, b = (t.shape for t in ins[first:first + 2])
            flops = float(flops(a, b))
            rate = GEMM_RATE.get(outs[0].dtype)
            if rate is None:
                raise ValueError(f"{func}: no peak rate for {outs[0].dtype}")
            self.gemm_flops += flops
            self.flops_by_rate[rate] += flops
            rec.update(flops=flops, rate=rate)
        self._line(**rec)
        return out

    def _collective(self, func, ns, name, args, kwargs, ins, outs) -> None:
        key = ("_c10d_functional" if ns == "_c10d_functional_autograd"
               else ns, name)
        if key not in _COLLECTIVE_OPS:
            raise ValueError(f"{func}: a collective the trace analysis does "
                             "not know")
        kind, base = _COLLECTIVE_OPS[key]
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        group = named.get("group_name", named.get("process_group"))
        ranks = group_ranks(group)
        n = len(ranks)
        if ns == "c10d":   # in place: the results are the argument lists
            src, dst = ([t for a in names if a in named
                         for t in _tensors(named[a])]
                        for names in (_C10D_IN, _C10D_OUT))
        else:
            src, dst = ins, outs
        b_in, b_out = _nbytes(src), _nbytes(dst)
        size = {"out": b_out, "in": b_in, "max": max(b_in, b_out)}[base]
        wire = _RING[kind](n) * size
        link = ("nvlink" if len({r // self.node_size for r in ranks}) <= 1
                else "nic")
        self.collectives[kind] += wire
        self.by_link[link] += wire
        self.collective_count += 1
        self.memory_bytes += b_in + b_out
        self._line(op=str(func), kind=kind, group=n, link=link, wire=wire,
                   bytes=b_in + b_out)

    # -- result --------------------------------------------------------------
    def summary(self) -> dict:
        return {
            "dot_flops": self.gemm_flops + self.kernel_flops,
            "gemm_flops": self.gemm_flops,
            "kernel_flops": self.kernel_flops,
            "flops_by_rate": dict(self.flops_by_rate),
            "memory_bytes": self.memory_bytes,
            "kernel_bytes": self.kernel_bytes,
            "collective_bytes": sum(self.collectives.values()),
            "collective_count": self.collective_count,
            "collectives": dict(self.collectives),
            "collective_bytes_by_link": dict(self.by_link),
            "kernel_calls": dict(self.kernel_calls),
            "ops": self.ops,
            "temp_bytes": self.temp_peak,
        }
