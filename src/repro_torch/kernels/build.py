"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into an object, all at once
(one ``nvcc`` per source, started together), and the objects are linked into
one shared library with a plain C interface. The library lands in
``build/kernels/`` at the repository root under a name that carries a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
is loaded as it is. Nothing is built when this module is imported: the first
``load()`` builds, which needs ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``) and is only ever called for tensors on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # the attention entries take the true head dim, then the built one
    "repro_flash_attention_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _P),
    "repro_flash_attention_tc_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                     _P),
    "repro_flash_attention_f32tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _P),
    "repro_flash_attention_f32tc_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _F, _P),
    # the cluster route (head dims 320 to 1024) takes a dtype after D
    "repro_flash_attention_cluster": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_flash_attention_cluster_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _F, _P),
    "repro_flash_attention_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _F, _P),
    "repro_flash_attention_wide_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                       _P),
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _P),
    "repro_decode_group": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P),
    "repro_selective_scan": (_P, _P, _P, _P, _I, _I, _L, _P),
    "repro_selective_scan_step": (_P, _P, _P, _P, _L, _I, _P),
    "repro_selective_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    # the fused scan (a and b built and h.C taken in the kernel): operands,
    # then B, S, DI, DS, Bc's and Cc's strides, the dtype
    "repro_selective_scan_fused": (_P,) * 7 + (_I,) * 4 + (_L,) * 4 + (_I, _P),
    "repro_selective_scan_fused_bwd": (_P,) * 15 + (_I,) * 5 + (_L,) * 4
    + (_I, _P),
}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or PATH); "
                       "the CUDA kernels are built on the machine with the card")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile and link the library if it is not there yet.

    Returns (path, seconds spent building; 0.0 when it was already built).
    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, out)   # atomic: a concurrent build loses nothing
    return out, time.perf_counter() - t0


def build_log() -> str:
    p = library_path().with_suffix(".log")
    return p.read_text() if p.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library once and declare every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    # bytes of the split-f32 flash kernels' workspace (not a launch), up to
    # head dim 256 and on the cluster route (which also takes the dtype)
    lib.repro_flash_f32tc_workspace.argtypes = [_I] * 7
    lib.repro_flash_cluster_workspace.argtypes = [_I] * 8
    for name in ("repro_flash_f32tc_workspace", "repro_flash_cluster_workspace"):
        getattr(lib, name).restype = ctypes.c_longlong
    # the cluster route's ranks at a head dim, and how many of its clusters
    # the card holds at once (queries, not launches)
    lib.repro_flash_cluster_ranks.argtypes = [_I]
    lib.repro_flash_cluster_occupancy.argtypes = [_I] * 3
    # dynamic shared memory a block of the bf16 flash forward / backward
    # takes at a head dim (not launches)
    lib.repro_flash_tc_smem.argtypes = [_I]
    lib.repro_flash_tc_bwd_smem.argtypes = [_I, _I]
    # the decode group route's layout: a block's dynamic shared memory and
    # the floats of a cluster's record in its scratch (not launches)
    lib.repro_decode_group_smem.argtypes = [_I] * 6
    lib.repro_decode_group_record.argtypes = [_I] * 2
    # the fused scan's channel blocks (its backward's partials) and a block's
    # dynamic shared memory (not launches)
    lib.repro_selective_scan_fused_blocks.argtypes = [_I] * 2
    lib.repro_selective_scan_fused_smem.argtypes = [_I] * 3
    for name in ("repro_flash_tc_smem", "repro_flash_tc_bwd_smem",
                 "repro_selective_scan_fused_blocks",
                 "repro_selective_scan_fused_smem",
                 "repro_flash_cluster_ranks", "repro_flash_cluster_occupancy",
                 "repro_decode_group_smem", "repro_decode_group_record"):
        getattr(lib, name).restype = ctypes.c_int
    return lib
