"""Per-architecture train presets: dtypes, accumulation, remat and the
strategy knobs, a copy of ``repro.launch.presets``.

``moment_dtype`` and ``grad_accum_dtype`` go into
``training.OptHParams``, ``remat`` into ``models.model.Runtime`` and
``expert_split`` into the config's ``moe``, as the JAX dry-run does with
them. ``fsdp``, ``ep``, ``microbatch``, ``dp_only_train`` and ``q_chunk``
only a mesh can honour: they are carried as data here and used by the
multi-GPU port (ROADMAP A.3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Preset:
    moment_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    remat: str = "block"
    fsdp: bool = True
    ep: bool = True
    # microbatch sequences per accumulation step; None => one seq per DP shard
    microbatch: Optional[int] = None
    q_chunk: int = 1024
    # pure-DP+FSDP training for small models (train shapes only) and
    # expert-splitting so grok's 8 experts EP-shard a 16-way axis
    dp_only_train: bool = False
    expert_split: int = 1


# >=300B configs: bf16 moments + bf16 accumulation
_BIG = Preset(moment_dtype="bfloat16", grad_accum_dtype="bfloat16",
              remat="full")

PRESETS = {
    # >=30B dense: full remat
    "chameleon-34b": Preset(remat="full"),
    "starcoder2-7b": Preset(dp_only_train=True, remat="full"),
    "internlm2-1.8b": Preset(dp_only_train=True, remat="full"),
    "qwen3-32b": Preset(remat="full"),
    "gemma2-9b": Preset(),
    "jamba-1.5-large-398b": _BIG,
    "seamless-m4t-large-v2": Preset(dp_only_train=True, remat="full"),
    # grok: 8 experts split 2-way => 16-way EP
    "grok-1-314b": dataclasses.replace(_BIG, expert_split=2),
    # 480B: blockwise-int8 AdamW moments
    "arctic-480b": dataclasses.replace(_BIG, moment_dtype="int8"),
    "falcon-mamba-7b": Preset(),
}


def preset_for(arch_name: str) -> Preset:
    return PRESETS.get(arch_name, Preset())
