"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 on
every other layer [arXiv:2403.19887; hf]. The repeating scan block is the
8-layer Jamba block: attention at in-block index 3 (1:7 ratio), MoE on odd
in-block indices. Sub-quadratic (Mamba + a single GQA layer per 8) => runs
long_500k."""
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec, MambaSpec,
                                MoESpec)


def _layer(i: int) -> LayerSpec:
    mixer = "attn" if i == 3 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(mixer=mixer, ffn=ffn, attn=AttnSpec())


CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    block=tuple(_layer(i) for i in range(8)),
    moe=MoESpec(n_experts=16, top_k=2),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    source="[arXiv:2403.19887; hf]",
)
