"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf]. 128 experts shard 8-per-chip over
the 16-way model axis (EP)."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000,
    block=(LayerSpec(mixer="attn", ffn="moe_dense", attn=AttnSpec()),),
    moe=MoESpec(n_experts=128, top_k=2),
    source="[hf:Snowflake/snowflake-arctic-base; hf]",
)
