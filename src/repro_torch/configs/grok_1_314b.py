"""grok-1-314b [moe] — 8 experts top-2, GQA(kv=8) [hf:xai-org/grok-1;
unverified]. With only 8 experts on a 16-way model axis, the sharding rules
use tensor-parallel-within-expert (shard expert d_ff) instead of EP — see
parallel/sharding.py."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072,
    block=(LayerSpec(mixer="attn", ffn="moe", attn=AttnSpec()),),
    moe=MoESpec(n_experts=8, top_k=2),
    source="[hf:xai-org/grok-1; unverified]",
)
