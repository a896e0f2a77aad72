"""qwen3-32b [dense] — qk_norm, GQA(kv=8) [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab=151936,
    block=(LayerSpec(mixer="attn", ffn="dense", attn=AttnSpec(qk_norm=True)),),
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
