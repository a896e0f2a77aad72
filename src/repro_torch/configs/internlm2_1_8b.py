"""internlm2-1.8b [dense] — GQA(kv=8) [arXiv:2403.17297; hf]. Also the family
used (at reduced width) by the ~100M end-to-end training example."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92544,
    block=(LayerSpec(mixer="attn", ffn="dense", attn=AttnSpec()),),
    source="[arXiv:2403.17297; hf]",
)
