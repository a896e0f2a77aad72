"""gemma2-9b [dense] — alternating local(4096)/global attention, logit
softcaps (attn 50, final 30) [arXiv:2408.00118; hf]. The repeating scan block
is the (local, global) pair. Global layers are quadratic => long_500k skipped."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab=256000,
    block=(
        LayerSpec(mixer="attn", ffn="dense",
                  attn=AttnSpec(window=4096, softcap=50.0)),
        LayerSpec(mixer="attn", ffn="dense",
                  attn=AttnSpec(window=None, softcap=50.0)),
    ),
    final_softcap=30.0,
    tie_embeddings=True,
    act="gelu",
    source="[arXiv:2408.00118; hf]",
)
