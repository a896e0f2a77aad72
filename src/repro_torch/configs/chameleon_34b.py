"""chameleon-34b [vlm] — early-fusion LM over interleaved text + VQ image
tokens [arXiv:2405.09818; unverified]. The modality frontend is a stub: the VQ
tokenizer output is precomputed ids inside the shared 65536 vocab, so the
backbone is a plain GQA decoder."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536,
    block=(LayerSpec(mixer="attn", ffn="dense", attn=AttnSpec()),),
    source="[arXiv:2405.09818; unverified]",
)
