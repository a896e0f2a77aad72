"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596; hf]. The speech/text frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings [B, S_src, d_model] for the encoder; the
24-layer decoder (self+cross attention) is the assigned backbone."""
from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab=256206,
    block=(LayerSpec(mixer="attn", ffn="dense", attn=AttnSpec()),),
    enc_dec=True, n_enc_layers=24,
    source="[arXiv:2308.11596; hf]",
)
