"""falcon-mamba-7b [ssm] — attention-free Mamba-1, ssm_state=16
[arXiv:2410.05355; unverified]. Mamba layers ARE the mixer+ffn (no separate
MLP), matching the mamba1 architecture. Fully sub-quadratic => long_500k."""
from repro_torch.configs.base import ArchConfig, LayerSpec, MambaSpec

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=65024,
    block=(LayerSpec(mixer="mamba", ffn="none"),),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    source="[arXiv:2410.05355; unverified]",
)
