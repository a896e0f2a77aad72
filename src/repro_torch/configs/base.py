"""Architecture configuration dataclasses (the port's own copy of
``repro.configs.base``; the two must stay field-for-field identical so that
params bridged from the JAX package line up).

Every assigned architecture is expressed as an ``ArchConfig``: a repeating
*block* of per-layer specs (mixer kind + ffn kind + attention flavour) that the
model stacks ``n_blocks`` times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention flavour for one layer position within a block."""
    window: Optional[int] = None      # sliding-window size; None = global
    softcap: Optional[float] = None   # tanh logit soft-capping (gemma2)
    qk_norm: bool = False             # RMSNorm on q/k heads (qwen3)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating block."""
    mixer: str = "attn"               # "attn" | "mamba"
    ffn: str = "dense"                # "dense" | "moe" | "moe_dense" (parallel dense residual) | "none"
    attn: AttnSpec = AttnSpec()


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # d_ff of each expert defaults to ArchConfig.d_ff
    # expert_split s > 1 splits each expert's ffn into s shards stored as
    # s separate "experts" [E*s, d, f/s] so E*s can EP-shard a wider model
    # axis than E allows (grok: 8 experts * 2 = 16-way EP). Semantics are
    # identical: a token routed to expert e runs on shards e*s..e*s+s-1 and
    # the halves sum in the combine scatter. §Perf lever.
    expert_split: int = 1


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    block: Tuple[LayerSpec, ...]      # repeating pattern; len(block) | n_layers
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    # encoder-decoder (seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # attention-free archs have n_heads==0 semantics handled by block specs
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    final_softcap: Optional[float] = None   # gemma2 final-logit capping
    tie_embeddings: bool = False
    act: str = "silu"                 # mlp activation
    # whether long (>=128k) decode is supported (sub-quadratic path exists)
    subquadratic: bool = False
    # citation / provenance tag, e.g. "[arXiv:2402.19173; hf]"
    source: str = ""
    # TP padding (set by padded_for_tp; zero-masked => semantics unchanged):
    # jit in_shardings require dims divisible by the mesh axis, so heads/vocab
    # that don't divide the 16-way model axis are padded (starcoder2 36->48,
    # arctic 56->64 heads; seamless vocab 256206->256208).
    pad_heads_to: Optional[int] = None
    pad_vocab_to: Optional[int] = None

    @property
    def eff_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def eff_vocab(self) -> int:
        return self.pad_vocab_to or self.vocab

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.block) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by block "
            f"pattern length {len(self.block)}")
        return self.n_layers // len(self.block)

    @property
    def dt_rank(self) -> int:
        if self.mamba is None:
            return 0
        return self.mamba.dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return 0 if self.mamba is None else self.mamba.expand * self.d_model

    # ---- analytic parameter / FLOP accounting (used by roofline) ----------
    def layer_kinds(self) -> Sequence[LayerSpec]:
        """Full per-layer spec list (block repeated)."""
        return list(self.block) * self.n_blocks

    def param_count(self) -> int:
        """Analytic total parameter count (matches init_params exactly)."""
        d, h, kv, dh, f, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.vocab)
        total = V * d                                  # embed
        if not self.tie_embeddings:
            total += V * d                             # unembed
        total += d                                     # final norm

        def attn_params() -> int:
            return d * h * dh + 2 * d * kv * dh + h * dh * d

        def dense_ffn(ff: int) -> int:
            return 3 * d * ff                          # gated mlp (w1,w3,w2)

        def moe_ffn() -> int:
            m = self.moe
            return d * m.n_experts + m.n_experts * 3 * d * f

        def mamba_params() -> int:
            di, ds, dc, dr = (self.d_inner, self.mamba.d_state,
                              self.mamba.d_conv, self.dt_rank)
            return (d * 2 * di            # in_proj (x & z)
                    + di * dc             # depthwise conv
                    + di * (dr + 2 * ds)  # x -> dt,B,C
                    + dr * di + di        # dt_proj (+bias)
                    + di * ds + di        # A_log, D
                    + di * d)             # out_proj

        def one_layer(spec: LayerSpec) -> int:
            p = d if spec.ffn == "none" else 2 * d     # rmsnorms
            if spec.mixer == "attn":
                p += attn_params()
                if spec.attn.qk_norm:
                    p += 2 * dh
            elif spec.mixer == "mamba":
                p += mamba_params()
            if spec.ffn == "dense":
                p += dense_ffn(f)
            elif spec.ffn == "moe":
                p += moe_ffn()
            elif spec.ffn == "moe_dense":
                p += moe_ffn() + dense_ffn(f)
            return p

        dec_layers = sum(one_layer(s) for s in self.layer_kinds())
        total += dec_layers
        if self.enc_dec:
            # encoder: self-attn + dense ffn per layer; decoder adds cross-attn
            enc = self.n_enc_layers * (2 * d + attn_params() + dense_ffn(f)) + d
            cross = self.n_layers * (d + attn_params())
            total += enc + cross
        return total

    def padded_for_tp(self, tp: int) -> "ArchConfig":
        """Return a config with head/vocab padding for a tp-way model axis."""
        def up(n):
            return -(-n // tp) * tp
        kw = {}
        if self.n_heads and self.n_heads % tp != 0:
            # padded head count must stay a multiple of kv groups
            ph = up(self.n_heads)
            while ph % self.n_kv_heads != 0:
                ph += tp
            kw["pad_heads_to"] = ph
        if self.vocab % tp != 0:
            kw["pad_vocab_to"] = up(self.vocab)
        return dataclasses.replace(self, **kw) if kw else self

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_kinds()
                           if s.ffn in ("moe", "moe_dense"))
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * self.d_ff
        return full - inactive
