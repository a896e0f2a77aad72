"""Model assembly for every family (the decoders and the encoder-decoder),
in PyTorch.

Counterpart of ``repro.models.model``. The JAX package stacks the layers of a
block position over ``n_blocks`` and scans; here the layers are a
``ModuleList`` in execution order: layer ``n * len(cfg.block) + i`` is block
``n``'s position ``i`` (``repro_torch.bridge`` maps between the two).

Public API (the JAX signatures and layouts):
    init_params(generator, cfg, dtype, device)   -> DecoderParams
    forward(params, batch, cfg, rt)              -> (logits [B,S,V], moe aux)
    init_cache(cfg, B, S, dtype, device, cross_len)
                                                 -> [{"k","v"} or
                                                     {"conv","ssm"} per block pos,
                                                     + {"xk","xv"} for enc-dec]
    decode_step(params, cache, tokens, pos, cfg, rt) -> (logits [B,V], cache)
    logical_specs(cfg)                           -> {param name: logical axes}
    cache_logical_specs(cfg)                     -> init_cache's list, axes at leaves

Sharded runs: with ``Runtime(shard_activations=True)`` and params, batch and
cache distributed as DTensors on a ``DeviceMesh``
(``repro_torch.parallel.sharding``), ``forward`` and ``decode_step`` set the
layers' shard context (``rt.shard_ctx()`` plus the params' mesh) and clear it
on return, as the JAX ones do; the logits come back as a DTensor split on
the batch (data axes) and the vocab ("tp").

The encoder-decoder (seamless) has ``params.encoder`` (its ``layers`` and
``final_norm``) and a cross-attention (``norm_cross``, ``cross``) in every
decoder layer; ``forward`` reads the encoder's input from
``batch["frames"]`` [B, Ss, d], as the JAX code does.

``Runtime.remat`` is the JAX package's rematerialisation of the layer scan:
the unit is one block of ``len(cfg.block)`` consecutive layers, checkpointed
with ``torch.utils.checkpoint`` ("full": only the block's inputs are kept;
"block": the outputs of products with no batch dimension as well). It
changes no value: a step with remat is bitwise equal to one without.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L
from repro_torch.parallel.dtensor import is_dtensor, local_map, sharded_on

Cache = List[Dict[str, torch.Tensor]]

REMATS = ("none", "block", "full")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs. ``attn_impl`` (attention) and ``scan_impl`` (the Mamba
    recurrence): "kernel" (the hand-written CUDA kernels on the card, their
    plain versions on the CPU) or "plain" (the plain PyTorch versions
    everywhere; an explicit request for references). ``remat`` ("none",
    "block" or "full", JAX's default "block") picks what a train forward
    keeps of each block (``forward``). ``aux_loss_weight`` weighs the MoE
    load-balance loss in ``loss_fn`` and ``cross_len`` sizes the
    encoder-decoder's cross K/V cache in ``SlotServer``, as the JAX
    ``Runtime``'s fields do. ``q_chunk`` is preset data only: the port's
    attention never chunks its queries (the flash kernel streams keys).
    ``shard_activations``, ``dp_axes``, ``tp_axis`` and ``ep`` are the JAX
    fields of the activation-sharding context (``shard_ctx``); empty
    ``dp_axes`` leaves the batch unsharded, and ``ep`` picks the MoE
    experts' layout (whole experts on the tensor axis, else each expert's
    FFN dim there; ``sharding.runtime`` sets it as the rules lay out the
    weights)."""
    attn_impl: str = "kernel"
    scan_impl: str = "kernel"
    remat: str = "block"
    q_chunk: int = 1024
    aux_loss_weight: float = 0.01
    cross_len: int = 4096
    shard_activations: bool = False
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    ep: bool = True

    def __post_init__(self):
        if self.attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{L.ATTN_IMPLS}")
        if self.scan_impl not in L.SCAN_IMPLS:
            raise ValueError(f"scan_impl {self.scan_impl!r} not in "
                             f"{L.SCAN_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat {self.remat!r} not in {REMATS}")

    def shard_ctx(self):
        if not self.shard_activations:
            return None
        return {"dp": self.dp_axes if self.dp_axes else None,
                "tp": self.tp_axis or None, "ep": self.ep}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class LayerParams(nn.Module):
    AXES = {"norm1": (None,), "norm_cross": (None,), "norm2": (None,)}

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype, device,
                 with_cross: bool = False):
        super().__init__()
        self.norm1 = L.leaf((cfg.d_model,), dtype, device)
        if spec.mixer == "attn":
            self.attn = L.AttentionParams(cfg, spec.attn, dtype, device)
        else:
            self.mamba = L.MambaParams(cfg, dtype, device)
        if with_cross:
            self.norm_cross = L.leaf((cfg.d_model,), dtype, device)
            self.cross = L.AttentionParams(cfg, spec.attn, dtype, device)
        if spec.ffn != "none":
            self.norm2 = L.leaf((cfg.d_model,), dtype, device)
        if spec.ffn in ("moe", "moe_dense"):
            self.moe = L.MoEParams(cfg, dtype, device)
        if spec.ffn in ("dense", "moe_dense"):
            self.mlp = L.MLPParams(cfg, dtype, device)


# the encoder's layers: bidirectional self-attention and a dense FFN
ENC_SPEC = LayerSpec(mixer="attn", ffn="dense")


class EncoderParams(nn.Module):
    """The encoder of an encoder-decoder: ``n_enc_layers`` layers (norm1,
    attn, norm2, mlp) and its ``final_norm``."""
    AXES = {"final_norm": (None,)}

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            LayerParams(cfg, ENC_SPEC, dtype, device)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = L.leaf((cfg.d_model,), dtype, device)


class DecoderParams(nn.Module):
    """All weights of a model, leaves in the JAX package's shapes (with
    ``encoder`` for an encoder-decoder)."""
    AXES = {"embed": ("vocab", "embed"), "final_norm": (None,),
            "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        L.check_supported(cfg)
        d, V = cfg.d_model, cfg.eff_vocab
        self.embed = L.leaf((V, d), dtype, device)
        self.final_norm = L.leaf((d,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.leaf((d, V), dtype, device)
        self.layers = nn.ModuleList(
            LayerParams(cfg, spec, dtype, device, with_cross=cfg.enc_dec)
            for spec in cfg.layer_kinds())
        if cfg.enc_dec:
            self.encoder = EncoderParams(cfg, dtype, device)


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16, device=None) -> DecoderParams:
    """Seeded full-size weights made directly on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). Same distributions as ``repro.models.model``'s
    init, not the same bits. ``generator`` must live on that device."""
    dev = resolve_device(device)
    p = DecoderParams(cfg, dtype, dev)
    L.normal_(p.embed, generator, 1.0)
    p.final_norm.zero_()
    if not cfg.tie_embeddings:
        L.normal_(p.unembed, generator, 1.0 / math.sqrt(cfg.d_model))
    layers = list(p.layers)
    if cfg.enc_dec:
        p.encoder.final_norm.zero_()
        layers += list(p.encoder.layers)
    for layer in layers:
        layer.norm1.zero_()
        if hasattr(layer, "attn"):
            L.init_attention(layer.attn, generator, cfg)
        else:
            L.init_mamba(layer.mamba, generator, cfg)
        if hasattr(layer, "cross"):
            layer.norm_cross.zero_()
            L.init_attention(layer.cross, generator, cfg)
        if hasattr(layer, "norm2"):
            layer.norm2.zero_()
        if hasattr(layer, "moe"):
            L.init_moe(layer.moe, generator, cfg)
        if hasattr(layer, "mlp"):
            L.init_mlp(layer.mlp, generator, cfg)
    return p


def logical_specs(cfg: ArchConfig) -> Dict[str, tuple]:
    """{parameter name (``DecoderParams.named_parameters()``): its logical
    axes}, the tuples of the JAX init functions (each module's ``AXES``).
    The JAX tree stacks a block position's layers and adds a leading
    "layers" axis; the port keeps one module per layer, so it has none
    (``repro_torch.bridge.specs_to_jax`` maps between the two)."""
    p = DecoderParams(cfg, torch.float32, "meta")
    return {(f"{mname}.{leaf}" if mname else leaf): type(mod).AXES[leaf]
            for mname, mod in p.named_modules()
            for leaf in mod._parameters}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _no_tf32(device: torch.device) -> None:
    """f32 products on the card run in full f32, never TF32: the references
    and tolerances of this package assume it."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _ffn(layer: LayerParams, spec: LayerSpec, x: torch.Tensor,
         cfg: ArchConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + FFN(norm2(x)), and the MoE aux loss (None without MoE).

    JAX sums ``f = 0; f = f + moe; f = f + mlp; x = x + f``. Its leading
    ``0 +`` changes no value, so ``f`` starts at the first term here; the
    order of the rest, which moves bf16 bits under ``moe_dense``, is kept.
    """
    if spec.ffn == "none":
        return x, None
    h = L.rms_norm(x, L.gather_weight(layer.norm2), cfg.norm_eps)
    f = aux = None
    if spec.ffn in ("moe", "moe_dense"):
        f, aux = L.apply_moe(layer.moe, h, cfg)
    if spec.ffn in ("dense", "moe_dense"):
        mlp = _reduced(L.apply_mlp(layer.mlp, h, cfg.act))
        f = mlp if f is None else f + mlp
    return x + f, aux


def _reduced(mix: torch.Tensor) -> torch.Tensor:
    """A mixer's or FFN's output before it joins the residual stream:
    sharded, its Partial sum over "tp" reduced and the batch kept on the
    data axes (a no-op otherwise)."""
    return L._cs(mix, "dp", None, None)


def _embed(params: DecoderParams, tokens: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    embed = L.gather_weight(params.embed)
    x = _embed_sharded(embed, tokens) if is_dtensor(embed) else embed[tokens]
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _embed_sharded(embed, tokens):
    """The lookup on a vocab-split table (the tensor axis): each rank looks
    up the tokens its rows hold and gives zeros for the rest, a Partial sum
    over the axis that the caller's ``_cs`` reduces (one nonzero term per
    token)."""
    from torch.distributed.tensor import Partial
    tp = L._SHARD_CTX["tp"]
    split = sharded_on(embed, 0, tp)
    r = L._tp_coord()[0] if split else 0

    def local(el, tl):
        ids = tl - r * el.shape[0]
        inside = (ids >= 0) & (ids < el.shape[0])
        x = el[ids.clamp(0, el.shape[0] - 1)]
        return torch.where(inside[..., None], x, 0) if split else x

    pl = [Partial() if (split and n == tp) else t_pl
          for n, t_pl in zip(embed.device_mesh.mesh_dim_names,
                             tokens.placements)]
    return local_map(local, pl, embed, tokens)


def _vocab_mask(logits: torch.Tensor, cfg: ArchConfig, v0: int = 0):
    """Mask the vocab rows padded for TP (logits' first row is ``v0``)."""
    keep = (v0 + torch.arange(logits.shape[-1], device=logits.device)
            ) < cfg.vocab
    return torch.where(keep, logits, -1e30)


def _logits(params: DecoderParams, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    x = L.rms_norm(x, L.gather_weight(params.final_norm), cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, L.gather_weight(params.embed))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              L.gather_weight(params.unembed))
    logits = logits.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.eff_vocab != cfg.vocab:   # mask TP-padded vocab rows
        if is_dtensor(logits):
            split = sharded_on(logits, logits.dim() - 1, L._SHARD_CTX["tp"])
            r = L._tp_coord()[0] if split else 0
            logits = local_map(
                lambda t: _vocab_mask(t, cfg, r * t.shape[-1]),
                logits.placements, logits)
        else:
            logits = _vocab_mask(logits, cfg)
    return logits


def _encode(params: DecoderParams, frames: torch.Tensor, cfg: ArchConfig,
            rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames: [B, Ss, d], the stub frontend's embeddings -> (memory [B, Ss,
    d], its positions [1, Ss]). ``n_enc_layers`` x (rms_norm -> non-causal
    self-attention with RoPE -> rms_norm -> gated MLP), then the encoder's
    final norm. Attention goes through the flash kernel
    (``rt.attn_impl``); the JAX encoder always runs XLA attention, the same
    function. Under ``rt.remat`` "block" or "full" each encoder layer is
    checkpointed with nothing saved, as JAX's ``jax.checkpoint(enc_layer)``
    with its default policy."""
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]

    def enc_layer(layer, x):
        x = L._cs(x, "dp", None, None)
        h = L.rms_norm(x, L.gather_weight(layer.norm1), cfg.norm_eps)
        x = x + _reduced(L.apply_attention(layer.attn, h, ENC_SPEC.attn, cfg,
                                           positions, causal=False,
                                           attn_impl=rt.attn_impl))
        h = L.rms_norm(x, L.gather_weight(layer.norm2), cfg.norm_eps)
        return x + _reduced(L.apply_mlp(layer.mlp, h, cfg.act))

    x = frames
    for layer in params.encoder.layers:
        x = _remat(_in_ctx(functools.partial(enc_layer, layer)),
                   "none" if rt.remat == "none" else "full", x)
    return (L.rms_norm(x, L.gather_weight(params.encoder.final_norm),
                       cfg.norm_eps), positions)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="block"``'s policy, JAX's ``checkpoint_dots_with_no_batch_dims``:
    keep the outputs of products with no batch dimension, recompute the rest.

    Decided from what the port dispatches (a ``TorchDispatchMode`` over one
    layer of each family): every projection einsum (``bsd,dhk->bshk``,
    ``bsd,df->bsf``, the router's ``td,de->te``, Mamba's ``in_proj``,
    ``x_proj``, ``dt_proj``, ``out_proj``) reaches ``aten.bmm`` with a batch
    of 1, not ``aten.mm``; the MoE experts' ``torch.bmm`` has the expert as
    its batch (JAX's ``ecd,edf``), the materialised Mamba route's ``h.C``
    einsum ``B * S`` (the fused route, at S > 256 with S % 256 == 0, takes
    h.C inside its kernel and has no einsum), plain attention's ``B * kv``:
    those are recomputed. So the rule is ``aten.mm``, or ``aten.bmm`` whose
    batch is 1. Everything else is recomputed: norms, elementwise work, the
    gathers, and the flash and scan kernels (the fused scan's too), which
    run through ``ctypes`` inside their ``autograd.Function``s: the
    dispatcher sees only the ``torch.empty`` a kernel writes into, so no
    allocation is ever saved, and the kernel runs again in the recompute."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str, *args):
    """``fn(*args)`` checkpointed as ``remat`` says ("full": only ``args``
    kept; "block": with ``_save_products``); "none", or no grad, runs it
    as it is. The forward draws no random numbers, so no RNG state is kept
    for the recompute."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = ({} if remat == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_products)))
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _block(layers, specs, x: torch.Tensor, positions: torch.Tensor,
           memory: Optional[torch.Tensor], mem_positions: Optional[torch.Tensor],
           cfg: ArchConfig, rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of ``len(cfg.block)`` layers (JAX's ``_block_fn``): returns
    x and the block's MoE aux, summed from 0 over its layers. ``memory``
    (an encoder-decoder's) feeds each layer's cross-attention."""
    aux = torch.zeros((), device=x.device)
    for layer, spec in zip(layers, specs):
        x = L._cs(x, "dp", None, None)
        h = L.rms_norm(x, L.gather_weight(layer.norm1), cfg.norm_eps)
        if spec.mixer == "attn":
            mix = L.apply_attention(layer.attn, h, spec.attn, cfg, positions,
                                    attn_impl=rt.attn_impl)
        else:
            mix = L.apply_mamba(layer.mamba, h, cfg, scan_impl=rt.scan_impl)
        x = x + _reduced(mix)
        if memory is not None:
            h = L.rms_norm(x, L.gather_weight(layer.norm_cross), cfg.norm_eps)
            x = x + _reduced(L.apply_attention(
                layer.cross, h, spec.attn, cfg, positions,
                kv_override=(memory, mem_positions), causal=False,
                attn_impl=rt.attn_impl))
        x, a = _ffn(layer, spec, x, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: DecoderParams, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, rt: Runtime = Runtime()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V] f32, moe_aux f32 scalar: the sum of the MoE
    layers' aux losses, 0 without MoE).

    batch: {"tokens": [B,S] integer} (+ "frames": [B,Ss,d] for an
    encoder-decoder, cast to the embedding's dtype; without it a
    ``KeyError``, as in the JAX code). Attention runs through the flash
    kernel (``rt.attn_impl="kernel"``) and the Mamba recurrence through the
    scan kernel (``rt.scan_impl="kernel"``), once per layer each; an
    encoder-decoder adds one flash call per encoder layer and a non-causal
    cross-attention per decoder layer (``x + cross(norm_cross(x), memory)``
    between the mixer and the FFN), without RoPE.

    The layers run as ``cfg.n_blocks`` blocks (``_block``), each
    checkpointed as ``rt.remat`` says when grad is on (JAX checkpoints its
    scan body so). The recompute runs a block's kernels again: under either
    remat mode a train step launches each forward kernel twice (and under
    the shard context of the forward, ``_in_ctx``).

    Sharded (``rt.shard_activations`` and DTensor params, tokens split on
    the batch over the data axes): the logits come back split on the batch
    and on the vocab over "tp" (the JAX ``_cs(logits, "dp", None, "tp")``)
    and the aux loss as a DTensor.
    """
    L.check_supported(cfg)
    dev = params.embed.device
    _no_tf32(dev)
    L.set_shard_ctx(_shard_ctx(params, rt))
    try:
        tokens = batch["tokens"].to(dev)
        S = tokens.shape[1]
        positions = torch.arange(S, device=dev)[None, :]
        x = L._cs(_embed(params, tokens, cfg), "dp", None, None)
        memory = (None, None)   # (encoder output, its positions): cross's K/V
        if cfg.enc_dec:
            memory = _encode(params, batch["frames"].to(dev, x.dtype), cfg,
                             rt)
        aux = torch.zeros((), device=dev)
        nb, layers = len(cfg.block), list(params.layers)
        for n in range(cfg.n_blocks):
            run = functools.partial(_block, layers[n * nb:(n + 1) * nb],
                                    cfg.block, cfg=cfg, rt=rt)
            x, a = _remat(_in_ctx(run), rt.remat, x, positions, *memory)
            aux = aux + a
        return L._cs(_logits(params, x, cfg), "dp", None, "tp"), aux
    finally:
        L.set_shard_ctx(None)


def _shard_ctx(params: DecoderParams, rt: Runtime) -> Optional[dict]:
    """The layers' shard context: ``rt.shard_ctx()`` and the mesh of the
    params (None when the params are not DTensors)."""
    ctx = rt.shard_ctx()
    if ctx is None or not is_dtensor(params.embed):
        return None
    return dict(ctx, mesh=params.embed.device_mesh)


def _in_ctx(fn):
    """``fn`` under the shard context that is set now: a checkpointed
    block's recompute runs in the backward, after ``forward`` has cleared
    it."""
    ctx = L._SHARD_CTX
    if ctx is None:
        return fn

    def run(*args):
        prev = L._SHARD_CTX
        L.set_shard_ctx(ctx)
        try:
            return fn(*args)
        finally:
            L.set_shard_ctx(prev)
    return run


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16,
               device=None, cross_len: int = 4096) -> Cache:
    """Decode cache of zeros, as in the JAX package: per in-block position
    ``{"k","v"}`` of ``[n_blocks, B, S, kv, dh]`` for attention, or
    ``{"conv": [n_blocks, B, d_conv-1, d_inner]`` in ``dtype``, ``"ssm":
    [n_blocks, B, d_inner, d_state]`` in f32 whatever ``dtype``} for Mamba;
    an encoder-decoder adds the cross K/V ``{"xk","xv"}`` of ``[n_blocks, B,
    cross_len, kv, dh]``. Nothing fills them (the JAX package has no
    prefill from the encoder), so serving attends over ``cross_len`` zero
    keys."""
    L.check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.n_blocks
    cache = []
    for spec in cfg.block:
        if spec.mixer == "attn":
            shape = (n, B, S, cfg.n_kv_heads, cfg.d_head)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            ms = cfg.mamba
            c = {"conv": torch.zeros((n, B, ms.d_conv - 1, cfg.d_inner),
                                     dtype=dtype, device=dev),
                 "ssm": torch.zeros((n, B, cfg.d_inner, ms.d_state),
                                    dtype=torch.float32, device=dev)}
        if cfg.enc_dec:
            shape = (n, B, cross_len, cfg.n_kv_heads, cfg.d_head)
            c["xk"] = torch.zeros(shape, dtype=dtype, device=dev)
            c["xv"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache.append(c)
    return cache


def decode_step(params: DecoderParams, cache: Cache, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig, rt: Runtime = Runtime()
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: [B] integer; pos: [B] current positions.

    Returns (logits [B,V] f32, cache). The cache is updated IN PLACE (see
    ``layers.apply_attention_decode`` and ``layers.apply_mamba_decode``) and
    returned. Attention runs through the decode kernel and the Mamba state
    update through the scan kernel, once per layer each; an
    encoder-decoder's cross-attention runs the decode kernel once more per
    layer over the whole of ``xk``/``xv``, which it reads and never writes.
    An MoE FFN runs ``layers.apply_moe`` on the [B, 1, d] tokens (capacity
    from T = B) and drops its aux, as the JAX ``decode_step`` does.
    """
    L.check_supported(cfg)
    dev = params.embed.device
    _no_tf32(dev)
    L.set_shard_ctx(_shard_ctx(params, rt))
    try:
        return _decode_step(params, cache, tokens.to(dev), pos.to(dev), cfg,
                            rt)
    finally:
        L.set_shard_ctx(None)


def _decode_step(params, cache, tokens, pos, cfg, rt):
    x = _embed(params, tokens[:, None], cfg)                    # [B,1,d]
    nb = len(cfg.block)
    for idx, (layer, spec) in enumerate(zip(params.layers, cfg.layer_kinds())):
        c = cache[idx % nb]
        n = idx // nb
        x = L._cs(x, "dp", None, None)
        h = L.rms_norm(x, L.gather_weight(layer.norm1), cfg.norm_eps)
        if spec.mixer == "attn":
            mix, _, _ = L.apply_attention_decode(
                layer.attn, h, spec.attn, cfg, c["k"][n], c["v"][n], pos,
                attn_impl=rt.attn_impl)
        else:
            mix, _, _ = L.apply_mamba_decode(
                layer.mamba, h, cfg, c["conv"][n], c["ssm"][n],
                scan_impl=rt.scan_impl)
        x = x + _reduced(mix)
        if cfg.enc_dec:
            h = L.rms_norm(x, L.gather_weight(layer.norm_cross), cfg.norm_eps)
            cross, _, _ = L.apply_attention_decode(
                layer.cross, h, spec.attn, cfg, c["xk"][n], c["xv"][n], pos,
                cross=True, attn_impl=rt.attn_impl)
            x = x + _reduced(cross)
        x, _ = _ffn(layer, spec, x, cfg)
    return L._cs(_logits(params, x, cfg)[:, 0, :], "dp", "tp"), cache


def cache_logical_specs(cfg: ArchConfig):
    """``init_cache``'s list with logical axes at its leaves: batch -> data,
    kv seq -> model (SP), mamba inner -> model. The port's cache keeps the
    JAX package's stacked layout, so its leading "layers" axis stays."""
    specs = []
    for spec in cfg.block:
        if spec.mixer == "attn":
            c = {"k": ("layers", "batch", "kv_seq", None, None),
                 "v": ("layers", "batch", "kv_seq", None, None)}
        else:
            c = {"conv": ("layers", "batch", None, "inner"),
                 "ssm": ("layers", "batch", "inner", None)}
        if cfg.enc_dec:
            c["xk"] = ("layers", "batch", "kv_seq", None, None)
            c["xv"] = ("layers", "batch", "kv_seq", None, None)
        specs.append(c)
    return specs
