"""The port's plain attention versions (``repro_torch.kernels.ref``, which the
``ops`` wrappers use for CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its pure-jnp oracles, on the same numpy inputs.

The JAX kernels take K/V expanded to the q heads (``np.repeat`` over the head
axis, as the JAX model does); the port takes them at kv heads. Tolerances are
those of ``tests/test_kernels.py``: 2e-5 for f32, 2e-2 for bf16. The CUDA
kernels themselves are held to the same plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dt):
    """The same numpy values as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(x, JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _close(got, want, dt):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])


FLASH_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype, block); the first seven
    # are tests/test_kernels.py's (KV = H), then GQA and a ragged S
    (2, 128, 4, 4, 64, True, None, None, "f32", 64),
    (1, 256, 2, 2, 128, True, 64, None, "f32", 64),
    (2, 128, 4, 4, 64, True, None, 50.0, "f32", 32),
    (1, 128, 2, 2, 64, False, None, None, "f32", 64),
    (1, 128, 2, 2, 256, True, None, None, "f32", 128),
    (2, 64, 8, 8, 64, True, 32, 30.0, "f32", 32),
    (1, 128, 2, 2, 64, True, None, None, "bf16", 64),
    (2, 64, 8, 2, 64, True, 16, 50.0, "f32", 32),      # GQA, 4 q heads per kv
    (1, 100, 4, 2, 32, True, 24, None, "f32", 100),    # ragged S (one block)
    (1, 100, 4, 2, 32, False, None, None, "bf16", 100),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_ref_matches_jax(case):
    B, S, H, KV, D, causal, window, softcap, dt, blk = case
    rng = np.random.default_rng(1)
    q, k, v = _np(rng, (B, S, H, D)), _np(rng, (B, S, KV, D)), _np(rng, (B, S, KV, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    jk_h = jnp.repeat(jk, H // KV, axis=2)
    jv_h = jnp.repeat(jv, H // KV, axis=2)
    got = ref.flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, S, H, D)
    got = got.float().numpy()
    _close(got, jops.flash_attention(jq, jk_h, jv_h, block_q=blk, block_k=blk,
                                     **kw), dt)
    _close(got, jref.flash_attention_ref(jq, jk_h, jv_h, **kw), dt)
    # on the CPU the wrapper is the plain version
    np.testing.assert_array_equal(
        ops.flash_attention(tq, tk, tv, **kw).float().numpy(), got)


DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype, block, lengths); the first four
    # are tests/test_kernels.py's (KV = H, lengths drawn in [1, S])
    (2, 256, 4, 4, 64, None, None, "f32", 64, None),
    (1, 512, 2, 2, 128, 128, None, "f32", 128, None),
    (2, 128, 8, 8, 64, None, 50.0, "f32", 32, None),
    (4, 64, 2, 2, 256, 32, None, "f32", 64, None),
    (3, 128, 8, 2, 64, 48, 30.0, "f32", 32, [1, 77, 128]),   # GQA
    (2, 128, 4, 2, 32, None, None, "bf16", 64, [5, 128]),
    (3, 64, 4, 2, 32, None, None, "f32", 64, [65, 100, 200]),  # lengths > S
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_ref_matches_jax(case):
    B, S, H, KV, D, window, softcap, dt, blk, lens = case
    rng = np.random.default_rng(2)
    q, k, v = _np(rng, (B, H, D)), _np(rng, (B, S, KV, D)), _np(rng, (B, S, KV, D))
    lengths = (np.asarray(lens, np.int32) if lens is not None
               else rng.integers(1, S + 1, (B,)).astype(np.int32))
    kw = dict(window=window, softcap=softcap)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    jk_h = jnp.repeat(jk, H // KV, axis=2)
    jv_h = jnp.repeat(jv, H // KV, axis=2)
    tl = torch.from_numpy(lengths)
    got = ref.decode_attention_ref(tq, tk, tv, tl, **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, H, D)
    got = got.float().numpy()
    jl = jnp.asarray(lengths)
    _close(got, jops.decode_attention(jq, jk_h, jv_h, jl, block_k=blk, **kw), dt)
    _close(got, jref.decode_attention_ref(jq, jk_h, jv_h, jl, **kw), dt)
    np.testing.assert_array_equal(
        ops.decode_attention(tq, tk, tv, tl, **kw).float().numpy(), got)


def test_decode_attention_no_valid_key_is_uniform():
    """lengths past S + window leave no valid key: every score is -1e30, so
    the softmax is uniform over S, as on the JAX XLA path and its oracle."""
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 2, 32, 4, 2, 32
    q, k, v = _np(rng, (B, H, D)), _np(rng, (B, S, KV, D)), _np(rng, (B, S, KV, D))
    lengths = np.asarray([S + 8, 3 * S], np.int32)
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(lengths), window=8)
    want = np.repeat(v.mean(axis=1), H // KV, axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    jwant = jref.decode_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), H // KV, axis=2),
        jnp.repeat(jnp.asarray(v), H // KV, axis=2), jnp.asarray(lengths),
        window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bad", ["heads", "dtype", "lengths", "shape"])
def test_wrappers_reject_bad_operands_on_any_device(bad):
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 16, 2, 64)
    lengths = torch.ones(2, dtype=torch.int32)
    if bad == "heads":
        q = torch.zeros(2, 3, 64)
    elif bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "lengths":
        lengths = lengths.long()
    else:
        k = torch.zeros(3, 16, 2, 64)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, k, lengths)
    if bad != "lengths":
        with pytest.raises(ValueError):
            ops.flash_attention(q[:, None], k, k)


def test_plain_versions_take_any_head_dim():
    """Only the CUDA kernels are limited to head dims 32/64/128/256 and head
    groups up to 16: on the CPU the wrappers take what the plain versions do
    (reduced configs have 16-dim heads)."""
    q, k = torch.randn(1, 5, 6, 16), torch.randn(1, 5, 1, 16)
    out = ops.flash_attention(q, k, k)
    assert out.shape == q.shape
    out = ops.decode_attention(q[:, 0], k, k, torch.tensor([3], dtype=torch.int32))
    assert out.shape == (1, 6, 16)
