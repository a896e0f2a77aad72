"""The port's plain kernel versions (``repro_torch.kernels.ref``, which the
``ops`` wrappers use for CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its pure-jnp oracles, on the same numpy inputs.
The scan is held at 1e-5, as in ``tests/test_kernels.py``.

The JAX kernels take K/V expanded to the q heads (``np.repeat`` over the head
axis, as the JAX model does); the port takes them at kv heads. Tolerances are
those of ``tests/test_kernels.py``: 2e-5 for f32, 2e-2 for bf16. The CUDA
kernels themselves are held to the same plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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


SCAN_CASES = [
    # (B, S, DI, DS, chunk, block_f): tests/test_kernels.py's four, then a
    # ragged one (S = 100, F = 120 is no multiple of 1024; one JAX block)
    (2, 64, 32, 8, 16, 64),
    (1, 256, 16, 16, 32, 128),
    (3, 128, 8, 4, 128, 32),
    (1, 32, 64, 16, 32, 1024),
    (2, 100, 24, 5, 100, 120),
]


def _scan_inputs(rng, B, S, DI, DS):
    a = rng.uniform(0.5, 0.999, (B, S, DI, DS)).astype(np.float32)
    return a, _np(rng, (B, S, DI, DS))


def _jax_recurrence(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t from h0, unrolled with lax.scan over S."""
    def step(h, ab):
        h = ab[0] * h + ab[1]
        return h, h
    _, h = jax.lax.scan(step, jnp.asarray(h0),
                        (jnp.moveaxis(jnp.asarray(a), 1, 0),
                         jnp.moveaxis(jnp.asarray(b), 1, 0)))
    return jnp.moveaxis(h, 0, 1)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_selective_scan_ref_matches_jax(case):
    B, S, DI, DS, chunk, bf = case
    a, b = _scan_inputs(np.random.default_rng(4), B, S, DI, DS)
    got = ref.selective_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, DI, DS)
    got = got.numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(got, jops.selective_scan(ja, jb, chunk=chunk,
                                                        block_f=bf),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jref.selective_scan_ref(ja, jb),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ops.selective_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy(), got)


@pytest.mark.parametrize("B,S,DI,DS", [(2, 1, 32, 16), (3, 37, 24, 5),
                                       (1, 256, 16, 16)])
def test_selective_scan_ref_from_a_state_matches_jax(B, S, DI, DS):
    """With h0 the plain scan is JAX's recurrence from h0; at S = 1 it is the
    decode update ``a * ssm_state + b`` of ``apply_mamba_decode``."""
    rng = np.random.default_rng(5)
    a, b = _scan_inputs(rng, B, S, DI, DS)
    h0 = _np(rng, (B, DI, DS))
    got = ops.selective_scan(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(h0)).numpy()
    np.testing.assert_allclose(got, _jax_recurrence(a, b, h0), rtol=1e-5,
                               atol=1e-5)
    if S == 1:
        want = jnp.asarray(a[:, 0]) * jnp.asarray(h0) + jnp.asarray(b[:, 0])
        np.testing.assert_allclose(got[:, 0], want, rtol=1e-5, atol=1e-5)


# The scan's backward: the plain reverse loop (``ref.selective_scan_backward_ref``,
# which ``ops.SelectiveScan`` runs for CPU tensors and the CUDA kernel
# reproduces bit for bit) at small sizes: S = 1, S below and past the
# kernel's 8-step groups, odd F, with and without h0.
SCAN_BWD_CASES = [
    # (B, S, DI, DS, h0)
    (2, 64, 32, 8, False),
    (1, 37, 16, 16, True),
    (3, 1, 7, 3, True),
    (2, 1, 8, 4, False),
    (2, 13, 24, 5, False),
    (2, 100, 24, 5, True),
]


def _scan_grad_inputs(case, seed=6):
    B, S, DI, DS, with_h0 = case
    rng = np.random.default_rng(seed)
    a, b = _scan_inputs(rng, B, S, DI, DS)
    h0 = _np(rng, (B, DI, DS)) if with_h0 else None
    return a, b, h0, _np(rng, (B, S, DI, DS))


@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_selective_scan_backward_ref_is_autograd_bit_for_bit(case):
    """One rounded product and one rounded sum per step, in the order of
    autograd through the forward loop: the same bits (``torch.equal``)."""
    a, b, h0, dh = _scan_grad_inputs(case)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in ((a, b) if h0 is None else (a, b, h0))]
    h = ref.selective_scan_ref(*leaves)
    want = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    got = ref.selective_scan_backward_ref(
        leaves[0].detach(), h.detach(),
        None if h0 is None else leaves[2].detach(), torch.from_numpy(dh))
    assert (got[2] is None) == (h0 is None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_selective_scan_backward_ref_matches_jax_vjp(case):
    """Against jax.vjp of the JAX oracle (its associative scan, which has no
    h0): within 2e-5 of each gradient's largest magnitude."""
    B, S, DI, DS = case[:4]
    a, b, _, dh = _scan_grad_inputs((B, S, DI, DS, False), seed=7)
    h = ref.selective_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    da, db, dh0 = ref.selective_scan_backward_ref(
        torch.from_numpy(a), h, None, torch.from_numpy(dh))
    assert dh0 is None
    _, vjp = jax.vjp(jref.selective_scan_ref, jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dh))
    _close_to_max(da.numpy(), want_da)
    _close_to_max(db.numpy(), want_db)


@pytest.mark.parametrize("case", SCAN_BWD_CASES[:3])
def test_selective_scan_grad_on_cpu_takes_the_plain_backward(case,
                                                              monkeypatch):
    """With grad on, the wrapper goes through ops.SelectiveScan, whose CPU
    backward is the plain reverse loop, called once, launching nothing; the
    bits are those of autograd through the plain loop."""
    a, b, h0, dh = _scan_grad_inputs(case, seed=8)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in ((a, b) if h0 is None else (a, b, h0))]
    calls = []
    plain_bwd = ref.selective_scan_backward_ref
    monkeypatch.setattr(ref, "selective_scan_backward_ref",
                        lambda *x: calls.append(1) or plain_bwd(*x))
    before = dict(ops.LAUNCHES)
    out = ops.selective_scan(*leaves)
    assert out.grad_fn is not None and "SelectiveScan" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dh))
    assert calls == [1] and ops.LAUNCHES == before
    want = torch.autograd.grad(ref.selective_scan_ref(*leaves), leaves,
                               torch.from_numpy(dh))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.selective_scan(*leaves).grad_fn is None


@pytest.mark.parametrize("bad", ["shape", "dh", "dtype"])
def test_selective_scan_backward_rejects_bad_operands(bad):
    a = h = dh = torch.zeros(2, 4, 8, 4)
    if bad == "shape":
        h = torch.zeros(2, 4, 8, 2)
    elif bad == "dh":
        dh = torch.zeros(2, 3, 8, 4)
    else:
        dh = dh.double()
    with pytest.raises(ValueError):
        ops.selective_scan_backward(a, h, None, dh)


@pytest.mark.parametrize("bad", ["shape", "h0", "dtype"])
def test_selective_scan_rejects_bad_operands_on_any_device(bad):
    a = b = torch.zeros(2, 4, 8, 4)
    h0 = None
    if bad == "shape":
        b = torch.zeros(2, 4, 8, 2)
    elif bad == "h0":
        h0 = torch.zeros(2, 4, 8)
    else:
        a = b = a.double()
    with pytest.raises(ValueError):
        ops.selective_scan(a, b, h0)


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


@pytest.mark.parametrize("dtype, head_dim, variant", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 32, "split_f32"), (torch.float32, 64, "split_f32"),
    (torch.float32, 128, "split_f32"), (torch.float32, 256, "cuda_core")])
def test_flash_variant_follows_dtype(dtype, head_dim, variant):
    """bf16 goes to the tensor-core kernel (flash_attention_tc.cu); f32 at
    D <= 128 to the split-f32 tensor-core kernels (flash_attention_f32tc.cu),
    f32 at D = 256 to the CUDA-core ones (flash_attention.cu and
    flash_attention_bwd.cu); the choice is by dtype and head dim alone."""
    assert ops.flash_variant(dtype, head_dim) == variant


def test_flash_variant_refuses_other_dtypes():
    with pytest.raises(ValueError):
        ops.flash_variant(torch.float16, 128)


def test_row_error_sees_a_dropped_key_tile():
    """The bf16 plain output is within ``ref.BF16_ROW_TOL`` of the f32 result
    row by row, and one with a middle tile of 128 keys dropped is not."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_np(rng, s)).bfloat16()
               for s in ((1, 16, 4, 64), (1, 2048, 2, 64), (1, 2048, 2, 64)))
    kw = dict(causal=False)
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert ref.row_error(ref.flash_attention_ref(q, k, v, **kw), exact) \
        <= ref.BF16_ROW_TOL
    keep = torch.cat([torch.arange(0, 960), torch.arange(1088, 2048)])
    dropped = ref.flash_attention_ref(q, k[:, keep], v[:, keep], **kw)
    assert ref.row_error(dropped, exact) > 5 * ref.BF16_ROW_TOL


@pytest.mark.parametrize("sms", [16, 114, 132])
def test_decode_grid_fits_whole_clusters(sms):
    """The decode kernel's host-side sizing: the cluster (the blocks of one
    (kv head, slot)) holds 1 to 8 blocks, and the split never grows past
    what S or the card needs."""
    for B in (1, 2, 4, 7, 64, 300):
        for KV in (1, 2, 8, 16):
            for S in (1, 64, 255, 256, 257, 1000, 2047, 4096, 8192, 131072):
                cluster = ops.decode_grid(B, KV, S, sms)
                assert 1 <= cluster <= ops.MAX_CLUSTER == 8
                assert cluster <= max(1, -(-S // 256))
                assert cluster <= max(1, -(-2 * sms // (B * KV)))


@pytest.mark.parametrize("B, KV, S, sms, n_split", [
    (4, 8, 4096, 132, 8),    # the serve path's shape: 9 wanted, the cluster limit
    (4, 8, 4096, 114, 8),    # an H100 PCIe
    (1, 4, 2048, 132, 8),
    (2, 2, 2047, 132, 8),    # S not a multiple of the split or the ring tile
    (64, 8, 4096, 132, 1),   # enough blocks without a split
    (4, 8, 300, 132, 2),     # at least 256 keys a block
])
def test_decode_grid_split_counts(B, KV, S, sms, n_split):
    assert ops.decode_grid(B, KV, S, sms) == n_split


@pytest.mark.parametrize("S, DI, DS, h0, variant", [
    (1, 64, 16, "fresh", "step"),
    (1, 64, 16, None, "step"),
    (1, 7, 3, "fresh", "sequential"),       # F % 4 != 0
    (1, 64, 16, "offset", "sequential"),    # h0 not 16-byte aligned
    (5, 64, 16, "fresh", "sequential"),     # more than one step
])
def test_scan_variant_follows_shape_and_alignment(S, DI, DS, h0, variant):
    """The scan wrapper's choice of kernel depends on S, F and the operands'
    alignment only, so it is the same on the CPU as on the card."""
    B = 2
    a, b = torch.zeros(B, S, DI, DS), torch.zeros(B, S, DI, DS)
    if h0 == "fresh":
        h0 = torch.zeros(B, DI, DS)
    elif h0 == "offset":
        h0 = torch.zeros(B * DI * DS + 1)[1:].view(B, DI, DS)
    assert ops.scan_variant(a, b, h0) == variant


# The backward's plain version (``ref.flash_attention_backward_ref``, which
# ``ops.FlashAttention`` runs for CPU tensors) against autograd of the plain
# forward and jax.grad of the JAX oracle: chip_smoke.py's phase-2 backward
# cases at small sizes (the main path's causal GQA, D = 64 / 256, groups
# 1 / 2 / 4, window and softcap, ragged S, Sq != Sk without a mask).
BWD_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 64, 64, 4, 2, 128, True, None, None),
    (1, 48, 48, 4, 4, 64, True, None, None),
    (2, 40, 40, 8, 2, 32, True, None, None),
    (1, 32, 32, 4, 2, 256, True, None, None),
    (1, 70, 70, 8, 4, 64, True, 12, None),
    (2, 50, 50, 4, 2, 64, True, 16, 50.0),
    (1, 37, 37, 4, 2, 32, False, None, 30.0),
    (2, 20, 45, 4, 2, 64, False, None, None),
    (1, 45, 20, 4, 1, 32, False, None, None),
]


def _bwd_inputs(case, seed=4):
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    rng = np.random.default_rng(seed)
    arrs = (_np(rng, (B, Sq, H, D)), _np(rng, (B, Sk, KV, D)),
            _np(rng, (B, Sk, KV, D)), _np(rng, (B, Sq, H, D)))
    return arrs, dict(causal=causal, window=window, softcap=softcap)


def _close_to_max(got, want, tol=TOL["f32"]):
    """f32 tolerance relative to the gradient's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_backward_ref_matches_autograd_and_jax(case):
    (q, k, v, do), kw = _bwd_inputs(case)
    H, KV = q.shape[2], k.shape[2]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tdo = torch.from_numpy(do)
    out = ref.flash_attention_ref(tq, tk, tv, **kw)
    lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(), **kw)
    got = ref.flash_attention_backward_ref(tq.detach(), tk.detach(),
                                           tv.detach(), out.detach(), lse,
                                           tdo, **kw)
    want_torch = torch.autograd.grad(out, (tq, tk, tv), tdo)

    def jf(a, b, c):
        return jref.flash_attention_ref(a, jnp.repeat(b, H // KV, axis=2),
                                        jnp.repeat(c, H // KV, axis=2), **kw)
    _, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(do))
    for g, wt, wj in zip(got, want_torch, want_jax):
        assert g.shape == wt.shape and g.dtype == torch.float32
        _close_to_max(g.numpy(), wt.numpy())
        _close_to_max(g.numpy(), wj)


@pytest.mark.parametrize("case", BWD_CASES[:3] + BWD_CASES[-2:])
def test_flash_attention_lse_ref_matches_jax(case):
    (q, k, _, _), kw = _bwd_inputs(case)
    H, KV, D = q.shape[2], k.shape[2], q.shape[3]
    sc = jnp.einsum("bqhd,bkhd->bhqk", q, jnp.repeat(k, H // KV, axis=2)
                    ) / np.sqrt(D)
    if kw["softcap"] is not None:
        sc = kw["softcap"] * jnp.tanh(sc / kw["softcap"])
    if kw["causal"]:
        qpos, kpos = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None]
        mask = kpos <= qpos
        if kw["window"] is not None:
            mask &= kpos > qpos - kw["window"]
        sc = jnp.where(mask, sc, -1e30)
    want = jax.nn.logsumexp(sc, axis=-1)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                      **kw)
    _close(got.numpy(), want, "f32")


@pytest.mark.parametrize("case", BWD_CASES[:2] + BWD_CASES[5:6])
def test_flash_attention_grad_on_cpu_takes_the_plain_backward(case,
                                                              monkeypatch):
    """With grad on, the wrapper goes through ops.FlashAttention, whose CPU
    backward is the plain backward (never autograd of the plain forward)
    and launches nothing."""
    (q, k, v, do), kw = _bwd_inputs(case, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    calls = []
    plain_bwd = ref.flash_attention_backward_ref
    monkeypatch.setattr(ref, "flash_attention_backward_ref",
                        lambda *a, **k_: calls.append(1) or plain_bwd(*a, **k_))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert calls == [1] and ops.LAUNCHES == before
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw), leaves,
                               torch.from_numpy(do))
    for g, w in zip(got, want):
        _close_to_max(g.numpy(), w.numpy())


# Why the f32 flash kernels of csrc/flash_attention_f32tc.cu split each
# operand: plain-PyTorch emulations of the tensor cores' tf32 products at
# reduced sizes of the f32 cases (D = 64 / 128, GQA, causal, window and
# softcap, ragged S, Sq != Sk). cvt.rna.tf32.f32 keeps 10 mantissa bits
# (round to nearest, ties away from zero); a tf32 x tf32 product is exact in
# f32 and the sums are f32. "3xtf32" splits x = hi + lo, hi = tf32(x),
# lo = tf32(x - hi), and sums lo.hi + hi.lo + hi.hi; "tf32" is one product.
SPLIT_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 128, 128, 4, 2, 128, True, None, None),   # the train path's form
    (1, 96, 96, 8, 2, 64, True, 24, 30.0),        # window and softcap
    (1, 100, 100, 4, 4, 64, True, None, None),    # ragged S
    (2, 40, 70, 4, 2, 128, False, None, None),    # Sq != Sk, no mask
]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half a unit of the 10th mantissa bit to the
    magnitude (the sign is apart in the bits) and clear the 13 bits below."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _split_inputs(case, seed=6):
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(_np(rng, s)) for s in (
        (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))
    return q, k, v, do, dict(causal=causal, window=window, softcap=softcap)


def _emulated_scores(q, k, mode, causal, window, softcap):
    """[B,KV,G,Sq,Sk] masked scores, the product q k^T in ``mode``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).permute(0, 2, 3, 1, 4)
    sc = _matmul(qg, k.permute(0, 2, 3, 1)[:, :, None], mode) / np.sqrt(D)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    if causal:
        qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
        keep = kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        sc = torch.where(keep, sc, ref.NEG_INF)
    return sc


def _emulated_forward(q, k, v, mode, causal, window, softcap):
    B, Sq, H, D = q.shape
    p = torch.softmax(_emulated_scores(q, k, mode, causal, window, softcap), -1)
    out = _matmul(p, v.permute(0, 2, 1, 3)[:, :, None], mode)   # [B,KV,G,Sq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _emulated_backward(q, k, v, out, lse, do, mode, causal, window, softcap):
    """(dq, dk, dv) as ref.flash_attention_backward_ref, its five products
    in ``mode``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    x = _emulated_scores(q, k, mode, False, None, None)   # unmasked, uncapped
    chain = None
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x, chain = softcap * t, 1.0 - t * t
    p = torch.exp(x - lse.reshape(B, KV, G, Sq, 1))
    if causal:
        qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
        keep = kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        p = torch.where(keep, p, 0.0)
    dog = do.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)     # [B,KV,G,Sq,D]
    qg = q.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    delta = (do * out).sum(-1).reshape(B, Sq, KV, G).permute(0, 2, 3, 1)
    dp = _matmul(dog, v.permute(0, 2, 3, 1)[:, :, None], mode)
    ds = p * (dp - delta[..., None])
    if chain is not None:
        ds = ds * chain
    ds = ds / np.sqrt(D)
    dq = _matmul(ds, k.permute(0, 2, 1, 3)[:, :, None], mode)
    dk = _matmul(ds.transpose(-1, -2), qg, mode).sum(2)         # [B,KV,Sk,D]
    dv = _matmul(p.transpose(-1, -2), dog, mode).sum(2)
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def _misses(got, want, tol=TOL["f32"], to_max=False):
    got, want = got.numpy(), want.numpy()
    if to_max:
        scale = float(np.abs(want).max())
        got, want = got / scale, want / scale
    return not np.allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie: away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -20, 1.0), (3.0 * 2.0 ** -20, 3.0 * 2.0 ** -20)])
def test_tf32_emulation_rounds_to_nearest_ties_away(x, want):
    got = _tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_f32_forward_meets_the_f32_tolerance(case):
    q, k, v, _, kw = _split_inputs(case)
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = _emulated_forward(q, k, v, "3xtf32", **kw)
    _close(got.numpy(), want.numpy(), "f32")
    assert _misses(_emulated_forward(q, k, v, "tf32", **kw), want)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_f32_backward_meets_the_f32_tolerance(case):
    q, k, v, do, kw = _split_inputs(case)
    out = ref.flash_attention_ref(q, k, v, **kw)
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    want = ref.flash_attention_backward_ref(q, k, v, out, lse, do, **kw)
    got = _emulated_backward(q, k, v, out, lse, do, "3xtf32", **kw)
    for g, w in zip(got, want):
        _close_to_max(g.numpy(), w.numpy())
    one = _emulated_backward(q, k, v, out, lse, do, "tf32", **kw)
    assert all(_misses(g, w, to_max=True) for g, w in zip(one, want))
