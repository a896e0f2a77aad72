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
    """On the CPU the wrappers take any head dim and head group, as the plain
    versions do (reduced configs have 16-dim heads). On the card the
    attention kernels take head dims up to 256 (instances at 32, 64, 128,
    192 and 256, any other width padded to the next: ``ops.built_head_dim``)
    and head groups up to 16."""
    q, k = torch.randn(1, 5, 6, 16), torch.randn(1, 5, 1, 16)
    out = ops.flash_attention(q, k, k)
    assert out.shape == q.shape
    out = ops.decode_attention(q[:, 0], k, k, torch.tensor([3], dtype=torch.int32))
    assert out.shape == (1, 6, 16)


@pytest.mark.parametrize("dtype, head_dim, variant", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 32, "split_f32"), (torch.float32, 64, "split_f32"),
    (torch.float32, 128, "split_f32"), (torch.float32, 256, "split_f32"),
    (torch.bfloat16, 192, "tensor_core"), (torch.float32, 192, "split_f32"),
    (torch.bfloat16, 16, "tensor_core"), (torch.float32, 16, "split_f32"),
    (torch.bfloat16, 48, "tensor_core"), (torch.float32, 48, "split_f32"),
    (torch.bfloat16, 80, "tensor_core"), (torch.float32, 80, "split_f32"),
    (torch.bfloat16, 257, "cluster"), (torch.float32, 320, "cluster"),
    (torch.bfloat16, 512, "cluster"), (torch.float32, 1024, "cluster"),
    (torch.float32, 704, "cluster"), (torch.bfloat16, 1025, "cuda_core"),
    (torch.float32, 2048, "cuda_core")])
def test_flash_variant_follows_dtype(dtype, head_dim, variant):
    """bf16 goes to the tensor-core kernel (flash_attention_tc.cu); f32 at
    every head dim up to 256 to the split-f32 tensor-core kernels
    (flash_attention_f32tc.cu; at D = 192 and 256 their cluster-pair
    kernels); the choice is by dtype alone, before any launch, at the built
    head dims and at the padded ones (16, 48, 80) alike. From 257 to 1024
    both dtypes take the split-f32 kernels over a cluster of N ranks
    (flash_attention_f32tc_cluster.cu), above 1024 the CUDA-core kernels
    (flash_attention_wide.cu)."""
    assert ops.flash_variant(dtype, head_dim) == variant


def test_flash_variant_refuses_other_dtypes():
    """float16 has no kernel at any head dim, the wide route's included."""
    with pytest.raises(ValueError):
        ops.flash_variant(torch.float16, 128)
    with pytest.raises(ValueError):
        ops.flash_variant(torch.float16, 320)


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


# (H, KV) and head dims of the plan's grid: groups 1 to 2048, head dims
# from 32 to the accumulator budget
_PLAN_HEADS = [(1, 1), (16, 8), (16, 1), (17, 1), (48, 8), (32, 1), (71, 1),
               (34, 2), (130, 2), (512, 1), (2048, 1), (64, 64)]
_PLAN_DIMS = (32, 64, 128, 192, 256, 320, 512, 1024, 1088, 4096, 16384)


def _pieces(S: int, n: int, least: int = 1) -> list:
    """The kernels' cut of the valid range [0, S) into n pieces, a block
    (narrow: a warp) each, of at least ``least`` keys (the group route's
    tile): [s0, s1) of piece i."""
    per = max(-(-S // n), least)
    return [(min(S, i * per), min(S, min(S, i * per) + per)) for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [16, 114, 132])
def test_decode_plan_routes_and_covers(sms, dtype):
    """``ops.decode_plan`` over a grid of shapes: the narrow kernel exactly
    when the group is at most 16 and the head dim at most 256; on the group
    route the chunks cover the group exactly once, each within the
    accumulator budget and a block's shared memory (the cluster's inbox
    included); the key pieces cover [0, S) in order without overlap; grid
    y (kv heads x chunks) stays within 65535 and the cluster within 8
    blocks."""
    el = torch.empty((), dtype=dtype).element_size()
    for B in (1, 4, 64, 300):
        for H, KV in _PLAN_HEADS:
            G = H // KV
            for D in _PLAN_DIMS:
                for S in (1, 64, 4096, 131072):
                    plan = ops.decode_plan(B, H, KV, S, D, sms, dtype)
                    narrow = G <= 16 and D <= 256
                    assert (plan.route == "narrow") == narrow, (B, H, KV, D)
                    assert 1 <= plan.cluster <= 8 and KV * plan.chunks <= 65535
                    assert plan.pieces <= 65535
                    least = 1
                    if narrow:
                        assert plan == ops.DecodePlan(
                            "narrow", G, 1, ops.decode_grid(B, KV, S, sms), 1,
                            0, 0)
                        pieces = 4 * plan.cluster   # four warps a block
                    else:
                        Gc, n = plan.head_chunk, plan.chunks
                        heads = [min(Gc, G - c * Gc) for c in range(n)]
                        assert all(h >= 1 for h in heads) and sum(heads) == G
                        assert Gc * D <= ops.GROUP_ACC_FLOATS
                        assert plan.tile_keys in (4, 8, 16, 32, 64)
                        assert plan.panel_cols == min(D, ops.GROUP_PANEL_COLS)
                        assert ops.group_smem(Gc, D, plan.tile_keys,
                                              plan.panel_cols, plan.cluster,
                                              el) <= ops.GROUP_MAX_SMEM
                        pieces, least = plan.pieces, plan.tile_keys
                        assert plan.cluster * (plan.clusters - 1) < pieces
                        assert plan.cluster <= ops.GROUP_CLUSTER == 2
                    cut = _pieces(S, pieces, least)
                    assert cut[0][0] == 0 and cut[-1][1] == S
                    assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
                    assert all(lo <= hi for lo, hi in cut)


@pytest.mark.parametrize("B, H, KV, S, D, dtype, plan", [
    # the timed shapes: D 512 over two kv heads (32 pieces of 128 keys in
    # clusters of 2: 256 blocks, one wave of two an SM), groups 32 and 71
    # over one kv head (71 heads' inbox leaves one-block clusters in f32)
    (4, 4, 2, 4096, 512, torch.float32, ("group", 2, 1, 2, 16, 16, 256)),
    (4, 32, 1, 4096, 64, torch.float32, ("group", 32, 1, 2, 16, 64, 64)),
    (4, 71, 1, 4096, 64, torch.float32, ("group", 71, 1, 1, 32, 32, 64)),
    (4, 71, 1, 4096, 64, torch.bfloat16, ("group", 71, 1, 2, 16, 32, 64)),
    # group 32 at D 512: 16384 accumulators, one chunk; 8 keys a tile for
    # shared memory in f32
    (4, 32, 1, 4096, 512, torch.float32, ("group", 32, 1, 1, 32, 8, 256)),
    # D 1024: a group of 17 cut into two chunks of 9 and 8 heads
    (1, 17, 1, 4096, 1024, torch.float32, ("group", 9, 2, 1, 32, 16, 256)),
    # the examples' servers (4 slots, max_len 128): one cluster a kv head,
    # no second merge
    (4, 4, 2, 128, 512, torch.float32, ("group", 2, 1, 2, 1, 16, 256)),
    (4, 4, 2, 128, 320, torch.float32, ("group", 2, 1, 2, 1, 16, 256)),
    (4, 32, 1, 128, 64, torch.float32, ("group", 32, 1, 2, 1, 64, 64)),
    # the serve shape stays on the narrow kernel
    (4, 16, 8, 4096, 128, torch.float32, ("narrow", 2, 1, 8, 1, 0, 0)),
])
def test_decode_plan_counts(B, H, KV, S, D, dtype, plan):
    assert ops.decode_plan(B, H, KV, S, D, 132, dtype) == ops.DecodePlan(*plan)


@pytest.mark.parametrize("B, H, KV, S, D", [
    (4, 4, 2, 128, 512), (4, 32, 1, 128, 64), (1, 17, 1, 128, 256),
    (4, 4, 2, 64, 320), (2, 24, 1, 1, 64), (16, 4, 2, 256, 512)])
def test_group_plan_short_cache_takes_one_cluster(B, H, KV, S, D):
    """A cache of at most a cluster's ``GROUP_MIN_KEYS`` keys runs one
    cluster per (slot, kv head, chunk), so no call at that cache needs the
    second merge, of as many blocks as the cluster may hold and one wave
    leaves."""
    plan = ops.group_plan(B, H, KV, S, D, 132)
    assert plan.clusters == 1 and S <= plan.cluster * ops.GROUP_MIN_KEYS
    assert plan.cluster == min(ops.GROUP_CLUSTER, 2 * 132 // (B * KV))


@pytest.mark.parametrize("n, pieces, tk, used", [
    (64, 32, 16, 4), (16, 32, 16, 1), (1, 32, 16, 1), (17, 2, 16, 2),
    (100, 32, 32, 4), (128, 2, 64, 2), (300, 32, 16, 19)])
def test_short_range_takes_the_first_pieces(n, pieces, tk, used):
    """A valid range shorter than its pieces' tiles takes the first pieces
    only, a tile each (the last one the range's end), and covers the range
    once: the later blocks (and clusters) have no key."""
    cut = _pieces(n, pieces, tk)
    busy = [(a, b) for a, b in cut if b > a]
    assert len(busy) == used and busy == cut[:used]
    assert busy[0][0] == 0 and busy[-1][1] == n
    assert all(b - a == tk for a, b in busy[:-1]) or used == 1 or \
        -(-n // pieces) > tk


@pytest.mark.parametrize("n, pieces, tk, used", [
    (4096, 32, 16, 32), (257, 32, 4, 29), (1000, 30, 32, 30),
    (4096, 16, 64, 16)])
def test_long_range_spreads_over_clusters(n, pieces, tk, used):
    """A longer valid range keeps every block it can (pieces of at least a
    tile) and the second merge."""
    assert sum(b > a for a, b in _pieces(n, pieces, tk)) == used


@pytest.mark.parametrize("D", [16448, 16416, 32768])
def test_decode_head_dim_limit(D):
    """Decode's group route holds a head's f32 accumulators in one block:
    a built head dim above 16384 (``GROUP_ACC_FLOATS``), or one that is not
    a multiple of 32, raises, on the plan and on the meta route alike."""
    with pytest.raises(ValueError, match="multiple of 32 up to 16384"):
        ops.decode_plan(4, 4, 2, 128, D, 132)
    if D % 64 == 0:   # a built width: the meta route reaches the plan
        q = torch.empty(1, 2, D, device="meta")
        k = torch.empty(1, 8, 1, D, device="meta")
        with pytest.raises(ValueError, match="multiple of 32 up to 16384"):
            ops.decode_attention(q, k, k, torch.empty(1, dtype=torch.int32,
                                                      device="meta"))


def test_decode_head_dim_16384_plans():
    """The largest head dim decode takes: one head a chunk."""
    plan = ops.decode_plan(1, 2, 1, 4096, 16384, 132)
    assert plan.route == "group" and plan.head_chunk == 1 and plan.chunks == 2


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
    """A tolerance relative to the gradient's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


# f32 first (ids case0-8), then the bf16 operands of the bf16 backward at
# its head dims: the plain backward computes the f32 math of the bf16
# operands and rounds its results to bf16, as JAX's vjp of its oracle in
# bf16 does; held at the bf16 tolerance relative to each gradient's max.
BWD_DTYPE_CASES = ([(case, "f32") for case in BWD_CASES]
                   + [(BWD_CASES[i], "bf16") for i in (0, 3, 5, 7)])


@pytest.mark.parametrize("case", BWD_DTYPE_CASES)
def test_flash_attention_backward_ref_matches_autograd_and_jax(case):
    case, dt = case
    (q, k, v, do), kw = _bwd_inputs(case)
    H, KV = q.shape[2], k.shape[2]
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dt]).requires_grad_(True)
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(TDT[dt])
    out = ref.flash_attention_ref(tq, tk, tv, **kw)
    lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(), **kw)
    got = ref.flash_attention_backward_ref(tq.detach(), tk.detach(),
                                           tv.detach(), out.detach(), lse,
                                           tdo, **kw)
    want_torch = torch.autograd.grad(out, (tq, tk, tv), tdo)

    def jf(a, b, c):
        return jref.flash_attention_ref(a, jnp.repeat(b, H // KV, axis=2),
                                        jnp.repeat(c, H // KV, axis=2), **kw)
    _, vjp = jax.vjp(jf, *(jnp.asarray(x, JDT[dt]) for x in (q, k, v)))
    want_jax = vjp(jnp.asarray(do, JDT[dt]))
    for g, wt, wj in zip(got, want_torch, want_jax):
        assert g.shape == wt.shape and g.dtype == TDT[dt] == wt.dtype
        assert wj.dtype == JDT[dt]
        _close_to_max(g.float().numpy(), wt.float().numpy(), TOL[dt])
        _close_to_max(g.float().numpy(), wj, TOL[dt])


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
# reduced sizes of the f32 cases (D = 64 / 128 / 256, GQA, causal, window
# and softcap, ragged S, Sq != Sk). cvt.rna.tf32.f32 keeps 10 mantissa bits
# (round to nearest, ties away from zero); a tf32 x tf32 product is exact in
# f32 and the sums are f32. "3xtf32" splits x = hi + lo, hi = tf32(x),
# lo = tf32(x - hi), and sums lo.hi + hi.lo + hi.hi; "tf32" is one product.
# Above D = 128 the products over the head dim (the scores q.k and dO.v) are
# summed as the kernels' clusters sum them: each rank's columns apart, then
# the partials in rank order: half 0 + half 1 at D = 256, ((p0 + p1) + p2)
# + ... at D = 320 (5 ranks of 64) and 512 (4 of 128).
SPLIT_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 128, 128, 4, 2, 128, True, None, None),   # the train path's form
    (1, 96, 96, 8, 2, 64, True, 24, 30.0),        # window and softcap
    (1, 100, 100, 4, 4, 64, True, None, None),    # ragged S
    (2, 40, 70, 4, 2, 128, False, None, None),    # Sq != Sk, no mask
    (2, 64, 64, 4, 2, 256, True, None, 50.0),     # gemma2's form
    (1, 96, 96, 4, 2, 256, True, 24, 50.0),       # a window that bites
    (1, 100, 100, 4, 2, 256, True, None, 50.0),   # ragged S
    (1, 64, 64, 4, 2, 320, True, None, None),     # 5 ranks of 64 columns
    (1, 64, 64, 2, 1, 512, True, 24, 50.0),       # 4 of 128, window, softcap
    (1, 40, 56, 2, 2, 512, False, None, None),    # Sq != Sk, no mask
]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half a unit of the 10th mantissa bit to the
    magnitude (the sign is apart in the bits) and clear the 13 bits below."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":   # bf16 operands, exact products, f32 sums
        return a.bfloat16().float() @ b.bfloat16().float()
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _cluster_ranks(D: int) -> int:
    """The ranks of a tile's cluster at built head dim D in the split-f32
    kernels (flash_attention_f32tc.cuh, split_of): 1 up to 128, a pair up
    to 256, above that N ranks of 128, else 96, else 64 columns, N <= 8."""
    if D <= 128:
        return 1
    if D <= 256:
        return 2
    return next(D // dh for dh in (128, 96, 64)
                if D % dh == 0 and D // dh <= ops.MAX_CLUSTER)


def _head_dim_matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b over the head dim (a's last axis), summed as the kernels sum
    it: above D = 128 each rank of a split-f32 cluster sums its columns,
    and the partial sums are added in rank order, ((p0 + p1) + p2) + ...;
    the bf16 kernel sums all of D in one chain of products."""
    D = a.shape[-1]
    n = 1 if mode == "bf16" else _cluster_ranks(D)
    w = D // n
    out = _matmul(a[..., :w], b[..., :w, :], mode)
    for r in range(1, n):
        out = out + _matmul(a[..., r * w:(r + 1) * w],
                            b[..., r * w:(r + 1) * w, :], mode)
    return out


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
    sc = _head_dim_matmul(qg, k.permute(0, 2, 3, 1)[:, :, None], mode) / np.sqrt(D)
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


def _ds(p, dp, delta, chain, D, order):
    """dS of ``_emulated_backward`` in ``order`` ("grad" or "factor")."""
    if order == "factor":
        g = p if chain is None else p * chain
        return (g / np.sqrt(D)) * (dp - delta[..., None])
    ds = p * (dp - delta[..., None])
    if chain is not None:
        ds = ds * chain
    return ds / np.sqrt(D)


def _emulated_backward(q, k, v, out, lse, do, mode, causal, window, softcap,
                       ds_order=None):
    """(dq, dk, dv) as ref.flash_attention_backward_ref, its five products
    in ``mode``. dS in ``ds_order``: "grad", P (dP - delta) (1 - tanh^2)
    scale, the reference's order, or "factor", g (dP - delta) with g =
    P (1 - tanh^2) scale, as the bf16 kernel forms it where its warpgroups
    split the products (the score warpgroup hands g to the one that holds
    dP): dk and dv from D = 128, dq at D = 256. By default each gradient
    takes its kernel's order."""
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
    dp = _head_dim_matmul(dog, v.permute(0, 2, 3, 1)[:, :, None], mode)
    split = mode == "bf16"
    ds_q = _ds(p, dp, delta, chain, D,
               ds_order or ("factor" if split and D == 256 else "grad"))
    ds_k = _ds(p, dp, delta, chain, D,
               ds_order or ("factor" if split and D >= 128 else "grad"))
    dq = _matmul(ds_q, k.permute(0, 2, 1, 3)[:, :, None], mode)
    dk = _matmul(ds_k.transpose(-1, -2), qg, mode).sum(2)       # [B,KV,Sk,D]
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


# The bf16 backward (csrc/flash_attention_tc_bwd.cu) emulated: its products
# take bf16 operands and sum in f32, so besides the bf16 inputs P and dS are
# rounded to bf16 before the products into dv, dk and dq; o is the bf16
# forward's (rounded), lse that of the bf16 operands in f32, and the
# gradients are rounded to bf16. Held against the f32 backward of the f32
# copies of the same operands, from the exact o, at 2e-2 of each gradient's
# largest magnitude: the check phase 2 of chip_smoke.py makes of the kernel
# on the card, here at reduced sizes of its cases (internlm2's causal GQA,
# gemma2's D = 256 with softcap, a window, seamless's non-causal group 1 and
# its cross Sq != Sk, head groups 6 and 7, ragged Sq / Sk, D = 32).
BF16_EMU_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 256, 256, 4, 2, 128, True, None, None),
    (1, 256, 256, 4, 2, 256, True, None, 50.0),
    (1, 256, 256, 4, 2, 128, True, 64, None),
    (1, 256, 256, 4, 4, 64, False, None, None),
    (1, 256, 188, 4, 4, 64, False, None, None),
    (1, 128, 128, 12, 2, 128, True, None, None),
    (1, 128, 128, 14, 2, 128, True, None, None),
    (1, 88, 125, 4, 2, 128, False, None, None),
    (1, 256, 256, 4, 2, 32, True, None, None),
    # ends inside a 128-row block: ragged Sq != Sk, a window that cuts one,
    # head groups 6 and 7, D = 32; D = 256 with Sk not a multiple of 64
    (1, 200, 150, 4, 2, 128, False, None, 30.0),
    (1, 200, 200, 4, 2, 128, True, 72, None),
    (1, 150, 150, 12, 2, 64, True, 40, None),
    (1, 100, 110, 14, 2, 32, False, None, None),
    (1, 200, 200, 4, 2, 256, True, 72, 50.0),
    (1, 125, 100, 4, 2, 256, False, None, 30.0),
]


@pytest.mark.parametrize("case", BF16_EMU_CASES)
def test_bf16_backward_emulation_meets_the_bf16_tolerance(case):
    q, k, v, do, kw = _split_inputs(case)
    q, k, v, do = (t.bfloat16().float() for t in (q, k, v, do))   # bf16 values
    exact_out = ref.flash_attention_ref(q, k, v, **kw)
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    want = ref.flash_attention_backward_ref(q, k, v, exact_out, lse, do, **kw)
    out = exact_out.bfloat16().float()
    got = _emulated_backward(q, k, v, out, lse, do, "bf16", **kw)
    for g, w in zip(got, want):
        _close_to_max(g.bfloat16().float().numpy(), w.numpy(), TOL["bf16"])
        # the roundings are there: the f32 tolerance is missed
        assert _misses(g.bfloat16().float(), w, to_max=True)


# The bf16 cluster route (head dims 320 to 1024, the kernels of
# csrc/flash_attention_f32tc.cuh with one TF32 product) emulated: a bf16
# value is exact in tf32, so Q K^T and dO V^T are one exact TF32 product
# with f32 sums, summed over the head dim in rank order; P and dS round to
# tf32 before the products into o, dv, dk and dq; o and the gradients round
# to bf16 once. Held against the f32 result of the f32 copies of the same
# operands as the card's bf16 checks hold it: the output at 2e-2 and row by
# row at ref.BF16_ROW_TOL, each gradient at 2e-2 of its largest magnitude.
BF16_CLUSTER_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (1, 64, 64, 4, 2, 320, True, None, None),
    (1, 64, 64, 2, 1, 512, True, 24, 50.0),
    (1, 40, 56, 2, 2, 576, False, None, 30.0),
]


@pytest.mark.parametrize("case", BF16_CLUSTER_CASES)
def test_bf16_one_tf32_product_meets_the_bf16_tolerance(case):
    q, k, v, do, kw = _split_inputs(case)
    q, k, v, do = (t.bfloat16().float() for t in (q, k, v, do))
    assert all(torch.equal(_tf32(t), t) for t in (q, k, v, do))
    exact = ref.flash_attention_ref(q, k, v, **kw)
    got = _emulated_forward(q, k, v, "tf32", **kw).bfloat16()
    _close(got.float().numpy(), exact.numpy(), "bf16")
    assert ref.row_error(got, exact) <= ref.BF16_ROW_TOL
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    want = ref.flash_attention_backward_ref(q, k, v, exact, lse, do, **kw)
    grads = _emulated_backward(q, k, v, got.float(), lse, do, "tf32", **kw)
    for g, w in zip(grads, want):
        _close_to_max(g.bfloat16().float().numpy(), w.numpy(), TOL["bf16"])


# Where the bf16 kernel's warpgroups split the products (dk and dv from
# D = 128, dq at D = 256) it forms dS as g (dP - delta), g = P (1 - tanh^2)
# scale handed over by the score warpgroup, where the row-split launches
# take P (dP - delta) (1 - tanh^2) scale: the same products and roundings
# to bf16 but another f32 order before the rounding of dS. Both orders meet
# the bf16 tolerance against the f32 backward, and they stay within 2e-3 of
# each gradient's largest magnitude of each other (observed: at most 1.1e-3).
@pytest.mark.parametrize("case", [c for c in BF16_EMU_CASES if c[5] >= 128]
                         + [(1, 256, 256, 4, 2, 256, True, None, None)])
def test_bf16_backward_factor_order_meets_the_tolerance_of_the_other(case):
    q, k, v, do, kw = _split_inputs(case)
    q, k, v, do = (t.bfloat16().float() for t in (q, k, v, do))
    exact_out = ref.flash_attention_ref(q, k, v, **kw)
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    want = ref.flash_attention_backward_ref(q, k, v, exact_out, lse, do, **kw)
    out = exact_out.bfloat16().float()
    new, old = (_emulated_backward(q, k, v, out, lse, do, "bf16", **kw,
                                   ds_order=order)
                for order in ("factor", "grad"))
    for a, b, w in zip(new, old, want):
        a, b = a.bfloat16().float(), b.bfloat16().float()
        _close_to_max(a.numpy(), w.numpy(), TOL["bf16"])
        _close_to_max(b.numpy(), w.numpy(), TOL["bf16"])
        scale = float(w.abs().max())
        assert float((a - b).abs().max()) <= 2e-3 * scale


# The fused scan (``ref.selective_scan_fused_ref``: a and b built and h.C
# taken per chunk of ``ref.FUSED_CHUNK`` steps), which ``ops`` runs for CPU
# tensors on the fused route and the CUDA kernels of
# ``csrc/selective_scan_fused.cu`` are held to on the card: S below, at and
# past a chunk, ragged, S = 1, d_state from 3 to 16, f32 and bf16 operands.
FUSED_CASES = [
    # (B, S, DI, DS, dtype)
    (2, 150, 12, 5, "f32"),
    (1, 64, 16, 16, "f32"),
    (2, 65, 8, 16, "f32"),
    (1, 1, 4, 3, "f32"),
    (2, 300, 24, 8, "bf16"),
    (1, 129, 40, 16, "bf16"),
]


def _fused_inputs(case, seed=9):
    """u, dt, A, Bc, Cc and dy as torch tensors (u, Bc, Cc in the case's
    dtype): dt in (0, 0.5), A = -exp(normal), as the mixer makes them."""
    B, S, DI, DS, dt_name = case
    rng = np.random.default_rng(seed)
    u, Bc, Cc = (torch.from_numpy(_np(rng, s)).to(TDT[dt_name])
                 for s in ((B, S, DI), (B, S, DS), (B, S, DS)))
    dt = torch.from_numpy(rng.uniform(0.0, 0.5, (B, S, DI)).astype(np.float32))
    A = -torch.from_numpy(np.exp(_np(rng, (DI, DS))))
    return u, dt, A, Bc, Cc, torch.from_numpy(_np(rng, (B, S, DI)))


@pytest.mark.parametrize("case", FUSED_CASES)
def test_selective_scan_fused_ref_matches_the_materialised_route(case):
    """y against a and b built at [B,S,DI,DS], the plain scan and the h.C
    einsum (the same products and the same loop: 1e-6), and against JAX's
    oracle (its associative scan) with the same einsum (2e-5 of the largest
    magnitude); each chunk's state is the materialised h before it, bit for
    bit."""
    u, dt, A, Bc, Cc, _ = _fused_inputs(case)
    y, states = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc, want_states=True)
    B, S, DI, DS, _ = case
    assert y.dtype == torch.float32 and y.shape == (B, S, DI)
    assert states.shape == (B, ref.fused_chunks(S), DI, DS)
    a = torch.exp(dt[..., None] * A)
    b = (dt * u.float())[..., None] * Bc.float()[:, :, None, :]
    h = ref.selective_scan_ref(a, b)
    want = torch.einsum("bsin,bsn->bsi", h, Cc.float())
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(states[:, 0], torch.zeros_like(states[:, 0]))
    for c in range(1, states.shape[1]):
        assert torch.equal(states[:, c], h[:, c * ref.FUSED_CHUNK - 1])
    hj = jref.selective_scan_ref(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    _close_to_max(y.numpy(), jnp.einsum("bsin,bsn->bsi", hj,
                                        jnp.asarray(Cc.float().numpy())))
    assert torch.equal(ref.selective_scan_fused_ref(u, dt, A, Bc, Cc), y)
    assert torch.equal(ops.selective_scan_fused(u, dt, A, Bc, Cc), y)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_selective_scan_fused_backward_ref_matches_autograd(case):
    """The written-out backward (each chunk recomputed from its saved
    state) against autograd through the plain forward: within 1e-6 of each
    gradient's largest magnitude in f32 (only the order of the sums over n
    and the channels differ), 2e-2 in bf16 (du, dB, dC round to bf16)."""
    u, dt, A, Bc, Cc, dy = _fused_inputs(case, seed=10)
    _, states = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc, want_states=True)
    leaves = [t.clone().requires_grad_(True) for t in (u, dt, A, Bc, Cc)]
    want = torch.autograd.grad(ref.selective_scan_fused_ref(*leaves), leaves, dy)
    got = ref.selective_scan_fused_backward_ref(u, dt, A, Bc, Cc, states, dy)
    tol = 1e-6 if case[4] == "f32" else TOL["bf16"]
    for g, w, x in zip(got, want, (u, dt, A, Bc, Cc)):
        assert g.dtype == x.dtype and g.shape == x.shape
        _close_to_max(g.float().numpy(), w.float().numpy(), tol)


@pytest.mark.parametrize("case", FUSED_CASES[:3])
def test_selective_scan_fused_grad_on_cpu_takes_the_plain_backward(
        case, monkeypatch):
    """With grad on, ``ops.selective_scan_fused`` goes through
    ``SelectiveScanFused``: its CPU forward keeps the plain forward's chunk
    states, its backward is the plain written-out backward, called once,
    launching nothing, giving its bits; an operand without grad gets
    None. Without grad, no graph."""
    u, dt, A, Bc, Cc, dy = _fused_inputs(case, seed=11)
    calls = []
    plain_bwd = ref.selective_scan_fused_backward_ref
    monkeypatch.setattr(ref, "selective_scan_fused_backward_ref",
                        lambda *x: calls.append(1) or plain_bwd(*x))
    leaves = [t.clone().requires_grad_(i != 2)
              for i, t in enumerate((u, dt, A, Bc, Cc))]
    before = dict(ops.LAUNCHES)
    out = ops.selective_scan_fused(*leaves)
    assert "SelectiveScanFused" in type(out.grad_fn).__name__
    need = [x for x in leaves if x.requires_grad]
    got = torch.autograd.grad(out, need, dy)
    assert calls == [1] and ops.LAUNCHES == before
    _, states = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc, want_states=True)
    want = plain_bwd(u, dt, A, Bc, Cc, states, dy)
    assert all(torch.equal(g, w)
               for g, w in zip(got, [w for i, w in enumerate(want) if i != 2]))
    with torch.no_grad():
        assert ops.selective_scan_fused(*leaves).grad_fn is None


@pytest.mark.parametrize("bad", ["u", "dt", "A", "rows", "dtype", "mixed",
                                 "d_state"])
def test_selective_scan_fused_rejects_bad_operands(bad):
    B, S, DI, DS = 2, 8, 4, 3
    u, dt = torch.zeros(B, S, DI), torch.zeros(B, S, DI)
    A, Bc, Cc = torch.zeros(DI, DS), torch.zeros(B, S, DS), torch.zeros(B, S, DS)
    if bad == "u":
        u = torch.zeros(B, S + 1, DI)
    elif bad == "dt":
        dt = dt.to(torch.bfloat16)
    elif bad == "A":
        A = torch.zeros(DI + 1, DS)
    elif bad == "rows":
        Cc = torch.zeros(B, S, DS + 1)
    elif bad == "dtype":
        u, Bc, Cc = u.double(), Bc.double(), Cc.double()
    elif bad == "mixed":
        Bc = Bc.to(torch.bfloat16)
    else:
        A, Bc, Cc = torch.zeros(DI, 33), torch.zeros(B, S, 33), torch.zeros(B, S, 33)
    with pytest.raises(ValueError):
        ops.selective_scan_fused(u, dt, A, Bc, Cc)


@pytest.mark.parametrize("bad", ["states", "dy_shape", "dy_dtype"])
def test_selective_scan_fused_backward_rejects_bad_operands(bad):
    B, S, DI, DS = 2, 70, 4, 3
    u, dt, dy = (torch.zeros(B, S, DI) for _ in range(3))
    A, Bc, Cc = torch.zeros(DI, DS), torch.zeros(B, S, DS), torch.zeros(B, S, DS)
    states = torch.zeros(B, ref.fused_chunks(S), DI, DS)
    if bad == "states":
        states = torch.zeros(B, 1, DI, DS)
    elif bad == "dy_shape":
        dy = torch.zeros(B, S - 1, DI)
    else:
        dy = dy.double()
    with pytest.raises(ValueError):
        ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy)


@pytest.mark.parametrize("DS,lanes", [(1, 8), (3, 8), (8, 8), (9, 16),
                                      (16, 16), (17, 32), (32, 32)])
def test_fused_lanes_and_blocks(DS, lanes):
    """A channel takes DS rounded up to 8, 16 or 32 lanes; a block of 256
    threads 256 / lanes channels, so falcon-mamba's DI 8192 at DS 16 is 512
    blocks; DS above 32 raises."""
    assert ops.fused_lanes(DS) == lanes
    per = ops.FUSED_THREADS // lanes
    assert ops.fused_blocks(8192, DS) == 8192 // per
    assert ops.fused_blocks(per + 1, DS) == 2
    assert ops.fused_blocks(8192, 16) == 512
    with pytest.raises(ValueError):
        ops.fused_lanes(33)
