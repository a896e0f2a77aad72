"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card every test skips. This file imports no JAX,
so it runs on a machine that has only PyTorch built for CUDA and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances as in ``tests/test_kernels.py``: 2e-5 for f32, 2e-2 for bf16,
1e-5 for the scan.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 2e-2}

# bf16 goes to the tensor-core kernel (csrc/flash_attention_tc.cu), f32 to
# the split-f32 tensor-core one (csrc/flash_attention_f32tc.cu; at D = 256
# its kernels whose blocks form cluster pairs, one per half of the head dim)
FLASH_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap, dtype)
    (2, 128, 128, 4, 4, 64, True, None, None, "f32"),
    (1, 256, 256, 2, 2, 128, True, 64, None, "f32"),
    (1, 128, 128, 2, 2, 64, False, None, None, "f32"),
    (1, 128, 128, 2, 2, 256, True, None, 50.0, "bf16"),
    (2, 64, 64, 8, 2, 64, True, 16, 50.0, "f32"),
    (1, 100, 100, 4, 2, 32, True, 24, None, "f32"),
    (1, 333, 333, 16, 8, 128, True, None, None, "bf16"),
    (1, 300, 300, 4, 2, 32, True, None, None, "bf16"),
    (2, 256, 256, 4, 4, 64, True, None, None, "bf16"),
    (1, 384, 384, 8, 2, 128, True, None, None, "bf16"),
    (1, 256, 256, 4, 2, 256, True, None, None, "bf16"),
    (2, 2048, 2048, 16, 8, 128, True, None, None, "bf16"),   # internlm2's forward
    (1, 1000, 1000, 8, 4, 64, True, None, None, "bf16"),      # ragged
    (2, 200, 333, 4, 2, 128, False, None, None, "bf16"),      # Sq != Sk, no mask
    (1, 333, 200, 4, 2, 64, False, None, 30.0, "bf16"),
    (1, 1024, 1024, 8, 4, 256, True, 256, 50.0, "bf16"),      # gemma2's form, scaled
    (1, 700, 700, 4, 2, 64, True, 48, None, "bf16"),          # window < q tile
    (1, 640, 640, 32, 2, 128, True, 200, None, "bf16"),       # head group 16
    (2, 2048, 2048, 16, 8, 128, True, None, None, "f32"),     # internlm2's train step
    (1, 1000, 1000, 8, 4, 64, True, None, None, "f32"),       # ragged
    (2, 200, 333, 4, 2, 128, False, None, None, "f32"),       # Sq != Sk, no mask
    (1, 333, 200, 4, 2, 32, False, None, 30.0, "f32"),
    (1, 640, 640, 32, 2, 128, True, 200, None, "f32"),        # head group 16
    (1, 200, 200, 4, 2, 256, True, 64, 50.0, "f32"),          # D = 256: cluster pairs
    (2, 256, 256, 8, 4, 256, True, None, 50.0, "f32"),        # gemma2's form
    (1, 333, 333, 4, 2, 256, True, 100, 50.0, "f32"),         # window, ragged
    (2, 200, 333, 4, 2, 256, False, None, None, "f32"),       # Sq != Sk, no mask
    # head groups 6 (grok: 48 / 8 heads) and 7 (arctic: 56 / 8)
    (2, 2048, 2048, 48, 8, 128, True, None, None, "bf16"),    # grok's forward
    (1, 1000, 1000, 56, 8, 128, True, None, None, "bf16"),
    (1, 333, 200, 48, 8, 64, False, None, 30.0, "bf16"),
    (1, 333, 333, 48, 8, 128, True, None, None, "f32"),
    (1, 300, 300, 56, 8, 64, False, None, None, "f32"),
    # seamless-m4t-large-v2 (head dim 64, head group 1, non-causal): its
    # encoder's self-attention and its cross-attention (Sq != Sk)
    (2, 2048, 2048, 16, 16, 64, False, None, None, "bf16"),
    (2, 2048, 1500, 16, 16, 64, False, None, None, "bf16"),
    (2, 2048, 2048, 16, 16, 64, False, None, None, "f32"),
    (1, 700, 1000, 16, 16, 64, False, None, None, "f32"),
    # bf16 at D = 256 (32-key tiles) ending inside a tile: ragged S, a window
    # that ends inside one, Sq != Sk, a single partial tile
    (1, 1000, 1000, 8, 4, 256, True, None, 50.0, "bf16"),
    (1, 1100, 1100, 8, 4, 256, True, 300, 50.0, "bf16"),
    (1, 1000, 1100, 4, 2, 256, False, None, 30.0, "bf16"),
    (1, 33, 33, 2, 1, 256, True, None, None, "bf16"),
    # D = 192 (the split-f32 pair kernels at 96 columns a block; the bf16
    # instances at 192): torch_train_e2e --big's shape, [2, 2048, 16, 192]
    # kv 8 causal with and without softcap 50 (chip_smoke.py phase 2's)
    (4, 64, 64, 4, 2, 192, True, None, None, "f32"),
    (4, 64, 64, 4, 2, 192, True, None, None, "bf16"),
    (2, 2048, 2048, 16, 8, 192, True, None, None, "f32"),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0, "f32"),
    (2, 2048, 2048, 16, 8, 192, True, None, None, "bf16"),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0, "bf16"),
    (1, 333, 200, 4, 2, 192, False, None, 30.0, "f32"),
    # the padded route (ops.built_head_dim): D 16, 48 and 80
    (4, 64, 64, 4, 2, 16, True, None, None, "f32"),
    (4, 64, 64, 4, 2, 16, True, None, None, "bf16"),
    (1, 1000, 1000, 8, 2, 48, True, 128, 30.0, "f32"),
    (1, 1000, 1000, 8, 2, 48, True, 128, 30.0, "bf16"),
    (2, 1024, 1024, 16, 8, 80, False, None, None, "f32"),
    (2, 1024, 1024, 16, 8, 80, True, None, None, "bf16"),
    # above head dim 256 (the cluster route, csrc/flash_attention_f32tc_cluster.cu,
    # up to 1024; above it the CUDA-core route, csrc/flash_attention_wide.cu):
    # launch.train --d-model 2048's head dim 512 (4 ranks of 128), 320
    # (d_model 1280: 5 ranks of 64), 576 (6 of 96), 1024 (8 of 128), a
    # padded 300 and 704 (run at 320 and 768), 1088 on the CUDA-core route;
    # head groups 24 and 17 (above the old limit of 16) on every variant
    (2, 256, 256, 4, 2, 512, True, None, None, "f32"),
    (2, 256, 256, 4, 2, 512, True, 100, 50.0, "bf16"),
    (1, 128, 128, 4, 2, 320, True, None, None, "f32"),
    (1, 100, 150, 4, 2, 300, False, None, 30.0, "f32"),
    (1, 128, 128, 2, 1, 1024, False, None, None, "bf16"),
    (1, 200, 200, 48, 2, 320, True, None, None, "bf16"),
    (1, 300, 300, 34, 2, 128, True, None, None, "bf16"),
    (1, 300, 300, 34, 2, 64, True, None, None, "f32"),
    (1, 128, 128, 4, 2, 320, True, 40, 50.0, "bf16"),
    (1, 150, 150, 4, 2, 576, True, 60, 30.0, "f32"),
    (1, 150, 150, 4, 2, 576, True, None, None, "bf16"),
    (1, 128, 128, 2, 1, 1024, True, None, 50.0, "f32"),
    (1, 100, 130, 2, 1, 704, False, None, None, "f32"),
    (1, 130, 130, 34, 2, 512, True, None, None, "f32"),
    (1, 130, 130, 48, 2, 512, True, 50, None, "bf16"),
    (1, 96, 96, 2, 1, 1088, True, None, None, "f32"),
    (1, 96, 96, 2, 1, 1088, True, None, 30.0, "bf16"),
]
# bf16 also per output row (b, q, h): its error over D relative to that row
# of the f32 result may be at most ref.BF16_ROW_TOL. rtol=atol 2e-2 alone
# would let late causal rows, whose values are ~1/sqrt(keys), be tens of
# percent off.

DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype, lengths); None -> [1, S]
    (2, 256, 4, 4, 64, None, None, "f32", None),
    (1, 512, 2, 2, 128, 128, None, "f32", None),
    (3, 128, 8, 2, 64, 48, 30.0, "f32", [1, 77, 128]),
    (2, 128, 4, 2, 32, None, None, "bf16", [5, 128]),
    (3, 64, 4, 2, 256, None, None, "f32", [65, 100, 200]),
    (2, 64, 36, 4, 128, 16, None, "f32", [64, 200]),   # group 9, no valid key
    # the cluster kernel: most splits of a cluster empty (1 and 64 keys of
    # 8 x 512), a split count at the cluster limit (8), S a multiple of
    # neither the split count nor the ring tile, head group 16 at D = 256,
    # bf16 with window and softcap, and the serve path's shape (64 valid
    # keys a slot, as at the end of a serve run, then random lengths)
    (3, 4096, 16, 8, 128, None, None, "f32", [1, 64, 4096]),
    (1, 2048, 4, 1, 64, None, None, "f32", [2048]),
    (2, 2047, 8, 2, 128, None, None, "f32", [2047, 1999]),
    (2, 4093, 8, 2, 32, 1000, None, "bf16", [4093, 3001]),
    (2, 512, 32, 2, 256, None, None, "f32", [300, 512]),
    (2, 512, 32, 2, 256, 100, 50.0, "bf16", [512, 77]),
    (2, 1024, 16, 4, 128, 200, 30.0, "bf16", [1024, 700]),
    (4, 4096, 16, 8, 128, None, None, "f32", [64, 64, 64, 64]),
    (4, 4096, 16, 8, 128, None, None, "f32", None),
    # head groups 6 (grok's serve shape) and 7 (arctic's heads): the
    # kernel's group-of-8 instance with two or one lanes idle
    (4, 4096, 48, 8, 128, None, None, "f32", [64, 64, 64, 64]),
    (4, 4096, 48, 8, 128, None, None, "f32", None),
    (2, 1024, 48, 8, 128, 300, 30.0, "bf16", [1024, 700]),
    (3, 1024, 56, 8, 128, None, None, "f32", None),
    (2, 512, 56, 8, 64, 100, 50.0, "bf16", [512, 77]),
    # seamless's serve shape (D = 64, group 1): cross-attention over the
    # whole cross cache, and self-attention at 64 keys a slot
    (4, 4096, 16, 16, 64, None, None, "f32", [4096] * 4),
    (4, 4096, 16, 16, 64, None, None, "bf16", [64] * 4),
    # D = 192 (launch.serve --d-model 768's server, then head groups 2 and
    # 6 at 64 keys and a full cache) and the padded D 16, 48 and 80
    (4, 128, 4, 2, 192, None, None, "f32", [1, 17, 128, 40]),
    (4, 4096, 16, 8, 192, None, None, "f32", [64] * 4),
    (4, 4096, 48, 8, 192, None, None, "f32", [4096] * 4),
    (4, 4096, 16, 8, 192, None, None, "bf16", [4096] * 4),
    (4, 4096, 48, 8, 192, 1000, 30.0, "bf16", [64] * 4),
    (4, 64, 4, 2, 16, 8, 50.0, "f32", [1, 17, 64, 40]),
    (4, 4096, 48, 8, 48, None, None, "bf16", [64] * 4),
    (4, 4096, 16, 8, 80, 1000, 30.0, "f32", None),
    # the group route (head dims above 256 and head groups above 16) at
    # 512 (64 keys and a full cache), 320 with a window and softcap, 1024;
    # groups 24, 32, 48 and Falcon-7B's 71 over one kv head; 17 at D 192;
    # 32 at D 512
    (4, 4096, 4, 2, 512, None, None, "f32", [64] * 4),
    (4, 4096, 4, 2, 512, None, None, "f32", [4096] * 4),
    (4, 1024, 4, 2, 320, 300, 30.0, "f32", [1100, 600, 64, 1024]),
    (4, 1024, 4, 2, 1024, None, None, "bf16", [64, 1024, 3, 1000]),
    (4, 1024, 24, 1, 64, None, None, "f32", None),
    (4, 1024, 32, 1, 64, None, None, "f32", None),
    (4, 1024, 48, 1, 64, 100, 50.0, "bf16", None),
    (4, 1024, 71, 1, 64, None, None, "f32", None),
    (2, 1024, 34, 2, 192, None, None, "f32", [1000, 64]),
    (2, 1024, 32, 1, 512, None, None, "f32", [1000, 64]),
]

# f32 flash backward against its plain version (csrc/flash_attention_f32tc.cu):
# the main path's shape, D = 32/64/256, groups 1/2/4, window and softcap,
# ragged S, Sq != Sk without a mask; at D = 256 (the cluster pairs) also
# gemma2's form, a window with ragged S and Sq != Sk
BWD_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 2048, 2048, 16, 8, 128, True, None, None),   # internlm2's train step
    (1, 256, 256, 4, 4, 64, True, None, None),       # group 1
    (2, 192, 192, 8, 2, 32, True, None, None),       # group 4
    (1, 128, 128, 4, 2, 256, True, None, None),
    (1, 300, 300, 8, 4, 64, True, 48, None),         # window, ragged
    (2, 200, 200, 4, 2, 256, True, 64, 50.0),        # gemma2's form
    (1, 130, 130, 4, 2, 128, False, None, 30.0),
    (2, 100, 333, 4, 2, 64, False, None, None),      # Sq != Sk, no mask
    (1, 333, 100, 4, 1, 128, False, None, None),
    (2, 256, 256, 8, 4, 256, True, None, 50.0),      # gemma2's form
    (1, 333, 333, 4, 2, 256, True, 100, 50.0),
    (1, 100, 333, 4, 2, 256, False, None, None),
    # seamless's train step (D = 64, group 1, non-causal; cross: Sq != Sk)
    (2, 2048, 2048, 16, 16, 64, False, None, None),
    (1, 700, 1000, 16, 16, 64, False, None, None),
    # D = 192 (the cluster pairs at 96 columns a block) and the padded D 16,
    # 48 and 80
    (4, 64, 64, 4, 2, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0),
    (1, 1000, 1000, 16, 8, 192, True, 300, 50.0),
    (1, 700, 1000, 16, 4, 192, False, None, None),
    (4, 64, 64, 4, 2, 16, True, None, None),
    (1, 1000, 1000, 16, 8, 48, True, None, None),
    (1, 700, 1000, 16, 4, 80, False, None, None),
    # above 256 (dk/dv and dq kernels): the cluster route at head dims 512,
    # 320 (window, softcap), a padded 300 (Sq != Sk), 1024, 576, head groups
    # 24 and 17; the CUDA-core route at 1088
    (2, 256, 256, 4, 2, 512, True, None, None),
    (1, 128, 128, 4, 2, 320, True, 40, 50.0),
    (1, 100, 150, 4, 2, 300, False, None, 30.0),
    (1, 128, 128, 2, 1, 1024, False, None, None),
    (1, 200, 200, 48, 2, 320, True, None, None),
    (1, 150, 150, 4, 2, 576, True, 60, 30.0),
    (1, 130, 130, 34, 2, 512, True, None, None),
    (1, 96, 96, 2, 1, 1088, True, None, None),
]
BWD_TOL = 2e-5   # relative to each gradient's largest magnitude


def assert_close_to_max(got, want, tol, what=""):
    """|got - want| <= tol * max|want| + tol * |want|: the f32 tolerance
    stated relative to the gradient's scale, which sums over up to Sq rows
    (dk, dv) or Sk keys (dq)."""
    scale = want.abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")


SCAN_CASES = [
    # (B, S, DI, DS, h0, variant); h0: None, "fresh" or "offset" (a view 4
    # bytes into a buffer, so not 16-byte aligned)
    (2, 64, 32, 8, None, "sequential"),
    (1, 256, 16, 16, "fresh", "sequential"),
    (3, 100, 24, 5, None, "sequential"),       # F = 120: one ragged block
    (4, 1, 8192, 16, "fresh", "step"),         # the decode step at full width
    (2, 13, 8, 3, "fresh", "sequential"),      # S below the unroll, odd F
    (4, 1, 8192, 16, None, "step"),
    (3, 1, 1000, 4, "fresh", "step"),          # F = 4000: a ragged block
    (3, 1, 7, 3, "fresh", "sequential"),       # F % 4 != 0
    (4, 1, 8192, 16, "offset", "sequential"),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


def _randn(g, shape, dt, card):
    return torch.randn(shape, generator=g, device=card).to(TDT[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, case):
    B, Sq, Sk, H, KV, D, causal, window, softcap, dt = case
    g = torch.Generator(device=card).manual_seed(0)
    q = _randn(g, (B, Sq, H, D), dt, card)
    k, v = (_randn(g, (B, Sk, KV, D), dt, card) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    n = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=TOL[dt], atol=TOL[dt])
    if dt == "bf16":
        exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        err = ref.row_error(got, exact)
        assert err <= ref.BF16_ROW_TOL, f"row error {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(card, case):
    B, S, H, KV, D, window, softcap, dt, lens = case
    g = torch.Generator(device=card).manual_seed(0)
    q = _randn(g, (B, H, D), dt, card)
    k, v = (_randn(g, (B, S, KV, D), dt, card) for _ in range(2))
    lengths = (torch.tensor(lens, device=card) if lens is not None else
               torch.randint(1, S + 1, (B,), generator=g, device=card)
               ).to(torch.int32)
    kw = dict(window=window, softcap=softcap)
    n = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == n + 1
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(q, k, v, lengths, **kw).float(),
        rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_lse_and_key_ranges_on_card(card, case):
    """The kernel's o is the same bits with its lse output as without; its
    lse matches the plain version's; and 2 key ranges, each launched with
    its key offset and merged by their lse, give the uncut result."""
    B, S, H, KV, D, window, softcap, dt, lens = case
    g = torch.Generator(device=card).manual_seed(2)
    q = _randn(g, (B, H, D), dt, card)
    k, v = (_randn(g, (B, S, KV, D), dt, card) for _ in range(2))
    lengths = (torch.tensor(lens, device=card) if lens is not None else
               torch.randint(1, S + 1, (B,), generator=g, device=card)
               ).to(torch.int32)
    kw = dict(window=window, softcap=softcap)
    o = ops.decode_attention(q, k, v, lengths, **kw)
    o2, lse = ops.decode_attention(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(o, o2)
    _, want = ref.decode_attention_ref(q, k, v, lengths, return_lse=True, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    cuts = (0, S // 2, S)
    parts = [ops.decode_attention(q, k[:, a:b].contiguous(),
                                  v[:, a:b].contiguous(), lengths, offset=a,
                                  return_lse=True, **kw)
             for a, b in zip(cuts, cuts[1:])]
    merged = ops.merge_attention_parts(torch.stack([x for x, _ in parts]),
                                       torch.stack([x for _, x in parts]))
    torch.testing.assert_close(merged, o.float(), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[1, 1000, 4096, 2500], [1, 1, 4096, 1]])
def test_decode_attention_is_deterministic(card, lens):
    g = torch.Generator(device=card).manual_seed(1)
    q = _randn(g, (4, 16, 128), "f32", card)
    k, v = (_randn(g, (4, 4096, 8, 128), "f32", card) for _ in range(2))
    lengths = torch.tensor(lens, device=card, dtype=torch.int32)
    first = ops.decode_attention(q, k, v, lengths)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(q, k, v, lengths), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_group_layout_matches_the_plans_copy(card, dt):
    """The C side owns the group route's layout: the plan's copy
    (``ops.group_smem``) gives the same bytes of shared memory as
    ``repro_decode_group_smem`` over the plans of a grid of shapes, and the
    scratch the wrapper sizes holds ``repro_decode_group_record`` floats a
    cluster."""
    from repro_torch.kernels import build
    lib, el = build.load(), TDT[dt].itemsize
    seen = 0
    for B in (1, 4, 64):
        for H, KV in ((17, 1), (32, 1), (71, 1), (4, 2), (48, 8), (512, 1)):
            for D in (32, 64, 128, 192, 256, 320, 512, 1024, 4096, 16384):
                plan = ops.group_plan(B, H, KV, 4096, D, 132, TDT[dt])
                Gc, tk, dc = plan.head_chunk, plan.tile_keys, plan.panel_cols
                for n in range(1, plan.cluster + 1):
                    assert lib.repro_decode_group_smem(
                        Gc, D, tk, dc, n, 0 if dt == "f32" else 1) == \
                        ops.group_smem(Gc, D, tk, dc, n, el), (plan, n)
                assert lib.repro_decode_group_record(Gc, D) == \
                    -(-Gc * (D + 2) // 4) * 4
                seen += 1
    assert seen == 180


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_selective_scan_kernel_matches_plain(card, case):
    B, S, DI, DS, h0_kind, variant = case
    g = torch.Generator(device=card).manual_seed(0)
    a = torch.rand((B, S, DI, DS), generator=g, device=card) * 0.5 + 0.499
    b = torch.randn((B, S, DI, DS), generator=g, device=card)
    h0 = None
    if h0_kind is not None:
        h0 = torch.randn((B * DI * DS + 1,), generator=g, device=card)
        h0 = (h0[1:] if h0_kind == "offset" else h0[:-1]).view(B, DI, DS)
    assert ops.scan_variant(a, b, h0) == variant
    n, nv = ops.LAUNCHES["selective_scan"], ops.SCAN_VARIANTS[variant]
    got = ops.selective_scan(a, b, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == n + 1
    assert ops.SCAN_VARIANTS[variant] == nv + 1
    assert got.dtype == torch.float32 and got.shape == a.shape
    want = ref.selective_scan_ref(a, b, h0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if S == 1:   # both variants round a * h, then + b: the plain loop's bits
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_mamba_paths_agree_on_card(card):
    """Reduced falcon-mamba: forward and decode steps through the scan kernel
    against the plain path, on the card, in f32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config("falcon-mamba-7b"), n_layers=2)
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    rt = {impl: M.Runtime(scan_impl=impl) for impl in ("kernel", "plain")}
    with torch.inference_mode():
        a, _ = M.forward(p, {"tokens": tokens}, cfg, rt["kernel"])
        b, _ = M.forward(p, {"tokens": tokens}, cfg, rt["plain"])
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        caches = {impl: M.init_cache(cfg, 2, 16, torch.float32, card)
                  for impl in rt}
        for step in range(12):
            pos = torch.full((2,), step, device=card, dtype=torch.int32)
            la, _ = M.decode_step(p, caches["kernel"], tokens[:, step], pos,
                                  cfg, rt["kernel"])
            lb, _ = M.decode_step(p, caches["plain"], tokens[:, step], pos,
                                  cfg, rt["plain"])
            torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_model_paths_agree_on_card(card):
    """A reduced decoder: forward and decode steps through the kernels
    against the plain path, on the card, in f32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config("gemma2-9b"), n_layers=2)
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    with torch.inference_mode():
        a, _ = M.forward(p, {"tokens": tokens}, cfg, M.Runtime("kernel"))
        b, _ = M.forward(p, {"tokens": tokens}, cfg, M.Runtime("plain"))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        caches = [M.init_cache(cfg, 2, 16, torch.float32, card) for _ in range(2)]
        for step in range(24):
            pos = torch.tensor([step, step + 3], device=card, dtype=torch.int32)
            la, _ = M.decode_step(p, caches[0], tokens[:, step], pos, cfg,
                                  M.Runtime("kernel"))
            lb, _ = M.decode_step(p, caches[1], tokens[:, step], pos, cfg,
                                  M.Runtime("plain"))
            torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_encdec_paths_agree_on_card(card):
    """A reduced seamless (head dim 32): forward (the encoder and the
    cross-attention through the flash kernel, non-causal) and decode steps
    (cross-attention through the decode kernel over random cross K/V)
    against the plain path, on the card, in f32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config("seamless-m4t-large-v2"), n_layers=2)
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card)
    g = torch.Generator(device=card).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=g,
                                     device=card),
             "frames": torch.randn((2, 56, cfg.d_model), generator=g,
                                   device=card)}
    rt = {impl: M.Runtime(impl) for impl in ("kernel", "plain")}
    with torch.inference_mode():
        n = ops.LAUNCHES["flash_attention"]
        a, _ = M.forward(p, batch, cfg, rt["kernel"])
        assert ops.LAUNCHES["flash_attention"] == n + cfg.n_enc_layers + 2 * cfg.n_layers
        b, _ = M.forward(p, batch, cfg, rt["plain"])
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        caches = {impl: M.init_cache(cfg, 2, 16, torch.float32, card, cross_len=24)
                  for impl in rt}
        for c_k, c_p in zip(caches["kernel"], caches["plain"]):
            for leaf in ("xk", "xv"):
                c_k[leaf].copy_(torch.randn(c_k[leaf].shape, generator=g, device=card))
                c_p[leaf].copy_(c_k[leaf])
        for step in range(20):
            pos = torch.tensor([step, step + 3], device=card, dtype=torch.int32)
            n = ops.LAUNCHES["decode_attention"]
            la, _ = M.decode_step(p, caches["kernel"], batch["tokens"][:, step], pos,
                                  cfg, rt["kernel"])
            assert ops.LAUNCHES["decode_attention"] == n + 2 * cfg.n_layers
            lb, _ = M.decode_step(p, caches["plain"], batch["tokens"][:, step], pos,
                                  cfg, rt["plain"])
            torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-5)


def _bwd_operands(card, case, seed=0):
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    g = torch.Generator(device=card).manual_seed(seed)
    q = _randn(g, (B, Sq, H, D), "f32", card)
    k, v = (_randn(g, (B, Sk, KV, D), "f32", card) for _ in range(2))
    dout = _randn(g, (B, Sq, H, D), "f32", card)
    return q, k, v, dout, dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_lse_leaves_the_output_alone(card, case):
    """The f32 forward with its lse output: o bit-identical to the call
    without it, lse against the plain log-sum-exp."""
    q, k, v, _, kw = _bwd_operands(card, case)
    plain_out = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_forward(q, k, v, kw["causal"], kw["window"],
                                  kw["softcap"], want_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(q, k, **kw),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_backward_matches_plain(card, case):
    q, k, v, dout, kw = _bwd_operands(card, case)
    out, lse = ops.flash_attention_forward(q, k, v, kw["causal"], kw["window"],
                                  kw["softcap"], want_lse=True)
    n = ops.LAUNCHES["flash_attention_backward"]
    got = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_backward"] == n + 1
    want = ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert_close_to_max(a, b, BWD_TOL, name)
    again = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES[1:])
def test_flash_attention_autograd_on_card(card, case):
    """ops.flash_attention with grad: the forward and backward kernels, one
    counted launch each, against autograd of the plain version."""
    q, k, v, dout, kw = _bwd_operands(card, case, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = dict(ops.LAUNCHES)
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_backward"]
            == n["flash_attention_backward"] + 1)
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw), leaves,
                               dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close_to_max(a, b, BWD_TOL, name)


@pytest.mark.cuda
def test_bare_flash_kernel_call_refuses_grad(card):
    """A bare forward-kernel call with grad raises in either dtype and names
    ops.FlashAttention; through the wrapper a bf16 operand with grad takes
    that route (the bf16 forward with its lse, then the bf16 backward)."""
    q = torch.randn(1, 64, 4, 64, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=card)
    qb = q.detach().bfloat16().requires_grad_(True)
    for qq, kk in ((q, k), (qb, k.bfloat16())):
        with pytest.raises(NotImplementedError, match="FlashAttention"):
            ops.flash_attention_forward(qq, kk, kk, True, None, None,
                                        want_lse=True)
    n = dict(ops.LAUNCHES)
    out = ops.flash_attention(qb, k.bfloat16(), k.bfloat16())
    assert "FlashAttention" in type(out.grad_fn).__name__
    (dq,) = torch.autograd.grad(out, (qb,), torch.ones_like(out))
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and bool(dq.isfinite().all())
    assert ops.LAUNCHES["flash_attention"] == n["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_backward"]
            == n["flash_attention_backward"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("D, variant", [(64, "split_f32"), (128, "split_f32"),
                                        (256, "split_f32"), (192, "split_f32"),
                                        (48, "split_f32"), (200, "split_f32"),
                                        (320, "cluster"), (512, "cluster"),
                                        (300, "cluster"), (1088, "cuda_core")])
def test_f32_flash_runs_the_variant_of_its_head_dim(card, D, variant):
    """The f32 forward and backward at head dim D run the kernels of
    ops.flash_variant (before the launch) at ops.flash_built_head_dim: their
    device kernels are the ones the profiler records, the cluster-pair
    kernels of 192 or 256 columns there, the one-block kernels below them,
    the N-rank cluster kernels from 257 to 1024 and the CUDA-core kernels
    above, never another set."""
    from torch.profiler import ProfilerActivity, profile
    sets = {w: tuple(f"flash_f32tc_{k}_d{w}_kernel" for k in ("fwd", "dkdv", "dq"))
            for w in (192, 256)}
    sets[0] = ("flash_f32tc_fwd_kernel", "flash_f32tc_dkdv_kernel",
               "flash_f32tc_dq_kernel")
    sets["cluster"] = tuple(f"flash_f32tc_{k}_cluster_kernel"
                            for k in ("fwd", "dkdv", "dq"))
    sets["cuda_core"] = ("flash_wide_fwd_kernel", "flash_wide_dkdv_kernel",
                         "flash_wide_dq_kernel")
    built = ops.flash_built_head_dim(torch.float32, D)
    names = sets.pop(variant if variant in sets
                     else built if built in sets else 0)
    other = [n for rest in sets.values() for n in rest]
    assert ops.flash_variant(torch.float32, D) == variant
    q, k, v, dout, kw = _bwd_operands(card, (1, 128, 128, 4, 2, D, True, None,
                                             None))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = ops.flash_attention_forward(q, k, v, True, None, None,
                                               want_lse=True)
        ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
    seen = " ".join(ev.key for ev in prof.key_averages())
    assert all(n in seen for n in names), seen
    assert not any(n in seen for n in other), seen


@pytest.mark.cuda
def test_f32_flash_d256_is_bitwise_repeatable(card):
    """At D = 256 both blocks of a pair sum the scores in one order: the
    forward (with and without lse) and the backward give the same bits on
    every call, as the trainer's resume check (==) needs."""
    q, k, v, dout, kw = _bwd_operands(card, (2, 333, 333, 8, 4, 256, True,
                                             100, 50.0))
    runs = []
    for _ in range(2):
        out, lse = ops.flash_attention_forward(q, k, v, True, 100, 50.0,
                                               want_lse=True)
        grads = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        runs.append((ops.flash_attention(q, k, v, **kw), out, lse, *grads))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][0], runs[0][1])   # o unchanged by lse


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [320, 512, 576, 1024])
def test_cluster_flash_is_bitwise_repeatable(card, D, dt):
    """Above 256 every rank of a cluster (ranks of 64, 128, 96 and 128
    columns here) sums the partial scores in rank order: the forward (with
    and without lse) and the backward give the same bits on every call, and
    every rank's columns of o hold to the plain version (ranks that
    disagreed on a score would weigh their column slices differently)."""
    q, k, v, dout, kw = _bwd_operands(card, (1, 200, 200, 4, 2, D, True, 90,
                                             30.0))
    q, k, v, dout = (t.to(TDT[dt]) for t in (q, k, v, dout))
    assert ops.flash_variant(q.dtype, D) == "cluster"
    runs = []
    for _ in range(2):
        out, lse = ops.flash_attention_forward(q, k, v, True, 90, 30.0,
                                               want_lse=True)
        grads = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        runs.append((ops.flash_attention(q, k, v, **kw), out, lse, *grads))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][0], runs[0][1])   # o unchanged by lse
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    dh = D // ops.build.load().repro_flash_cluster_ranks(D)
    for r in range(D // dh):   # each rank's columns
        cols = slice(r * dh, (r + 1) * dh)
        torch.testing.assert_close(runs[0][0][..., cols].float(),
                                   want[..., cols], rtol=TOL[dt], atol=TOL[dt])


# bf16 flash backward (csrc/flash_attention_tc_bwd.cu) against the plain
# backward on f32 copies of the same bf16 operands, given the plain f32
# forward's o and lse: every head dim (row and product splits of a block's
# two warpgroups),
# causal and not, softcap, window, ragged S, Sq != Sk, head groups 1-16.
BF16_BWD_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (1, 128, 128, 4, 2, 32, True, None, None),
    (2, 200, 200, 4, 4, 64, False, None, None),
    (1, 256, 256, 8, 4, 128, True, None, None),
    (1, 256, 256, 4, 2, 256, True, None, 50.0),
    (1, 300, 300, 8, 4, 64, True, 48, None),          # window, ragged
    (2, 200, 200, 4, 2, 256, True, 64, 50.0),         # gemma2's form
    (1, 130, 130, 4, 2, 128, False, None, 30.0),
    (2, 100, 333, 4, 2, 64, False, None, None),       # Sq != Sk, no mask
    (1, 333, 100, 4, 1, 128, False, None, None),
    (1, 100, 333, 4, 2, 256, False, None, None),
    (1, 333, 333, 48, 8, 128, True, None, None),      # head group 6
    (1, 300, 300, 56, 8, 128, True, None, None),      # head group 7
    (1, 256, 256, 32, 2, 64, True, 100, None),        # head group 16
    (1, 700, 1000, 8, 4, 128, False, None, None),     # ragged Sq / Sk
    (2, 2048, 2048, 16, 8, 128, True, None, None),    # internlm2's train step
]
# shapes that end inside a block (128 rows, 64 a warpgroup, a step with no
# kept pair of a warpgroup skipped: dk/dv below D = 128, dq below 256; else
# 64 rows, the two warpgroups splitting the products): Sq, Sk multiples of
# neither 128 nor each other, a window that cuts a 128-key block, head
# groups 6 and 7 there, D = 32, D = 256 with Sk not a multiple of 64, a
# block whose second warpgroup has no row, Sq below one block
BF16_BWD_EDGE_CASES = [
    (1, 1000, 1000, 8, 4, 128, True, None, None),
    (1, 1100, 1000, 8, 4, 128, False, None, 30.0),
    (1, 1100, 1100, 8, 4, 128, True, 200, None),
    (1, 1100, 1100, 48, 8, 64, True, 300, None),
    (1, 1000, 1100, 56, 8, 64, False, None, None),
    (1, 1100, 1100, 8, 2, 32, True, 100, None),
    (1, 1000, 1000, 8, 4, 256, True, None, 50.0),
    (1, 1100, 1000, 8, 4, 256, False, None, 30.0),
    (1, 300, 300, 4, 2, 256, True, 100, 50.0),
    (1, 60, 60, 4, 2, 128, True, None, None),
    (1, 64, 200, 4, 2, 64, False, None, None),
    # D = 192 (dk/dv and dq both splitting the products of 64 rows) and the
    # padded D 16, 48 and 80
    (4, 64, 64, 4, 2, 192, True, None, None),
    (2, 2048, 2048, 16, 8, 192, True, None, 50.0),
    (1, 1100, 1100, 48, 8, 192, True, 200, None),
    (1, 1000, 1100, 16, 8, 192, False, None, 30.0),
    (4, 64, 64, 4, 2, 16, True, None, None),
    (1, 1000, 1000, 16, 8, 48, True, None, None),
    (1, 1100, 1000, 16, 8, 80, False, None, 30.0),
    # above 256 in bf16: the cluster route at head dims 512 (softcap), 320
    # (a window, head group 24), a padded 300 (Sq != Sk), 576, 1024 and head
    # group 17; the CUDA-core route at 1088
    (2, 256, 256, 4, 2, 512, True, None, 50.0),
    (1, 200, 200, 48, 2, 320, True, 50, None),
    (1, 100, 150, 4, 2, 300, False, None, None),
    (1, 150, 150, 4, 2, 576, True, None, 30.0),
    (1, 128, 128, 2, 1, 1024, True, 40, None),
    (1, 130, 130, 34, 2, 512, True, None, None),
    (1, 96, 96, 2, 1, 1088, True, None, None),
]
BF16_BWD_TOL = 2e-2   # relative to each gradient's largest magnitude
BF16_LSE_TOL = 1e-3


def _bf16_bwd_operands(card, case, seed=0):
    """bf16 q, k, v, dO and the f32 reference grads of their f32 copies
    (the plain backward from the plain f32 forward's o and lse)."""
    q, k, v, dout, kw = _bwd_operands(card, case, seed)
    qb, kb, vb, db = (t.bfloat16() for t in (q, k, v, dout))
    f32 = [t.float() for t in (qb, kb, vb, db)]
    out = ref.flash_attention_ref(*f32[:3], **kw)
    lse = ref.flash_attention_lse_ref(*f32[:2], **kw)
    want = ref.flash_attention_backward_ref(*f32[:3], out, lse, f32[3], **kw)
    return (qb, kb, vb, db), want, lse, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_BWD_CASES + BF16_BWD_EDGE_CASES)
def test_bf16_flash_backward_matches_plain(card, case):
    """The bf16 forward with lse (o the same bits as without it, lse within
    1e-3 of the f32 one), then the bf16 backward: each gradient within 2e-2
    of its largest magnitude of the f32 reference, and a second call the
    same bits."""
    (q, k, v, dout), want, lse_want, kw = _bf16_bwd_operands(card, case)
    plain_out = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_forward(q, k, v, kw["causal"], kw["window"],
                                           kw["softcap"], want_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    torch.testing.assert_close(lse, lse_want, rtol=BF16_LSE_TOL,
                               atol=BF16_LSE_TOL)
    n = ops.LAUNCHES["flash_attention_backward"]
    got = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_backward"] == n + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert_close_to_max(a.float(), b, BF16_BWD_TOL, name)
    again = ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_BWD_CASES[:4] + BF16_BWD_EDGE_CASES[:9:2])
def test_bf16_flash_autograd_on_card(card, case):
    """ops.flash_attention on bf16 leaves with grad: the bf16 forward and
    backward kernels, one counted launch each, within 2e-2 of each
    gradient's max of the f32 reference."""
    (q, k, v, dout), want, _, kw = _bf16_bwd_operands(card, case, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = dict(ops.LAUNCHES)
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_backward"]
            == n["flash_attention_backward"] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert_close_to_max(a.float(), b, BF16_BWD_TOL, name)


@pytest.mark.cuda
def test_bare_scan_kernel_call_refuses_grad(card):
    """The scan's forward kernel called bare with grad raises, and its
    message names the differentiable route (ops.SelectiveScan), as the flash
    kernel's names ops.FlashAttention."""
    a = torch.rand(1, 4, 8, 4, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="SelectiveScan") as e:
        ops.selective_scan_forward(a, torch.rand(1, 4, 8, 4, device=card))
    assert "FlashAttention" not in str(e.value)


# The scan's backward kernel against the plain reverse loop, bit for bit:
# chip_smoke.py's phase-2 cases (falcon-mamba's train shape, a ragged F with
# h0 and S one past a multiple of the 8-step groups, a small odd F, S below
# one group, an h0 4 bytes into its buffer, S = 1 with and without h0)
SCAN_BWD_CASES = [
    # (B, S, DI, DS, h0)
    (2, 2048, 8192, 16, None),
    (3, 1001, 8192 + 48, 16, "fresh"),
    (2, 300, 7, 3, "fresh"),
    (2, 13, 24, 5, None),
    (2, 37, 64, 16, "offset"),
    (4, 1, 8192, 16, "fresh"),
    (4, 1, 8192, 16, None),
]


def _scan_operands(card, B, S, DI, DS, h0_kind, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.rand((B, S, DI, DS), generator=g, device=card) * 0.5 + 0.499
    b = torch.randn((B, S, DI, DS), generator=g, device=card)
    h0 = None
    if h0_kind is not None:
        h0 = torch.randn((B * DI * DS + 1,), generator=g, device=card)
        h0 = (h0[1:] if h0_kind == "offset" else h0[:-1]).view(B, DI, DS)
    dh = torch.randn((B, S, DI, DS), generator=g, device=card)
    return a, b, h0, dh


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_selective_scan_backward_kernel_matches_plain(card, case):
    a, b, h0, dh = _scan_operands(card, *case)
    h = ops.selective_scan(a, b, h0)
    n = ops.LAUNCHES["selective_scan_backward"]
    got = ops.selective_scan_backward(a, h, h0, dh)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan_backward"] == n + 1
    want = ref.selective_scan_backward_ref(a, h, h0, dh)
    assert (got[2] is None) == (h0 is None) == (want[2] is None)
    for x, y in zip(got, want):
        if y is not None:
            assert x.dtype == torch.float32 and x.shape == y.shape
            assert torch.equal(x, y)   # rounded mul and add, as the loop
    again = ops.selective_scan_backward(a, h, h0, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, again) if x is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 64, 32, 8, None), (1, 37, 16, 16, "fresh"),
                                  (3, 1, 7, 3, "fresh"), (2, 512, 256, 16, None)])
def test_selective_scan_autograd_on_card(card, case):
    """ops.selective_scan with grad: the forward and backward kernels, one
    counted launch each, give the bits of autograd through the plain loop."""
    a, b, h0, dh = _scan_operands(card, *case, seed=1)
    leaves = [t.clone().requires_grad_(True)
              for t in ((a, b) if h0 is None else (a, b, h0))]
    n = dict(ops.LAUNCHES)
    out = ops.selective_scan(*leaves)
    got = torch.autograd.grad(out, leaves, dh)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == n["selective_scan"] + 1
    assert (ops.LAUNCHES["selective_scan_backward"]
            == n["selective_scan_backward"] + 1)
    want_out = ref.selective_scan_ref(*leaves)
    want = torch.autograd.grad(want_out, leaves, dh)
    assert torch.equal(out, want_out)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_mamba_layer_grads_through_the_kernel_route(card):
    """A reduced falcon-mamba's loss gradient through the scan kernel and its
    backward kernel (one launch of each per layer) against the plain path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.training import loss_fn
    cfg = reduced(get_config("falcon-mamba-7b"), n_layers=2)
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card).requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 41), device=card)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].to(torch.int32)}
    leaves = list(p.parameters())
    n = dict(ops.LAUNCHES)
    got = torch.autograd.grad(
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="kernel", remat="none"))[0],
        leaves)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == n["selective_scan"] + cfg.n_layers
    assert (ops.LAUNCHES["selective_scan_backward"]
            == n["selective_scan_backward"] + cfg.n_layers)
    want = torch.autograd.grad(
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="plain", remat="none"))[0],
        leaves)
    for (name, _), x, y in zip(p.named_parameters(), got, want):
        assert_close_to_max(x, y, BWD_TOL, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grok-1-314b", "jamba-1.5-large-398b"])
def test_moe_model_paths_agree_on_card(card, name):
    """A reduced MoE model (grok; jamba's Mamba + attention + MoE block):
    forward and decode steps through the kernels against the plain path,
    on the card, in f32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config(name))
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    with torch.inference_mode():
        a, aux_a = M.forward(p, {"tokens": tokens}, cfg, M.Runtime("kernel"))
        b, aux_b = M.forward(p, {"tokens": tokens}, cfg, M.Runtime("plain"))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(aux_a, aux_b, rtol=1e-6, atol=1e-6)
        caches = [M.init_cache(cfg, 2, 16, torch.float32, card) for _ in range(2)]
        for step in range(20):
            pos = torch.tensor([step, step + 3], device=card, dtype=torch.int32)
            la, _ = M.decode_step(p, caches[0], tokens[:, step], pos, cfg,
                                  M.Runtime("kernel"))
            lb, _ = M.decode_step(p, caches[1], tokens[:, step], pos, cfg,
                                  M.Runtime("plain"))
            torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-5)


# Run in a process of its own: the deterministic mode needs
# CUBLAS_WORKSPACE_CONFIG before CUDA starts.
_MOE_ON_CARD = r"""
import dataclasses, json, warnings
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L

torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
res = []
for name, split, T, skew in (("grok-1-314b", 2, 128, False),
                             ("grok-1-314b", 1, 128, True),
                             ("arctic-480b", 1, 96, False),
                             ("grok-1-314b", 2, 4, False)):
    cfg = reduced(get_config(name))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           expert_split=split))
    g = torch.Generator(device="cuda").manual_seed(0)
    p = L.MoEParams(cfg, torch.float32, "cuda")
    L.init_moe(p, g, cfg)
    x = torch.randn((1, T, cfg.d_model), generator=g, device="cuda")
    if skew:   # every token to expert 0 first: it overflows C = 96
        x[..., 0] = 10.0
        with torch.no_grad():
            p.router[0] = 0.0
            p.router[0, 0] = 5.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = L.apply_moe(p, x, cfg)
        b = L.apply_moe(p, x, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            c = L.apply_moe(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    cpu = L.MoEParams(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for dst, src in zip(cpu.parameters(), p.parameters()):
            dst.copy_(src)
    want = L.apply_moe(cpu, x.cpu(), cfg)
    res.append({
        "case": [name, split, T, skew],
        "bitwise": all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        and all(bool(torch.equal(u, v)) for u, v in zip(a, c)),
        "warnings": [str(w.message)[:200] for w in caught
                     if "determinis" in str(w.message).lower()],
        "err": (a[0].cpu() - want[0]).abs().max().item(),
        "scale": want[0].abs().max().item(),
        "aux_err": abs(float(a[1]) - float(want[1]))})
print(json.dumps(res))
"""


@pytest.mark.cuda
def test_moe_dispatch_on_card_is_repeatable_sync_free_and_right(card):
    """Reduced grok (experts split in two, and whole with a router that
    overflows expert 0, the slot-0 behaviour) and arctic, and a decode-size
    batch: under ``use_deterministic_algorithms(True)`` two calls are
    bitwise equal and raise no determinism warning, a third under
    ``set_sync_debug_mode("error")`` makes no host sync that the mode
    detects (it is a prototype and says it misses some), and the output
    agrees with the CPU path within 2e-5 (aux within 1e-6)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", _MOE_ON_CARD], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    for r in json.loads(out.stdout.strip().splitlines()[-1]):
        assert r["bitwise"], r
        assert not r["warnings"], r
        assert r["err"] <= 2e-5 + 2e-5 * r["scale"], r
        assert r["aux_err"] <= 1e-6, r


def _on_card(script: str) -> list:
    """Run ``script`` in a process of its own with the deterministic mode's
    cuBLAS workspace set before CUDA starts; its last line of output, JSON."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_REMAT_ON_CARD = r"""
import dataclasses, json
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.training import OptHParams, init_train_state, make_train_step
from repro_torch.training.optimizer import moment_leaves

torch.use_deterministic_algorithms(True)
CASES = {   # reduced widths with head dims the kernels take
    "internlm2-1.8b": dict(d_model=256, n_heads=4),
    "gemma2-9b": dict(d_model=512, n_heads=2),
    "falcon-mamba-7b": dict(d_model=128),
    "grok-1-314b": dict(d_model=256, n_heads=4),
    "seamless-m4t-large-v2": dict(d_model=256, n_heads=4, n_kv_heads=4),
}
res = []
for name, kw in CASES.items():
    for dtype in (torch.float32, torch.bfloat16):
        if name == "falcon-mamba-7b" and dtype == torch.bfloat16:
            continue   # the scan kernel is f32
        cfg = reduced(get_config(name), n_layers=2 * len(get_config(name).block), **kw)
        if name.startswith("grok"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, expert_split=2))
        hp = OptHParams(moment_dtype="bfloat16", grad_accum_dtype="bfloat16")
        g = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (1, 2, 129), generator=g,
                             device="cuda")
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.enc_dec:
            batch["frames"] = torch.randn((1, 2, 128, cfg.d_model),
                                          generator=g, device="cuda")
        out = {}
        for remat in ("none", "block", "full"):
            state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                     cfg, hp, dtype, "cuda")
            ops.reset_launches()
            state, metrics = make_train_step(cfg, hp, M.Runtime(remat=remat))(
                state, batch)
            torch.cuda.synchronize()
            leaves = [t.detach() for t in state["params"].parameters()]
            leaves += [x for key in ("m", "v")
                       for x in moment_leaves(state["opt"][key])]
            out[remat] = (metrics["loss"], leaves, dict(ops.LAUNCHES))
        want = out["none"]
        for remat in ("block", "full"):
            got = out[remat]
            res.append({
                "case": [name, str(dtype), remat],
                "bitwise": bool(torch.equal(got[0], want[0])) and all(
                    bool(torch.equal(a, b)) for a, b in zip(got[1], want[1])),
                "launches": got[2], "launches_none": want[2]})
print(json.dumps(res))
"""


@pytest.mark.cuda
def test_remat_step_on_card_is_bitwise_none(card):
    """A train step with remat "block" or "full" at a reduced width, f32
    and bf16 params (bf16 moments and accumulation), gives the bits of one
    with "none": loss, params and moments, for a dense, a gemma2 (local /
    global, dh 256), a Mamba, an MoE (grok, experts split in two) and an
    encoder-decoder model. Each forward kernel launches twice (the forward
    and its recompute), each backward kernel once, as without remat."""
    for r in _on_card(_REMAT_ON_CARD):
        assert r["bitwise"], r
        for key in ("flash_attention", "selective_scan"):
            assert r["launches"][key] == 2 * r["launches_none"][key], r
        for key in ("flash_attention_backward", "selective_scan_backward"):
            assert r["launches"][key] == r["launches_none"][key], r


_MOE_BACKWARD_ON_CARD = r"""
import dataclasses, json, warnings
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L

torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
res = []
for dtype, T in ((torch.float32, 256), (torch.bfloat16, 4096)):
    cfg = reduced(get_config("grok-1-314b"), d_model=256)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           expert_split=2))
    g = torch.Generator(device="cuda").manual_seed(0)
    p = L.MoEParams(cfg, dtype, "cuda")
    L.init_moe(p, g, cfg)
    p.requires_grad_(True)
    x = torch.randn((1, T, cfg.d_model), generator=g,
                    device="cuda").to(dtype).requires_grad_(True)
    dy = torch.randn((1, T, cfg.d_model), generator=g, device="cuda")

    def grads():
        y, aux = L.apply_moe(p, x, cfg)
        return torch.autograd.grad((y.float() * dy).sum() + aux,
                                   [x] + list(p.parameters()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a, b = grads(), grads()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            c = grads()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    res.append({
        "case": [str(dtype), T],
        "bitwise": all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        and all(bool(torch.equal(u, v)) for u, v in zip(a, c)),
        "finite": all(bool(u.isfinite().all()) for u in a),
        "warnings": [str(w.message)[:200] for w in caught
                     if "determinis" in str(w.message).lower()]})
print(json.dumps(res))
"""


@pytest.mark.cuda
def test_moe_backward_on_card_is_repeatable_and_sync_free(card):
    """The MoE FFN's backward (grok, experts split in two, reduced width),
    whose gathers autograd turns into accumulating ``index_put_``s: under
    ``use_deterministic_algorithms(True)`` two runs give the same bits and
    no determinism warning, and a third under ``set_sync_debug_mode("error")``
    makes no host sync that the mode detects."""
    for r in _on_card(_MOE_BACKWARD_ON_CARD):
        assert r["bitwise"] and r["finite"], r
        assert not r["warnings"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 48, 80, 192, 200, 300, 512, 704])
def test_attention_launches_record_their_built_head_dim(card, D, dt):
    """Flash (forward and backward) and decode at a head dim D launch the
    kernel instance of ops.flash_built_head_dim and ops.built_head_dim (D
    itself at 192 and 512, else the next built width: above 256 the next
    multiple of 64 in decode, the next cluster width in flash, 768 at 704;
    the operands padded with zero columns) and count it in
    ops.BUILT_WIDTHS; each result holds to the plain version at the true D."""
    g = torch.Generator(device=card).manual_seed(1)
    q = _randn(g, (2, 100, 4, D), dt, card)
    k, v, dout = (_randn(g, s, dt, card) for s in ((2, 100, 2, D),) * 2
                  + ((2, 100, 4, D),))
    built = ops.built_head_dim(TDT[dt], D)
    flash_built = ops.flash_built_head_dim(TDT[dt], D)
    ops.reset_launches()
    out, lse = ops.flash_attention_forward(q, k, v, True, None, None,
                                           want_lse=True)
    grads = ops.flash_attention_backward(q, k, v, out, lse, dout)
    lengths = torch.tensor([37, 100], dtype=torch.int32, device=card)
    dec = ops.decode_attention(q[:, 0].contiguous(), k, v, lengths)
    torch.cuda.synchronize()
    assert dict(ops.BUILT_WIDTHS) == {
        ("flash_attention", D, flash_built): 1,
        ("flash_attention_backward", D, flash_built): 1,
        ("decode_attention", D, built): 1}
    assert out.shape == q.shape and dec.shape == (2, 4, D)
    assert all(a.shape == b.shape for a, b in zip(grads, (q, k, v)))
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(
        q, k, v).float(), rtol=TOL[dt], atol=TOL[dt])
    torch.testing.assert_close(dec.float(), ref.decode_attention_ref(
        q[:, 0].contiguous(), k, v, lengths).float(), rtol=TOL[dt],
        atol=TOL[dt])
    if dt == "f32":
        want = ref.flash_attention_backward_ref(q, k, v, out, lse, dout)
        for a, b in zip(grads, want):
            assert_close_to_max(a, b, BWD_TOL)


# The fused scan's kernels (csrc/selective_scan_fused.cu) against their plain
# versions: falcon-mamba's train shape in f32 and bf16, a ragged S (not a
# multiple of the kernels' 16-step intervals or the forward's 64-step
# stages), a reduced width, d_state 8 (the reduced configs'), 3 and 32 (the
# 8- and 32-state instances), 12 (the 16-state instance with its last
# thread of a channel idle) and a DI that is not a multiple of a block's
# channels (24, 40; 200 over 4 blocks of 64); y within 2e-5 (f32
# accumulation in another order over n), the backward within 2e-5 of each
# gradient's largest magnitude, every kernel bitwise repeatable.
FUSED_CASES = [
    # (B, S, DI, DS, dtype)
    (2, 2048, 8192, 16, "f32"),
    (2, 2048, 8192, 16, "bf16"),
    (2, 1000, 512, 16, "f32"),
    (1, 333, 256, 8, "bf16"),
    (2, 130, 40, 3, "f32"),
    (1, 200, 24, 32, "f32"),
    (2, 300, 200, 12, "bf16"),
]


def _fused_operands(card, B, S, DI, DS, dt_name, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.randn((B, S, DI), generator=g, device=card).to(TDT[dt_name])
    rows = torch.randn((B, S, 2 * DS + 3), generator=g,
                       device=card).to(TDT[dt_name])
    Bc, Cc = rows[..., 3:3 + DS], rows[..., 3 + DS:]   # x_proj's split views
    dt = torch.rand((B, S, DI), generator=g, device=card) * 0.1
    A = -torch.exp(torch.randn((DI, DS), generator=g, device=card))
    dy = torch.randn((B, S, DI), generator=g, device=card)
    return u, dt, A, Bc, Cc, dy


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_selective_scan_fused_kernels_match_plain(card, case):
    u, dt, A, Bc, Cc, dy = _fused_operands(card, *case)
    n = dict(ops.LAUNCHES)
    y, states = ops.selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                                 want_states=True)
    got = ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan_fused"] == n["selective_scan_fused"] + 1
    assert (ops.LAUNCHES["selective_scan_fused_backward"]
            == n["selective_scan_fused_backward"] + 1)
    want_y, want_states = ref.selective_scan_fused_ref(u, dt, A, Bc, Cc,
                                                       want_states=True)
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(states, want_states, rtol=2e-5, atol=2e-5)
    want = ref.selective_scan_fused_backward_ref(u, dt, A, Bc, Cc, states, dy)
    for name, x, w in zip(("du", "ddt", "dA", "dB", "dC"), got, want):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        assert_close_to_max(x.float(), w.float(),
                            2e-5 if case[4] == "f32" else TOL["bf16"], name)
    y2, s2 = ops.selective_scan_fused_forward(u, dt, A, Bc, Cc,
                                              want_states=True)
    assert torch.equal(y, y2) and torch.equal(states, s2)
    assert torch.equal(y, ops.selective_scan_fused(u, dt, A, Bc, Cc))
    again = ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, states, dy)
    assert all(torch.equal(x, w) for x, w in zip(got, again))


@pytest.mark.cuda
def test_selective_scan_fused_autograd_on_card(card):
    """ops.selective_scan_fused with grad: one counted launch of the forward
    and of the backward, against autograd through the plain forward."""
    u, dt, A, Bc, Cc, dy = _fused_operands(card, 2, 300, 64, 16, "f32", seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (u, dt, A, Bc, Cc)]
    n = dict(ops.LAUNCHES)
    got = torch.autograd.grad(ops.selective_scan_fused(*leaves), leaves, dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan_fused"] == n["selective_scan_fused"] + 1
    assert (ops.LAUNCHES["selective_scan_fused_backward"]
            == n["selective_scan_fused_backward"] + 1)
    want = torch.autograd.grad(ref.selective_scan_fused_ref(*leaves), leaves, dy)
    for x, w in zip(got, want):
        assert_close_to_max(x, w, 2e-5, "fused grad")


@pytest.mark.cuda
def test_bare_fused_scan_call_refuses_grad(card):
    u, dt, A, Bc, Cc, _ = _fused_operands(card, 1, 8, 16, 4, "f32")
    with pytest.raises(NotImplementedError, match="SelectiveScanFused"):
        ops.selective_scan_fused_forward(u.requires_grad_(True), dt, A, Bc,
                                         Cc, want_states=False)


@pytest.mark.cuda
def test_fused_blocks_match_the_kernels(card):
    """``ops.fused_blocks`` (the backward's partials) is the C side's count."""
    from repro_torch.kernels import build
    lib = build.load()
    for DI in (1, 24, 40, 256, 8192, 8193):
        for DS in (1, 3, 8, 9, 16, 17, 32):
            assert lib.repro_selective_scan_fused_blocks(DI, DS) == \
                ops.fused_blocks(DI, DS)
    assert lib.repro_selective_scan_fused_blocks(8192, 33) == 0


@pytest.mark.cuda
def test_mamba_layer_takes_the_fused_route_on_card(card):
    """A reduced falcon-mamba at S = 512 (JAX's chunked branch): one fused
    forward and backward launch a layer and no materialised scan, the loss
    gradient against the plain path's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.training import loss_fn
    cfg = reduced(get_config("falcon-mamba-7b"), n_layers=2)
    p = M.init_params(torch.Generator(device=card).manual_seed(0), cfg,
                      torch.float32, card).requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 513), device=card)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].to(torch.int32)}
    leaves = list(p.parameters())
    n = dict(ops.LAUNCHES)
    got = torch.autograd.grad(
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="kernel", remat="none"))[0],
        leaves)
    torch.cuda.synchronize()
    delta = {k: ops.LAUNCHES[k] - n[k] for k in n}
    assert delta["selective_scan_fused"] == cfg.n_layers
    assert delta["selective_scan_fused_backward"] == cfg.n_layers
    assert delta["selective_scan"] == delta["selective_scan_backward"] == 0
    want = torch.autograd.grad(
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="plain", remat="none"))[0],
        leaves)
    for (name, _), x, y in zip(p.named_parameters(), got, want):
        assert_close_to_max(x, y, BWD_TOL, name)
