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

# bf16 goes to the tensor-core kernel (csrc/flash_attention_tc.cu), f32 at
# D <= 128 to the split-f32 tensor-core one (csrc/flash_attention_f32tc.cu),
# f32 at D = 256 to the CUDA-core one (csrc/flash_attention.cu)
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
    (1, 200, 200, 4, 2, 256, True, 64, 50.0, "f32"),          # D = 256: CUDA cores
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
]

# f32 flash backward against its plain version (csrc/flash_attention_f32tc.cu
# at D <= 128, csrc/flash_attention_bwd.cu at D = 256): the main path's
# shape, D = 32/64/256, groups 1/2/4, window and softcap, ragged S, Sq != Sk
# without a mask
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
    q = torch.randn(1, 64, 4, 64, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=card)
    with pytest.raises(NotImplementedError, match="FlashAttention"):
        ops.flash_attention_forward(q, k, k, True, None, None, want_lse=True)
    with pytest.raises(NotImplementedError, match="f32 only"):
        ops.flash_attention(q.detach().bfloat16().requires_grad_(True),
                            k.bfloat16(), k.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("D, variant", [(64, "split_f32"), (128, "split_f32"),
                                        (256, "cuda_core")])
def test_f32_flash_runs_the_variant_of_its_head_dim(card, D, variant):
    """The f32 forward and backward at head dim D run the kernels of
    ops.flash_variant (by shape, before the launch): their device kernels
    are the ones the profiler records."""
    from torch.profiler import ProfilerActivity, profile
    names = {"split_f32": ("flash_f32tc_fwd_kernel", "flash_f32tc_dkdv_kernel",
                           "flash_f32tc_dq_kernel"),
             "cuda_core": ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                           "flash_bwd_dq_kernel")}
    assert ops.flash_variant(torch.float32, D) == variant
    q, k, v, dout, kw = _bwd_operands(card, (1, 128, 128, 4, 2, D, True, None,
                                             None))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = ops.flash_attention_forward(q, k, v, True, None, None,
                                               want_lse=True)
        ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
    seen = " ".join(ev.key for ev in prof.key_averages())
    other = "cuda_core" if variant == "split_f32" else "split_f32"
    assert all(n in seen for n in names[variant]), seen
    assert not any(n in seen for n in names[other]), seen


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
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="kernel"))[0], leaves)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == n["selective_scan"] + cfg.n_layers
    assert (ops.LAUNCHES["selective_scan_backward"]
            == n["selective_scan_backward"] + cfg.n_layers)
    want = torch.autograd.grad(
        loss_fn(p, batch, cfg, M.Runtime(scan_impl="plain"))[0], leaves)
    for (name, _), x, y in zip(p.named_parameters(), got, want):
        assert_close_to_max(x, y, BWD_TOL, name)
