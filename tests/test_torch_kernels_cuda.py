"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card every test skips. This file imports no JAX,
so it runs on a machine that has only PyTorch built for CUDA and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances as in ``tests/test_kernels.py``: 2e-5 for f32, 2e-2 for bf16.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 2e-2}

FLASH_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype)
    (2, 128, 4, 4, 64, True, None, None, "f32"),
    (1, 256, 2, 2, 128, True, 64, None, "f32"),
    (1, 128, 2, 2, 64, False, None, None, "f32"),
    (1, 128, 2, 2, 256, True, None, 50.0, "bf16"),
    (2, 64, 8, 2, 64, True, 16, 50.0, "f32"),
    (1, 100, 4, 2, 32, True, 24, None, "f32"),
    (1, 333, 16, 8, 128, True, None, None, "bf16"),
]

DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype, lengths); None -> [1, S]
    (2, 256, 4, 4, 64, None, None, "f32", None),
    (1, 512, 2, 2, 128, 128, None, "f32", None),
    (3, 128, 8, 2, 64, 48, 30.0, "f32", [1, 77, 128]),
    (2, 128, 4, 2, 32, None, None, "bf16", [5, 128]),
    (3, 64, 4, 2, 256, None, None, "f32", [65, 100, 200]),
    (2, 64, 36, 4, 128, 16, None, "f32", [64, 200]),   # group 9, no valid key
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
    B, S, H, KV, D, causal, window, softcap, dt = case
    g = torch.Generator(device=card).manual_seed(0)
    q = _randn(g, (B, S, H, D), dt, card)
    k, v = (_randn(g, (B, S, KV, D), dt, card) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    n = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=TOL[dt], atol=TOL[dt])


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
def test_decode_attention_is_deterministic(card):
    g = torch.Generator(device=card).manual_seed(1)
    q = _randn(g, (4, 16, 128), "f32", card)
    k, v = (_randn(g, (4, 4096, 8, 128), "f32", card) for _ in range(2))
    lengths = torch.tensor([1, 1000, 4096, 2500], device=card, dtype=torch.int32)
    first = ops.decode_attention(q, k, v, lengths)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(q, k, v, lengths), first)


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
