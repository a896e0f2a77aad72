"""What the port promises about itself, checked on the CPU:

* it imports neither JAX nor anything of the ``repro`` package;
* its entry points run on ``cuda`` and raise without a card unless the
  caller asks for ``device="cpu"``;
* families outside this slice raise ``NotImplementedError``;
* the kernel wrappers pick the plain version by the tensors' device alone:
  a tensor on the card gets the kernel or an error, never the plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_driver  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(info.name)
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] == "repro" or m.split(".")[0].startswith("jax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("repro_torch.bridge", "repro_torch.kernels.ops",
                "repro_torch.kernels.build", "repro_torch.models.model",
                "repro_torch.serving.decode", "repro_torch.launch.serve",
                "repro_torch.configs.base"):
        assert mod in res["modules"]


def test_chip_smoke_fails_without_the_repository(tmp_path):
    """Alone in a directory, chip_smoke.py cannot import the port: it must
    exit non-zero and print no result."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny(name="internlm2-1.8b"):
    return reduced(get_config(name), d_model=64, n_layers=1)


def test_entry_points_raise_without_a_card(no_card):
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(torch.Generator(), cfg, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_driver.main(["--requests", "1", "--tokens", "1"])
    p = M.init_params(torch.Generator(), cfg, torch.float32, "cpu")
    np_params = bridge.params_to_jax(p, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax(np_params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.cache_from_jax(bridge.cache_to_jax(M.init_cache(
            cfg, 1, 4, torch.float32, "cpu")))
    # the same calls run when the CPU is asked for
    assert repro_torch.resolve_device("cpu").type == "cpu"
    assert bridge.params_from_jax(np_params, cfg, "cpu").embed.device.type == "cpu"
    done = serve_driver.main(["--requests", "1", "--tokens", "2",
                              "--d-model", "64", "--device", "cpu"])
    assert len(done[0]) == 2


UNSUPPORTED = {
    "falcon-mamba-7b": "Mamba",
    "jamba-1.5-large-398b": "Mamba",
    "grok-1-314b": "MoE",
    "arctic-480b": "MoE",
    "seamless-m4t-large-v2": "encoder-decoder",
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_families_raise(name):
    cfg = reduced(ARCHS[name])
    match = f"{UNSUPPORTED[name]} slice"
    with pytest.raises(NotImplementedError, match=match):
        M.init_params(torch.Generator(), cfg, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        M.init_cache(cfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        serve_driver.main(["--arch", name, "--device", "cpu"])
    # a dense model's weights do not let forward run another family's config
    dense = M.init_params(torch.Generator(), _tiny(), torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        M.forward(dense, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, cfg)


def test_runtime_rejects_unknown_attn_impl():
    with pytest.raises(ValueError):
        M.Runtime(attn_impl="xla")


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper decides from."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _claims_cuda(t):
    return t.as_subclass(_ClaimsCuda)


class _Launched(Exception):
    pass


def _refuse(*args, **kwargs):
    raise _Launched("launcher reached")


@pytest.mark.parametrize("which", ["flash_attention", "decode_attention"])
def test_wrappers_choose_the_plain_version_only_by_device(monkeypatch, which):
    monkeypatch.setattr(ops, f"_launch_{which}", _refuse)
    q4, k4 = torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32)
    q3, lengths = torch.randn(1, 4, 32), torch.tensor([5], dtype=torch.int32)
    args = (q4, k4, k4) if which == "flash_attention" else (q3, k4, k4, lengths)
    wrapper = getattr(ops, which)
    before = dict(ops.LAUNCHES)
    # CPU tensors: the plain version, no launch
    want = getattr(ref, f"{which}_ref")(*args)
    torch.testing.assert_close(wrapper(*args), want, rtol=0, atol=0)
    # tensors that claim the card: the launcher, whose error propagates;
    # the plain version is never consulted
    monkeypatch.setattr(ref, f"{which}_ref", _refuse)
    with pytest.raises(_Launched):
        wrapper(*(_claims_cuda(a) for a in args))
    assert ops.LAUNCHES == before          # a failed launch is not counted
    # a tensor on neither device is refused before any launch
    with pytest.raises(ValueError):
        wrapper(*(a.to("meta") for a in args))


@pytest.mark.parametrize("bad", ["dim", "group", "noncontiguous", "grad"])
def test_kernel_limits_are_checked_before_launch(monkeypatch, bad):
    """On the card the wrapper refuses what the kernels do not take before
    it launches anything (the launcher here would raise _Launched)."""
    monkeypatch.setattr(ops, "_launch_decode_attention", _refuse)
    monkeypatch.setattr(ops, "_launch_flash_attention", _refuse)
    H, KV, D = 4, 2, 32
    if bad == "dim":
        D = 48
    elif bad == "group":
        H, KV = 34, 2
    q, k = torch.randn(1, H, D), torch.randn(1, 8, KV, D)
    lengths = torch.tensor([5], dtype=torch.int32)
    q4 = torch.randn(1, 8, H, D)
    if bad == "noncontiguous":
        k = torch.randn(1, 8, D, KV).transpose(2, 3)
    if bad == "grad":
        q.requires_grad_(True)
        q4.requires_grad_(True)
    err = NotImplementedError if bad == "grad" else ValueError
    with pytest.raises(err):
        ops.decode_attention(*(_claims_cuda(t) for t in (q, k, k, lengths)))
    with pytest.raises(err):
        ops.flash_attention(*(_claims_cuda(t) for t in (q4, k, k)))


def test_kernels_are_not_built_on_import():
    from repro_torch.kernels import build
    assert build.load.cache_info().currsize == 0
    assert build.library_path().suffix == ".so"
    assert dataclasses.is_dataclass(M.Runtime)
