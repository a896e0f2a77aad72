"""The port's examples (``examples/torch_*.py``), on the CPU.

* each runs as a script (``--device cpu`` where it takes a device) in a
  subprocess whose ``sys.modules`` then holds neither ``jax`` nor anything
  of ``repro``;
* ``torch_quickstart`` and ``torch_elastic_scaling`` print what
  ``examples/quickstart.py`` and ``examples/elastic_scaling.py`` print (run
  unchanged, with ``PYTHONPATH=src``): the committed outputs, the failure
  and restart counts and the lineage answers, ``==``;
* ``torch_train_e2e --device cpu --steps 12`` resumes bit-identically;
* ``torch_serve_batched --device cpu`` gives every request its tokens, for
  each of the ten archs;
* with ``--device cuda`` (the default) and no card, both model examples
  raise.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

# runs an example as __main__ with its arguments, then prints the modules
# of jax or repro that the process loaded, as the last line
_RUN = r"""
import json, runpy, sys
path, args = sys.argv[1], sys.argv[2:]
sys.argv = [path] + args
runpy.run_path(path, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("repro", "jax", "jaxlib"))))
"""


def _script(name, *args, probe=True):
    """stdout of ``examples/<name>`` run with ``args`` (PYTHONPATH=src), on
    one torch thread: beside other test processes a pool of intra-op
    threads as wide as the machine spins against them (the train example's
    12 steps then took minutes, past the limit below)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = ([sys.executable, "-c", _RUN, str(EXAMPLES / name), *args] if probe
           else [sys.executable, str(EXAMPLES / name), *args])
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _probed(name, *args):
    """The example's stdout without the probe line; the probe must be
    empty."""
    lines = _script(name, *args).splitlines()
    assert json.loads(lines[-1]) == [], f"{name} loaded jax or repro"
    return lines[:-1]


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "elastic_scaling"])
def test_engine_example_prints_what_the_jax_one_prints(name):
    port = _probed(f"torch_{name}.py")
    jax = _script(f"{name}.py", probe=False).splitlines()
    assert port == jax
    assert any("exactly" in line for line in port)


def test_quickstart_lineage_answers():
    lines = _probed("torch_quickstart.py")
    assert lines[0] == "failures injected: 2, groups restarted: 2"
    assert ("report #2 was computed from sales batches "
            f"{list(range(16, 24))}") in lines
    assert "sales batch #11 flowed into [('agg', 'out', 1)]" in lines


def test_train_e2e_resumes_bit_identically_on_the_cpu():
    lines = _probed("torch_train_e2e.py", "--device", "cpu", "--steps", "12")
    assert "pipeline failures in B: 2; final states identical: True" in lines
    assert lines[-1] == "OK: crash-recovery resumed the exact trajectory."


def test_serve_batched_runs_as_a_script():
    lines = _probed("torch_serve_batched.py", "--device", "cpu")
    assert [line.split(":")[0] for line in lines[:6]] == [
        f"request {i}" for i in range(6)]
    assert lines[6].startswith("72 tokens across 6 requests")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_batched_serves_every_arch(arch):
    ex = _module("torch_serve_batched")
    done = ex.main(["--arch", arch, "--device", "cpu"])
    assert sorted(done) == list(range(6))
    assert all(len(toks) == 12 for toks in done.values())


def test_model_examples_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    serve, train = _module("torch_serve_batched"), _module("torch_train_e2e")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1", "--tokens", "1"])
    was = torch.are_deterministic_algorithms_enabled()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--steps", "1"])
    finally:
        torch.use_deterministic_algorithms(was)
