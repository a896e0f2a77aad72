"""The port's serving path against the JAX package's, on the CPU.

The JAX ``SlotServer`` and the port's run the same requests on the same
bridged f32 weights; their greedy token streams must be equal. The port's
serve driver must run end to end with ``--device cpu``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import SlotServer as JSlotServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import SlotServer, serve_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _drive(server, requests, tokens):
    """The request loop of repro.launch.serve: fill free slots, step, retire
    requests that have their tokens."""
    pending = list(range(requests))
    active, done = {}, {}
    while pending or active:
        while pending and len(active) < server.n_slots:
            req = pending.pop(0)
            active[server.submit(prompt_token=req + 2)] = req
        server.step()
        for rid in list(active):
            if len(server.outputs.get(rid, [])) >= tokens:
                done[active.pop(rid)] = server.finish(rid)
    return done


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-9b", "grok-1-314b",
                                  "arctic-480b", "jamba-1.5-large-398b"])
def test_slot_server_greedy_tokens_equal_jax(arch):
    """Dense, MoE (grok; arctic's MoE beside a dense FFN) and jamba's
    8-layer Mamba + attention + MoE block."""
    cfg = reduced(get_config(arch), d_model=64, n_layers=2)
    tcfg = t_reduced(t_get_config(arch), d_model=64, n_layers=2)
    params = JM.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    # max_len 12 < the 14 tokens each request decodes: positions pass S
    want = _drive(JSlotServer(params, cfg, JM.Runtime(), n_slots=3,
                              max_len=12), requests=5, tokens=14)
    server = SlotServer(tp, tcfg, TM.Runtime(), n_slots=3, max_len=12)
    got = _drive(server, requests=5, tokens=14)
    assert sorted(got) == list(range(5))
    assert got == want
    attn = next(c for c in server.cache if "k" in c)
    assert attn["k"].dtype == torch.float32               # f32 cache, as JAX
    assert int(server.pos.max()) >= 12                    # pos is unbounded


def test_mamba_slot_server_carries_slot_state_as_jax():
    """falcon-mamba, 6 requests x 5 tokens on 2 slots: slots are reused, and
    a request in a reused slot starts from the previous request's conv and
    SSM state (``submit`` resets only the token and position) in both
    servers; their greedy token lists are equal."""
    cfg = reduced(get_config("falcon-mamba-7b"), d_model=64, n_layers=2)
    tcfg = t_reduced(t_get_config("falcon-mamba-7b"), d_model=64, n_layers=2)
    params = JM.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    want = _drive(JSlotServer(params, cfg, JM.Runtime(), n_slots=2,
                              max_len=8), requests=6, tokens=5)
    server = SlotServer(tp, tcfg, TM.Runtime(), n_slots=2, max_len=8)
    got = _drive(server, requests=6, tokens=5)
    assert sorted(got) == list(range(6))
    assert got == want
    assert sorted(server.cache[0]) == ["conv", "ssm"]
    assert server.cache[0]["ssm"].dtype == torch.float32
    assert server.cache[0]["ssm"].abs().sum() > 0      # never reset


def test_serve_step_sampling_uses_the_generator():
    tcfg = t_reduced(t_get_config("internlm2-1.8b"), d_model=64, n_layers=1)
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32,
                        "cpu")
    tokens = torch.tensor([2, 3], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)

    def sample(seed):
        cache = TM.init_cache(tcfg, 2, 8, torch.float32, "cpu")
        g = torch.Generator().manual_seed(seed)
        return [serve_step(tp, cache, tokens, pos, cfg=tcfg, rt=TM.Runtime(),
                           temperature=5.0, generator=g)[0].tolist()
                for _ in range(6)]

    assert sample(3) == sample(3)
    cache = TM.init_cache(tcfg, 2, 8, torch.float32, "cpu")
    nxt, logits, _ = serve_step(tp, cache, tokens, pos, cfg=tcfg, rt=TM.Runtime())
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))


def test_serve_driver_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--tokens", "4", "--slots", "2", "--max-len", "16",
         "--d-model", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 3 requests x 4 tokens" in out.stdout
    assert "device=cpu" in out.stdout
