"""The port's copy of tests/test_train_e2e.py, on the CPU: a trainer crash
and a pipeline-worker crash must replay to a BIT-IDENTICAL trajectory and
final state (exactly-once batch consumption at checkpoint granularity),
through ``repro_torch.launch.train.run_training(device="cpu")``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import to_host  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield np.asarray(tree)


def _check_resume(tmp_path, **kw):
    a = run_training(steps=10, ckpt_every=3, seq_len=64, batch_size=4,
                     ckpt_dir=str(tmp_path / "a"), d_model=64, n_layers=2,
                     verbose=False, seed=3, device="cpu", **kw)
    b = run_training(steps=10, ckpt_every=3, seq_len=64, batch_size=4,
                     ckpt_dir=str(tmp_path / "b"), d_model=64, n_layers=2,
                     verbose=False, seed=3, kill_trainer_at=7,
                     kill_worker_at=2, device="cpu", **kw)
    # pre-crash prefix identical
    assert b["losses"][:7] == a["losses"][:7]
    # post-crash: replays from the last checkpoint (step 6) onward
    assert b["losses"][7:] == a["losses"][6:]
    assert b["engine"].failures >= 2     # worker + feed-group kill
    same = all(np.allclose(x, y)
               for x, y in zip(_leaves(to_host(a["final_state"])),
                               _leaves(to_host(b["final_state"]))))
    assert same


@pytest.mark.timeout(300)      # two short training runs
def test_bit_identical_resume(tmp_path):
    _check_resume(tmp_path)


@pytest.mark.timeout(300)      # two short training runs
def test_bit_identical_resume_falcon_mamba(tmp_path):
    """The same through falcon-mamba's train step (the scan's gradient via
    ``ops.SelectiveScan``), reduced to d_model 64 and 2 layers."""
    _check_resume(tmp_path, arch="falcon-mamba-7b")


@pytest.mark.timeout(300)      # a short training run
def test_worker_crash_nonblocking(tmp_path):
    out = run_training(steps=8, ckpt_every=4, seq_len=64, batch_size=4,
                       ckpt_dir=str(tmp_path / "w"), d_model=64, n_layers=2,
                       verbose=False, seed=1, kill_worker_at=2, device="cpu")
    assert out["steps"] == 8
    assert out["engine"].failures == 1
    assert out["engine"].restarts == 1
