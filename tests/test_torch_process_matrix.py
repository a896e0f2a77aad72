"""The full crash-point matrix of ``tests/test_process_mode.py``
(``test_sigkill_recovery_matrix_full``) on the port's process mode, for the
source and the map: every crash point under real process death, on each
sqlite stack, over the ``proc_transport`` and ``proc_ctx`` axes. The
window and the sink are in ``tests/test_torch_process_matrix_b.py``.

Combinations whose point never fires for the operator (a map has no write
actions) degenerate to failure-free runs, as in the step-mode matrix.
"""
import pytest

pytest.importorskip("torch")

import repro_torch.core as TC  # noqa: E402
from tests.test_torch_process_mode import SQLITE_SPECS, run  # noqa: E402
from tests.torch_core_helpers import linear_pipeline  # noqa: E402

pytestmark = pytest.mark.timeout(300)

POINTS = ["source_pre_log", "source_post_log", "pre_filter",
          "pre_state_update", "post_ack_log", "pre_log", "post_log",
          "post_send", "pre_write", "post_write_pre_done"]


@pytest.mark.parametrize("spec", SQLITE_SPECS)
@pytest.mark.parametrize("op_id", ["src", "map"])
@pytest.mark.parametrize("point", POINTS)
def test_sigkill_recovery_matrix_full(op_id, point, spec, proc_transport,
                                      proc_ctx, tmp_path):
    build, expected = linear_pipeline(TC, writes=1)
    run(build, expected, spec, [(op_id, point, 2)], tmp_path,
        require_fired=False, transport=proc_transport, ctx=proc_ctx)
