"""The port's multi-host process mode on the CPU: copies of
``tests/test_multihost.py`` on ``repro_torch.core``.

They pin the multi-host path whatever the LOGIO_PROC_CTX/LOGIO_TRANSPORT
axes say: workers started by ``spawn`` (or by ``LocalCluster`` node
agents) are rebuilt from the picklable ``WorkerBootstrap`` payload and the
shared log alone, and their channels ride authkey-authenticated
``AF_INET`` sockets brokered as ``(host, port)`` tuples. The scaling copy
places its scale-up and scale-down by outputs committed so far, where the
JAX case sleeps 0.5 s.
"""
import pickle
import time
from functools import partial
from multiprocessing import AuthenticationError
from multiprocessing import connection as mpc

import pytest

pytest.importorskip("torch")

import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (Engine, FailureInjector,  # noqa: E402
                              LocalCluster, Placement)
from repro_torch.core.scaling import Controller  # noqa: E402
from tests.torch_core_helpers import (gated_delay,  # noqa: E402
                                      linear_pipeline, mk_replica, mk_store,
                                      replica_pipeline, sink_outputs,
                                      wait_for)

# cluster boots + eng.wait budgets exceed the global 120s pytest-timeout
pytestmark = pytest.mark.timeout(300)


def _mk(root, spec="sqlite+group"):
    return mk_store(TC, spec, root, shards=3, batch_size=4, interval=0.001)


# ---------------------------------------------------------------------------
# units: placement + bootstrap payload
# ---------------------------------------------------------------------------

def test_placement_units():
    p = Placement({"a": "n0", "b": None}, default="n1")
    assert p.node_of("a") == "n0"
    assert p.node_of("b") is None
    assert p.node_of("zzz") == "n1"        # default applies to unknowns
    p.assign("c", "n2")
    assert p.node_of("c") == "n2"
    assert p.nodes() == ["n0", "n1", "n2"]
    assert Placement().node_of("anything") is None
    assert Placement().nodes() == []


def test_bootstrap_payload_is_picklable_and_complete():
    """The bootstrap crosses process boundaries by stdlib pickle and
    carries everything a worker rebuild needs."""
    build, _ = linear_pipeline(TC, writes=1)
    eng = Engine(build(), mode="process", transport="tcp",
                 store=mk_store(TC, "memory"))
    try:
        bs = eng.make_bootstrap("map", recover=True, incarnation=7)
        bs2 = pickle.loads(pickle.dumps(bs))
        assert bs2.group == "map" and bs2.incarnation == 7 and bs2.recover
        assert bs2.group_ops() == ["map"]
        assert set(bs2.factories) == {"map"}     # only this group's ops
        op = bs2.factories["map"]()              # rebuilds a live operator
        assert op.id == "map"
        names = {c.name for c in bs2.channels}
        assert "src.out->map.in" in names and "map.out->win.in" in names
        assert all(c.capacity > 0 for c in bs2.channels)
        assert bs2.transport == "tcp"
        assert bs2.transport_options["family"] == "inet"
        assert isinstance(bs2.transport_options["authkey"], bytes)
    finally:
        eng.stop()


def test_socket_family_is_per_engine_config(tmp_path):
    """The family is engine configuration, not an import-time constant:
    AF_INET is selectable on a host that also has AF_UNIX, and two engines
    with different families coexist."""
    build, expected = linear_pipeline(TC, writes=1)
    eng = Engine(build(), mode="process", transport="socket",
                 transport_options={"family": "inet"}, store=_mk(tmp_path))
    eng.start()
    ok = eng.wait(60)
    eng.stop()
    assert ok and sink_outputs(eng) == expected
    eng2 = Engine(linear_pipeline(TC, writes=1)[0](), mode="process",
                  transport="tcp", store=mk_store(TC, "memory"))
    assert eng2.transport_options["family"] == "inet"
    eng2.stop()
    with pytest.raises(ValueError):
        Engine(linear_pipeline(TC)[0](), mode="process", transport="socket",
               transport_options={"family": "bogus"})


# ---------------------------------------------------------------------------
# spawn + AF_INET recovery: reconnect-replay and obsolete-filter correctness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_id,point,nth", [
    ("map", "post_send", 1),       # sender dies: buffer rebuilt from log
    ("win", "post_ack_log", 2),    # receiver dies: reconnect + resend
])
def test_spawn_tcp_sigkill_recovery(op_id, point, nth, tmp_path):
    """SIGKILL a spawn-context worker mid-protocol over AF_INET channels:
    the respawned worker is rebuilt from bootstrap + log, senders
    re-transmit on reconnect, and the obsolete filter keeps the output
    exactly-once."""
    build, expected = linear_pipeline(TC, writes=1)
    inj = FailureInjector([(op_id, point, nth)])
    eng = Engine(build(), mode="process", ctx="spawn", transport="tcp",
                 store=_mk(tmp_path), injector=inj, restart_delay=0.02)
    eng.start()
    ok = eng.wait(90)
    eng.stop()
    assert ok, (op_id, point)
    assert eng.failures == 1, (op_id, point)
    assert sink_outputs(eng) == expected       # no duplicates, no holes


def test_spawn_tcp_midstream_kill_reconnect_replay(tmp_path):
    """Kill a spawn worker mid-stream (not at an injected point): the
    sender's buffered events for the dead receiver are re-transmitted to
    its fresh AF_INET listener and filtered exactly-once."""
    build, expected = linear_pipeline(TC, n_events=200, window=4,
                                      sink_target=50, writes=1, rate=0.005)
    eng = Engine(build(), mode="process", ctx="spawn", transport="tcp",
                 store=_mk(tmp_path, "sqlite+sharded+group"),
                 restart_delay=0.05)
    eng.start()
    wait_for(lambda: eng.metrics().op("win").processed >= 20, 30.0,
             "steady state")
    eng.kill_group("win")
    ok = eng.wait(120)
    eng.stop()
    assert ok
    assert eng.failures >= 1
    assert sink_outputs(eng) == expected


# ---------------------------------------------------------------------------
# LocalCluster: node agents, bootstrap-only workers, whole-node death
# ---------------------------------------------------------------------------

def _cluster_engine(build, *, store, n_nodes=2, placement=None, **kw):
    cluster = LocalCluster(n_nodes)
    placement = placement or {"src": "node0", "map": "node0",
                              "win": "node1", "sink": "node1"}
    eng = Engine(build(), mode="process", ctx="spawn", transport="tcp",
                 store=store, cluster=cluster, placement=placement, **kw)
    return eng, cluster


def test_localcluster_bootstrap_only_recovery_matches_thread_mode(tmp_path):
    """A worker rebuilt from the bootstrap payload + log alone, launched by
    a node agent, crashed with SIGKILL and relaunched by the agent,
    recovers to exactly the output thread mode produces."""
    build, expected = linear_pipeline(TC, writes=1)
    ref = Engine(build(), mode="thread", store=mk_store(TC, "memory"))
    ref.start()
    assert ref.wait(60)
    ref.stop()

    inj = FailureInjector([("win", "post_log", 2)])
    eng, _cluster = _cluster_engine(build, store=_mk(tmp_path), injector=inj,
                                    restart_delay=0.02)
    eng.start()
    ok = eng.wait(120)
    eng.stop()
    assert ok
    assert eng.failures == 1
    assert sink_outputs(eng) == sink_outputs(ref) == expected


def test_localcluster_rejects_unauthenticated_control_connections(tmp_path):
    """The control hub runs the mpc authkey challenge: a client with the
    wrong key never gets a connection, and the run is not disturbed."""
    build, expected = linear_pipeline(TC, writes=1)
    eng, _cluster = _cluster_engine(build, store=_mk(tmp_path))
    eng.start()
    try:
        addr = eng._proc._hub.address
        with pytest.raises(AuthenticationError):
            mpc.Client(addr, authkey=b"wrong-key")
        ok = eng.wait(120)
    finally:
        eng.stop()
    assert ok and sink_outputs(eng) == expected


def test_localcluster_kill_node_nonblocking(tmp_path):
    """Pull the plug on one node (SIGKILL of its agent's process group):
    the other node's workers keep processing while the dead node's groups
    warm-restart on a fresh agent."""
    build, expected = linear_pipeline(TC, n_events=200, window=4,
                                      sink_target=50, writes=1, rate=0.005)
    eng, cluster = _cluster_engine(
        build, store=_mk(tmp_path, "sqlite+sharded+group"),
        restart_delay=0.3)
    eng.start()
    wait_for(lambda: eng.metrics().op("sink").processed >= 5, 30.0,
             "steady state")
    before = eng.metrics().op("src").processed
    cluster.kill_node("node1")                 # win + sink die with it
    assert cluster.wait_node_dead("node1")
    # node0's source must advance while node1 is down
    probe_deadline = time.time() + 1.0
    during = before
    while during <= before and time.time() < probe_deadline:
        during = eng.metrics().op("src").processed
        time.sleep(0.005)
    ok = eng.wait(150)
    eng.stop()
    assert ok, "run did not complete after node death"
    assert during > before, "source stalled while node1 was down"
    assert eng.failures >= 2                   # both of node1's groups
    assert sink_outputs(eng) == expected       # exactly-once across nodes


def test_localcluster_scale_up_across_nodes(tmp_path):
    """Dynamic scaling lands new replicas on other nodes: place r2 on
    node1 before scale_up, then scale r1 away. The source (a spawned
    process on node0) holds after the events the scale-down waits for
    until the scale-down has run (a gate file), so the run cannot reach
    its n outputs first, however the processes are scheduled."""
    n = 60
    gate = tmp_path / "scaled_down"
    # 25 outputs before the scale-down, and one more event: the batched
    # source looks one event ahead of the one it emits
    hold = 26
    placement = {"src": "node0", "disp": "node0", "r0": "node0",
                 "r1": "node1", "mrg": "node1", "sink": "node1"}
    cluster = LocalCluster(2)
    eng = Engine(replica_pipeline(TC, n, rate_fn=partial(
                     gated_delay, str(gate), hold, 0.002))(),
                 mode="process", ctx="spawn",
                 transport="tcp", cluster=cluster, placement=placement,
                 restart_delay=0.02)
    ctrl = Controller(eng, "disp", "mrg",
                      replica_factory=partial(mk_replica, TC))
    eng.start()

    def committed():
        return len(eng.external.committed())
    wait_for(lambda: committed() >= 10, 60.0, "outputs before scale-up")
    eng.placement.assign("r2", "node1")
    ctrl.scale_up("r2")
    wait_for(lambda: committed() >= 25, 60.0, "outputs after scale-up")
    assert committed() < n, "the run ended before the scale-down"
    ctrl.scale_down("r1")
    gate.touch()
    ok = eng.wait(150)
    eng.stop()
    assert ok
    assert sorted(b["v"] for b in eng.external.committed()) == \
        sorted(2 * i for i in range(n))
