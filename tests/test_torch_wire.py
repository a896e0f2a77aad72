"""The port's batched wire protocol and shared-memory rings on the CPU.

* copies of ``tests/test_wire.py`` on ``repro_torch.core``: superframe
  codec round trips, vectored writes over real sockets, ring byte-pipe
  semantics (wrap, blocking, incarnation resync), the shared event-payload
  encode, and mid-stream SIGKILL with batches and coalesced acks in flight
  on every byte transport;
* copies of the mid-batch SIGKILL cases of ``tests/test_batching.py``
  (process mode with the adaptive batch governor);
* parity with ``repro.core.transport.wire``: for the same entries the
  port's superframe bytes equal the JAX package's, and each decoder reads
  the other's frames into equal entries (payloads are ``pickle((header,
  body))`` of plain dicts, so the bytes match exactly);
* the public surface (``__all__``, with ``LocalCluster``) equals
  ``repro.core``'s, and the deprecated ``channels`` shim warns.
"""
import os
import pickle
import random
import socket
import threading
import time

import pytest

pytest.importorskip("torch")

from repro.core.transport import wire as jwire  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import Engine, FailureInjector  # noqa: E402
from repro_torch.core.batching import DEFAULT_MAX_BATCH  # noqa: E402
from repro_torch.core.events import Event  # noqa: E402
from repro_torch.core.transport import wire  # noqa: E402
from repro_torch.core.transport.shmring import (ShmRing,  # noqa: E402
                                                sweep_stale_rings)
from tests.torch_core_helpers import (linear_pipeline, mk_store,  # noqa: E402
                                      sink_outputs, window_writes)

pytestmark = pytest.mark.timeout(300)

#: pipeline default channel capacity (Pipeline.connect): bounds how many
#: in-flight events a kill can strand beyond the watermark
CHANNEL_CAPACITY = 256

# ---------------------------------------------------------------------------
# superframe codec
# ---------------------------------------------------------------------------


def _payload(i, w=wire):
    return w.encode_payload({"n": i}, {"v": i, "blob": b"x" * (i % 7)})


def _entries(n, w=wire):
    """A deterministic interleaving of all entry kinds."""
    out = []
    for i in range(n):
        kind = ("ev", "ack", "defer", "release")[i % 4]
        name = f"op{i % 3}.out->op{(i + 1) % 3}.in"
        if kind == "ev":
            out.append(("ev", name, i, _payload(i, w)))
        else:
            out.append((kind, name, i))
    return out


def _decoded_matches(entries, decoded):
    assert len(decoded) == len(entries)
    for ent, dec in zip(entries, decoded):
        assert dec[0] == ent[0]
        assert dec[1] == ent[1]
        assert dec[2] == ent[2]
        if ent[0] == "ev":
            header, body = pickle.loads(ent[3])
            assert dec[3] == header
            assert dec[4] == body


def test_superframe_roundtrip_one_feed():
    entries = _entries(17)
    bufs, total, n_ev, n_ctrl = wire.encode_superframe(entries)
    assert n_ev == len([e for e in entries if e[0] == "ev"])
    assert n_ctrl == len(entries) - n_ev
    assert sum(len(b) for b in bufs) == total
    dec = wire.SuperframeDecoder()
    out = dec.feed(b"".join(bytes(b) for b in bufs))
    _decoded_matches(entries, out)
    assert dec.pending() == 0


def test_superframe_roundtrip_byte_by_byte():
    entries = _entries(9)
    bufs, total, _, _ = wire.encode_superframe(entries)
    data = b"".join(bytes(b) for b in bufs)
    dec = wire.SuperframeDecoder()
    out = []
    for i in range(len(data)):
        out.extend(dec.feed(data[i:i + 1]))
    _decoded_matches(entries, out)
    assert dec.pending() == 0


def test_multiple_superframes_in_one_chunk():
    e1, e2 = _entries(5), _entries(8)
    b1, _, _, _ = wire.encode_superframe(e1)
    b2, _, _, _ = wire.encode_superframe(e2)
    data = b"".join(bytes(b) for b in b1) + b"".join(bytes(b) for b in b2)
    out = wire.SuperframeDecoder().feed(data)
    _decoded_matches(e1 + e2, out)


def test_entry_size_agrees_with_encoder():
    entries = _entries(12)
    _, total, _, _ = wire.encode_superframe(entries)
    assert total == 4 + sum(wire.entry_size(e) for e in entries)


def test_empty_superframe():
    bufs, total, n_ev, n_ctrl = wire.encode_superframe([])
    assert (n_ev, n_ctrl) == (0, 0)
    out = wire.SuperframeDecoder().feed(b"".join(bytes(b) for b in bufs))
    assert out == []


def test_write_buffers_over_socketpair():
    """Vectored writes with partial-write handling deliver the byte stream
    intact: big payloads against a small kernel buffer force the writev
    loop through its offset-slice path."""
    entries = [("ev", "a.out->b.in", i,
                wire.encode_payload({}, {"big": os.urandom(70_000)}))
               for i in range(4)]
    bufs, total, _, _ = wire.encode_superframe(entries)
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
    received = bytearray()

    def drain():
        while len(received) < total:
            chunk = b.recv(65536)
            if not chunk:
                return
            received.extend(chunk)

    t = threading.Thread(target=drain)
    t.start()
    wire.write_buffers(a.fileno(), bufs, total)
    t.join(timeout=10)
    a.close(), b.close()
    assert len(received) == total
    out = wire.SuperframeDecoder().feed(bytes(received))
    assert len(out) == 4
    for i, dec in enumerate(out):
        assert dec[2] == i


# ---------------------------------------------------------------------------
# parity with repro.core.transport.wire
# ---------------------------------------------------------------------------

def _random_entries(seed, n):
    """Entries of every kind with names, ids and payload sizes drawn from
    ``seed``: the same entries for both packages."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["ev", "ev", "ack", "defer", "release"])
        name = f"op{rng.randrange(5)}.out->op{rng.randrange(5)}.in{'é' * (i % 2)}"
        eid = rng.randrange(-2**40, 2**40)
        if kind == "ev":
            body = {"v": rng.randrange(1 << 30), "f": rng.random(),
                    "blob": bytes(rng.randrange(256)
                                  for _ in range(rng.randrange(0, 300))),
                    "xs": [rng.randrange(100) for _ in range(rng.randrange(4))]}
            out.append(("ev", name, eid, {"h": i, "ts": rng.random()}, body))
        else:
            out.append((kind, name, eid))
    return out


def _encoded(w, decoded_entries):
    entries = [(e[0], e[1], e[2], w.encode_payload(e[3], e[4]))
               if e[0] == "ev" else e for e in decoded_entries]
    bufs, total, n_ev, n_ctrl = w.encode_superframe(entries)
    return b"".join(bytes(b) for b in bufs), total, n_ev, n_ctrl


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 40), (3, 257)])
def test_superframe_bytes_match_jax(seed, n):
    """The same entries encode to the same bytes in both packages, and
    each decoder reads the other's frames into the entries encoded."""
    entries = _random_entries(seed, n)
    t_bytes, t_total, t_ev, t_ctrl = _encoded(wire, entries)
    j_bytes, j_total, j_ev, j_ctrl = _encoded(jwire, entries)
    assert t_bytes == j_bytes
    assert (t_total, t_ev, t_ctrl) == (j_total, j_ev, j_ctrl)
    assert len(t_bytes) == t_total
    from_jax = wire.SuperframeDecoder().feed(j_bytes)
    from_port = jwire.SuperframeDecoder().feed(t_bytes)
    assert from_jax == from_port == entries
    # chunked feeds at the same cut points decode alike
    tdec, jdec = wire.SuperframeDecoder(), jwire.SuperframeDecoder()
    cuts = sorted(random.Random(seed).sample(range(len(j_bytes) + 1),
                                             min(8, len(j_bytes) + 1)))
    got_t, got_j = [], []
    for a, b in zip([0] + cuts, cuts + [len(j_bytes)]):
        got_t += tdec.feed(j_bytes[a:b])
        got_j += jdec.feed(t_bytes[a:b])
    assert got_t == got_j == entries
    assert tdec.pending() == jdec.pending() == 0


def test_payload_and_event_blob_match_jax():
    """The shared payload encode and an event's cached blob are the same
    bytes in both packages (the log persists them, the wire ships them)."""
    from repro.core.events import Event as JEvent
    header, body = {"h": 1, "k": "x"}, {"v": [1, 2.5, "é"], "b": b"\x00"}
    assert wire.encode_payload(header, body) == \
        jwire.encode_payload(header, body)
    te = Event(3, "a", "out", "b", "in", body=body, header=header)
    je = JEvent(3, "a", "out", "b", "in", body=body, header=header)
    assert te.cache_blob() == je.cache_blob() == \
        wire.encode_payload(header, body)
    assert wire.entry_size(("ev", "a.out->b.in", 3, te.cache_blob())) == \
        jwire.entry_size(("ev", "a.out->b.in", 3, je.cache_blob()))


# ---------------------------------------------------------------------------
# event payload cache (the shared encode)
# ---------------------------------------------------------------------------

def test_event_blob_cache_roundtrip_and_pickle_exclusion():
    ev = Event(7, "a", "out", "b", "in", body={"v": 1}, header={"h": 2})
    assert ev.cached_blob() is None
    blob = ev.cache_blob()
    assert ev.cached_blob() is blob
    assert ev.cache_blob() is blob              # cached, not re-pickled
    assert pickle.loads(blob) == ({"h": 2}, {"v": 1})
    # the cache is process-local derived state: never shipped by pickle,
    # never inherited by clones (their header may diverge)
    copy = pickle.loads(pickle.dumps(ev))
    assert copy.cached_blob() is None
    assert copy.body == ev.body
    assert ev.clone_for("c", "in2").cached_blob() is None


# ---------------------------------------------------------------------------
# shm rings
# ---------------------------------------------------------------------------

def _alive():
    return True


def test_ring_byte_pipe_with_wraparound():
    ring = ShmRing.create(256)
    try:
        rng_in, rng_out = [], []

        def read_all():
            got = bytearray()
            while len(got) < 10_000:
                chunk = ring.read_avail()
                if chunk:
                    got.extend(chunk)
                else:
                    time.sleep(0.0002)
            rng_out.append(bytes(got))

        t = threading.Thread(target=read_all)
        t.start()
        for i in range(100):
            chunk = bytes([i % 251]) * 100
            rng_in.append(chunk)
            ring.write_bytes(chunk, _alive)
        t.join(timeout=10)
        assert rng_out and rng_out[0] == b"".join(rng_in)
    finally:
        ring.unlink()
        ring.close()


def test_ring_attach_handshake_and_writer_resync():
    """A fresh attacher-writer must not publish until the creator-reader
    discarded the dead incarnation's bytes; a fresh attacher-reader starts
    at a frame boundary."""
    ring = ShmRing.create(1024)
    try:
        ring.write_bytes(b"\xff" * 10, _alive)   # a dead writer's partial
        att = ShmRing.attach(ring.name)
        done = []

        def handshake():
            assert att.attacher_handshake(_alive)
            att.write_bytes(b"fresh", _alive)
            done.append(True)

        t = threading.Thread(target=handshake)
        t.start()
        time.sleep(0.05)
        assert not done          # blocked until the creator acknowledges
        assert ring.reader_resync_check()       # discards the 10 bytes
        t.join(timeout=10)
        assert done
        assert not ring.reader_resync_check()
        assert ring.read_avail() == b"fresh"
        att.close()
    finally:
        ring.unlink()
        ring.close()


def test_ring_creator_writer_resyncs_for_fresh_reader():
    """Ack-ring shape: the creator writes, a respawned attacher reads.
    Unread bytes addressed to the dead reader are discarded before the
    next frame."""
    ring = ShmRing.create(1024)
    try:
        ring.write_bytes(b"stale-acks", _alive)     # never read
        att = ShmRing.attach(ring.name)
        got = []

        def attach_read():
            assert att.attacher_handshake(_alive)
            deadline = time.time() + 10
            while time.time() < deadline:
                chunk = att.read_avail()
                if chunk:
                    got.append(chunk)
                    return
                time.sleep(0.0005)

        t = threading.Thread(target=attach_read)
        t.start()
        time.sleep(0.05)
        ring.write_bytes(b"fresh-acks", _alive)     # resyncs, then writes
        t.join(timeout=10)
        assert got == [b"fresh-acks"]
        att.close()
    finally:
        ring.unlink()
        ring.close()


def test_sweep_stale_rings_reclaims_dead_pid_names():
    ring = ShmRing.create(128)
    name = ring.name
    ring.close()
    # forge a dead-creator name: pid 2**22-1 is (virtually) never live
    stale = f"logio-{2**22 - 1}-0"
    import multiprocessing.shared_memory as sm
    seg = sm.SharedMemory(name=stale, create=True, size=128)
    from multiprocessing import resource_tracker
    try:
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass
    seg.close()
    swept = sweep_stale_rings()
    assert swept >= 1
    with pytest.raises(FileNotFoundError):
        sm.SharedMemory(name=stale)
    # this process is alive: its ring survives the sweep
    reattach = ShmRing.attach(name)
    reattach.close()
    ShmRing.attach(name).unlink()


# ---------------------------------------------------------------------------
# mid-stream SIGKILL with batching in flight, across every byte transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["socket", "tcp", "shm"])
@pytest.mark.parametrize("victim,point", [
    ("map", "post_send"),            # sender dies with superframes queued
    ("win", "post_ack_log"),         # receiver dies with coalesced acks
])
def test_sigkill_mid_batch(transport, victim, point, tmp_path):
    """Exactly-once under real process death while superframes and delayed
    acks are in flight, on each byte transport."""
    build, expected = linear_pipeline(TC, n_events=120, window=4,
                                      sink_target=30, writes=1)
    inj = FailureInjector([(victim, point, 7)])
    eng = Engine(build(), mode="process", transport=transport,
                 store=mk_store(TC, "sqlite+group", tmp_path, batch_size=4,
                                interval=0.001),
                 injector=inj, restart_delay=0.02)
    eng.start()
    ok = eng.wait(90)
    eng.stop()
    assert ok, (transport, victim, point)
    assert sink_outputs(eng) == expected
    assert eng.failures == 1
    tm = eng.metrics().transport
    assert tm.frames > 0
    assert tm.events > 0


# ---------------------------------------------------------------------------
# mid-batch SIGKILL with the adaptive governor (tests/test_batching.py)
# ---------------------------------------------------------------------------

KILL_SPECS = ["memory", "sqlite+group", "segment+group"]
KILL_TRANSPORTS = ["routed", "socket", "shm"]

# kills landing inside the batched phases: mid-classify (phase 1), after
# the one vectored commit before the coalesced acks (phase 3), and inside
# a batched source emission
KILL_POINTS = [
    ("src", "source_post_log", 2),
    ("map", "pre_state_update", 5),
    ("win", "post_ack_log", 3),
]


def _mk(spec, root):
    return mk_store(TC, spec, root, shards=3, batch_size=4, interval=0.001)


@pytest.mark.parametrize("spec", KILL_SPECS)
@pytest.mark.parametrize("transport", KILL_TRANSPORTS)
@pytest.mark.parametrize("op_id,point,nth", KILL_POINTS)
def test_mid_batch_sigkill_exactly_once(op_id, point, nth, spec, transport,
                                        proc_ctx, tmp_path):
    build, expected = linear_pipeline(TC, n_events=64, window=4,
                                      sink_target=16, writes=1)
    inj = FailureInjector([(op_id, point, nth)])
    eng = Engine(build(), mode="process", store=_mk(spec, tmp_path),
                 injector=inj, transport=transport, ctx=proc_ctx,
                 batching="adaptive", restart_delay=0.02)
    eng.start()
    ok = eng.wait(60)
    eng.stop()
    case = (spec, transport, op_id, point)
    assert ok, case
    assert sink_outputs(eng) == expected, case
    assert len(window_writes(eng)) == 16, case
    assert eng.failures == 1, case
    # replay length: at most one batch beyond the durability watermark
    # (plus the credit window of events that were legitimately in flight)
    bound = DEFAULT_MAX_BATCH + CHANNEL_CAPACITY
    for op, s in eng.metrics().ops.items():
        assert s.recovered_resends <= bound, (op, s)
        assert s.recovered_inputs <= bound, (op, s)


def test_env_forced_governor_reaches_workers(proc_ctx, monkeypatch):
    """LOGIO_BATCH=adaptive resolves at the engine and rides the bootstrap
    into the worker processes."""
    monkeypatch.setenv("LOGIO_BATCH", "adaptive")
    build, expected = linear_pipeline(TC, n_events=64, window=4,
                                      sink_target=16)
    eng = Engine(build(), mode="process", store=_mk("memory", None),
                 transport="routed", ctx=proc_ctx, restart_delay=0.02)
    assert eng.batching == "adaptive"
    eng.start()
    ok = eng.wait(60)
    eng.stop()
    assert ok
    assert sink_outputs(eng) == expected
    ops = eng.metrics().ops
    assert any(s.batched_events > 0 for s in ops.values())


# ---------------------------------------------------------------------------
# the public surface and the deprecated channels shim (tests/test_config_api.py)
# ---------------------------------------------------------------------------

def test_api_surface_matches_jax():
    import repro.core as JC
    assert TC.__all__ == JC.__all__
    assert "LocalCluster" in TC.__all__
    for name in TC.__all__:
        assert getattr(TC, name) is not None


def test_channels_shim_warns():
    import importlib
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # the first import and the reload both inside the catch: the shim's
        # warning never leaks into the test session
        import repro_torch.core.channels as ch
        importlib.reload(ch)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    from repro_torch.core.transport.local import Channel
    assert ch.Channel is Channel
