"""The port's typed config API and curated public surface, on the CPU: a
copy of ``tests/test_config_api.py`` on ``repro_torch.core`` (its
``test_channels_shim_warns`` is in ``tests/test_torch_wire.py``).

* ``StoreConfig`` <-> spec-string round trips (each spec's string and
  fields ``==`` ``repro.core``'s), refusals of malformed specs and fields,
  ``build_store`` taking either form;
* ``TransportConfig`` validation and the legacy ``transport_options``;
* ``ControllerConfig`` round trips and refusals (parsed configs ``==``
  ``repro.core``'s, field for field);
* the frozen ``MetricsSnapshot`` and the deprecated accessors' warnings;
* the ``repro_torch.core`` surface snapshot: the same names as
  ``repro.core``'s.
"""
import dataclasses
import warnings

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (ControllerConfig, Engine,  # noqa: E402
                              StoreConfig, TransportConfig, build_store)
from repro_torch.core.logstore import (GroupCommitStore,  # noqa: E402
                                       MemoryLogStore, NullLogStore,
                                       SegmentLogStore, ShardedLogStore,
                                       SqliteLogStore)
from tests.torch_core_helpers import linear_pipeline  # noqa: E402


# ---------------------------------------------------------------------------
# StoreConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,base,sharded,group", [
    ("memory", "memory", False, False),
    ("sqlite+group", "sqlite", False, True),
    ("segment+sharded", "segment", True, False),
    ("segment+sharded+group", "segment", True, True),
    ("null", "null", False, False),
])
def test_spec_round_trip(spec, base, sharded, group):
    cfg = StoreConfig.parse(spec)
    assert (cfg.base, cfg.sharded, cfg.group) == (base, sharded, group)
    assert str(cfg) == spec
    assert str(StoreConfig.parse(str(cfg))) == spec
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JC.StoreConfig.parse(spec))


@pytest.mark.parametrize("spec,match", [
    ("rocksdb", "unknown store base"),
    ("memory+turbo", "unknown store modifier"),
    ("memory+group+group", "duplicate store modifier"),
    ("", "non-empty string"),
    (None, "non-empty string"),
    ("+group", "unknown store base"),
])
def test_malformed_specs_raise(spec, match):
    with pytest.raises(ValueError, match=match):
        StoreConfig.parse(spec)


@pytest.mark.parametrize("field,value,match", [
    ("shards", 0, "shards must be >= 1"),
    ("batch_size", 0, "batch_size must be >= 1"),
    ("interval", -1.0, "interval must be >= 0"),
    ("segment_bytes", 0, "segment_bytes must be >= 1"),
    ("checkpoint_interval", -1, "checkpoint_interval must be >= 0"),
])
def test_malformed_fields_raise(field, value, match):
    with pytest.raises(ValueError, match=match):
        StoreConfig(**{field: value})


def test_config_is_frozen():
    cfg = StoreConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.base = "sqlite"


def test_build_store_accepts_config_and_spec(tmp_path):
    # typed path: segment knobs (no spec-string syntax) thread through
    cfg = StoreConfig(base="segment", group=True,
                      path=str(tmp_path / "segs"),
                      segment_bytes=1024, compress=False,
                      checkpoint_interval=7)
    store = build_store(cfg)
    assert isinstance(store, GroupCommitStore)
    assert isinstance(store.inner, SegmentLogStore)
    assert store.inner.segment_bytes == 1024
    assert store.inner.compress is False
    assert store.inner.checkpoint_interval == 7
    store.close()
    # legacy path: spec string + keyword overrides still work
    store = build_store("sqlite", path=str(tmp_path / "log.db"))
    assert isinstance(store, SqliteLogStore)
    store.close()
    assert isinstance(build_store("memory"), MemoryLogStore)
    assert isinstance(build_store("null"), NullLogStore)
    sharded = build_store("memory+sharded", shards=2)
    assert isinstance(sharded, ShardedLogStore)
    assert len(sharded.shards) == 2


def test_build_store_rejects_overrides_with_config(tmp_path):
    cfg = StoreConfig(base="sqlite", path=str(tmp_path / "log.db"))
    with pytest.raises(ValueError, match="inside the StoreConfig"):
        build_store(cfg, path=str(tmp_path / "other.db"))
    with pytest.raises(ValueError, match="StoreConfig or a spec"):
        build_store(42)


def test_durable_bases_require_path():
    with pytest.raises(ValueError, match="sqlite store needs a path"):
        build_store("sqlite")
    with pytest.raises(ValueError, match="segment store needs a path"):
        build_store("segment")


def test_engine_accepts_store_config(tmp_path):
    build, expected = linear_pipeline(TC)
    cfg = StoreConfig(base="segment", path=str(tmp_path / "segs"),
                      checkpoint_interval=10)
    eng = Engine(build(), mode="step", store=cfg)
    eng.run_to_completion()
    assert isinstance(eng.store, SegmentLogStore)
    assert eng.store.compactions > 0


# ---------------------------------------------------------------------------
# TransportConfig
# ---------------------------------------------------------------------------

def test_transport_config_options():
    assert TransportConfig().options() == {}
    cfg = TransportConfig(name="socket", family="inet", host="127.0.0.1",
                          authkey=b"s")
    assert cfg.options() == {"family": "inet", "host": "127.0.0.1",
                             "authkey": b"s"}
    assert cfg.options() == JC.TransportConfig(
        name="socket", family="inet", host="127.0.0.1",
        authkey=b"s").options()


@pytest.mark.parametrize("kw,match", [
    ({"name": "carrier-pigeon"}, "unknown transport"),
    ({"family": "ipx"}, "unknown socket family"),
])
def test_transport_config_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        TransportConfig(**kw)


def test_engine_accepts_transport_config():
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="step", transport=TransportConfig(name="local"))
    eng.run_to_completion()
    # options must live inside the config once the typed form is used
    with pytest.raises(ValueError, match="inside the TransportConfig"):
        Engine(build(), transport=TransportConfig(name="local"),
               transport_options={"family": "unix"})


# ---------------------------------------------------------------------------
# Curated public surface
# ---------------------------------------------------------------------------

def test_api_surface_snapshot():
    # the documented public surface (docs/api.md), the same as repro.core's
    assert sorted(TC.__all__) == [
        "ControllerConfig",
        "Engine",
        "EventKey",
        "LineageFilter",
        "LineageQuery",
        "LineageScope",
        "LocalCluster",
        "LogioAPI",
        "MetricsSnapshot",
        "OpMetrics",
        "Pipeline",
        "Placement",
        "StoreConfig",
        "TransportConfig",
        "build_store",
    ]
    assert sorted(TC.__all__) == sorted(JC.__all__)
    for name in TC.__all__:
        assert getattr(TC, name) is not None


def test_lineage_free_functions_shim_warns():
    """The free-function query surface moved to LineageQuery; the shims
    must warn on CALL (not import) and still return the old tuple lists."""
    from repro_torch.core import Event, LineageQuery, backward, forward
    from repro_torch.core.events import UNDONE

    store = MemoryLogStore()
    txn = store.begin()
    txn.log_event(Event(0, "a", "out", "b", "in"), UNDONE)
    txn.commit()
    txn = store.begin()
    txn.assign_insets(("a", "out", 0), ["i0"], rec_op="b")
    txn.put_lineage(0, "b", "out", "i0")
    txn.commit()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old_bw = backward(store, ("b", "out", 0))
        old_fw = forward(store, ("a", "out", 0), "b")
    assert len([w for w in caught
                if issubclass(w.category, DeprecationWarning)]) == 2
    assert all("LineageQuery" in str(w.message) for w in caught)
    # the shims delegate: identical answers to the typed facade
    assert old_bw == LineageQuery(store).backward(("b", "out", 0)).keys()
    assert old_fw == LineageQuery(store).forward(("a", "out", 0), "b").keys()


# ---------------------------------------------------------------------------
# ControllerConfig
# ---------------------------------------------------------------------------

def test_controller_config_round_trip():
    cfg = ControllerConfig(slo_ms=50.0, switch_hysteresis=2, max_replicas=6)
    assert ControllerConfig.parse(str(cfg)) == cfg
    parsed = ControllerConfig.parse("slo_ms=50,switch_hysteresis=2,"
                                    "max_replicas=6")
    assert parsed == cfg
    # overrides win over the spec
    assert ControllerConfig.parse("slo_ms=50", slo_ms=75.0).slo_ms == 75.0
    assert str(cfg) == str(JC.ControllerConfig(
        slo_ms=50.0, switch_hysteresis=2, max_replicas=6))
    assert dataclasses.asdict(parsed) == dataclasses.asdict(
        JC.ControllerConfig.parse("slo_ms=50,switch_hysteresis=2,"
                                  "max_replicas=6"))


@pytest.mark.parametrize("spec,match", [
    ("", "non-empty string"),
    (None, "non-empty string"),
    ("slo_ms", "malformed controller spec"),
    ("warp_factor=9", "unknown controller spec key"),
    ("slo_ms=50,slo_ms=60", "duplicate controller spec key"),
    ("slo_ms=fast", "bad value for controller spec key"),
])
def test_controller_config_malformed_specs_raise(spec, match):
    with pytest.raises(ValueError, match=match):
        ControllerConfig.parse(spec)


@pytest.mark.parametrize("kw,match", [
    ({"slo_ms": 0}, "slo_ms must be > 0"),
    ({"sample_interval": 0}, "sample_interval must be > 0"),
    ({"switch_hysteresis": 0}, "switch_hysteresis must be >= 1"),
    ({"min_replicas": 0}, "min_replicas must be >= 1"),
    ({"min_replicas": 3, "max_replicas": 2},
     "max_replicas must be >= min_replicas"),
    ({"high_rate_eps": 0}, "high_rate_eps must be > 0"),
    ({"epoch_interval": 1}, "epoch_interval must be >= 2"),
    ({"scale_cooldown": -1}, "scale_cooldown must be >= 0"),
])
def test_controller_config_bad_fields_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        ControllerConfig(**kw)


def test_controller_config_is_frozen():
    cfg = ControllerConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.slo_ms = 1.0


# ---------------------------------------------------------------------------
# the typed metrics plane + legacy-accessor deprecation shims
# ---------------------------------------------------------------------------

def test_metrics_snapshot_is_typed_and_frozen():
    from repro_torch.core import MetricsSnapshot, OpMetrics
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="step")
    eng.run_to_completion()
    m = eng.metrics()
    assert isinstance(m, MetricsSnapshot)
    assert m.mode == "step" and m.protocol == "logio"
    win = m.op("win")
    assert isinstance(win, OpMetrics)
    assert win.processed == win.events_in + win.events_out > 0
    assert m.recovery_modes["win"] == "log"
    with pytest.raises(dataclasses.FrozenInstanceError):
        win.events_in = 0
    with pytest.raises(TypeError):
        m.ops["win"] = win       # frozen mapping view


def test_legacy_stats_accessors_warn_and_delegate():
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="step")
    eng.run_to_completion()
    m = eng.metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ps = eng.process_stats()
        detail = eng.op_stats_detail()
        ws = eng.wire_stats()
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 3
    assert all("Engine.metrics()" in str(w.message) for w in deps)
    assert ps == {op: om.processed for op, om in m.ops.items()}
    assert detail["win"]["txns"] == m.op("win").txns
    assert ws == {}              # step mode: no byte wire


def test_backend_query_stats_shim_warns():
    store = MemoryLogStore()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stats = store.query_stats()
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert stats == store._query_stats()
