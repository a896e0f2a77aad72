"""The port's copy of the train presets (``repro_torch.launch.presets``)
against the JAX package's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.launch import presets as JP  # noqa: E402
from repro_torch.launch import presets as TP  # noqa: E402


def test_presets_match_jax_field_by_field():
    assert sorted(TP.PRESETS) == sorted(JP.PRESETS)
    fields = [f.name for f in dataclasses.fields(JP.Preset)]
    assert [f.name for f in dataclasses.fields(TP.Preset)] == fields
    for arch, want in JP.PRESETS.items():
        got = TP.PRESETS[arch]
        for name in fields:
            assert getattr(got, name) == getattr(want, name), (arch, name)
    assert dataclasses.asdict(TP._BIG) == dataclasses.asdict(JP._BIG)


@pytest.mark.parametrize("arch", ["grok-1-314b", "no-such-arch"])
def test_preset_for_matches_jax(arch):
    assert (dataclasses.asdict(TP.preset_for(arch))
            == dataclasses.asdict(JP.preset_for(arch)))
    if arch not in JP.PRESETS:
        assert TP.preset_for(arch) == TP.Preset()
