"""The port's Config is a standalone copy of the JAX package's: same fields,
defaults, presets, overrides and JSON round-trip (exact equality)."""

import dataclasses

import pytest

from stove_tpu import config as jcfg
from stove_tpu_torch import config as tcfg


def test_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcfg.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcfg.Config)]
    assert tf == jf


def test_presets_equal():
    assert tcfg.PRESETS == jcfg.PRESETS
    assert tcfg._PRESET_COMMON == jcfg._PRESET_COMMON


@pytest.mark.parametrize("preset", [None] + sorted(jcfg.PRESETS))
def test_make_config_and_overrides_equal(preset):
    kv = ("cl=4", "encoder_channels=8,16", "velocity_obs=filtered",
          "overshoot_sample=true")
    j = jcfg.make_config(preset, *kv)
    t = tcfg.make_config(preset, *kv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.debug_shrunk()) == \
        dataclasses.asdict(j.debug_shrunk())


def test_json_round_trip_of_checkpoint_config():
    with open("ckpts/r4rp_bill_s32/config.json") as f:
        text = f.read()
    t = tcfg.Config.from_json(text)
    assert dataclasses.asdict(t) == \
        dataclasses.asdict(jcfg.Config.from_json(text))
    assert tcfg.Config.from_json(t.to_json()) == t


@pytest.mark.parametrize("bad", ["nokey=1", "cl", "debug=maybe"])
def test_override_errors(bad):
    with pytest.raises((KeyError, ValueError)):
        tcfg.make_config(None, bad)
