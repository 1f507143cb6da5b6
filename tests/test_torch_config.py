"""Config parity: every field of the port's config trees equals the JAX
package's (the port keeps its own copy of config.py / go1_config.py)."""
import dataclasses

import pytest

from walk_these_ways_tpu import config as j_config
from walk_these_ways_tpu import go1_config as j_go1
from walk_these_ways_tpu_torch import config as t_config
from walk_these_ways_tpu_torch import go1_config as t_go1

CFGS = ["go1_cfg", "mob_train_cfg", "small_train_cfg", "rough_train_cfg"]


def _flat(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("name", CFGS)
def test_cfg_fields_equal(name):
    a = _flat(getattr(j_go1, name)())
    b = _flat(getattr(t_go1, name)())
    assert a.keys() == b.keys()
    diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not diff, diff
    assert len(a) > 200


@pytest.mark.parametrize("name", ["mob_train_cfg", "small_train_cfg"])
def test_cfg_num_envs_and_derived(name):
    a = getattr(j_go1, name)(16)
    b = getattr(t_go1, name)(16)
    assert b.env.num_envs == 16
    assert a.dt == b.dt and a.max_episode_length == b.max_episode_length
    assert dict(a.reward_scales.items()) == dict(b.reward_scales.items())
    assert a.commands.bin_counts == b.commands.bin_counts
    assert a.commands.limits_low == b.commands.limits_low
    assert a.commands.ranges_high == b.commands.ranges_high


def test_section_classes_match():
    names = [n for n in dir(j_config) if n.endswith("Cfg") or n == "CurriculumThresholds"]
    assert len(names) >= 14
    for n in names:
        ja, ta = getattr(j_config, n), getattr(t_config, n)
        assert [f.name for f in dataclasses.fields(ja)] == \
            [f.name for f in dataclasses.fields(ta)], n
    cfg = t_config.update(t_go1.go1_cfg(), env=t_config.update(
        t_go1.go1_cfg().env, num_envs=64))
    assert cfg.env.num_envs == 64
    assert hash(cfg) == hash(cfg)
