"""The port's enums, constants and config records equal the reference's."""
import dataclasses

import jax
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import config as jc
from raytracer_js_tpu.ops import sampling as js
from raytracer_js_tpu_torch import config as pc
from raytracer_js_tpu_torch.ops import sampling as ps


@pytest.mark.parametrize("name", ["ResponseType", "RayStatus", "TextureKind",
                                  "ToneMapperKind", "HitBackend"])
def test_enums_equal(name):
    j, p = getattr(jc, name), getattr(pc, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in p]


def test_constants_equal():
    assert pc.EPS_ADVANCE == jc.EPS_ADVANCE
    assert pc.JS_EPSILON == jc.JS_EPSILON


@pytest.mark.parametrize("name", ["RenderConfig", "ToneMapConfig",
                                  "OctreeConfig"])
def test_record_defaults_equal(name):
    def defaults(cls):
        return {f.name: (f.default.value if hasattr(f.default, "value")
                         else f.default)
                for f in dataclasses.fields(cls)}

    assert defaults(getattr(pc, name)) == defaults(getattr(jc, name))


def test_default_seed_is_the_reference_default_key():
    assert ps.DEFAULT_SEED == int(js.seed_from_key(jax.random.key(0)))


def test_salts_equal():
    for k in ("SALT_Z", "SALT_PHI", "SALT_R", "SALT_FRESNEL"):
        assert getattr(ps, k) == getattr(js, k)
