"""TILED packet mode end to end: ``render_frame_tiled`` with the sweep
threshold at 0 in both packages (packet rounds through B7-wave's plain
version, marching retries, whole-table rescue rounds) against the
reference's packet frame, computed once per case.

Tolerance: the reference's own for packet frames
(``tests/test_tiled.py:96-98``): allclose(rtol 1e-4, atol 1e-5) on all but
0.2% of the pixels (an exact nearest-hit tie may pick another prim), and
no ray left unresolved."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu.render_tiled as jrtl
from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.kernels import trace_tiled as tt
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.ops.trace import trace_rays
from raytracer_js_tpu_torch.render import start_substance

from test_tiled_fast import _tiny_scene
from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene
from test_torch_trace import ext_scene

_TINY_CAM = ((0.0, 0.0, 0.5), 128, 32, np.pi / 2, np.pi / 8)
_CASES = {
    # name: (scene, camera, refmax, packet_c_max, seed)
    "c_max_64_record": (_tiny_scene, _TINY_CAM, 2, 64, None),
    "c_max_96_refmax_3": (_tiny_scene, _TINY_CAM, 3, 96, None),
    "rough_glass": (lambda: ext_scene(trans=True, rough=0.6),
                    ((0.0, 0.0, 0.5), 128, 32, 1.4, 0.45), 3, 4096, 5),
}


def assert_packet_tolerance(got, want):
    """The reference's packet-frame check (``tests/test_tiled.py:96``)."""
    got = np.asarray(got)
    mism = (~np.isclose(got, want, rtol=1e-4, atol=1e-5)).any(axis=-1)
    assert mism.mean() < 0.002, f"{mism.sum()} mismatching pixels"
    return int(mism.sum())


@pytest.fixture(scope="module")
def ref_frames():
    """The reference's packet frames (and recordings), one per case."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrtl, "SWEEP_MAX_PRIMS", 0)
        for name, (make, cam, refmax, c_max, seed) in _CASES.items():
            js, jc = make(), make_camera(*cam)
            cfg = RenderConfig(refmax=refmax, backend=JB.BRUTE)
            key = jax.random.key(0 if seed is None else seed)
            img, diag, rec = jrtl.render_frame_tiled(
                js, cfg, jc, packet_c_max=c_max, key=key, with_diag=True,
                with_record=True)
            assert int(diag["unresolved"]) == 0
            out[name] = (js, jc, cfg, np.asarray(img), np.asarray(rec),
                         int(jsamp.seed_from_key(key)))
    return out


@pytest.mark.parametrize("name", sorted(_CASES))
def test_packet_frame_matches_reference(name, ref_frames, monkeypatch):
    js, jc, cfg, ref, ref_rec, seed = ref_frames[name]
    c_max = _CASES[name][3]
    ps, pc, pcfg = to_port_scene(js), to_port_camera(jc), to_port_cfg(cfg)
    assert prtl.supports(ps)
    monkeypatch.setattr(prtl, "SWEEP_MAX_PRIMS", 0)
    calls = {"wave": 0, "dense": 0}
    real_wave, real_dense = tt.wave_bounce_plain, nh.nearest_hit_pallas_plain

    def wave_spy(*a, **kw):
        calls["wave"] += 1
        return real_wave(*a, **kw)

    def dense_spy(*a, **kw):
        calls["dense"] += 1
        return real_dense(*a, **kw)

    monkeypatch.setattr(tt, "wave_bounce_plain", wave_spy)
    monkeypatch.setattr(nh, "nearest_hit_pallas_plain", dense_spy)
    img, diag, rec = prtl.render_frame_tiled(
        ps, pcfg, pc, seed=seed, with_diag=True, with_record=True,
        packet_c_max=c_max)
    assert int(diag["unresolved"]) == 0
    assert diag["packet_rounds"] >= cfg.refmax - 1
    # one wave launch per live segment (one here) per packet round; the
    # rescue rounds search with B4
    assert calls["wave"] == diag["packet_rounds"]
    assert calls["dense"] == diag["rounds"]
    assert_packet_tolerance(img, ref)
    assert rec.shape == ref_rec.shape and rec.dtype == torch.int32
    agree = (rec.numpy() == ref_rec).all(axis=1).mean()
    assert agree >= 0.998, agree
    # the recording replays to the frame
    org, dirs = pixel_rays(pc)
    refr0 = start_substance(ps, pc.pos).expand(org.shape[0])
    replay = trace_rays(ps, pcfg, org, dirs, seed=seed, start_refr=refr0,
                        pid_seq=rec).color
    torch.testing.assert_close(replay.reshape(img.shape), img, rtol=1e-4,
                               atol=1e-5)
    if name == "c_max_64_record":
        # a small budget leaves stragglers: retries run, then rescues
        assert diag["packet_rounds"] > cfg.refmax - 1 and diag["rounds"] > 0
