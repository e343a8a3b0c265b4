"""Gradients through the search path, the camera pose, ``remat`` and the
FUSED and TILED refusals, against the reference package on the
``tests/test_grad.py`` config-1 scene (12x12, refmax 3).

Tolerance: rtol 2e-4 / atol 2e-6 against ``jax.grad`` (another order of
float32 rounding in the surface recompute, and XLA fuses multiply-adds on
the CPU); PALLAS and BRUTE gradients inside the port are equal exactly
(the search carries no gradient)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import render_hdr as j_render_hdr
from raytracer_js_tpu.config import HitBackend as JBackend
from raytracer_js_tpu.models import camera as jcam
from raytracer_js_tpu.parallel.sharding import float_partition as j_partition
import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch import HitBackend
from raytracer_js_tpu_torch.kernels import trace_fused
from raytracer_js_tpu_torch.models import camera as pcam
from raytracer_js_tpu_torch.models.scene import (float_leaf_names,
                                                 float_partition)
from raytracer_js_tpu_torch.render import render_rays

from scenes import config1_camera, config1_cfg, config1_scene
from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene

TOL = dict(rtol=2e-4, atol=2e-6)
POSE = ("pos", "front", "left", "up")


def _port_grads(ps, cam, cfg):
    params, rebuild = float_partition(ps)
    params = [p.clone().requires_grad_(True) for p in params]
    img = rt.render_hdr(rebuild(params), cam, cfg)
    (img ** 2).sum().backward()
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in params]


@pytest.mark.parametrize("glass_tri", [False, True])
def test_search_grads_match_reference(glass_tri):
    js = config1_scene(with_glass=glass_tri, with_tri=glass_tri)
    jc, cfg = config1_camera(12, 12), config1_cfg()
    params, rebuild = j_partition(js)
    want = jax.grad(lambda p: jnp.sum(j_render_hdr(rebuild(p), jc, cfg)
                                      ** 2))(params)
    got = _port_grads(to_port_scene(js), to_port_camera(jc),
                      to_port_cfg(cfg))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0


def test_pallas_grads_equal_brute():
    ps = to_port_scene(config1_scene())
    cam = to_port_camera(config1_camera(12, 12))
    brute = _port_grads(ps, cam, to_port_cfg(config1_cfg()))
    pallas = _port_grads(ps, cam, dataclasses.replace(
        to_port_cfg(config1_cfg()), backend=HitBackend.PALLAS))
    for a, b in zip(pallas, brute):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_camera_pose_grads_match_reference():
    js = config1_scene()
    jc, cfg = config1_camera(12, 12), config1_cfg()

    def loss(pose):
        cam = jc.replace(**dict(zip(POSE, pose)))
        return jnp.sum(j_render_hdr(js, cam, cfg) ** 2)

    want = jax.grad(loss)([getattr(jc, k) for k in POSE])
    pc = to_port_camera(jc)
    pose = [getattr(pc, k).clone().requires_grad_(True) for k in POSE]
    img = rt.render_hdr(to_port_scene(js),
                        dataclasses.replace(pc, **dict(zip(POSE, pose))),
                        to_port_cfg(cfg))
    (img ** 2).sum().backward()
    for p, w in zip(pose, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **TOL)


def test_camera_helpers_match_reference():
    jc = jcam.rotate_h(jcam.make_camera((0.2, -0.3, 0.5), 8, 8, 1.3, 1.1),
                       0.4)
    jc = jc.replace(front=jc.front * 1.1 + 0.02, left=jc.left + 0.03)
    pc = to_port_camera(jc)
    for jf, pf, args in ((jcam.renormalized, pcam.renormalized, ()),
                         (jcam.move_xy_forward, pcam.move_xy_forward,
                          (0.7,))):
        want, got = jf(jc, *args), pf(pc, *args)
        for k in POSE:
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6, atol=1e-7)
    tri = torch.stack([getattr(pcam.renormalized(pc), k)
                       for k in ("front", "left", "up")])
    torch.testing.assert_close(tri @ tri.T, torch.eye(3), rtol=0, atol=1e-6)


def test_fused_refuses_inputs_that_require_grad():
    """The fused kernels and their plain versions return detached colors:
    a loss through them got zero gradients without a word. render_hdr and
    render_rays on FUSED now raise instead, as jax.grad refuses to
    transpose a Pallas call."""
    ps = to_port_scene(config1_scene())
    cam = to_port_camera(config1_camera(8, 8))
    cfg = to_port_cfg(config1_cfg(backend=JBackend.FUSED))
    params, rebuild = float_partition(ps)
    params = [p.clone().requires_grad_(True) for p in params]
    sc = rebuild(params)
    # the silent zero: what render_hdr FUSED returned before the refusal
    img = trace_fused.trace_frame_fused(sc, cfg, cam)
    assert not img.requires_grad
    ((img ** 2).sum() + 0.0 * params[1].sum()).backward()
    assert float(params[1].grad.abs().sum()) == 0.0
    with pytest.raises(RuntimeError, match="PALLAS.*BRUTE"):
        rt.render_hdr(sc, cam, cfg)
    org, d = pcam.pixel_rays(cam)
    with pytest.raises(RuntimeError, match="PALLAS.*BRUTE"):
        render_rays(ps, cfg, org.requires_grad_(True), d)
    pose = dataclasses.replace(cam, pos=cam.pos.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="no backward"):
        rt.render_hdr(ps, pose, cfg)
    with torch.no_grad():
        assert tuple(rt.render_hdr(sc, cam, cfg).shape) == (8, 8, 3)


def test_tiled_refuses_inputs_that_require_grad():
    """TILED's bounce 0 shades inside kernel B7 (detached) while its sweep
    rounds record autograd, so a loss through it got partial gradients
    without a word. ``render_hdr`` TILED (forced with ``tables=``) and the
    TILED frame functions now raise, naming TILED; without grad they
    render as before."""
    from raytracer_js_tpu_torch import render_tiled as prtl

    ps = to_port_scene(config1_scene())
    cam = to_port_camera(config1_camera(8, 8))
    cfg = rt.RenderConfig(refmax=2, backend=HitBackend.TILED)
    tables = prtl.frame_tables(ps, cam)
    params, rebuild = float_partition(ps)
    k = float_leaf_names(ps).index("textures.solid_rgb")
    sc = rebuild([p.clone().requires_grad_(i == k)
                  for i, p in enumerate(params)])
    with pytest.raises(RuntimeError, match="TILED backend has no backward"):
        rt.render_hdr(sc, cam, cfg, tables=tables)
    for frame in (prtl.render_frame_tiled,
                  prtl.render_frame_tiled_replay_shaded):
        with pytest.raises(RuntimeError, match="TILED.*PALLAS.*BRUTE"):
            frame(sc, cfg, cam, tables=tables)
    pose = dataclasses.replace(cam, pos=cam.pos.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="TILED"):
        rt.render_hdr(ps, pose, cfg, tables=tables)
    with torch.no_grad():
        img = rt.render_hdr(sc, cam, cfg, tables=tables)
    assert torch.equal(img, rt.render_hdr(ps, cam, cfg, tables=tables))
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_remat_gradients_match():
    """``cfg.remat`` recomputes each bounce in the backward instead of
    keeping its residuals (``tests/test_grad.py``'s memory knob): the same
    value and gradients, bit for bit (the counter RNG makes the recompute
    exact), and far fewer tensor elements saved for the backward."""
    ps = to_port_scene(config1_scene(with_glass=True, with_tri=True))
    cam = to_port_camera(jcam.make_camera((0, 0, 0.5), 16, 8, np.pi / 2,
                                          np.pi / 4))
    org, d = pcam.pixel_rays(cam)
    params, rebuild = float_partition(ps)

    def run(remat):
        ps_ = [p.clone().requires_grad_(True) for p in params]
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        cfg = rt.RenderConfig(refmax=3, remat=remat)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = (render_rays(rebuild(ps_), cfg, org, d) ** 2).sum()
        loss.backward()
        return loss.detach(), [p.grad for p in ps_], sum(saved)

    v0, g0, saved0 = run(False)
    v1, g1, saved1 = run(True)
    assert torch.equal(v0, v1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert float(g0[0].abs().sum()) > 0
    assert saved1 < saved0 / 4, (saved0, saved1)

