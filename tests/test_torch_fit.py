"""The fit loop (``optim/fit``), the parameter partition
(``parallel/sharding.float_partition``) and checkpoints
(``utils/checkpoint``) against the reference package.

Fit losses are compared over a few steps on scenes that draw no random
numbers: with SGD at rtol 1e-5 (float32 reductions in another order), and
with Adam only on camera-pose leaves, whose gradients stand far above
rounding, at rtol 1e-4 (Adam's steps of about lr per entry amplify the
gradients' last bits less than a noise-level entry would)."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.models import camera as jcam
from raytracer_js_tpu.optim import FitConfig as JFitConfig
from raytracer_js_tpu.optim import fit as j_fit
from raytracer_js_tpu.parallel.sharding import float_partition as j_partition
from raytracer_js_tpu.render import render_rays as j_render_rays
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.models.scene import (float_leaf_names,
                                                 float_partition)
from raytracer_js_tpu_torch.optim import FitConfig, fit
from raytracer_js_tpu_torch.render import render_rays
from raytracer_js_tpu_torch.utils import checkpoint as ckpt

from scenes import config1_scene
from test_fit import _pose_scene, _scene as color_scene
from test_replay import _scene as replay_scene
from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene

j_fitmod = sys.modules["raytracer_js_tpu.optim.fit"]
pfit = sys.modules["raytracer_js_tpu_torch.optim.fit"]


def _jax_image_scene():
    from raytracer_js_tpu import ResponseType, SceneBuilder

    b = SceneBuilder(atlas_hw=(4, 4))
    b.set_sky(b.add_solid_texture((0.3, 0.4, 0.5)))
    m = b.add_material(ResponseType.REFLECTION, roughness=0.2)
    b.add_sphere((4, 0, 0), 1.0, m,
                 b.add_image_texture(np.full((4, 4, 3), 0.5, np.float32)))
    b.add_triangle((3, -1, -1), (3, 1, -1), (3, 0, 1), m,
                   b.add_solid_texture((0.2, 0.9, 0.1)))
    return b.build()


@pytest.mark.parametrize("make", [lambda: config1_scene(True, True),
                                  _jax_image_scene, _pose_scene],
                         ids=["config1_glass_tri", "image_tri", "pose"])
def test_float_partition_matches_reference(make):
    js = make()
    want, _ = j_partition(js)
    ps = to_port_scene(js)
    got, rebuild = float_partition(ps)
    assert float_leaf_names(ps) == [
        "sphere_center", "sphere_radius", "box_center", "box_half", "tri_v0",
        "tri_v1", "tri_v2", "materials.roughness", "textures.solid_rgb",
        "textures.atlas", "sub_refr", "default_refr"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    doubled = rebuild([2.0 * p for p in got])
    np.testing.assert_array_equal(doubled.textures.solid_rgb.numpy(),
                                  2.0 * np.asarray(js.textures.solid_rgb))
    assert doubled.prim_texture is ps.prim_texture
    with pytest.raises(ValueError, match="expected 12 params"):
        rebuild(got[:-1])


def test_project_triad_grads_matches_reference():
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32)
              for s in [(5, 3), (5,)] + [(3,)] * 8]
    grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
    want = j_fitmod._project_triad_grads(
        [jnp.asarray(p) for p in params], [jnp.asarray(g) for g in grads],
        2, 2)
    got = pfit._project_triad_grads(
        [torch.as_tensor(p) for p in params],
        [torch.as_tensor(g) for g in grads], 2, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _both_fits(js, cfg, cams, targets, fc, trainable=None):
    want = j_fit(js, cfg, cams, jnp.asarray(targets), JFitConfig(**fc),
                 key=jax.random.key(1), trainable=trainable)
    got = fit(to_port_scene(js), to_port_cfg(cfg),
              [to_port_camera(c) for c in cams], torch.as_tensor(np.array(targets)),
              FitConfig(**fc), trainable=trainable)
    return got, want


@pytest.mark.parametrize("trans,replay_every", [(False, 0), (False, 1),
                                                (False, 3), (True, 1)])
def test_fit_losses_match_reference(trans, replay_every):
    """SGD on every leaf: the search path, the B5 replay (the mirror scene
    is in its class), and the autograd replay (transmission is not)."""
    js = replay_scene(trans=trans)
    cfg = RenderConfig(refmax=2)
    cams = [make_camera((0.0, 0.0, 0.5), 12, 12, np.pi / 2, np.pi / 2)]
    targets = np.full((1, 144, 3), 0.1, np.float32)
    fc = dict(steps=4, lr=1e-2, optimizer="sgd", replay_every=replay_every)
    got, want = _both_fits(js, cfg, cams, targets, fc)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.losses[-1] < got.losses[0]
    for g, w in zip(float_partition(got.scene)[0], j_partition(want.scene)[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_fit_cameras_matches_reference():
    """Adam on the pose leaves only, through the triad projection and the
    retraction; the triad stays orthonormal."""
    js = _pose_scene()
    cfg = RenderConfig(refmax=1, distance_attenuation_factor=0.1)
    true_cam = make_camera((0, 0, 0), 12, 12, np.pi / 2, np.pi / 2)
    targets = np.asarray(jnp.stack([
        j_render_rays(js, cfg, *jcam.pixel_rays(true_cam), jax.random.key(1),
                      jnp.arange(144, dtype=jnp.int32))]))
    start = jcam.rotate_h(jcam.move(true_cam, (0.1, 0.2, -0.15)), 0.06)
    n_scene = len(j_partition(js)[0])
    got, want = _both_fits(js, cfg, [start], targets,
                           dict(steps=3, lr=1e-2, fit_cameras=True),
                           trainable=lambda i, p: i >= n_scene)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    cam = got.cameras[0]
    for k in ("pos", "front", "left", "up"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(want.cameras[0], k)),
                                   rtol=1e-4, atol=1e-6)
    tri = torch.stack([cam.front, cam.left, cam.up])
    torch.testing.assert_close(tri @ tri.T, torch.eye(3), rtol=0, atol=1e-5)


def test_fit_refuses_what_is_not_ported():
    """Nothing is refused any more but ``replay_every`` with spp > 1: a
    fit on the one-rank mesh equals the plain fit, and the OCTREE accel
    and its rebuild policy run (``accel_every`` without an accel changes
    nothing, and the fit through the octree follows the dense one)."""
    from raytracer_js_tpu_torch.parallel import make_mesh

    ps = to_port_scene(color_scene((0.5, 0.5, 0.5)))
    cams = [to_port_camera(make_camera((0, 0, 0), 4, 4, 1.5, 1.5))]
    tgt = torch.zeros((1, 16, 3))
    cfg = to_port_cfg(RenderConfig(refmax=1))
    fc = FitConfig(steps=3, lr=1e-2)
    dense = fit(ps, cfg, cams, tgt, fc)
    meshed = fit(ps, cfg, cams, tgt, fc, mesh=make_mesh(device="cpu"))
    assert meshed.losses == dense.losses
    for a, b in zip(float_partition(meshed.scene)[0],
                    float_partition(dense.scene)[0]):
        assert torch.equal(a, b)
    assert fit(ps, cfg, cams, tgt, FitConfig(steps=3, lr=1e-2,
                                             accel_every=2)).losses \
        == dense.losses
    from raytracer_js_tpu_torch import HitBackend, OctreeConfig
    from raytracer_js_tpu_torch.accel.octree import build_octree

    octree = fit(ps, dataclasses.replace(cfg, backend=HitBackend.OCTREE),
                 cams, tgt, FitConfig(steps=3, lr=1e-2, accel_every=2),
                 accel=build_octree(ps, OctreeConfig(max_depth=2)))
    np.testing.assert_allclose(octree.losses, dense.losses, rtol=1e-5)
    with pytest.raises(ValueError, match="spp == 1"):
        fit(ps, to_port_cfg(RenderConfig(refmax=1, spp=2)), cams, tgt,
            FitConfig(replay_every=1))


def test_untrained_leaf_gets_zero_gradient_and_stays():
    """A leaf the loss never reaches (the empty triangle tables, the atlas
    of a solid scene) has no .grad in torch: it counts as zero."""
    ps = to_port_scene(color_scene((0.5, 0.5, 0.5)))
    cams = [to_port_camera(make_camera((0, 0, 0), 6, 6, 1.5, 1.5))]
    res = fit(ps, to_port_cfg(RenderConfig(refmax=1)), cams,
              torch.full((1, 36, 3), 0.2), FitConfig(steps=2, lr=1e-2))
    assert torch.equal(res.scene.textures.atlas, ps.textures.atlas)
    assert not torch.equal(res.scene.textures.solid_rgb,
                           ps.textures.solid_rgb)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.zeros(4, dtype=torch.int32), torch.ones(())),
            "c": [torch.tensor(2.5), np.arange(3)], 7: {"lr": 0.01,
                                                       "betas": (0.9, 0.999),
                                                       "flag": None}}
    p = ckpt.save(tmp_path / "x", tree, step=7, meta={"k": "v"})
    assert p.suffix == ".npz" and p.with_suffix(".json").exists()
    out, step, meta = ckpt.restore(p, device="cpu")
    assert step == 7 and meta == {"k": "v"}
    assert out[7] == {"lr": 0.01, "betas": (0.9, 0.999), "flag": None}
    assert out["b"][0].dtype == torch.int32 and isinstance(out["b"], tuple)
    torch.testing.assert_close(out["a"], tree["a"], rtol=0, atol=0)
    np.testing.assert_array_equal(out["c"][1], tree["c"][1])
    like, _, _ = ckpt.restore(p, like=tree)
    assert like["c"][0].dtype == torch.float32


def test_checkpoint_rejects_wrong_structure(tmp_path):
    p = ckpt.save(tmp_path / "x", {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(p, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(p, {"a": torch.zeros(4)})


def test_checkpoint_latest(tmp_path):
    for s in (5, 20, 10):
        ckpt.save(tmp_path / f"ckpt_{s}", {"a": torch.zeros(1)}, step=s)
    (tmp_path / "ckpt_x.npz").write_bytes(b"")
    assert ckpt.latest(tmp_path).stem == "ckpt_20"
    assert ckpt.latest(tmp_path / "none") is None


def test_fit_resume_bit_exact(tmp_path):
    """A fit stopped at step 4 and resumed lands exactly where an
    uninterrupted 8-step fit lands (Adam's state included)."""
    cfg = to_port_cfg(RenderConfig(refmax=1))
    cams = [to_port_camera(make_camera((0, 0, 0), 8, 8, np.pi / 2,
                                       np.pi / 2))]
    targets = render_rays(to_port_scene(color_scene((0.9, 0.2, 0.1))), cfg,
                          *pixel_rays(cams[0]))[None]
    start = to_port_scene(color_scene((0.5, 0.5, 0.5)))
    full = fit(start, cfg, cams, targets, FitConfig(steps=8, lr=1e-2))
    d = tmp_path / "ck"
    fit(start, cfg, cams, targets,
        FitConfig(steps=4, lr=1e-2, save_every=4, ckpt_dir=str(d)))
    resumed = fit(start, cfg, cams, targets,
                  FitConfig(steps=8, lr=1e-2, save_every=4, ckpt_dir=str(d)))
    assert resumed.losses == full.losses[4:]
    for a, b in zip(float_partition(resumed.scene)[0],
                    float_partition(full.scene)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ckpt.latest(d).stem == "ckpt_8"


@pytest.mark.parametrize("trans,replay_every", [(True, 0), (False, 2)])
def test_fit_accel_rebuild_matches_reference(trans, replay_every,
                                             monkeypatch):
    """``fit(accel=..., accel_every=2)`` on the OCTREE backend: SGD losses
    and leaves as the reference's fit with its accel, and the octree
    rebuilt at the same steps (the reference's rebuild is shape-pinned,
    the port's a fresh build)."""
    from raytracer_js_tpu.accel import octree as jo
    from raytracer_js_tpu.config import HitBackend as JB
    from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
    from raytracer_js_tpu_torch.accel import octree as po
    from raytracer_js_tpu_torch.config import OctreeConfig

    js = replay_scene(trans=trans)
    cfg = RenderConfig(refmax=2, backend=JB.OCTREE)
    cams = [make_camera((0.0, 0.0, 0.5), 12, 12, np.pi / 2, np.pi / 2)]
    targets = np.full((1, 144, 3), 0.1, np.float32)
    fc = dict(steps=5, lr=1e-2, optimizer="sgd", accel_every=2,
              replay_every=replay_every)
    built = {"jax": [], "port": []}

    def counting(name, real):
        def build(scene, *a, **kw):
            built[name].append(kw.get("like") is not None)
            return real(scene, *a, **kw)
        return build

    monkeypatch.setattr(jo, "build_octree", counting("jax", jo.build_octree))
    monkeypatch.setattr(po, "build_octree", counting("port", po.build_octree))
    want = j_fit(js, cfg, cams, jnp.asarray(targets), JFitConfig(**fc),
                 key=jax.random.key(1),
                 accel=jo.build_octree(js, JOctreeConfig(max_depth=3)))
    ps = to_port_scene(js)
    got = fit(ps, to_port_cfg(cfg), [to_port_camera(c) for c in cams],
              torch.as_tensor(targets), FitConfig(**fc),
              accel=po.build_octree(ps, OctreeConfig(max_depth=3)))
    # the first build, then rebuilds at steps 2 and 4 (the reference's
    # with like=)
    assert built["jax"] == [False, True, True]
    assert built["port"] == [False, False, False]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.losses[-1] < got.losses[0]
    for g, w in zip(float_partition(got.scene)[0], j_partition(want.scene)[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
