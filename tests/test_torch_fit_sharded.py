"""``fit(mesh=...)`` at 1, 2 and 4 ranks against the port's unsharded fit
and the reference's ``fit(mesh=make_mesh())`` (mirrors the mesh cases of
``tests/test_fit.py``, ``tests/test_replay.py`` and
``tests/test_replay_grad.py``): the search path, the autograd replay, the
B5 replay (its plain version on the CPU), camera poses, and an OCTREE
accel rebuilt with ``accel_every``; checkpoints written by rank 0 and
restored by every rank.

The ranks run as in ``tests/test_torch_sharding.py`` (``run_ranks``). All
fits use SGD: Adam's first step is lr x sign(g), and gradients that are 0
up to rounding take either sign under another sum order. Tolerances:
against the unsharded port, float32 sum order (losses rtol 1e-5, params
rtol 1e-5 / atol 1e-6); against the reference, each reference test's own
(rtol 1e-5 and atol 1e-7; camera poses rtol 1e-4 and atol 1e-8, the poses
themselves rtol 1e-4 / atol 1e-6). The ranks hold the same params bit for
bit.
"""
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu_torch import HitBackend, OctreeConfig
from raytracer_js_tpu_torch.accel.octree import build_octree
from raytracer_js_tpu_torch.optim import FitConfig, fit
from raytracer_js_tpu_torch.parallel import float_partition

from test_torch_sharding import WORLDS, Runs

#: case -> the reference test's loss tolerance (rtol, atol)
CASES = {
    "search": (1e-5, 1e-7),
    "replay_autograd": (1e-5, 0.0),
    "replay_b5": (1e-5, 1e-7),
    "cameras": (1e-4, 1e-8),
    "octree": (1e-5, 0.0),
}


def _run(case, mesh=None, **fc_over):
    accel = (build_octree(case["scene"], OctreeConfig(max_depth=3))
             if case["accel"] else None)
    fc = FitConfig(**{**case["fc"], **fc_over})
    return fit(case["scene"], case["cfg"], case["cams"], case["targets"], fc,
               mesh=mesh, accel=accel)


def _fit_cases(mesh, inp):
    out = {}
    for name in CASES:
        r = _run(inp[name], mesh)
        out[name] = (r.losses, float_partition(r.scene)[0], r.cameras)
    # checkpoints: rank 0 writes, every rank restores and resumes
    d = pathlib.Path(inp["ckpt_base"]) / f"w{mesh.world_size}"
    full = _run(inp["search"], mesh, steps=6)
    _run(inp["search"], mesh, steps=4, save_every=2, ckpt_dir=str(d))
    resumed = _run(inp["search"], mesh, steps=6, save_every=2,
                   ckpt_dir=str(d))
    out["ckpt"] = (full.losses, resumed.losses,
                   sorted(p.name for p in d.iterdir()))
    return out


def _cases():
    """Each case's reference inputs -> (jax args, port args)."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig, make_camera
    from raytracer_js_tpu.config import HitBackend as JB
    from raytracer_js_tpu.models.camera import move, pixel_rays
    from raytracer_js_tpu.render import render_rays
    from test_fit import _pose_scene, _scene as color_scene, _targets
    from test_replay import _scene as replay_scene
    from test_replay_grad import _scene as rg_scene
    from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene

    key = jax.random.key(0)
    sgd = dict(lr=1e-2, optimizer="sgd")
    cam16 = make_camera((0, 0, 0), 16, 8, np.pi / 2, np.pi / 2)
    cam32 = make_camera((0.0, 0.0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    org32, dir32 = pixel_rays(cam32)
    pose_cfg = RenderConfig(refmax=1, distance_attenuation_factor=0.1)
    j = {
        "search": dict(
            scene=color_scene((0.5, 0.5, 0.5)), cfg=RenderConfig(refmax=1),
            cams=[cam16], targets=_targets(color_scene((0.9, 0.1, 0.2)),
                                           [cam16], RenderConfig(refmax=1),
                                           key),
            fc=dict(steps=3, **sgd), accel=False),
        "replay_autograd": dict(
            scene=replay_scene(trans=True), cfg=RenderConfig(refmax=2),
            cams=[make_camera((0.0, float(v) - 0.5, 0.5), 16, 8, np.pi / 2,
                              np.pi / 4) for v in range(2)],
            targets=jnp.full((2, 128, 3), 0.1, jnp.float32),
            fc=dict(steps=3, replay_every=1, **sgd), accel=False),
        "replay_b5": dict(
            scene=rg_scene(seed=7, n_sph=4), cfg=RenderConfig(refmax=2),
            cams=[cam32],
            targets=jnp.stack([render_rays(
                rg_scene(seed=5, n_sph=4), RenderConfig(refmax=2), org32,
                dir32, jax.random.key(2),
                jnp.arange(1024, dtype=jnp.int32))]),
            fc=dict(steps=3, replay_every=1, **sgd), accel=False),
        "cameras": dict(
            scene=_pose_scene(), cfg=pose_cfg,
            cams=[move(cam16, (0.0, 0.2, 0.0))],
            targets=_targets(_pose_scene(), [cam16], pose_cfg,
                             jax.random.key(7)),
            fc=dict(steps=2, fit_cameras=True, **sgd), accel=False),
        "octree": dict(
            scene=replay_scene(), cfg=RenderConfig(refmax=2,
                                                   backend=JB.OCTREE),
            cams=[make_camera((0.0, 0.0, 0.5), 16, 8, np.pi / 2,
                              np.pi / 4)],
            targets=jnp.zeros((1, 128, 3), jnp.float32),
            fc=dict(steps=3, accel_every=2, replay_every=1, **sgd),
            accel=True),
    }
    p = {name: dict(scene=to_port_scene(c["scene"]), cfg=to_port_cfg(c["cfg"]),
                    cams=[to_port_camera(x) for x in c["cams"]],
                    targets=torch.as_tensor(np.array(c["targets"])),
                    fc=c["fc"], accel=c["accel"])
         for name, c in j.items()}
    return j, p


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    j, p = _cases()
    p["ckpt_base"] = str(tmp_path_factory.mktemp("ckpt"))
    return j, p


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    return Runs(_fit_cases, cases[1], tmp_path_factory.mktemp("fits"))


@pytest.fixture(scope="module")
def unsharded(cases):
    return {name: _run(cases[1][name]) for name in CASES}


@pytest.fixture(scope="module")
def reference(cases):
    """The reference's fits on its 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu.accel.octree import build_octree as j_build
    from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
    from raytracer_js_tpu.optim import FitConfig as JFitConfig
    from raytracer_js_tpu.optim import fit as j_fit
    from raytracer_js_tpu.parallel import make_mesh as j_make_mesh

    out = {}
    for name, c in cases[0].items():
        accel = (j_build(c["scene"], JOctreeConfig(max_depth=3))
                 if c["accel"] else None)
        out[name] = j_fit(c["scene"], c["cfg"], c["cams"],
                          jnp.asarray(c["targets"]), JFitConfig(**c["fc"]),
                          key=jax.random.key(0), mesh=j_make_mesh(),
                          accel=accel)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_fit_matches_unsharded(runs, unsharded, name, world):
    want = unsharded[name]
    losses, params, cams = runs[world][0][name]
    np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for g, w in zip(params, float_partition(want.scene)[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
    if name == "cameras":
        for k in ("pos", "front", "left", "up"):
            np.testing.assert_allclose(getattr(cams[0], k).numpy(),
                                       getattr(want.cameras[0], k).numpy(),
                                       rtol=1e-5, atol=1e-6)
    for res in runs[world][1:]:
        assert res[name][0] == losses
        assert all(torch.equal(a, b) for a, b in zip(res[name][1], params))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_fit_matches_reference(runs, reference, name, world):
    rtol, atol = CASES[name]
    losses, _, cams = runs[world][0][name]
    want = reference[name]
    np.testing.assert_allclose(losses, want.losses, rtol=rtol, atol=atol)
    if name == "cameras":
        np.testing.assert_allclose(cams[0].pos.numpy(),
                                   np.asarray(want.cameras[0].pos),
                                   rtol=1e-4, atol=1e-6)


def test_b5_case_is_in_the_kernel_class(cases):
    """The B5 case replays through the kernel's wrapper (its plain version
    on CPU tensors), the autograd case through the trace loop."""
    from raytracer_js_tpu_torch.kernels import replay_grad as rg

    p = cases[1]
    assert rg.supports(p["replay_b5"]["scene"], p["replay_b5"]["cfg"])
    assert not rg.supports(p["replay_autograd"]["scene"],
                           p["replay_autograd"]["cfg"])
    assert p["octree"]["cfg"].backend == HitBackend.OCTREE


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_resume(runs, world):
    """Rank 0 writes each checkpoint once; every rank restores the newest
    and lands where the uninterrupted fit does."""
    for full, resumed, files in (r["ckpt"] for r in runs[world]):
        assert resumed == full[4:]
        assert files == ["ckpt_2.json", "ckpt_2.npz", "ckpt_4.json",
                         "ckpt_4.npz", "ckpt_6.json", "ckpt_6.npz"]
