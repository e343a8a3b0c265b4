"""Kernel B5 (``kernels/replay_grad``): its plain versions, reached through
``replay_colors`` on CPU tensors, against the reference's Pallas kernels in
interpret mode, on the scenes of ``tests/test_replay_grad.py``.

Tolerances, the reference's own for its kernel against its XLA replay:
colors allclose(rtol 2e-5, atol 2e-5); gradients (every float leaf, org,
dir) rtol 2e-4 / atol 2e-6. The per-prim sums run in another order (the
plain version sums in float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.config import HitBackend
from raytracer_js_tpu.kernels import replay_grad as jrg
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops.trace import record_paths
from raytracer_js_tpu.parallel.sharding import float_partition as j_partition
from raytracer_js_tpu_torch.kernels import replay_grad as rg
from raytracer_js_tpu_torch.models.scene import float_partition
from raytracer_js_tpu_torch.ops import trace as ptrace

from test_replay import _scene as replay_scene
from test_replay_grad import _scene
from test_torch_parity import to_port_cfg, to_port_scene
from scenes import config1_scene


def _setup(refmax, seed=0, n_sph=9, w=32, h=32):
    js = _scene(seed=seed, n_sph=n_sph)
    cfg = RenderConfig(refmax=refmax, backend=HitBackend.BRUTE, unroll=True)
    org, dirs = pixel_rays(make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2,
                                       np.pi / 2))
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    rec = record_paths(js, cfg, org, dirs, jax.random.key(0), rid)
    return js, cfg, org, dirs, rec


def _port_value_and_grads(js, cfg, org, dirs, rec, target, kernel=True):
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    params, rebuild = float_partition(ps)
    params = [p.clone().requires_grad_(True) for p in params]
    o = torch.as_tensor(np.array(org)).requires_grad_(True)
    d = torch.as_tensor(np.array(dirs)).requires_grad_(True)
    pid = torch.as_tensor(np.array(rec))
    if kernel:
        col = rg.replay_colors(rebuild(params), pcfg, o, d, pid)
    else:
        col = ptrace.trace_rays(rebuild(params), pcfg, o, d,
                                pid_seq=pid).color
    loss = ((col - torch.as_tensor(target)) ** 2).sum() / o.shape[0]
    loss.backward()
    return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params] + [o.grad, d.grad]


@pytest.mark.parametrize("refmax", [1, 2, 3])
def test_forward_matches_reference_kernel(refmax):
    js, cfg, org, dirs, rec = _setup(refmax)
    assert rg.supports(to_port_scene(js), to_port_cfg(cfg))
    want = jrg.replay_colors(js, cfg, org, dirs, rec, interpret=True)
    before = dict(rg.LAUNCHES)
    got = rg.replay_colors(to_port_scene(js), to_port_cfg(cfg),
                           torch.as_tensor(np.array(org)),
                           torch.as_tensor(np.array(dirs)),
                           torch.as_tensor(np.array(rec)))
    assert rg.LAUNCHES == before          # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("refmax,seed,n_sph", [(2, 0, 9), (3, 0, 9),
                                               (2, 11, 37)])
def test_grads_match_reference_kernel(refmax, seed, n_sph):
    js, cfg, org, dirs, rec = _setup(refmax, seed, n_sph)
    n = org.shape[0]
    target = np.random.default_rng(3).uniform(0, 1, (n, 3)).astype(
        np.float32)
    params, rebuild = j_partition(js)

    def loss(p, o, d):
        col = jrg.replay_colors(rebuild(p), cfg, o, d, rec, interpret=True)
        return jnp.sum((col - target) ** 2) / n

    l_ref, (g_p, g_o, g_d) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        params, org, dirs)
    l_port, grads = _port_value_and_grads(js, cfg, org, dirs, rec, target)
    np.testing.assert_allclose(l_port, float(l_ref), rtol=1e-5)
    for got, want in zip(grads, list(g_p) + [g_o, g_d]):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)


def test_listed_class_matches_reference_kernel():
    """Above 192 prims (the listed class): the reference's listed kernels
    with their per-tile id lists; the port indexes prims directly."""
    js, cfg, org, dirs, rec = _setup(2, seed=5, n_sph=200)
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    assert rg.supports_listed(ps, pcfg) and not rg.supports(ps, pcfg)
    tab = jrg.build_tile_lists(np.asarray(rec), js.n_spheres)
    n = org.shape[0]
    target = np.zeros((n, 3), np.float32)
    params, rebuild = j_partition(js)

    def loss(p, o, d):
        col = jrg.replay_colors(rebuild(p), cfg, o, d, rec, interpret=True,
                                tile_lists=tab)
        return jnp.sum((col - target) ** 2) / n

    l_ref, (g_p, g_o, g_d) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        params, org, dirs)
    l_port, grads = _port_value_and_grads(js, cfg, org, dirs, rec, target)
    np.testing.assert_allclose(l_port, float(l_ref), rtol=1e-5)
    for got, want in zip(grads, list(g_p) + [g_o, g_d]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)


def test_kernel_grads_match_autograd_replay():
    """Inside the port: B5's hand-derived backward against autograd through
    the replaying trace loop, on the same winners."""
    js, cfg, org, dirs, rec = _setup(3, seed=11, n_sph=37)
    target = np.random.default_rng(4).uniform(0, 1, (org.shape[0], 3)).astype(
        np.float32)
    l_k, g_k = _port_value_and_grads(js, cfg, org, dirs, rec, target)
    l_a, g_a = _port_value_and_grads(js, cfg, org, dirs, rec, target,
                                     kernel=False)
    np.testing.assert_allclose(l_k, l_a, rtol=1e-6)
    for a, b in zip(g_k, g_a):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)


def test_supports_gates_match_reference():
    from raytracer_js_tpu import SceneBuilder, ResponseType

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.4, 0.5)))
    b.add_sphere((4, 0, 0), 1.0, b.add_material(ResponseType.REFLECTION),
                 b.add_image_texture(np.full((4, 4, 3), 0.5, np.float32)))
    scenes = [_scene(), _scene(n_sph=jrg.SCAN_MAX_PRIMS + 8),
              replay_scene(rough=0.4), replay_scene(trans=True),
              config1_scene(with_tri=True), b.build()]
    cfgs = [RenderConfig(refmax=2), RenderConfig(refmax=4),
            RenderConfig(refmax=5), RenderConfig(refmax=2, spp=4)]
    assert (rg.SCAN_MAX_PRIMS, rg.LISTED_MAX_SPHERES) == (
        jrg.SCAN_MAX_PRIMS, jrg.LISTED_MAX_SPHERES)
    seen = set()
    for js in scenes:
        ps = to_port_scene(js)
        for cfg in cfgs:
            pcfg = to_port_cfg(cfg)
            got = (rg.supports(ps, pcfg), rg.supports_listed(ps, pcfg))
            assert got == (jrg.supports(js, cfg),
                           jrg.supports_listed(js, cfg))
            seen.add(got)
    assert seen == {(True, True), (False, True), (False, False)}


def test_cuda_launch_refuses_cpu_tensors():
    js, cfg, org, dirs, rec = _setup(1, w=4, h=4)
    tabs = rg.scene_tables(to_port_scene(js))
    o, d = torch.as_tensor(np.array(org)), torch.as_tensor(np.array(dirs))
    pid = torch.as_tensor(np.array(rec))
    with pytest.raises(ValueError, match="need CUDA tensors"):
        rg.launch_fwd(tabs, o, d, pid, 1, 1.0)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        rg.launch_bwd(tabs, o, d, pid, torch.zeros_like(o), 1, 1.0)
