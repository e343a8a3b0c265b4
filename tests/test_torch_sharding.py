"""Ray sharding over ``torch.distributed`` (``parallel/``) against one
process and against the reference's ``shard_map`` sharding, at 1, 2 and 4
ranks (mirrors ``tests/test_sharding.py``).

World sizes above 1 run as gloo process groups of CPU processes, started
with ``torch.multiprocessing`` ``spawn``, one thread each, meeting through a
``file://`` rendezvous in a temp dir; each world size is spawned once per
module (:func:`run_ranks`) and runs every case, and each test asserts one.
The children import this module, which imports no JAX: the reference
package is imported inside the tests.

Tolerances: sharded images equal one process bit for bit (the RNG is keyed
by the global ray id); against the reference, the port's parity rule
(``utils/parity``). Sharded gradients equal the unsharded autograd ones
and the reference's sharded ones within float32 sum order (rtol 1e-5,
atol 1e-6; the loss rtol 1e-6 against the port, 1e-5 against the
reference).
"""
import dataclasses
import math
import multiprocessing.connection
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

torch.set_num_threads(1)

import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.parallel import (float_partition, make_mesh,
                                             render_hdr_sharded,
                                             sharded_fit_step)
from raytracer_js_tpu_torch.parallel import distributed as pdist
from raytracer_js_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_js_tpu_torch.parallel.sharding import Mesh
from raytracer_js_tpu_torch.render import render_rays

WORLDS = (1, 2, 4)
#: seconds a spawned world may take to start, run every case and exit
JOIN_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# the rank launcher (shared with tests/test_torch_fit_sharded.py)
# ---------------------------------------------------------------------------

def _rank_main(rank, world, rdv, out_dir, fn):
    torch.set_num_threads(1)
    ok = pdist.init_distributed(f"file://{rdv}", world, rank, device="cpu",
                                timeout_s=120)
    assert ok and torch.distributed.get_backend() == "gloo"
    try:
        inputs = torch.load(pathlib.Path(out_dir) / "inputs.pt",
                            weights_only=False)
        res = fn(make_mesh(device="cpu"), inputs)
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(world, fn, inputs, out_dir, timeout_s=JOIN_TIMEOUT_S):
    """Run ``fn(mesh, inputs)`` on ``world`` ranks -> each rank's result.
    World 1 runs in this process on the one-rank mesh (no group); larger
    worlds spawn one process a rank. A rank that fails, or a world that
    outlives ``timeout_s``, fails the call (the others are killed)."""
    if world == 1:
        return [fn(make_mesh(device="cpu"), inputs)]
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, out_dir / "inputs.pt")
    ctx = tmp_mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out_dir / "rdv"), str(out_dir),
                               fn)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0 or any(p.exitcode not in (None, 0) for p in procs):
                break
            multiprocessing.connection.wait([p.sentinel for p in procs
                                             if p.is_alive()],
                                            timeout=min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited {codes} (timeout " \
        f"{timeout_s} s; a negative code is a kill)"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


class Runs(dict):
    """world size -> per-rank results of ``fn``, each world run once."""

    def __init__(self, fn, inputs, base):
        super().__init__()
        self.fn, self.inputs, self.base = fn, inputs, base

    def __missing__(self, world):
        self[world] = run_ranks(world, self.fn, self.inputs,
                                self.base / f"w{world}")
        return self[world]


# ---------------------------------------------------------------------------
# the cases every rank runs
# ---------------------------------------------------------------------------

def _sharding_cases(mesh, inp):
    cfg = inp["cfg"]
    out = {
        "render": render_hdr_sharded(mesh, inp["scene"], inp["cam"], cfg),
        "render_fused": render_hdr_sharded(
            mesh, inp["scene"], inp["cam"],
            dataclasses.replace(cfg, backend=HitBackend.FUSED)),
        "rough": render_hdr_sharded(mesh, inp["rough"], inp["rough_cam"],
                                    RenderConfig(refmax=2), seed=7),
        "step": sharded_fit_step(mesh, inp["scene"], cfg, inp["step_cam"],
                                 inp["step_target"], 3),
        "sky_step": sharded_fit_step(mesh, inp["sky"], RenderConfig(refmax=1),
                                     inp["step_cam"], inp["step_target"], 3),
        "topology": pdist.topology_summary(mesh),
        "dryrun": dryrun_multichip(mesh),
    }
    return out


def _rough_scene():
    b = rt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.6)))
    rough = b.add_material(rt.ResponseType.REFLECTION, mirror=True,
                           roughness=0.5)
    b.add_sphere((4.0, 0.0, 0.0), 1.5, rough, b.add_solid_texture((1, 1, 1)))
    b.add_box((0.0, 0.0, -51.0), 100.0, b.add_material(
        rt.ResponseType.REFLECTION), b.add_solid_texture((0.9, 0.2, 0.1)))
    return b.build(device="cpu")


def _sky_scene():
    """Only sky in view (one sphere behind the camera): the loss is
    ``mean_rays(sum_c (sky_c - target_c)^2)``, whose gradient on the sky
    color is ``2 (sky - target)`` exactly."""
    b = rt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.5, 0.7)))
    b.add_sphere((-10.0, 0.0, 0.0), 1.0, b.add_material(
        rt.ResponseType.REFLECTION), b.add_solid_texture((1, 1, 1)))
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def inputs():
    from scenes import config1_camera, config1_cfg, config1_scene
    from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene

    js = config1_scene(with_glass=True, with_tri=True)
    return {
        "jax_scene": js, "jax_cam": config1_camera(32, 16),
        "jax_step_cam": config1_camera(16, 8),
    }, {
        "scene": to_port_scene(js), "cam": to_port_camera(
            config1_camera(32, 16)),                # 512 rays
        "cfg": to_port_cfg(config1_cfg()),
        "rough": _rough_scene(),
        "rough_cam": rt.make_camera((0, 0, 0), 16, 16, np.pi / 2, np.pi / 2,
                                    device="cpu"),
        "step_cam": to_port_camera(config1_camera(16, 8)),
        "step_target": torch.full((128, 3), 0.25),
        "sky": _sky_scene(),
    }


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return Runs(_sharding_cases, inputs[1],
                tmp_path_factory.mktemp("sharding"))


def _unsharded_step(scene, cfg, cam, target, seed):
    """``value_and_grad`` of the global loss in one process (no mesh)."""
    org, dirs = pixel_rays(cam)
    params, rebuild = float_partition(scene)
    params = [p.detach().requires_grad_(True) for p in params]
    colors = render_rays(rebuild(params), cfg, org, dirs, seed)
    loss = ((colors - target) ** 2).sum() / org.shape[0]
    loss.backward()
    return loss.detach(), [torch.zeros_like(p) if p.grad is None else p.grad
                           for p in params]


def _assert_grads_close(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_single(runs, inputs, world):
    p = inputs[1]
    one = rt.render_hdr(p["scene"], p["cam"], p["cfg"])
    for res in runs[world]:
        assert torch.equal(res["render"], one)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fused_render_matches_render_rays(runs, inputs, world):
    """FUSED per shard runs the wavefront kernel (its plain version here):
    equal to ``render_rays`` FUSED over the frame's rays."""
    p = inputs[1]
    cfg = dataclasses.replace(p["cfg"], backend=HitBackend.FUSED)
    one = render_rays(p["scene"], cfg, *pixel_rays(p["cam"])).reshape(
        16, 32, 3)
    for res in runs[world]:
        assert torch.equal(res["render_fused"], one)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_reference_sharded(runs, inputs, world):
    import jax

    from raytracer_js_tpu.parallel import make_mesh as j_make_mesh
    from raytracer_js_tpu.parallel import (
        render_hdr_sharded as j_render_hdr_sharded)
    from raytracer_js_tpu_torch.utils import parity
    from scenes import config1_cfg
    from test_torch_parity import assert_parity

    j = inputs[0]
    want = np.asarray(j_render_hdr_sharded(
        j_make_mesh(jax.devices()[:world]), j["jax_scene"], j["jax_cam"],
        config1_cfg()))
    got = runs[world][0]["render"]
    zeros = np.zeros(want.shape[:2], np.int32)
    assert_parity(got, zeros, want, zeros,
                  prove_rounding=parity.grazing_prover(
                      inputs[1]["scene"], *pixel_rays(inputs[1]["cam"])))


def test_sharded_render_rng_stable_across_world_sizes(runs, inputs):
    """Roughness draws random numbers: keyed by the global ray id, the
    image is the same at 1, 2 and 4 ranks, and another seed changes it."""
    imgs = [runs[w][r]["rough"] for w in WORLDS for r in range(w)]
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])
    p = inputs[1]
    assert torch.equal(imgs[0], rt.render_hdr(p["rough"], p["rough_cam"],
                                              RenderConfig(refmax=2),
                                              seed=7))
    assert not torch.equal(imgs[0], rt.render_hdr(
        p["rough"], p["rough_cam"], RenderConfig(refmax=2), seed=8))


# ---------------------------------------------------------------------------
# the sharded fit step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_step_matches_unsharded(runs, inputs, world):
    p = inputs[1]
    loss_1, grads_1 = _unsharded_step(p["scene"], p["cfg"], p["step_cam"],
                                      p["step_target"], 3)
    loss, grads = runs[world][0]["step"]
    assert math.isfinite(float(loss)) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    np.testing.assert_allclose(float(loss), float(loss_1), rtol=1e-6)
    _assert_grads_close(grads, grads_1, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_step_matches_reference(runs, inputs, world):
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu.parallel import make_mesh as j_make_mesh
    from raytracer_js_tpu.parallel import sharded_fit_step as j_step
    from scenes import config1_cfg

    # config 1 draws no random numbers: the ranks' seed and the key need
    # not name the same stream
    j = inputs[0]
    loss_j, grads_j = j_step(j_make_mesh(jax.devices()[:world]),
                             j["jax_scene"], config1_cfg(), j["jax_step_cam"],
                             jnp.full((128, 3), 0.25, jnp.float32),
                             jax.random.key(5))
    loss, grads = runs[world][0]["step"]
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _assert_grads_close(grads, jax.tree_util.tree_leaves(grads_j),
                        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_is_reduced_once(runs, inputs, world):
    """A gradient known in closed form: W ranks give it, not W times it."""
    p = inputs[1]
    loss, grads = runs[world][0]["sky_step"]
    names = rt.parallel.float_leaf_names(p["sky"])
    g_rgb = grads[names.index("textures.solid_rgb")]
    sky = p["sky"].textures.solid_rgb[p["sky"].sky_tex]
    torch.testing.assert_close(g_rgb[p["sky"].sky_tex], 2.0 * (sky - 0.25),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(loss, ((sky - 0.25) ** 2).sum(), rtol=1e-6,
                               atol=0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_stay_replicated(runs, world):
    """Every rank holds the same image, loss and gradients, bit for bit."""
    first = runs[world][0]
    for res in runs[world][1:]:
        for k in ("render", "render_fused", "rough"):
            assert torch.equal(res[k], first[k])
        for k in ("step", "sky_step"):
            assert torch.equal(res[k][0], first[k][0])
            assert all(torch.equal(a, b) for a, b in zip(res[k][1],
                                                         first[k][1]))
        assert res["dryrun"] == first["dryrun"]


# ---------------------------------------------------------------------------
# bootstrap, topology, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_topology_summary(runs, world):
    for rank, res in enumerate(runs[world]):
        assert res["topology"] == {
            "process_index": rank, "process_count": world,
            "local_devices": 1, "global_devices": world, "platform": "cpu",
            "ray_axis": "rays"}


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_multichip(runs, world):
    losses = runs[world][0]["dryrun"]
    assert len(losses) == 3
    assert all(math.isfinite(x) and x > 0 for x in losses)


def test_indivisible_ray_count_asserts(inputs):
    p = inputs[1]
    mesh3 = Mesh(group=None, rank=0, world_size=3, device=torch.device("cpu"))
    with pytest.raises(AssertionError, match="must divide over 3 ranks"):
        render_hdr_sharded(mesh3, p["scene"], p["cam"], p["cfg"])
    with pytest.raises(AssertionError, match="must divide"):
        sharded_fit_step(mesh3, p["scene"], p["cfg"], p["step_cam"],
                         p["step_target"])
    from raytracer_js_tpu_torch.optim import fit

    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        fit(p["scene"], p["cfg"], [p["step_cam"]], p["step_target"][None],
            mesh=mesh3)


def test_make_mesh_without_group(monkeypatch):
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    assert mesh.rows(8) == slice(0, 8)
    with pytest.raises(ValueError, match="initialised process group"):
        make_mesh(group=object(), device="cpu")


_DIST_ENV = ("JAX_COORDINATOR", "NPROC", "PROC_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def fake_init(monkeypatch):
    """The environment cleared, and init_process_group recorded instead of
    run."""
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def test_init_distributed_single_process(fake_init):
    assert pdist.init_distributed(device="cpu") is False
    assert pdist.init_distributed(coordinator="h:1", device="cpu") is False
    assert fake_init == [] and not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({"JAX_COORDINATOR": "host0:1234", "NPROC": "2", "PROC_ID": "1"},
     ("tcp://host0:1234", 2, 1)),
    ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "3", "LOCAL_RANK": "1"}, ("tcp://10.0.0.2:29500", 4, 3)),
])
def test_init_distributed_reads_environment(fake_init, monkeypatch, env,
                                            want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pdist.init_distributed(device="cpu", timeout_s=5) is True
    (kw,) = fake_init
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == want
    assert kw["backend"] == "gloo" and kw["timeout"].total_seconds() == 5


def test_init_distributed_backend_and_device(fake_init, monkeypatch):
    """A CUDA rank takes cuda:{LOCAL_RANK % count} and NCCL; ``backend=``
    is the only override; a ``file://`` coordinator is kept as it is."""
    picked = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pdist.init_distributed("file:///tmp/x", 4, 3)
    assert picked == [torch.device("cuda", 1)]
    assert fake_init[-1]["backend"] == "nccl"
    assert fake_init[-1]["init_method"] == "file:///tmp/x"
    assert pdist.init_distributed("h:1", 4, 3, device="cuda:0",
                                  backend="gloo")
    assert picked[-1] == torch.device("cuda", 0)
    assert fake_init[-1]["backend"] == "gloo"
    assert pdist.rank_device("cpu", 5) == torch.device("cpu")
