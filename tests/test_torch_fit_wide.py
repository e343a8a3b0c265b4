"""BASELINE config 5's fit on the port at a small size on the CPU: the
replay's class for the fit (``replay_grad.supports_fit``), the fresh
octree rebuild, the fit's hook and its ``rt.fit.*`` spans, held
against the benchmark's plain reference (``portbench/reference/fit``).

The field is ``bench.build_config4_scene``'s (``portbench/scenes/
config4.py``) with more spheres than the reference's listed class holds
(16,384), so the fit's replay takes B5 (its plain version here) on the
port's own class; two views of 64x48 at config 5's camera positions."""
import dataclasses
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from portbench import harness, program
from portbench.reference import fit as ref_fit
from portbench.reference import render as ref
from portbench.reference.scene import tensors
from raytracer_js_tpu_torch import FitConfig, FitStep, fit, float_leaf_names
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import (HitBackend, OctreeConfig,
                                           RenderConfig, ResponseType)
from raytracer_js_tpu_torch.kernels import replay_grad as rg
from raytracer_js_tpu_torch.models.camera import make_camera
from raytracer_js_tpu_torch.models.scene import (SceneBuilder,
                                                 float_partition)
from raytracer_js_tpu_torch.utils import profiling

W, H = 64, 48
FOV_H = math.pi / 2
FOV_V = FOV_H * H / W
POSES = [(0.0, -4.0, 0.5), (0.0, -3.0, 0.5)]
CFG = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
#: the trained leaves: the program's name -> the reference's
TRAINED = {"sphere_center": "sphere_center", "textures.solid_rgb": "tex_rgb"}


def field(n_prims, seed=7):
    mod = harness.load_module(harness.ROOT / "scenes" / "config4.py")
    return mod.spec(dict(n_prims=n_prims), np.random.default_rng(seed))


def cameras():
    return [make_camera(p, W, H, FOV_H, FOV_V, device="cpu") for p in POSES]


def ref_rays():
    return [ref.pixel_rays(ref.make_camera(p, W, H, FOV_H, FOV_V))
            for p in POSES]


@pytest.fixture(scope="module")
def wide():
    """The 16,500-prim field, its targets (the layout's OCTREE frames) and
    the fit's start (every center moved, the palette scaled)."""
    spec = field(16_500)
    scene = program.build_scene(spec, "cpu")
    accel = po.build_octree(scene, OctreeConfig(max_depth=5))
    targets = torch.stack([
        program.render(scene, c, CFG, seed=0, accel=accel).reshape(-1, 3)
        for c in cameras()])
    rng = np.random.default_rng(3)
    tex = spec.tex_rgb.copy()
    tex[3:] = np.clip(tex[3:] * rng.uniform(0.8, 1.2, tex[3:].shape), 0, 1)
    start = dataclasses.replace(
        spec, tex_rgb=tex.astype(np.float32),
        sphere_center=(spec.sphere_center + rng.uniform(
            -0.02, 0.02, spec.sphere_center.shape)).astype(np.float32))
    s = program.build_scene(start, "cpu")
    return dict(spec=start, scene=s, targets=targets,
                accel=po.build_octree(s, OctreeConfig(max_depth=5)))


def run_fit(w, fc, hook=None, accel=None):
    names = float_leaf_names(w["scene"])
    return fit(w["scene"], CFG, cameras(), w["targets"], fc, seed=11,
               trainable=lambda i, _p: names[i] in TRAINED,
               accel=w["accel"] if accel is None else accel, hook=hook)


def keep_steps(out, scene):
    names = float_leaf_names(scene)

    def hook(s: FitStep):
        out.append(dict(
            step=s.step, loss=s.loss.clone(), recorded=s.recorded,
            recs=None if s.recs is None else [r.clone() for r in s.recs],
            params=[p.detach().clone() for p in s.params],
            grads={TRAINED[n]: g.clone()
                   for n, g in zip(names, s.grads) if n in TRAINED}))
    return hook


@pytest.fixture(scope="module")
def one_step(wide):
    """One Adam step of the fit with its recording, through the hook."""
    steps = []
    fit_ = run_fit(wide, FitConfig(steps=1, lr=1e-3, replay_every=8,
                                   accel_every=8), keep_steps(steps, wide["scene"]))
    return fit_, steps[0]


def test_fit_class_holds_where_listed_does_not(wide):
    scene, cfg = wide["scene"], CFG
    assert scene.n_spheres > rg.LISTED_MAX_SPHERES
    assert (rg.supports(scene, cfg), rg.supports_listed(scene, cfg),
            rg.supports_fit(scene, cfg)) == (False, False, True)
    for bad in (dataclasses.replace(cfg, refmax=5),
                dataclasses.replace(cfg, spp=2)):
        assert not rg.supports_fit(scene, bad)


def _builder_scene(kind):
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.4, 0.5)))
    tex = b.add_solid_texture((0.8, 0.2, 0.1))
    if kind == "rough":
        m = b.add_material(ResponseType.REFLECTION, roughness=0.3)
    elif kind == "glass":
        m = b.add_material(ResponseType.BOTH)
    else:
        m = b.add_material(ResponseType.REFLECTION, mirror=True)
    if kind == "image":
        tex = b.add_image_texture(np.full((4, 4, 3), 0.5, np.float32))
    b.add_sphere((4.0, 0.0, 0.0), 1.0, m, tex)
    if kind == "tri":
        b.add_triangle((3, -1, -1), (3, 1, -1), (3, 0, 1), m, tex)
    if kind == "boxes":
        for i in range(rg.SCAN_MAX_PRIMS + 1):
            b.add_box((8.0, i, 0.0), 0.5, m, tex)
    return b.build("cpu")


@pytest.mark.parametrize("kind", ["mirror", "rough", "glass", "image", "tri",
                                  "boxes"])
def test_fit_class_is_the_listed_class_up_to_its_sphere_cap(kind):
    """Below the cap on spheres the two classes agree: roughness,
    transmission, image textures, triangles and more than 192 boxes are
    outside both."""
    scene = _builder_scene(kind)
    for cfg in (RenderConfig(refmax=2), RenderConfig(refmax=4),
                RenderConfig(refmax=5), RenderConfig(refmax=2, spp=4)):
        assert rg.supports_fit(scene, cfg) == rg.supports_listed(scene, cfg)
    assert rg.supports_fit(scene, RenderConfig(refmax=2)) == (
        kind == "mirror")


def test_the_fit_replays_through_b5(wide, monkeypatch):
    """``replay_loss`` takes the B5 Function (its plain version on the
    CPU), not the autograd replay, on the wide field."""
    calls = {"b5": 0, "trace": 0}
    pfit = __import__("sys").modules["raytracer_js_tpu_torch.optim.fit"]
    real_b5, real_trace = rg.replay_colors, pfit.trace_rays

    def b5(*a, **kw):
        calls["b5"] += 1
        return real_b5(*a, **kw)

    def trace(*a, **kw):
        calls["trace"] += 1
        return real_trace(*a, **kw)

    monkeypatch.setattr(rg, "replay_colors", b5)
    monkeypatch.setattr(pfit, "trace_rays", trace)
    run_fit(wide, FitConfig(steps=1, lr=1e-3, replay_every=1))
    assert calls == {"b5": len(POSES), "trace": 0}


def _grazing(scene, org, dir, pid) -> float:
    """|disc| / r^2 of a sphere test in float64 (inf for a miss or a
    box): how close the ray runs to the sphere's silhouette."""
    if not 0 <= pid < scene.n_spheres:
        return math.inf
    c = scene.sphere_center[pid].double()
    r = scene.sphere_radius[pid].double()
    o, d = org.double(), dir.double()
    oc = o - c
    b = (oc * d).sum()
    disc = b * b - (d * d).sum() * ((oc * oc).sum() - r * r)
    return float(disc.abs() / (r * r))


def test_recording_equals_the_dense_chain(wide, one_step):
    """The step's recording (the octree search) against each ray's winner
    chain by the reference's dense search at the step's parameters. They
    differ only by rounding, on 13 of 6,144 rays here:

    - at bounce 0 only at a sphere's silhouette: |disc| < 5% of r^2 in
      float64 for one of the two winners (the reference's factored
      quadratic rounds |c|^2 ~ 10^3 at ~6e-5, a few % of a small sphere's
      r^2);
    - at bounce 1, after the same bounce-0 winner, on at most 0.5% of the
      rays: a reflected ray starts 1e-3 off a sphere up to ~48 away, where
      that rounding lets the reference's ray hit its own sphere again, and
      a normal one rounding apart sends it elsewhere.

    (``c5_1m.fit`` judges the same comparison on its sampled rays.)"""
    _, s = one_step
    assert s["recorded"]
    scene = tensors(wide["spec"], "cpu")
    for (org, dir), rec in zip(ref_rays(), s["recs"]):
        rec = rec.long()
        want = ref_fit.dense_chain(scene, org, dir, CFG.refmax)
        assert int((want[:, 1] >= 0).sum()) > 100   # mirrors reflect
        first = torch.nonzero(rec[:, 0] != want[:, 0])[:, 0].tolist()
        for i in first:
            assert min(_grazing(scene, org[i], dir[i], int(p))
                       for p in (rec[i, 0], want[i, 0])) < 0.05, i
        later = (rec[:, 0] == want[:, 0]) & (rec[:, 1] != want[:, 1])
        assert int(later.sum()) <= 0.005 * rec.shape[0]
        assert len(first) <= 0.001 * rec.shape[0]


def test_fit_step_equals_the_reference_replay(wide, one_step):
    """The step's loss and gradients against the reference's autograd
    replay of its recording. Both are float32; the replay kernel's plain
    version multiplies by 1/a where the reference divides, and sums each
    sphere's cotangents in float64 where autograd's index_add sums in
    float32: the loss agrees to 1e-6 (read here: 4e-8), and the gradients
    to 1e-4 of their norm (read here: 2.4e-6 on the centers, 3e-8 on the
    colors), far under the 0.1 and more that a bfloat16 replay reads."""
    _, s = one_step
    scene = tensors(wide["spec"], "cpu")
    loss, grads = ref_fit.loss_and_grads(scene, ref_rays(), s["recs"],
                                         wide["targets"])
    assert abs(float(s["loss"]) - float(loss)) <= 1e-6 * float(loss)
    for k, g in grads.items():
        err = float((s["grads"][k].double() - g.double()).norm()
                    / g.double().norm())
        assert err <= 1e-4, (k, err)
        assert float(g.abs().max()) > 0


def test_fit_survives_a_rebuild_that_outgrows_the_first(wide, monkeypatch):
    """``fit(accel=..., accel_every=2)`` from an octree of smaller spheres:
    the rebuild at step 2 outgrows the first build's capacity (a rebuild
    pinned to it raises) and is a fresh build of the step's geometry,
    array for array."""
    small = po.build_octree(dataclasses.replace(
        wide["scene"], sphere_radius=wide["scene"].sphere_radius * 0.25),
        OctreeConfig(max_depth=5))
    built, real = [], po.build_octree
    monkeypatch.setattr(po, "build_octree",
                        lambda *a, **kw: built.append(real(*a, **kw))
                        or built[-1])
    steps = []
    run_fit(wide, FitConfig(steps=3, lr=1e-3, replay_every=1,
                            accel_every=2), keep_steps(steps, wide["scene"]),
            accel=small)
    monkeypatch.undo()
    (got,) = built
    moved = float_partition(wide["scene"])[1](steps[2]["params"])
    fresh = po.build_octree(moved, OctreeConfig(max_depth=5))
    with pytest.raises(ValueError, match="pinned capacity"):
        po.build_octree(moved, OctreeConfig(max_depth=5), like=small)
    assert fresh.cell_ids.shape[0] > small.cell_ids.shape[0]
    for k in ("root_lo", "root_size", "coarse_ids", "cell_offsets",
              "cell_ids", "skip_dist"):
        assert torch.equal(getattr(got, k), getattr(fresh, k)), k
    assert (got.max_depth, got.l_cut, got.max_per_cell) == (
        fresh.max_depth, fresh.l_cut, fresh.max_per_cell)


@pytest.fixture(scope="module")
def small():
    """A 600-prim field and its targets, for fits of a few steps."""
    spec = field(600)
    scene = program.build_scene(spec, "cpu")
    accel = po.build_octree(scene, OctreeConfig(max_depth=4))
    targets = torch.stack([
        program.render(scene, c, CFG, seed=0, accel=accel).reshape(-1, 3)
        * 0.9 for c in cameras()])
    return dict(scene=scene, targets=targets, accel=accel)


FC = FitConfig(steps=4, lr=1e-3, replay_every=2, accel_every=2)
SPANS = ("rt.fit.step", "rt.fit.rebuild", "rt.fit.record", "rt.fit.replay",
         "rt.fit.backward", "rt.fit.opt", "rt.sync")


def test_fit_spans_open_once_per_step(small):
    """Under a profiler: one ``rt.fit.step``, ``rt.fit.replay``,
    ``rt.fit.backward`` and ``rt.fit.opt`` a step, ``rt.fit.record`` at
    each recording (steps 0 and 2), ``rt.fit.rebuild`` at each rebuild
    (step 2), and ``rt.sync`` at each loss read and rebuild's AABB read."""
    before = {k: profiling.SPAN_TOTALS.get(k, [0, 0.0])[0] for k in SPANS}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run_fit(small, FC)
    got = {k: profiling.SPAN_TOTALS.get(k, [0, 0.0])[0] - before[k]
           for k in SPANS}
    assert got == {"rt.fit.step": 4, "rt.fit.rebuild": 1,
                   "rt.fit.record": 2, "rt.fit.replay": 4,
                   "rt.fit.backward": 4, "rt.fit.opt": 4, "rt.sync": 5}


def _final(res):
    return res.losses, [p.detach() for p in float_partition(res.scene)[0]]


def test_hook_and_profiler_change_no_step(small):
    """``fit`` with no hook and no profiler, with a hook that reads every
    step, and under a profiler: the same losses and parameters, bit for
    bit. The hook sees each step once, in order."""
    plain = _final(run_fit(small, FC))
    seen = []
    hooked = _final(run_fit(small, FC, keep_steps(seen, small["scene"])))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _final(run_fit(small, FC))
    for other in (hooked, traced):
        assert other[0] == plain[0]
        assert all(torch.equal(a, b) for a, b in zip(other[1], plain[1]))
    assert [s["step"] for s in seen] == [0, 1, 2, 3]
    assert [s["recorded"] for s in seen] == [True, False, True, False]
    assert [float(s["loss"]) for s in seen] == plain[0]


def test_hook_ends_the_fit_after_its_step(small):
    full = _final(run_fit(small, FC))
    res = _final(run_fit(small, FC, lambda s: s.step == 1))
    assert res[0] == full[0][:2]
    two = _final(run_fit(small, dataclasses.replace(FC, steps=2)))
    assert all(torch.equal(a, b) for a, b in zip(res[1], two[1]))


def test_hook_sees_the_optimizer_before_its_step(small):
    """The hook's optimizer holds Adam's moments and step count before the
    step: the reference's Adam step (``reference/fit.adam_step``) from them
    and the step's gradients is the change to the next step's parameters,
    up to the float32 rounding of the program's step."""
    names = float_leaf_names(small["scene"])
    seen = []

    def hook(s: FitStep):
        st = [s.optimizer.state.get(p, {}) for p in s.params]
        seen.append(dict(
            params=[p.detach().clone() for p in s.params],
            grads=[g.clone() for g in s.grads],
            m=[x["exp_avg"].clone() if x else torch.zeros_like(p)
               for x, p in zip(st, s.params)],
            v=[x["exp_avg_sq"].clone() if x else torch.zeros_like(p)
               for x, p in zip(st, s.params)],
            t=[int(x["step"]) if x else 0 for x in st]))

    run_fit(small, FC, hook)
    assert [s["t"][0] for s in seen] == [0, 1, 2, 3]
    for a, b in zip(seen, seen[1:]):
        for i, n in enumerate(names):
            if n not in TRAINED:
                continue
            got = b["params"][i].double() - a["params"][i].double()
            want = ref_fit.adam_step(a["grads"][i], a["m"][i], a["v"][i],
                                     a["t"][i], FC.lr)
            assert float(want.abs().max()) > 0, n
            # the program's step rounds each parameter to float32 (half an
            # ulp of the larger of p and p + dp) and computes in float32
            ulp = 2.0 ** -24 * torch.maximum(a["params"][i].abs(),
                                             b["params"][i].abs()).double()
            assert bool(((got - want).abs()
                         <= ulp + 1e-5 * want.abs()).all()), n
