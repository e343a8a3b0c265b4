"""``fit(mesh=...)`` as BASELINE config 5 runs it over several ranks
(``replay_every`` and ``accel_every`` set, Adam), at 2 and 4 gloo ranks on
a small config-4 field, against the benchmark's plain reference
(``portbench/reference/fit``) over the whole batch: the all-reduced loss,
gradients and Adam step of a recording step equal the reference's on the
recording gathered from every rank; the ranks hold the same parameters
bit for bit; and the exchange is the span ``rt.fit.allreduce``, entered
once a step under a mesh and never without one, whose collectives and
bytes ``parallel/sharding.ALLREDUCE`` counts.

The ranks run as in ``tests/test_torch_sharding.py`` (``run_ranks``).
Tolerances, as ``tests/test_torch_fit_wide.py`` gives their reasons: the
loss to 1e-6 of itself and the gradients to 1e-4 of their norm (float32
sums in another order: the replay's plain version against autograd, and
here the ranks' partial sums too; read here: 4.3e-8, 7.8e-6); the Adam
step to 1e-3 of its norm (Adam divides by the root of the second moment,
which magnifies the gradients' rounding where a gradient is small against
its history; read here: 5.0e-5; the benchmark's limit is 0.1)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from portbench import program
from portbench.reference import fit as ref_fit
from portbench.reference import render as ref
from portbench.reference.scene import tensors
from raytracer_js_tpu_torch import FitConfig, fit, float_leaf_names
from raytracer_js_tpu_torch.accel.octree import build_octree
from raytracer_js_tpu_torch.config import (HitBackend, OctreeConfig,
                                           RenderConfig)
from raytracer_js_tpu_torch.models.camera import make_camera
from raytracer_js_tpu_torch.parallel import sharding
from raytracer_js_tpu_torch.utils import profiling

from test_torch_fit_wide import TRAINED, field
from test_torch_sharding import Runs

W, H = 48, 32
FOV_H = math.pi / 2
FOV_V = FOV_H * H / W
POSES = [(0.0, -4.0, 0.5), (0.0, -3.0, 0.5)]
CFG = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
FC = FitConfig(steps=5, lr=1e-2, optimizer="adam", replay_every=2,
               accel_every=2)
#: the recording steps judged: the first (set-up's octree, Adam's first
#: step) and one after a rebuild
JUDGED = (0, 2)
SPANS = ("rt.fit.step", "rt.fit.allreduce")


def cameras():
    return [make_camera(p, W, H, FOV_H, FOV_V, device="cpu") for p in POSES]


@pytest.fixture(scope="module")
def inputs():
    """The field's targets (its OCTREE frames) and the fit's start (every
    center moved, the palette scaled)."""
    spec = field(3000)
    scene = program.build_scene(spec, "cpu")
    accel = build_octree(scene, OctreeConfig(max_depth=4))
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
    return dict(spec=start, scene=program.build_scene(start, "cpu"),
                targets=targets)


def _fit(mesh, inp):
    """The fit on this rank, under a profiler -> each step's copy (its
    trained parameters, gradients, Adam state, loss and recording, and the
    next step's parameters), the final parameters, and what the spans and
    the exchange's counter saw."""
    scene = inp["scene"]
    names = float_leaf_names(scene)
    keep = [(i, TRAINED[n]) for i, n in enumerate(names) if n in TRAINED]
    steps = []

    def hook(s):
        if steps:
            steps[-1]["next"] = {k: s.params[i].detach().clone()
                                 for i, k in keep}
        st = [s.optimizer.state.get(s.params[i], {}) for i, _ in keep]
        steps.append(dict(
            loss=s.loss.clone(), recorded=s.recorded,
            recs=[r.clone() for r in s.recs],
            params={k: s.params[i].detach().clone() for i, k in keep},
            grads={k: s.grads[i].clone() for i, k in keep},
            exp_avg={k: (torch.zeros_like(s.params[i]) if "exp_avg" not in m
                         else m["exp_avg"].clone())
                     for m, (i, k) in zip(st, keep)},
            exp_avg_sq={k: (torch.zeros_like(s.params[i])
                            if "exp_avg_sq" not in m
                            else m["exp_avg_sq"].clone())
                        for m, (i, k) in zip(st, keep)},
            adam_steps={k: int(m.get("step", 0))
                        for m, (_, k) in zip(st, keep)}))

    sent = dict(sharding.ALLREDUCE)
    spans = {k: profiling.SPAN_TOTALS.get(k, [0])[0] for k in SPANS}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fit(scene, CFG, cameras(), inp["targets"], FC, seed=11,
                  trainable=lambda i, _p: names[i] in TRAINED, mesh=mesh,
                  accel=build_octree(scene, OctreeConfig(max_depth=4)),
                  hook=hook)
    return dict(
        steps=steps, final=[p.clone() for p in
                            sharding.float_partition(out.scene)[0]],
        sent={k: sharding.ALLREDUCE[k] - sent[k] for k in sent},
        spans={k: profiling.SPAN_TOTALS.get(k, [0])[0] - spans[k]
               for k in SPANS})


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return Runs(_fit, inputs, tmp_path_factory.mktemp("mesh_fits"))


@pytest.fixture(scope="module")
def unmeshed(inputs):
    """The same fit in this process without a mesh."""
    return _fit(None, inputs)


@pytest.mark.parametrize("step", JUDGED)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_equals_the_reference(inputs, runs, world, step):
    """The step's all-reduced loss and gradients, and the Adam step it
    took, against the reference replaying the recording gathered from
    every rank (each rank's rows in rank order) over every ray of every
    view, at the step's parameters."""
    ranks_ = runs[world]
    mine = ranks_[0]["steps"][step]
    assert mine["recorded"]
    recs = [torch.cat([r["steps"][step]["recs"][v] for r in ranks_])
            for v in range(len(POSES))]
    assert recs[0].shape[0] == W * H
    base = tensors(inputs["spec"], "cpu")
    scene = base.with_leaves([mine["params"].get(k, getattr(base, k))
                              for k in base.LEAVES])
    rays = [ref.pixel_rays(ref.make_camera(p, W, H, FOV_H, FOV_V))
            for p in POSES]
    loss, grads = ref_fit.loss_and_grads(scene, rays, recs,
                                         inputs["targets"])
    assert abs(float(mine["loss"]) - float(loss)) <= 1e-6 * float(loss)
    for k, g in grads.items():
        assert float(g.abs().max()) > 0, k
        err = float((mine["grads"][k].double() - g.double()).norm()
                    / g.double().norm())
        assert err <= 1e-4, (k, err)
        want = ref_fit.adam_step(g, mine["exp_avg"][k],
                                 mine["exp_avg_sq"][k],
                                 mine["adam_steps"][k], FC.lr)
        got = mine["next"][k].double() - mine["params"][k].double()
        err = float((got - want).norm() / want.norm())
        assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_the_same_parameters(runs, world):
    """Every rank takes the same step from the same all-reduced bits: the
    replicas agree bit for bit at every step and at the end."""
    first, *rest = runs[world]
    for other in rest:
        for a, b in zip(first["steps"], other["steps"]):
            assert torch.equal(a["loss"], b["loss"])
            for k in a["params"]:
                assert torch.equal(a["params"][k], b["params"][k]), k
                assert torch.equal(a["grads"][k], b["grads"][k]), k
        assert all(torch.equal(p, q)
                   for p, q in zip(first["final"], other["final"]))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_the_exchange_is_spanned_and_counted(inputs, runs, unmeshed, world):
    """Under a mesh of two or four ranks ``rt.fit.allreduce`` is entered
    once a step, and ``sharding.ALLREDUCE`` counts one collective a step
    carrying every float leaf and the loss in float32. The one-rank mesh
    enters the span and runs no collective; a fit without a mesh does
    neither."""
    floats = sum(p.numel() for p in
                 sharding.float_partition(inputs["scene"])[0])
    want_bytes = FC.steps * 4 * (floats + 1)
    for r in runs[world]:
        assert r["spans"] == {"rt.fit.step": FC.steps,
                              "rt.fit.allreduce": FC.steps}
        assert r["sent"] == ({"calls": 0, "bytes": 0} if world == 1 else
                             {"calls": FC.steps, "bytes": want_bytes})
    assert unmeshed["spans"] == {"rt.fit.step": FC.steps,
                                 "rt.fit.allreduce": 0}
    assert unmeshed["sent"] == {"calls": 0, "bytes": 0}
