"""The benchmark's reference against the port at small sizes on the CPU:
frames against the port's BRUTE and FUSED paths."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench import harness, program
from portbench.reference import render as ref
from portbench.reference.scene import tensors

RECIPES = {"headline": dict(n_spheres=24), "config4": dict(n_prims=600)}


def spec_of(recipe, seed=5):
    mod = harness.load_module(harness.ROOT / "scenes" / f"{recipe}.py")
    return mod.spec(RECIPES[recipe], np.random.default_rng(seed))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("backend", ["brute", "fused"])
@pytest.mark.parametrize("yaw", [0.0, 0.07])
def test_frame_matches_port(recipe, backend, yaw):
    spec = spec_of(recipe)
    w, h = 64, 40
    fov_h = math.pi / 2
    fov_v = fov_h * h / w
    pos = (0.0, 0.3, 0.6)
    scene = program.build_scene(spec, "cpu")
    cam = program.camera(pos, w, h, fov_h, fov_v, yaw, "cpu")
    got = program.render(scene, cam, program.render_config(2, 1, backend),
                         seed=7).reshape(-1, 3)
    want = ref.render_frame(tensors(spec, "cpu"), ref.make_camera(
        pos, w, h, fov_h, fov_v, yaw), 2).color
    if backend == "brute":
        # the same operations in the same order on the same device
        assert torch.equal(got, want)
    else:
        # the frame kernel's plain version solves the sphere quadratic in
        # another form: near-ties flip a few winners
        assert harness.mismatch_share(got, want) <= 5e-3


def dense_hits(scene, org, dir):
    """Every ray against every prim as one [N, P] matrix, the least t a row
    (the first on a tie): the search as the port's BRUTE path writes it."""
    d_dot_c = dir @ scene.sphere_center.T
    o_dot_c = org @ scene.sphere_center.T
    b_half = ref.dot(org, dir)[:, None] - d_dot_c
    c = (ref.dot(org, org)[:, None] - 2.0 * o_dot_c
         + ref.dot(scene.sphere_center, scene.sphere_center)[None, :]
         - (scene.sphere_radius * scene.sphere_radius)[None, :])
    a = ref.dot(dir, dir)[:, None]
    disc = b_half * b_half - a * c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.where(valid, disc, 0.0))
    t_s = ref._first_forward((-b_half - sq) / a, (-b_half + sq) / a, valid)
    t_all = torch.cat([t_s, ref.box_hit_t(org, dir, scene.box_center,
                                          scene.box_half)], dim=1)
    t, pid = t_all.min(dim=1)
    return t, torch.where(torch.isfinite(t), pid, -1)


@pytest.mark.parametrize("block", [None, 7])
def test_search_equals_the_dense_matrix(monkeypatch, block):
    """The winner search equals the whole [rays, prims] matrix's minimum,
    in blocks of rays too, with a tie between two copies of a sphere won
    by the lower id."""
    spec = spec_of("config4")
    dup = dataclasses.replace(
        spec, sphere_center=np.concatenate([spec.sphere_center,
                                            spec.sphere_center[:40]]),
        sphere_radius=np.concatenate([spec.sphere_radius,
                                      spec.sphere_radius[:40]]),
        sphere_mat=np.concatenate([spec.sphere_mat, spec.sphere_mat[:40]]),
        sphere_tex=np.concatenate([spec.sphere_tex, spec.sphere_tex[:40]]))
    scene = tensors(dup, "cpu")
    org, dir = ref.pixel_rays(ref.make_camera((0, 0, 0.5), 96, 64, 1.4, 1.0))
    if block:
        monkeypatch.setattr(ref, "BLOCK_ELEMS", block * scene.n_prims + 3)
    t, pid = ref.nearest_hit(scene, org, dir)
    t_d, pid_d = dense_hits(scene, org, dir)
    assert torch.equal(pid, pid_d) and torch.equal(t, t_d)
    assert int((pid >= 0).sum()) > 0 and int((pid < 40).sum()) > 0

