"""The port's spans (``utils/profiling.span``): a shared no-op while no
profiler runs; under ``torch.profiler`` the frame path's ``rt.*`` events,
counted per frame, per bounce, per TILED round and per host read; and a
frame bit-identical with the profiler on and off."""
import collections
import dataclasses

import numpy as np
import pytest
import torch

import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.accel.octree import build_octree
from raytracer_js_tpu_torch.config import OctreeConfig
from raytracer_js_tpu_torch.kernels import trace_tiled as tt
from raytracer_js_tpu_torch.utils import profiling

torch.set_num_threads(1)

REFMAX = 3


def _scene(image_sky=False):
    """A ground box, mirrors, diffuse spheres and an emitter (solid
    textures: FUSED's class); with ``image_sky`` an image sky and rough
    mirrors (TILED's record and replay frame, several samples apart)."""
    if image_sky:
        b = prt.SceneBuilder(atlas_hw=(8, 8))
        sky = np.random.default_rng(4).uniform(0.2, 1.0, (8, 8, 3))
        b.set_sky(b.add_image_texture(sky.astype(np.float32)))
    else:
        b = prt.SceneBuilder()
        b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(prt.ResponseType.REFLECTION)
    mirror = b.add_material(prt.ResponseType.REFLECTION, mirror=True,
                            roughness=0.05 if image_sky else 0.0)
    light = b.add_material(prt.ResponseType.REFLECTION, light=True)
    rng = np.random.default_rng(3)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(4)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])
    for i in range(9):
        c = rng.uniform([2.5, -3.0, -0.3], [8.0, 3.0, 3.0], 3)
        b.add_sphere(c, float(rng.uniform(0.3, 0.8)),
                     mirror if i % 2 == 0 else diffuse, pal[i % 4])
    b.add_sphere((5.0, 0.0, 5.0), 1.0, light, pal[1])
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def image_scene():
    return _scene(image_sky=True)


def _camera(w, h):
    return prt.make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2,
                           np.pi / 2 * h / w, device="cpu")


def _spans(fn):
    """(fn's result, Counter of the ``rt.*`` events it recorded)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(e.name for e in prof.events()
                                    if e.name.startswith("rt."))


def test_span_without_profiler_is_one_shared_noop(monkeypatch):
    """No profiler: every span is the same module-level no-op, no record
    function is built, and nothing is recorded or counted."""
    built = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: built.append(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name))
    before = {k: list(v) for k, v in profiling.SPAN_TOTALS.items()}
    first = profiling.span("rt.a")
    assert first is profiling.span("rt.b") is profiling._NO_SPAN
    with profiling.span("rt.c") as got:
        assert got is None
    assert built == [] and not profiling._profiling()
    assert profiling.SPAN_TOTALS == before


def test_span_under_profiler_is_a_named_event():
    """Under a profiler a span is one host event of its name, and no user
    annotation: the profiler puts none of it on the device's timeline, so
    a reduction of the trace counts no span as a device operation."""
    def body():
        assert profiling._profiling()
        with profiling.span("rt.test"):
            return torch.ones(4).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = body()
    mine = [e for e in prof.events() if e.name.startswith("rt.")]
    assert float(out) == 4.0 and [e.name for e in mine] == ["rt.test"]
    assert not getattr(mine[0], "is_user_annotation", False)
    assert "CPU" in str(mine[0].device_type)
    assert not profiling._profiling()


def test_span_totals_count_and_time_profiled_spans():
    """``SPAN_TOTALS`` gains one entry and the host time of each span
    entered under a profiler, nested spans each in full."""
    def count(name):
        return list(profiling.SPAN_TOTALS.get(name, [0, 0.0]))

    before = {k: count(k) for k in ("rt.t.outer", "rt.t.inner")}

    def body():
        with profiling.span("rt.t.outer"):
            for _ in range(3):
                with profiling.span("rt.t.inner"):
                    torch.ones(8).sum()

    _, n = _spans(body)
    assert n == {"rt.t.outer": 1, "rt.t.inner": 3}
    outer, inner = count("rt.t.outer"), count("rt.t.inner")
    assert outer[0] - before["rt.t.outer"][0] == 1
    assert inner[0] - before["rt.t.inner"][0] == 3
    d_outer = outer[1] - before["rt.t.outer"][1]
    d_inner = inner[1] - before["rt.t.inner"][1]
    assert 0.0 < d_inner <= d_outer


#: backend -> the spans one frame records (FUSED: one frame launch and the
#: grad check; the wavefront loop: a search and a shading a bounce; TILED
#: with cached tables: one grad check a call, its rounds, each shading
#: through ``_bounce``, and its reads; on the image scene two samples, each
#: a record frame and a replay of ``REFMAX`` shadings)
_FRAME_SPANS = {
    "brute": {"rt.render": 1, "rt.trace.search": REFMAX,
              "rt.trace.shade": REFMAX},
    "octree": {"rt.render": 1, "rt.trace.search": REFMAX,
               "rt.trace.shade": REFMAX},
    "pallas": {"rt.render": 1, "rt.trace.search": REFMAX,
               "rt.trace.shade": REFMAX},
    "fused": {"rt.render": 1, "rt.render.refuse_grad": 1,
              "rt.fused.frame": 1},
    "tiled": {"rt.render": 1, "rt.render.refuse_grad": 1,
              "rt.tiled.round": 2, "rt.trace.shade": 2, "rt.sync": 5},
    "tiled_image": {"rt.render": 1, "rt.render.refuse_grad": 1,
                    "rt.tiled.round": 4, "rt.trace.shade": 4 + 2 * REFMAX,
                    "rt.sync": 10},
}


@pytest.mark.parametrize("backend", sorted(_FRAME_SPANS))
def test_frame_spans(scene, image_scene, backend):
    """A ``render_hdr`` call records each span the expected number of
    times, and is bit-identical with the profiler on and off."""
    image = backend == "tiled_image"
    cfg = RenderConfig(refmax=REFMAX, spp=2 if image else 1,
                       backend=HitBackend[backend.split("_")[0].upper()])
    sc = image_scene if image else scene
    accel = (build_octree(sc, OctreeConfig(max_depth=3))
             if backend == "octree" else None)
    cam = _camera(24, 16)
    tables = (prtl.frame_tables(sc, cam)
              if cfg.backend == HitBackend.TILED else None)

    def frame():
        return prt.render_hdr(sc, cam, cfg, seed=7, accel=accel,
                              tables=tables)

    plain = frame()
    traced, n = _spans(frame)
    assert dict(n) == _FRAME_SPANS[backend]
    assert torch.equal(traced, plain)


def test_remat_recomputes_the_bounce_spans(scene):
    """Under ``cfg.remat`` the backward recomputes each bounce: its search
    and shading spans fire again, once a bounce."""
    cfg = RenderConfig(refmax=REFMAX, backend=HitBackend.BRUTE, remat=True)
    cam = _camera(12, 8)
    radius = scene.sphere_radius.clone().requires_grad_(True)
    s = dataclasses.replace(scene, sphere_radius=radius)

    def step():
        img = prt.render_hdr(s, cam, cfg, seed=7)
        img.sum().backward()
        return img.detach()

    _, n = _spans(step)
    assert n["rt.render"] == 1
    assert n["rt.trace.search"] == n["rt.trace.shade"] == 2 * REFMAX


def _tiled_counts(scene, cam, cfg, tables):
    """What the TILED frame's diagnostics say it did: (sweep or rescue
    rounds, packet rounds, whether the packet loop stopped early)."""
    _, diag = prtl.render_frame_tiled(scene, cfg, cam, tables=tables,
                                      seed=7, with_diag=True)
    assert int(diag["unresolved"]) == 0
    pk = diag.get("packet_rounds")
    limit = cfg.refmax - 1 + prtl.EXTRA_ROUNDS
    return diag["rounds"], pk or 0, pk is not None and pk < limit


@pytest.mark.parametrize("mode", ["sweep", "sweep_sliced", "packet"])
def test_tiled_frame_spans(scene, monkeypatch, mode):
    """A TILED frame with cached tables: one ``rt.tiled.round`` a sweep or
    rescue round, each shading through ``_bounce`` with the winners given
    (a shading span, no search span); one ``rt.sync`` each time a read site
    is passed (the round's own test, the rounds loop's test, the packet
    loop's test); bit-identical with the profiler on and off."""
    if mode == "sweep_sliced":
        monkeypatch.setattr(prtl, "SWEEP_SLICE", 64)
    if mode == "packet":
        monkeypatch.setattr(prtl, "SWEEP_MAX_PRIMS", 0)
    cfg = RenderConfig(refmax=REFMAX, backend=HitBackend.TILED)
    cam = _camera(tt.LANE, tt.TILE_SUB)
    tables = prtl.frame_tables(scene, cam)
    rounds, packet_rounds, stopped = _tiled_counts(scene, cam, cfg, tables)
    if mode == "sweep_sliced":
        assert rounds > 2
    if mode == "packet":
        assert packet_rounds >= 1

    def frame():
        return prt.render_hdr(scene, cam, cfg, seed=7, tables=tables)

    plain = frame()
    traced, n = _spans(frame)
    assert torch.equal(traced, plain)
    assert n["rt.render"] == 1
    assert n["rt.tiled.round"] == n["rt.trace.shade"] == rounds
    assert "rt.trace.search" not in n
    # each round reads once, the rounds loop once a round and once to end
    # (its bound is never reached here); the packet loop once a round, and
    # once more where it stopped early
    assert n["rt.sync"] == 2 * rounds + 1 + packet_rounds + int(stopped)
