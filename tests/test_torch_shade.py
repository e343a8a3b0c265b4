"""The wavefront shade kernel (``csrc/shade.cu``, ``kernels/shade``) on the
CPU.

* A float32 model of its per-ray arithmetic and control flow in NumPy (one
  ray at a time: the winner's surface, the texture and material reads, the
  mirror reflection and rough scatter, the sky, the status decisions, the
  epilogue) against the port's plain ``ops/trace._shade`` plus the
  epilogue, bit for bit in every column and the next bounce's ALIVE mask.
* The CUDA source itself, compiled here by g++ against a header that runs
  each thread of a launch in turn (the elementary functions taken from
  torch, as the plain twin takes them), called through the real launch
  wrapper on CPU tensors: the same cases, and whole traces, recordings and
  TILED frames through the dispatch, against the plain path.
* The dispatch: what takes the plain ``_shade`` (CPU tensors, autograd,
  remat, each scene outside the class) and the wrapper's refusal of CPU
  tensors.

The kernel runs on the card only in ``chip_smoke.py`` (phase 9j), which
holds it to the plain ``_shade`` there."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import render_tiled
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import (HitBackend, OctreeConfig,
                                           RayStatus, RenderConfig,
                                           ResponseType)
from raytracer_js_tpu_torch.kernels import _build
from raytracer_js_tpu_torch.kernels import shade as shade_kernel
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.models.scene import float_partition, records_grad
from raytracer_js_tpu_torch.ops import trace
from raytracer_js_tpu_torch.ops.trace import refuse_grad

import cuda_emu
from test_torch_parity import ROOT, load_by_path

f32 = np.float32
ALIVE, LIGHT, KEEP, MISS, EXHAUST = (int(s) for s in RayStatus)
CAP = render_tiled._CAP
SEED = 4070199207
STATUSES = (ALIVE, LIGHT, KEEP, MISS, EXHAUST, CAP)


# ---------------------------------------------------------------------------
# Scenes and states
# ---------------------------------------------------------------------------

def _field(seed=0, rough=0.3, n_sph=24, n_box=6, n_tri=10):
    """Spheres (a tiny and a zero radius among them), boxes and triangles
    (a degenerate one) in front of the origin; diffuse, mirror, rough
    mirror, emitter and emitting-mirror materials; solid textures and sky."""
    rng = np.random.default_rng(seed)
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    mats = [b.add_material(ResponseType.REFLECTION),
            b.add_material(ResponseType.REFLECTION, mirror=True),
            b.add_material(ResponseType.REFLECTION, mirror=True,
                           roughness=rough),
            b.add_material(ResponseType.REFLECTION, light=True),
            b.add_material(ResponseType.REFLECTION, light=True, mirror=True)]
    texs = [b.add_solid_texture(rng.uniform(0.1, 1.0, 3)) for _ in range(5)]

    def pick():
        return mats[rng.integers(5)], texs[rng.integers(5)]

    for i in range(n_sph):
        r = (1e-13, 0.0)[i] if i < 2 else rng.uniform(0.05, 1.0)
        b.add_sphere(rng.uniform((2, -3, -2), (8, 3, 2)), r, *pick())
    for i in range(n_box):
        m, t = pick()
        b.add_box(rng.uniform((2, -3, -2), (8, 3, 2)),
                  rng.uniform(0.1, 1.5, 3), mats[1] if i == 0 else m, t)
    for i in range(n_tri):
        v0 = rng.uniform((2, -3, -2), (8, 3, 2))
        v1 = v0 + (0.0 if i == 0 else rng.uniform(-1, 1, 3))
        v2 = v0 + (0.0 if i == 0 else rng.uniform(-1, 1, 3))
        b.add_triangle(v0, v1, v2, *pick())
    return b.build(device="cpu")


def _empty():
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.9)))
    return b.build(device="cpu")


def _smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


def _scene(name):
    if name == "field":
        return _field(0)
    if name == "field_smooth":
        return _field(1, rough=0.0)
    if name == "spheres":
        return _field(2, n_box=0, n_tri=0)
    if name == "tri_edge":
        return _smoke().tri_edge_field(6, 40, device="cpu")[0]
    if name == "near_miss":
        return _smoke().near_miss_field(200, device="cpu")
    assert name == "empty"
    return _empty()


def _rays(scene, n, seed):
    """Origins near the camera; directions at prims (grazing their
    centers), random (mostly misses), axis-parallel within the slab clamp,
    and not unit."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.5, 0.5, (n, 3)).astype(f32)
    targets = np.concatenate([
        scene.sphere_center.numpy(), scene.box_center.numpy(),
        scene.tri_v0.numpy(), np.zeros((1, 3), f32) + (5, 0, 0)])
    d = (targets[rng.integers(len(targets), size=n)]
         + rng.normal(0, 0.3, (n, 3)) - org)
    d[: n // 8] = rng.normal(size=(n // 8, 3))
    k = n // 8
    d[k: k + 8] = [[1, 0, 0], [1, 1e-13, -3e-13], [1e-13, 1, 0],
                   [0, 0, -1], [-1, 0, 0], [0, -1, 1e-14], [1, 0, 1e-12],
                   [1, 2e-12, 0]]
    d = d.astype(np.float64)
    d[k + 8:] /= np.linalg.norm(d[k + 8:], axis=1, keepdims=True)
    d[-n // 8:] *= rng.uniform(0.5, 2.0, (n // 8, 1))
    # axis-parallel rays at each box, their zero components signed: the
    # reflection keeps the sign of zero that the face normal's gives
    j = k + 8
    for c, h in zip(scene.box_center.numpy(), scene.box_half.numpy()):
        for axis, dv in ((0, (1.0, -0.0, 0.0)), (0, (1.0, 0.0, -0.0)),
                         (1, (-0.0, -1.0, -0.0)), (2, (0.0, -0.0, 1.0))):
            if j >= n - n // 8:
                break
            dv = np.array(dv)
            org[j] = c + 0.3 * h * rng.uniform(-1, 1, 3)
            org[j, axis] = c[axis] - dv[axis] * (h[axis] + 1.5)
            d[j] = dv
            j += 1
    return torch.as_tensor(org), torch.as_tensor(d.astype(f32))


def _state(scene, n=400, seed=0, per_ray=False):
    """A wavefront state with every status (TILED's capped one too),
    colors, paths and refr; the winners of a dense search, some replaced
    by other prims, misses and ids past the table; the RNG's ray ids; the
    bounce (an int, or a per-ray tensor)."""
    rng = np.random.default_rng(seed + 100)
    org, dir = _rays(scene, n, seed)
    _t, pid = trace.nearest_hit_brute(scene, org, dir)
    p = scene.n_prims
    if p:
        sel = rng.random(n)
        pid = torch.where(torch.as_tensor(sel < 0.1),
                          torch.as_tensor(rng.integers(0, p, n),
                                          dtype=torch.int32), pid)
        pid = torch.where(torch.as_tensor(sel > 0.97), -1, pid)
        pid[:2] = p + 3
    status = torch.as_tensor(
        np.where(rng.random(n) < 0.7, ALIVE,
                 rng.choice(STATUSES, n)), dtype=torch.int32)
    state = trace.RayState(
        org=org, dir=dir,
        color=torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(f32)),
        path=torch.as_tensor(rng.uniform(0, 10, n).astype(f32)),
        refr=torch.full((n,), 1.0),
        status=status)
    rid = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, n), dtype=torch.int32)
    bounce = (torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32)
              if per_ray else 1)
    return state, pid.to(torch.int32), rid, bounce


def _plain(scene, cfg, state, pid, bounce, rng, last):
    """The plain twin: ``_shade`` (and the epilogue where ``last``) ->
    the output state and the next ALIVE mask."""
    alive = state.status == ALIVE
    out = trace._shade(scene, cfg, state, rng, bounce, trace.prim_rows(scene),
                       alive, pid, None)
    if last:
        out = trace._epilogue(cfg, out)
    return out, out.status == ALIVE


def _assert_same(got, want, alive_got, alive_want):
    for k in ("org", "dir", "color", "path", "refr", "status"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.is_floating_point():
            # bit for bit: the sign of a zero and a NaN's bits count
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = (g != w).reshape(g.shape[0], -1).any(dim=1)
        assert not bool(bad.any()), (k, int(bad.sum()),
                                     torch.nonzero(bad)[:5].ravel())
    assert torch.equal(alive_got, alive_want)


# ---------------------------------------------------------------------------
# The per-ray model of shade_bounce_kernel
# ---------------------------------------------------------------------------

def _torch1(fn, x):
    """One value through torch's CPU function, as the plain twin takes it
    (torch's CPU sqrt, exp, log, cos and sin are not all IEEE or glibc's;
    the card's, and the kernel's there, are the CUDA library's)."""
    return getattr(torch, fn)(torch.tensor(x, dtype=torch.float32)).numpy()[()]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], f32)


def _nan_min(a, b):
    return a if a != a else (b if b != b else (b if b < a else a))


def _nan_max(a, b):
    return a if a != a else (b if b != b else (b if b > a else a))


def _clamp_min(x, lo):
    return x if x != x else (lo if x < lo else x)


def _first_extreme(v, lower):
    """torch.max(dim) (``lower``: min(dim)) over three -> (value, index):
    the first NaN, else the first extremum."""
    k, best = 0, v[0]
    for j in (1, 2):
        if best != best:
            break
        if v[j] != v[j] or (v[j] < best if lower else v[j] > best):
            k, best = j, v[j]
    return best, k


def _against(d, n):
    return -n if _dot(d, n) > 0 else n


def _sphere(o, d, c, r):
    oc = o - c
    b = _dot(oc, d)
    a = _dot(d, d)
    cc = _dot(oc, oc) - r * r
    disc = b * b - a * cc
    sq = _torch1("sqrt", disc) if disc > 0 else f32(0)
    tn, tf = (-b - sq) / a, (-b + sq) / a
    t = tn if tn >= 0 else tf
    pt = o + t * d
    rs = f32(1e-12) if abs(r) < f32(1e-12) else r
    return t, pt, _against(d, (pt - c) / rs)


def _box(o, d, c, h):
    lo, hi = c - h, c + h
    ds = [(f32(-1e-12) if x < 0 else f32(1e-12)) if abs(x) < f32(1e-12)
          else x for x in d]
    inv = np.array([f32(1) / x * f32(1) for x in ds], f32)
    ta, tb = (lo - o) * inv, (hi - o) * inv
    te, ea = _first_extreme([_nan_min(ta[k], tb[k]) for k in range(3)],
                            False)
    tx, xa = _first_extreme([_nan_max(ta[k], tb[k]) for k in range(3)],
                            True)
    t, axis = (te, ea) if te >= 0 else (tx, xa)
    pt = o + t * d
    one = np.array([axis == 0, axis == 1, axis == 2], f32)
    sign = f32(-1) if _dot(d, one) < 0 else f32(1)
    return t, pt, -sign * one


def _tri(o, d, v0, v1, v2):
    e1, e2 = v1 - v0, v2 - v0
    det = _dot(e1, _cross(d, e2))
    inv = f32(1) / (f32(1e-9) if abs(det) < f32(1e-9) else det) * f32(1)
    t = _dot(e2, _cross(o - v0, e1)) * inv
    pt = o + t * d
    g = _cross(e1, e2)
    k = _torch1("rsqrt", _dot(g, g) + f32(1e-20 * 1e-20))
    return t, pt, _against(d, g * k)


def _lowbias32(x):
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def _uniform(seed, rid, bounce, salt):
    m = 0xFFFFFFFF
    h = _lowbias32((rid & m) ^ (seed & m))
    h = _lowbias32((h + (bounce & m) * 0x68BC21EB) & m)
    h = _lowbias32(h ^ salt)
    return f32(h >> 8) * f32(1.0 / (1 << 24))


def _scatter(seed, rid, bounce, r, n, rho):
    if not rho > 0:
        return r
    z = f32(1) - f32(2) * _uniform(seed, rid, bounce, 0x9E3779B9)
    phi = f32(2.0 * np.pi) * _uniform(seed, rid, bounce, 0x85EBCA6B)
    u_r = _uniform(seed, rid, bounce, 0xC2B2AE35)
    s = _torch1("sqrt", _clamp_min(f32(1) - z * z, f32(0)))
    rr = _torch1("exp", _torch1("log", _clamp_min(u_r, f32(2.0 ** -25)))
                 * f32(1.0 / 3.0))
    rs = rr * s
    b = np.array([rs * _torch1("cos", phi), rs * _torch1("sin", phi),
                  rr * z], f32)
    b = b * (f32(-1) if _dot(b, n) < 0 else f32(1))
    k = f32(1) - rho
    m = k * r + rho * b
    inv = f32(1) / _torch1("sqrt", _clamp_min(_dot(m, m), f32(1e-20)))
    return m * inv * f32(1)


def _model(scene, cfg, state, pid, bounce, rng, last):
    """The kernel's control flow, one ray at a time -> (state, alive)."""
    g = {k: getattr(scene, k).numpy() for k in (
        "sphere_center", "sphere_radius", "box_center", "box_half", "tri_v0",
        "tri_v1", "tri_v2", "prim_material", "prim_texture")}
    mt, tx = scene.materials, scene.textures
    rgb = tx.solid_rgb.numpy()
    sky = rgb[min(max(scene.sky_tex, 0), rgb.shape[0] - 1)]
    ns, nb, p_all = scene.n_spheres, scene.n_boxes, scene.n_prims
    n = state.org.shape[0]
    cols = [x.numpy().copy() for x in (state.org, state.dir, state.color,
                                       state.path, state.status)]
    pid = pid.numpy()
    bounce = (bounce.numpy() if isinstance(bounce, torch.Tensor)
              else np.full(n, bounce))
    if scene.has_rough:
        seed, rid = rng[0], rng[1].numpy()
    eps, atten = f32(1e-3), f32(cfg.distance_attenuation_factor)
    with np.errstate(all="ignore"):
        for i in range(n):
            o, d, c = cols[0][i], cols[1][i], cols[2][i]
            path, status = cols[3][i], int(cols[4][i])
            if status == ALIVE:
                if pid[i] < 0 or p_all == 0:
                    c, status = c * sky, MISS
                else:
                    p = min(int(pid[i]), p_all - 1)
                    if p < ns:
                        t, pt, nrm = _sphere(o, d, g["sphere_center"][p],
                                             g["sphere_radius"][p])
                    elif p < ns + nb:
                        t, pt, nrm = _box(o, d, g["box_center"][p - ns],
                                          g["box_half"][p - ns])
                    else:
                        q = p - ns - nb
                        t, pt, nrm = _tri(o, d, g["tri_v0"][q], g["tri_v1"][q],
                                          g["tri_v2"][q])
                    c = c * rgb[g["prim_texture"][p]]
                    path = path + t
                    m = g["prim_material"][p]
                    if mt.light[m]:
                        status = LIGHT
                    elif (int(mt.response[m]) == int(ResponseType.REFLECTION)
                          and mt.mirror[m]):
                        r = d - (f32(2) * _dot(d, nrm)) * nrm
                        if scene.has_rough:
                            r = _scatter(seed, int(rid[i]), int(bounce[i]), r,
                                         nrm, mt.roughness.numpy()[m])
                        o, d = pt + eps * r, r
                    else:
                        status = KEEP
            if last:
                if status == ALIVE:
                    c, status = np.zeros(3, f32), EXHAUST
                if status == LIGHT:
                    pa = path * atten
                    c = c * (f32(1) / (f32(2.0 ** -52) + pa * pa) * f32(1))
            cols[0][i], cols[1][i], cols[2][i] = o, d, c
            cols[3][i], cols[4][i] = path, status
    out = trace.RayState(org=torch.as_tensor(cols[0]),
                         dir=torch.as_tensor(cols[1]),
                         color=torch.as_tensor(cols[2]),
                         path=torch.as_tensor(cols[3]), refr=state.refr,
                         status=torch.as_tensor(cols[4]))
    return out, out.status == ALIVE


CASES = ["field", "field_smooth", "spheres", "tri_edge", "near_miss",
         "empty"]


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in CASES}


def _inputs(scene, per_ray, seed=0, n=400):
    state, pid, rid, bounce = _state(scene, n, seed, per_ray)
    return state, pid, bounce, ((SEED, rid) if scene.has_rough else None)


@pytest.mark.parametrize("last", [False, True], ids=["bounce", "last"])
@pytest.mark.parametrize("per_ray", [False, True], ids=["int", "per_ray"])
@pytest.mark.parametrize("name", CASES)
def test_model_equals_the_plain_shade(scenes, name, per_ray, last):
    scene = scenes[name]
    cfg = RenderConfig(refmax=2, distance_attenuation_factor=0.7)
    state, pid, bounce, rng = _inputs(scene, per_ray)
    want, alive_w = _plain(scene, cfg, state, pid, bounce, rng, last)
    got, alive_g = _model(scene, cfg, state, pid, bounce, rng, last)
    _assert_same(got, want, alive_g, alive_w)
    alive = state.status == ALIVE
    assert bool((alive & (pid >= 0)).any()) == (scene.n_prims > 0)
    assert bool((alive & (want.status == MISS)).any())


def test_the_field_reaches_every_branch(scenes):
    """The field's rays hit each class, take each material and miss; the
    rough mirror scatters."""
    scene = scenes["field"]
    state, pid, _b, _r = _inputs(scene, True)
    alive = state.status == ALIVE
    ns, nb = scene.n_spheres, scene.n_boxes
    for lo, hi in ((0, ns), (ns, ns + nb), (ns + nb, scene.n_prims)):
        assert bool((alive & (pid >= lo) & (pid < hi)).any())
    mat = scene.prim_material[pid.clamp(0, scene.n_prims - 1).long()]
    for m in range(5):
        assert bool((alive & (pid >= 0) & (mat == m)).any()), m
    assert bool((alive & (pid < 0)).any())
    assert set(state.status.tolist()) == set(STATUSES)


# ---------------------------------------------------------------------------
# The CUDA source on the CPU
# ---------------------------------------------------------------------------

#: what the shade kernel uses beyond ``cuda_emu.STUB``: the elementary
#: functions are pointers the test sets to torch's
_EXTRA = r"""
extern "C" {
float (*emu_sqrt)(float), (*emu_rsqrt)(float), (*emu_exp)(float),
    (*emu_log)(float), (*emu_cos)(float), (*emu_sin)(float);
}
inline float __fsqrt_rn(float x) { return emu_sqrt(x); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return emu_rsqrt(x); }
#define expf(x) emu_exp(x)
#define logf(x) emu_log(x)
#define cosf(x) emu_cos(x)
#define sinf(x) emu_sin(x)
"""

_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/shade.cu`` built by g++ for the CPU, its elementary functions
    torch's."""
    cdll = cuda_emu.build(tmp_path_factory, "shade", 1, _EXTRA)
    keep = []
    for name in ("sqrt", "rsqrt", "exp", "log", "cos", "sin"):
        cb = _FN(lambda x, fn=name: float(_torch1(fn, f32(x))))
        keep.append(cb)
        ctypes.c_void_p.in_dll(cdll, f"emu_{name}").value = ctypes.cast(
            cb, ctypes.c_void_p).value
    cdll.keep = keep
    return cdll


@pytest.fixture
def card(emulated, monkeypatch):
    """The CPU as the card for the shade kernel: ``engages`` admits CPU
    tensors and ``launch`` runs the CUDA source built by g++. Counts each
    launch's rays."""
    monkeypatch.setattr(shade_kernel, "_build",
                        cuda_emu.EmulatedBuild(load=lambda: emulated))
    monkeypatch.setattr(shade_kernel, "LAUNCHES", {"shade": 0, "plain": 0})
    return shade_kernel.LAUNCHES


@pytest.mark.parametrize("last", [False, True], ids=["bounce", "last"])
@pytest.mark.parametrize("per_ray", [False, True], ids=["int", "per_ray"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_source_equals_the_plain_shade(scenes, card, name, per_ray,
                                              last):
    scene = scenes[name]
    cfg = RenderConfig(refmax=2, distance_attenuation_factor=0.7)
    state, pid, bounce, rng = _inputs(scene, per_ray, seed=1)
    want, alive_w = _plain(scene, cfg, state, pid, bounce, rng, last)
    got, alive_g = trace._bounce_kernel(scene, cfg, state, rng, bounce,
                                        pid_override=pid, last=last)
    _assert_same(got, want, alive_g, alive_w)
    assert got.refr is state.refr and card == {"shade": 1, "plain": 0}


def _refuse_kernel():
    """From here on the shade kernel declines the CPU again (the ``card``
    fixture's patch is undone at the test's end)."""
    shade_kernel._build.on_cpu = _build.on_cpu


def test_kernel_source_on_a_rough_field_of_many_draws(card):
    """Rough mirrors everywhere: most rays draw the scatter."""
    scene = _field(5, rough=0.6)
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, mirror=torch.ones_like(scene.materials.mirror),
        roughness=torch.tensor([0.9, 0.6, 0.3, 0.05, 1.0])))
    cfg = RenderConfig(refmax=2)
    state, pid, bounce, rng = _inputs(scene, True, seed=7, n=1000)
    want, alive_w = _plain(scene, cfg, state, pid, bounce, rng, False)
    got, alive_g = trace._bounce_kernel(scene, cfg, state, rng, bounce,
                                        pid_override=pid)
    _assert_same(got, want, alive_g, alive_w)
    turned = (want.dir != state.dir).any(dim=1)
    assert int(((state.status == ALIVE) & turned).sum()) > 100


# ---------------------------------------------------------------------------
# Whole traces through the dispatch
# ---------------------------------------------------------------------------

def _camera(w=37, h=23):
    return prt.make_camera((0.0, 0.1, 0.2), w, h, 1.1, 0.8, device="cpu")


def _trace(scene, cfg, accel=None, seed=SEED):
    org, dir = pixel_rays(_camera())
    return trace.trace_rays(scene, cfg, org, dir, seed, accel=accel)


@pytest.mark.parametrize("backend", ["BRUTE", "PALLAS", "OCTREE"])
@pytest.mark.parametrize("name", ["field", "field_smooth", "near_miss"])
def test_traces_take_the_kernel_and_equal_the_plain_loop(scenes, card, name,
                                                         backend):
    scene = scenes[name]
    cfg = RenderConfig(refmax=3, backend=HitBackend[backend])
    accel = (po.build_octree(scene, OctreeConfig(max_depth=3))
             if backend == "OCTREE" else None)
    got = _trace(scene, cfg, accel)
    assert card == {"shade": 3, "plain": 0}
    _refuse_kernel()
    want = _trace(scene, cfg, accel)
    assert card == {"shade": 3, "plain": 0}
    _assert_same(got, want, got.status == ALIVE, want.status == ALIVE)
    assert int((want.status != MISS).sum()) > 50


def test_recording_and_replay_take_the_kernel(scenes, card):
    scene = scenes["field"]
    cfg = RenderConfig(refmax=2)
    org, dir = pixel_rays(_camera())
    rec = trace.record_paths(scene, cfg, org, dir, SEED)
    got = trace.trace_rays(scene, cfg, org, dir, SEED, pid_seq=rec)
    assert card == {"shade": 4, "plain": 0}
    _refuse_kernel()
    assert torch.equal(rec, trace.record_paths(scene, cfg, org, dir, SEED))
    want = trace.trace_rays(scene, cfg, org, dir, SEED, pid_seq=rec)
    _assert_same(got, want, got.status == ALIVE, want.status == ALIVE)


def test_render_hdr_octree_and_spp_take_the_kernel(scenes, card):
    scene = scenes["field"]
    accel = po.build_octree(scene, OctreeConfig(max_depth=3))
    cfg = RenderConfig(refmax=2, spp=2, backend=HitBackend.OCTREE)
    got = prt.render_hdr(scene, _camera(), cfg, seed=SEED, accel=accel)
    assert card == {"shade": 4, "plain": 0}
    _refuse_kernel()
    want = prt.render_hdr(scene, _camera(), cfg, seed=SEED, accel=accel)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tiled_sweep_round_takes_the_kernel(card, monkeypatch):
    """A TILED frame's sweep round shades its working rays (per-ray
    bounces, capped rays among them) with one launch a round."""
    scene = _field(3, n_sph=60)
    cam = _camera(41, 29)
    cfg = RenderConfig(refmax=3, backend=HitBackend.TILED)
    tables = render_tiled.frame_tables(scene, cam)
    monkeypatch.setattr(render_tiled, "SWEEP_SLICE", 300)
    got, diag = render_tiled.render_frame_tiled(
        scene, cfg, cam, tables=tables, seed=SEED, with_diag=True)
    assert diag["unresolved"] == 0 and diag["rounds"] >= 2
    assert card == {"shade": diag["rounds"], "plain": 0}
    _refuse_kernel()
    want, diag_w = render_tiled.render_frame_tiled(
        scene, cfg, cam, tables=tables, seed=SEED, with_diag=True)
    assert diag_w == diag
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The dispatch: what keeps the plain _shade
# ---------------------------------------------------------------------------

def test_a_tiled_frame_chooses_the_shade_once(card, monkeypatch):
    """One dispatch decision a TILED frame, however many sweep rounds."""
    scene = _field(3, n_sph=60)
    cam = _camera(41, 29)
    tables = render_tiled.frame_tables(scene, cam)
    monkeypatch.setattr(render_tiled, "SWEEP_SLICE", 300)
    calls = []
    real = shade_kernel.engages
    monkeypatch.setattr(shade_kernel, "engages",
                        lambda *a: calls.append(a) or real(*a))
    _img, diag = render_tiled.render_frame_tiled(
        scene, RenderConfig(refmax=3, backend=HitBackend.TILED), cam,
        tables=tables, seed=SEED, with_diag=True)
    assert diag["rounds"] >= 2 and len(calls) == 1
    assert card == {"shade": diag["rounds"], "plain": 0}


@pytest.mark.parametrize("where", ["none", "tensor", "scene", "no_grad"])
def test_records_grad_is_the_refusal_and_the_dispatch(scenes, card, where):
    """``records_grad`` decides both ``ops/trace.refuse_grad`` and the shade
    kernel's dispatch: each refuses exactly where the other declines."""
    scene = scenes["field"]
    org = torch.zeros(4, 3)
    if where == "tensor":
        org.requires_grad_(True)
    if where == "scene":
        params, rebuild = float_partition(scene)
        scene = rebuild(params[:-1] + [params[-1].clone().requires_grad_()])
    want = where in ("tensor", "scene")
    with torch.set_grad_enabled(where != "no_grad"):
        assert records_grad(scene, org) is want
        assert shade_kernel.engages(scene, org) is not want
        if want:
            with pytest.raises(RuntimeError, match="has no backward"):
                refuse_grad(scene, org)
        else:
            refuse_grad(scene, org)


def _no_launch(*a, **kw):
    raise AssertionError("the shade kernel was launched")


def test_cpu_tensors_take_the_plain_shade(scenes, monkeypatch):
    monkeypatch.setattr(shade_kernel, "launch", _no_launch)
    monkeypatch.setattr(shade_kernel, "LAUNCHES", {"shade": 0, "plain": 0})
    scene = scenes["field"]
    assert not shade_kernel.engages(scene, torch.zeros(3, 3))
    _trace(scene, RenderConfig(refmax=2))
    # the plain count is of CUDA tensors only
    assert shade_kernel.LAUNCHES == {"shade": 0, "plain": 0}


def test_the_wrapper_refuses_cpu_and_meta_tensors(scenes):
    scene = scenes["field"]
    state, pid, bounce, _rng = _inputs(scene, False)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shade_kernel.launch(scene, state.org, state.dir, state.color,
                            state.path, state.status, pid, bounce)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shade_kernel.launch(scene, state.org.to("meta"), state.dir,
                            state.color, state.path, state.status, pid,
                            bounce)


def _out_of_class(name):
    smoke = _smoke()
    if name == "glass":
        return smoke.config4_glass_scene(300, device="cpu")
    if name == "both":
        b = prt.SceneBuilder()
        b.set_sky(b.add_solid_texture((0.3, 0.4, 0.5)))
        m = b.add_material(ResponseType.BOTH)
        b.add_sphere((4.0, 0.0, 0.0), 1.0, m, b.add_solid_texture((1, 1, 1)),
                     b.add_substance(1.5))
        return b.build(device="cpu")
    b = prt.SceneBuilder()
    img = np.random.default_rng(0).uniform(0, 1, (4, 5, 3))
    t_img = b.add_image_texture(img)
    t_solid = b.add_solid_texture((0.3, 0.4, 0.5))
    m = b.add_material(ResponseType.REFLECTION, mirror=True)
    b.add_sphere((4.0, 0.0, 0.0), 1.0, m,
                 t_img if name == "image" else t_solid)
    if name == "cube_sky":
        b.set_sky_box([t_solid] * 6)
    else:
        b.set_sky(t_solid)
    return b.build(device="cpu")


@pytest.mark.parametrize("name", ["glass", "image", "cube_sky", "both"])
def test_scenes_outside_the_class_take_the_plain_shade(card, name,
                                                        monkeypatch):
    scene = _out_of_class(name)
    assert not shade_kernel.supports(scene)
    monkeypatch.setattr(shade_kernel, "launch", _no_launch)
    _trace(scene, RenderConfig(refmax=2))
    assert card == {"shade": 0, "plain": 2}


def test_inputs_that_require_grad_take_the_plain_shade(scenes, card,
                                                       monkeypatch):
    scene = scenes["field"]
    cfg = RenderConfig(refmax=2)
    org, dir = pixel_rays(_camera())
    params, rebuild = float_partition(scene)
    leaf = params[0].clone().requires_grad_(True)
    grad_scene = rebuild([leaf] + params[1:])
    plain = {"shade": 0, "plain": 2}
    with monkeypatch.context() as mp:
        mp.setattr(shade_kernel, "launch", _no_launch)
        trace.trace_rays(grad_scene, cfg, org, dir, SEED).color.sum() \
            .backward()
        assert leaf.grad is not None and card == plain
        trace.trace_rays(scene, cfg, org.clone().requires_grad_(True), dir,
                         SEED)
        assert card == {"shade": 0, "plain": 4}
    # no grad: the same inputs take the kernel
    with torch.no_grad():
        trace.trace_rays(grad_scene, cfg, org, dir, SEED)
    assert card == {"shade": 2, "plain": 4}


def test_remat_takes_the_plain_shade(scenes, card, monkeypatch):
    """Under remat with grad, even on inputs that require none."""
    scene = scenes["field"]
    cfg = RenderConfig(refmax=2, remat=True)
    params, rebuild = float_partition(scene)
    leaf = params[0].clone().requires_grad_(True)
    org, dir = pixel_rays(_camera())
    with monkeypatch.context() as mp:
        mp.setattr(shade_kernel, "launch", _no_launch)
        trace.trace_rays(rebuild([leaf] + params[1:]), cfg, org, dir, SEED) \
            .color.sum().backward()
        assert leaf.grad is not None and card["shade"] == 0
        trace.trace_rays(scene, cfg, org, dir, SEED)
        assert card["shade"] == 0
    # without grad remat checkpoints nothing, and the kernel shades
    with torch.no_grad():
        trace.trace_rays(scene, cfg, org, dir, SEED)
    assert card["shade"] == 2
