"""The octree search kernel (``csrc/octree_dda.cu``) on the CPU: a float32
model of its per-ray control flow in NumPy (one ray at a time, its own
``3R + 2`` cap, the skip byte read before a cell's offsets, the first
minimum of a strict ``<``, the slots past a cell's count skipped) against
the port's live-ray loop (``accel/octree.nearest_hit_octree_plain``) bit
for bit in t, pid and each ray's steps and tests, and the same rays
through the reference's DDA under the rounding rule of
``tests/test_torch_octree.py``. The kernel itself
runs only on the card (``chip_smoke.py`` phase 9f holds it against the
plain loop there); its dispatch is checked here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.accel import octree as jo
from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import OctreeConfig
from raytracer_js_tpu_torch.kernels import octree_dda
from raytracer_js_tpu_torch.utils import parity

from test_octree import _random_scene
from test_torch_parity import ROOT, load_by_path, to_port_scene
from test_torch_scene_camera import assert_same_scene

f32 = np.float32
INF = f32(np.inf)
#: the kernel's constants: Python's 1e-12, 1e-4 and MT_EPS as float32
DIR_EPS, EPS_T, MT_EPS = f32(1e-12), f32(1e-4), f32(1e-9)


# ---------------------------------------------------------------------------
# The per-ray model of octree_dda_kernel
# ---------------------------------------------------------------------------

def _nan_min(a, b):
    return a if a != a else (b if b != b else (b if b < a else a))


def _nan_max(a, b):
    return a if a != a else (b if b != b else (b if b > a else a))


def _clamp0(x):
    return x if x != x else (f32(0) if x < 0 else x)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], f32)


def _safe_inv(d):
    return f32(1) / ((-DIR_EPS if d < 0 else DIR_EPS) if abs(d) < DIR_EPS
                     else d)


def _sqrt(x):
    """The square root as the plain loop takes it on the CPU: torch's CPU
    sqrt is not correctly rounded on every CPU (with AVX-512 it is 1 ulp
    off IEEE for ~0.6% of inputs); the card's, and the kernel's sqrtf, are
    IEEE."""
    return torch.sqrt(torch.tensor(x, dtype=torch.float32)).numpy()[()]


def _int_rz(x):
    """cvt.rzi.s32.f32: truncate, saturate, NaN -> 0."""
    if x != x:
        return 0
    return int(min(max(float(x), -2.0 ** 31), 2.0 ** 31 - 1))


def _prim_t(g, o, d, pid):
    ns, nb = g["ns"], g["nb"]
    if pid < ns:
        oc = o - g["sc"][pid]
        r = g["sr"][pid]
        b = _dot(oc, d)
        a = _dot(d, d)
        cc = _dot(oc, oc) - r * r
        disc = b * b - a * cc
        sq = _sqrt(_clamp0(disc))
        tn, tf = (-b - sq) / a, (-b + sq) / a
        ts = tn if tn >= 0 else (tf if tf >= 0 else INF)
        return ts if disc >= 0 else INF
    if pid < ns + nb:
        c, h = g["bc"][pid - ns], g["bh"][pid - ns]
        inv = [_safe_inv(x) for x in d]
        ta = ((c - h) - o) * inv
        tb = ((c + h) - o) * inv
        te = _nan_max(_nan_max(_nan_min(ta[0], tb[0]), _nan_min(ta[1], tb[1])),
                      _nan_min(ta[2], tb[2]))
        tx = _nan_min(_nan_min(_nan_max(ta[0], tb[0]), _nan_max(ta[1], tb[1])),
                      _nan_max(ta[2], tb[2]))
        t = te if te >= 0 else (tx if tx >= 0 else INF)
        return t if te <= tx else INF
    i = pid - ns - nb
    v0 = g["v0"][i]
    e1, e2 = g["v1"][i] - v0, g["v2"][i] - v0
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    inv = f32(1) / (MT_EPS if abs(det) < MT_EPS else det)
    sv = o - v0
    u = _dot(sv, pv) * inv
    qv = _cross(sv, e1)
    v = _dot(d, qv) * inv
    tt = _dot(e2, qv) * inv
    ok = abs(det) >= MT_EPS and u >= 0 and v >= 0 and u + v <= 1 and tt >= 0
    return tt if ok else INF


def _model_ray(g, o, d):
    """One ray through the kernel's control flow -> (t, pid, steps,
    tests)."""
    t_best, pid_best, tests, steps = INF, -1, 0, 0
    for pid in g["coarse"]:
        if pid < 0:
            continue
        tests += 1
        t = _prim_t(g, o, d, pid)
        if t < t_best:
            t_best, pid_best = t, int(pid)
    if g["ids"].size:
        R, K, lo, rs = g["R"], g["K"], g["lo"], g["rs"]
        cell_sz = rs / f32(R)
        inv = np.array([_safe_inv(x) for x in d], f32)
        ta, tb = (lo - o) * inv, ((lo + rs) - o) * inv
        t_enter = _nan_max(_nan_max(_nan_min(ta[0], tb[0]),
                                    _nan_min(ta[1], tb[1])),
                           _nan_min(ta[2], tb[2]))
        t_exit = _nan_min(_nan_min(_nan_max(ta[0], tb[0]),
                                   _nan_max(ta[1], tb[1])),
                          _nan_max(ta[2], tb[2]))
        t_cur = _clamp0(t_enter)
        sp = np.array([f32(1) if x >= 0 else f32(0) for x in d], f32)
        ad = np.abs(d)
        dt_cheb = cell_sz / _nan_max(_nan_max(ad[0], ad[1]), ad[2])
        eps_t = EPS_T * dt_cheb
        live = t_cur <= t_exit
        while live and steps < 3 * R + 2:
            steps += 1
            p = o + (t_cur + eps_t) * d
            cell = [min(max(_int_rz(np.floor((p[a] - lo[a]) / cell_sz)), 0),
                        R - 1) for a in range(3)]
            lin = (cell[0] * R + cell[1]) * R + cell[2]
            # the skip byte first: 0 exactly where the cell lists an id,
            # and only then the offsets
            skip = int(g["skip"][lin])
            if skip > 0:
                assert g["off"][lin + 1] == g["off"][lin], lin
            else:
                base = int(g["off"][lin])
                m = min(int(g["off"][lin + 1]) - base, K)
                assert m > 0, lin
                t_min, p_min = INF, -1
                for j in range(m):
                    pid = int(g["ids"][base + j])
                    t = _prim_t(g, o, d, pid)
                    if t < t_min:
                        t_min, p_min = t, pid
                tests += m
                if t_min < t_best:
                    t_best, pid_best = t_min, p_min
            nb = lo + (np.array(cell, f32) + sp) * cell_sz
            tq = (nb - o) * inv
            t_exit_cell = _nan_min(_nan_min(tq[0], tq[1]), tq[2])
            k = f32(skip)
            t_jump = t_cur + _clamp0(k - f32(2)) * dt_cheb
            t_new = _nan_max(_nan_max(t_exit_cell, t_jump), t_cur + eps_t)
            live = not ((not np.isinf(t_best) and t_best <= t_new)
                        or t_new > t_exit)
            t_cur = t_new
    return t_best, (pid_best if np.isfinite(t_best) else -1), steps, tests


def _model(scene, accel, org, dir):
    """The model over every ray -> (t [N] f32, pid, steps, tests [N] i32)."""
    g = dict(ns=scene.n_spheres, nb=scene.n_boxes,
             sc=scene.sphere_center.numpy(), sr=scene.sphere_radius.numpy(),
             bc=scene.box_center.numpy(), bh=scene.box_half.numpy(),
             v0=scene.tri_v0.numpy(), v1=scene.tri_v1.numpy(),
             v2=scene.tri_v2.numpy(), coarse=accel.coarse_ids.numpy(),
             ids=accel.cell_ids.numpy(), off=accel.cell_offsets.numpy(),
             skip=accel.skip_dist.numpy(), R=accel.res,
             K=accel.max_per_cell, lo=accel.root_lo.numpy(),
             rs=accel.root_size.numpy()[()])
    out = []
    with np.errstate(all="ignore"):
        for o, d in zip(org.numpy(), dir.numpy()):
            out.append(_model_ray(g, o, d))
    t, pid, steps, tests = zip(*out)
    return (torch.as_tensor(np.array(t, f32)),
            torch.as_tensor(np.array(pid, np.int32)),
            torch.as_tensor(np.array(steps, np.int32)),
            torch.as_tensor(np.array(tests, np.int32)))


def _check_model_equals_plain(ps, pa, o, d):
    """The model against the plain loop bit for bit -> the plain loop's
    (t, pid, per-ray steps)."""
    stats, per_ray = {}, {}
    t_p, p_p = po.nearest_hit_octree_plain(ps, pa, o, d, stats=stats,
                                           per_ray=per_ray)
    t_m, p_m, s_m, n_m = _model(ps, pa, o, d)
    assert torch.equal(t_m.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(p_m, p_p)
    assert torch.equal(s_m, per_ray["steps"])
    assert torch.equal(n_m, per_ray["tests"])
    assert int(s_m.max()) == stats["steps"]
    assert int(s_m.sum()) == stats["ray_steps"]
    assert int(n_m.sum()) == stats["tests"]
    return t_p, p_p, per_ray["steps"]


def _check_reference(js, ja, ps, o, d, t_p, p_p):
    """The reference's DDA on the same rays under the parity rule (proven
    flips; sphere hits whose t differs within twice ``sphere_t_bound``).
    A ray that still differs must be a sphere hit that float32 leaves
    undetermined (``parity.grazing_prover`` with either side's winner, as
    chip_smoke's config-4 rule): a tangent ray one side hits and the other
    misses, or an origin so far that ``|oc|^2 - r^2`` loses ``r^2``."""
    t_j, p_j = jo.nearest_hit_octree(js, ja, jnp.asarray(o.numpy()),
                                     jnp.asarray(d.numpy()))
    t_j, p_j = torch.as_tensor(np.array(t_j)), torch.as_tensor(np.array(p_j))
    rep = parity.compare_hits(ps, o, d, t_p, p_p, t_j, p_j,
                              rounding_slack=True)
    if rep["ok"]:
        return rep, 0
    bad = torch.as_tensor([not parity.compare_hits(
        ps, o[i:i + 1], d[i:i + 1], t_p[i:i + 1], p_p[i:i + 1],
        t_j[i:i + 1], p_j[i:i + 1], rounding_slack=True)["ok"]
        for i in range(o.shape[0])])
    idx = torch.nonzero(bad).flatten()
    proven = (parity.grazing_prover(ps, o, d, pid=p_p)(idx)
              | parity.grazing_prover(ps, o, d, pid=p_j)(idx))
    assert bool(proven.all()), (rep, idx[~proven].tolist())
    return rep, int(idx.numel())


def _rays(n, seed, span=6.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(org), torch.as_tensor(d)


@pytest.fixture(scope="module")
def mixed():
    js = _random_scene(30)
    return js, to_port_scene(js)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_model_equals_the_live_ray_loop_on_the_mixed_scene(mixed, depth):
    js, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
    o, d = _rays(256, 100 + depth)
    t_p, p_p, steps = _check_model_equals_plain(ps, pa, o, d)
    assert int((p_p >= 0).sum()) > 20 and int(steps.max()) > 2
    rep, graze = _check_reference(js, ja, ps, o, d, t_p, p_p)
    assert rep["hits"] > 20 and graze == 0


# ---------------------------------------------------------------------------
# The near-miss field
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


@pytest.mark.parametrize("depth", [3, 4])
def test_model_equals_the_live_ray_loop_on_the_near_miss_field(smoke,
                                                                depth):
    """``chip_smoke.py``'s near-miss field and its rays, which the card
    holds the kernel to the plain loop on."""
    from raytracer_js_tpu import SceneBuilder as JSceneBuilder

    js = smoke.octree_field(JSceneBuilder).build()
    ps = to_port_scene(js)
    assert_same_scene(smoke.octree_field().build(device="cpu"), js)
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
    assert int((pa.coarse_ids >= 0).sum()) >= 1 and pa.max_per_cell > 1
    o, d, kinds = smoke.octree_field_rays(ps, pa, seed=depth)
    t_p, p_p, steps = _check_model_equals_plain(ps, pa, o, d)
    cap = 3 * pa.res + 2
    # every kind is present, some rays hit, and some walks end at the cap
    assert int((p_p >= 0).sum()) > 40
    assert bool((steps[kinds == "cap"] == cap).all())
    # the reference on the same rays (the zero direction aside: the parity
    # rule's rounding bound divides by |dir|)
    fin = torch.as_tensor(kinds != "cap")
    rep, graze = _check_reference(js, ja, ps, o[fin], d[fin], t_p[fin],
                                  p_p[fin])
    assert graze <= int(fin.sum()) // 4, (rep, graze)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_dispatch_cpu_takes_the_plain_loop_and_meta_raises(mixed):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=3))
    o, d = _rays(32, 5)
    stats_a, stats_b = {}, {}
    t_a, p_a = po.nearest_hit_octree(ps, pa, o, d, stats=stats_a)
    t_b, p_b = po.nearest_hit_octree_plain(ps, pa, o, d, stats=stats_b)
    assert torch.equal(t_a, t_b) and torch.equal(p_a, p_b)
    assert stats_a == stats_b and set(stats_a) == {"steps", "ray_steps",
                                                   "tests"}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        po.nearest_hit_octree(ps, pa, o.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        octree_dda.launch(ps, pa, o, d)
    assert octree_dda.LAUNCHES == {"octree_dda": 0}


def test_dispatch_card_launches_and_never_runs_the_plain_loop(
        mixed, monkeypatch):
    """With the device test answering "card", the dispatcher calls the
    launch wrapper and fills ``stats``/``per_ray`` from its per-ray counts;
    the plain loop is never reached."""
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=3))
    o, d = _rays(32, 6)
    t_m, p_m, s_m, n_m = _model(ps, pa, o, d)
    calls = []

    def fake_launch(scene, accel, org, dir, live=None):
        calls.append(org.shape[0])
        return t_m, p_m, s_m, n_m

    def no_plain(*a, **kw):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(po._build, "on_cpu", lambda dev: False)
    monkeypatch.setattr(octree_dda, "launch", fake_launch)
    monkeypatch.setattr(po, "nearest_hit_octree_plain", no_plain)
    stats, per_ray = {}, {}
    t, pid = po.nearest_hit_octree(ps, pa, o, d, stats=stats,
                                   per_ray=per_ray)
    assert calls == [32] and t is t_m and pid is p_m
    assert stats == {"steps": int(s_m.max()), "ray_steps": int(s_m.sum()),
                     "tests": int(n_m.sum())}
    assert per_ray["steps"] is s_m and per_ray["tests"] is n_m
