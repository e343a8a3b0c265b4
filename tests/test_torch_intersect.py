"""Ray-primitive intersection: the port against the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.ops import intersect as ji
from raytracer_js_tpu_torch.ops import intersect as pi

RTOL, ATOL = 1e-5, 1e-6


def _rays(n, seed, lo=-6.0, hi=6.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _both(fn_j, fn_p, *arrays):
    j = fn_j(*map(jnp.asarray, arrays))
    p = fn_p(*map(torch.as_tensor, arrays))
    return j, p


def _assert_hit_t(j, p, max_mismatch=0):
    j, p = np.asarray(j), p.numpy()
    assert j.shape == p.shape
    jh, ph = np.isfinite(j), np.isfinite(p)
    # a hit/miss disagreement can only be a grazing ray at a disc ~ 0 edge
    assert (jh != ph).sum() <= max_mismatch
    both = jh & ph
    np.testing.assert_allclose(p[both], j[both], rtol=RTOL, atol=ATOL)


def _near_miss_field(n=200, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    c[:, 0] += 8
    return c, np.full(n, 0.25, np.float32)


def test_sphere_hit_t_random():
    org, d = _rays(300, 1)
    rng = np.random.default_rng(2)
    c = rng.uniform(-4, 4, (9, 3)).astype(np.float32)
    r = rng.uniform(0.3, 2.0, 9).astype(np.float32)
    _assert_hit_t(*_both(ji.sphere_hit_t, pi.sphere_hit_t, org, d, c, r))


def test_sphere_hit_t_near_miss_field():
    """Camera rays through a 200-sphere field: most pass close to several
    spheres, the class an inexact dot product turns into phantom hits."""
    c, r = _near_miss_field()
    n = 32
    th = (np.arange(n, dtype=np.float32) - n // 2) * np.float32(np.pi / 2 / n)
    ch, sh = np.cos(th), np.sin(th)
    d = np.stack([np.outer(ch, ch).ravel(), np.tile(sh, n),
                  np.repeat(ch * sh, n)], 1).astype(np.float32)
    org = np.tile(np.float32([0.0, 0.0, 0.5]), (n * n, 1))
    j, p = _both(ji.sphere_hit_t, pi.sphere_hit_t, org, d, c, r)
    _assert_hit_t(j, p)
    # the field really is near-miss rich
    jn = np.asarray(j)
    assert np.isfinite(jn).any(axis=1).mean() > 0.2


def test_box_hit_t_random_and_grazing():
    org, d = _rays(300, 3)
    c = np.array([[0, 0, 0], [3, -2, 1], [-4, 4, -1]], np.float32)
    h = np.array([[1, 1, 1], [0.5, 2, 1], [2, 0.5, 0.5]], np.float32)
    _assert_hit_t(*_both(ji.box_hit_t, pi.box_hit_t, org, d, c, h))
    # axis-parallel rays grazing faces, edges and corners of a unit box
    g_org = np.array([[-3, 1, 0], [-3, 1, 1], [-3, 0.5, 1], [-3, 2, 0],
                      [0, -3, 1], [0.5, 0.5, -3], [-3, -1, -1]], np.float32)
    g_d = np.array([[1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 0]], np.float32)
    j, p = _both(ji.box_hit_t, pi.box_hit_t, g_org, g_d, c[:1], h[:1])
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_tri_hit_t_random():
    org, d = _rays(300, 4)
    rng = np.random.default_rng(5)
    v = rng.uniform(-3, 3, (3, 6, 3)).astype(np.float32)
    _assert_hit_t(*_both(ji.tri_hit_t, pi.tri_hit_t, org, d, *v))


@pytest.mark.parametrize("fn", ["sphere_hit_t", "box_hit_t", "tri_hit_t"])
def test_empty_tables(fn):
    org, d = _rays(5, 6)
    empty = [np.zeros((0, 3), np.float32)] * (3 if fn == "tri_hit_t" else 2)
    if fn == "sphere_hit_t":
        empty[1] = np.zeros((0,), np.float32)
    assert getattr(pi, fn)(*map(torch.as_tensor, (org, d, *empty))).shape \
        == (5, 0)


def _hit_rows(t):
    """For each ray: the first prim it hits forward (-1 if none)."""
    t = np.asarray(t)
    return np.where(np.isfinite(t).any(1), np.argmin(t, 1), -1)


def _assert_surface(j, p):
    jt, jp, jn, (ju, jv) = j
    pt, pp, pn, (pu, pv) = p
    for a, b in ((pt, jt), (pp, jp), (pn, jn), (pu, ju), (pv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-5)


def test_sphere_surface():
    org, d = _rays(400, 7)
    c = np.array([[0.5, 0.2, -0.3]], np.float32)
    r = np.array([2.5], np.float32)
    k = _hit_rows(ji.sphere_hit_t(jnp.asarray(org), jnp.asarray(d),
                                  jnp.asarray(c), jnp.asarray(r))) >= 0
    args = (org[k], d[k], np.repeat(c, k.sum(), 0), np.repeat(r, k.sum()))
    _assert_surface(*_both(ji.sphere_surface, pi.sphere_surface, *args))


def test_box_surface():
    org, d = _rays(400, 8)
    c = np.array([[0.3, -0.2, 0.1]], np.float32)
    h = np.array([[2.0, 1.5, 2.5]], np.float32)
    k = _hit_rows(ji.box_hit_t(jnp.asarray(org), jnp.asarray(d),
                               jnp.asarray(c), jnp.asarray(h))) >= 0
    args = (org[k], d[k], np.repeat(c, k.sum(), 0), np.repeat(h, k.sum(), 0))
    _assert_surface(*_both(ji.box_surface, pi.box_surface, *args))


def test_box_surface_axis_tie_order():
    """A ray through an edge ties two slab axes; x wins over y over z."""
    org = np.array([[-3, -3, 0], [0, -3, -3], [-3, -3, -3]], np.float32)
    d = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.zeros((3, 3), np.float32)
    h = np.ones((3, 3), np.float32)
    j, p = _both(ji.box_surface, pi.box_surface, org, d, c, h)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(p[2].numpy()[:, :2],
                                  [[-1, 0], [0, -1], [-1, 0]])


def test_tri_surface():
    org, d = _rays(400, 9, lo=-1, hi=1)
    org[:, 2] = 4.0
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = np.array([[-3, -3, 0]], np.float32)
    v1 = np.array([[4, -3, 0.5]], np.float32)
    v2 = np.array([[-3, 4, -0.5]], np.float32)
    k = _hit_rows(ji.tri_hit_t(*map(jnp.asarray, (org, d, v0, v1, v2)))) >= 0
    assert k.mean() > 0.3
    args = (org[k], d[k], *(np.repeat(v, k.sum(), 0) for v in (v0, v1, v2)))
    _assert_surface(*_both(ji.tri_surface, pi.tri_surface, *args))
