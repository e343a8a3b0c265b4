"""Counter RNG: bit-identical to the reference, uint32 edge ids included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.ops import sampling as js
from raytracer_js_tpu_torch.ops import sampling as ps

EDGE_IDS = np.array([0, 1, 2, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                     2 ** 32 - 2, 2 ** 32 - 1], np.uint64)


def _ids(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_IDS,
                           rng.integers(0, 2 ** 32, n, dtype=np.uint64)])


def _j(ids):
    return jnp.asarray(ids.astype(np.uint32))


def _p(ids):
    return torch.as_tensor(ids.astype(np.int64))


def test_lowbias32_bit_identical():
    ids = _ids()
    np.testing.assert_array_equal(
        ps.lowbias32(_p(ids)).numpy().astype(np.uint64),
        np.asarray(js.lowbias32(_j(ids))).astype(np.uint64))


@pytest.mark.parametrize("salt", [js.SALT_Z, js.SALT_PHI, js.SALT_R,
                                  js.SALT_FRESNEL])
@pytest.mark.parametrize("bounce", [0, 1, 3, 7])
@pytest.mark.parametrize("seed", [0, ps.DEFAULT_SEED, 2 ** 32 - 1])
def test_hash_and_uniform_bit_identical(salt, bounce, seed):
    ids = _ids(128, seed=bounce)
    ph = ps.hash_u32(seed, _p(ids), bounce, salt)
    jh = js.hash_u32(jnp.uint32(seed), _j(ids), jnp.uint32(bounce), salt)
    np.testing.assert_array_equal(ph.numpy().astype(np.uint64),
                                  np.asarray(jh).astype(np.uint64))
    pu = ps.uniform01(ph).numpy()
    ju = np.asarray(js.uniform01(jh))
    assert pu.dtype == np.float32
    np.testing.assert_array_equal(pu.view(np.uint32), ju.view(np.uint32))


def test_int32_ray_ids_wrap_like_uint32():
    """render_rays feeds int32 ids; negative int32 reinterpret as uint32."""
    ids32 = np.array([-1, -2, -(2 ** 31), 5], np.int32)
    ph = ps.hash_u32(7, torch.as_tensor(ids32), 2, js.SALT_Z)
    jh = js.hash_u32(jnp.uint32(7), jnp.asarray(ids32), jnp.uint32(2),
                     js.SALT_Z)
    np.testing.assert_array_equal(ph.numpy().astype(np.uint64),
                                  np.asarray(jh).astype(np.uint64))


@pytest.mark.parametrize("bounce", [0, 2])
def test_ball_sample_matches(bounce):
    ids = np.arange(2048, dtype=np.uint64) * 7919
    p = ps.ball_sample_xyz(ps.DEFAULT_SEED, _p(ids), bounce)
    j = js.ball_sample_xyz(jnp.uint32(ps.DEFAULT_SEED), _j(ids),
                           jnp.uint32(bounce))
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_scatter_direction_matches():
    rng = np.random.default_rng(3)
    n = 1024
    r = rng.normal(size=(n, 3)).astype(np.float32)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    nn = rng.normal(size=(n, 3)).astype(np.float32)
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    rho = rng.choice([0.0, 0.25, 0.5, 1.0], n).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    p = ps.scatter_direction(123, _p(ids), 1, torch.as_tensor(r),
                             torch.as_tensor(nn), torch.as_tensor(rho))
    j = js.scatter_direction(jnp.uint32(123), _j(ids), 1, jnp.asarray(r),
                             jnp.asarray(nn), jnp.asarray(rho))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-6)
    # roughness 0 returns the reflection exactly
    np.testing.assert_array_equal(p.numpy()[rho == 0], r[rho == 0])
