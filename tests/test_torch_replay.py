"""Path recording and replay (``ops/trace.record_paths``, ``trace_rays``
with ``pid_seq``) against the reference package, on the scenes of
``tests/test_replay.py``: mirror, rough (one seed given to both) and
transmission.

Tolerances: recorded winners equal; replayed colors allclose(rtol 1e-5,
atol 1e-6) with equal status, grazing sphere hits proven by
``utils/parity.grazing_prover`` (XLA fuses multiply-adds on the CPU);
autograd gradients against ``jax.grad`` of the XLA replay at rtol 2e-4 /
atol 2e-6 on every float leaf and on org/dir. Inside the port, replay
equals search exactly in value and gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops import sampling as jsampling
from raytracer_js_tpu.ops.trace import record_paths as j_record
from raytracer_js_tpu.ops.trace import trace_rays as j_trace
from raytracer_js_tpu.parallel.sharding import float_partition as j_partition
from raytracer_js_tpu_torch.models.scene import float_partition
from raytracer_js_tpu_torch.ops import trace as ptrace
from raytracer_js_tpu_torch.utils import parity

from test_replay import _scene
from test_torch_parity import assert_parity, to_port_cfg, to_port_scene

SCENES = {"mirror": (dict(), 3), "rough": (dict(rough=0.4), 2),
          "transmission": (dict(trans=True), 3)}


def _setup(kind, w=16, h=16):
    kw, refmax = SCENES[kind]
    js = _scene(**kw)
    cfg = RenderConfig(refmax=refmax)
    org, dirs = pixel_rays(make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2,
                                       np.pi / 2))
    key = jax.random.key(2)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    seed = int(jsampling.seed_from_key(key))
    return js, cfg, org, dirs, key, rid, seed


def _port_grads(ps, pcfg, org, dirs, seed, pid_seq=None):
    params, rebuild = float_partition(ps)
    params = [p.clone().requires_grad_(True) for p in params]
    o = torch.as_tensor(np.array(org)).requires_grad_(True)
    d = torch.as_tensor(np.array(dirs)).requires_grad_(True)
    st = ptrace.trace_rays(rebuild(params), pcfg, o, d, seed,
                           pid_seq=pid_seq)
    loss = (st.color ** 2).sum()
    loss.backward()
    return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params] + [o.grad, d.grad]


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_record_matches_reference(kind):
    js, cfg, org, dirs, key, rid, seed = _setup(kind)
    want = np.asarray(j_record(js, cfg, org, dirs, key, rid))
    got = ptrace.record_paths(to_port_scene(js), to_port_cfg(cfg),
                              torch.as_tensor(np.array(org)),
                              torch.as_tensor(np.array(dirs)), seed)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_replay_of_reference_winners(kind):
    """The port replays the reference's recording: colors and status, then
    gradients against jax.grad of the reference's XLA replay."""
    js, cfg, org, dirs, key, rid, seed = _setup(kind)
    rec = j_record(js, cfg, org, dirs, key, rid)
    pid_seq = torch.as_tensor(np.array(rec))
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    o_t, d_t = torch.as_tensor(np.array(org)), torch.as_tensor(np.array(dirs))
    ref = j_trace(js, cfg, org, dirs, key, rid, pid_seq=rec)
    st = ptrace.trace_rays(ps, pcfg, o_t, d_t, seed, pid_seq=pid_seq)
    assert_parity(st.color, st.status, np.asarray(ref.color),
                  np.asarray(ref.status),
                  prove_rounding=parity.grazing_prover(ps, o_t, d_t))

    params, rebuild = j_partition(js)

    def loss(p, o, d):
        s = j_trace(rebuild(p), cfg, o, d, key, rid, pid_seq=rec)
        return jnp.sum(s.color ** 2)

    l_ref, (g_p, g_o, g_d) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        params, org, dirs)
    l_port, grads = _port_grads(ps, pcfg, org, dirs, seed, pid_seq)
    np.testing.assert_allclose(l_port, float(l_ref), rtol=1e-5)
    for got, want in zip(grads, list(g_p) + [g_o, g_d]):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_replay_equals_search(kind):
    js, cfg, org, dirs, key, rid, seed = _setup(kind)
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    pid_seq = ptrace.record_paths(ps, pcfg, torch.as_tensor(np.array(org)),
                                  torch.as_tensor(np.array(dirs)), seed)
    l_s, g_s = _port_grads(ps, pcfg, org, dirs, seed)
    l_r, g_r = _port_grads(ps, pcfg, org, dirs, seed, pid_seq)
    assert l_r == l_s
    for a, b in zip(g_r, g_s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_replay_never_searches(monkeypatch):
    """A replay takes its winners from pid_seq: the search must not run."""
    js, cfg, org, dirs, key, rid, seed = _setup("mirror", 8, 8)
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    o_t, d_t = torch.as_tensor(np.array(org)), torch.as_tensor(np.array(dirs))
    pid_seq = ptrace.record_paths(ps, pcfg, o_t, d_t, seed)
    want = ptrace.trace_rays(ps, pcfg, o_t, d_t, seed).color

    def no_search(*args, **kw):
        raise AssertionError("the replay ran a nearest-hit search")

    monkeypatch.setattr(ptrace, "nearest_hit", no_search)
    got = ptrace.trace_rays(ps, pcfg, o_t, d_t, seed, pid_seq=pid_seq).color
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="ran a nearest-hit search"):
        ptrace.trace_rays(ps, pcfg, o_t, d_t, seed)
