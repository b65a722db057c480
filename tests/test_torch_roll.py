"""The port's DDA roll (torch twin and CUDA kernel) against the JAX package.

Bit-exact: every visit field and every carried field, f32 compared as its
int32 bits.  Inputs are made with numpy from fixed seeds and handed to both
packages.  JAX is imported inside the tests that compare with it: the card's
machine has no jax, and the ``cuda`` tests run there
(``python -m pytest --noconftest -m cuda tests/test_torch_*.py``).
"""
import numpy as np
import pytest
import torch

from cpuvox_tpu_torch.ops import roll_kernel
from cpuvox_tpu_torch.render import raymarch as trm

DIMS = (64, 16, 64)
LOD_DIST = np.array([2., 5., 9., 14., 20., 27.], np.float32)
FAR = np.float32(40.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def adversarial_state(R=256, seed=3):
    """tests/test_pallas_kernel.py:351-392's state: axis-parallel rays (inf
    tdelta), out-of-bounds positions, dead lanes, mixed LODs."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-4, 60, size=(R, 2)).astype(np.int32)
    dirs = rng.normal(size=(R, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True).astype(np.float32)
    dirs[:8, 0] = 0.0
    with np.errstate(divide="ignore"):
        tdelta = np.abs(1.0 / dirs).astype(np.float32)
    tmax = (rng.random((R, 2)).astype(np.float32) * tdelta).astype(np.float32)
    tmax = np.where(np.isfinite(tmax), tmax, np.float32(1e30)).astype(np.float32)
    dda = dict(pos=pos, tmax=tmax, tdelta=tdelta,
               stp=np.where(dirs >= 0, 1, -1).astype(np.int32),
               ids=np.sort(rng.random((R, 2)).astype(np.float32) * 3.0, axis=1),
               lod=rng.integers(0, 3, size=R).astype(np.int32))
    alive = rng.random(R) < 0.9
    return dda, alive, dirs


def frame_state():
    """A real frame's host-initialised state (camera outside the world)."""
    import scenes
    from cpuvox_tpu.render import camera as cm
    from cpuvox_tpu_torch.render import ray_init

    w = scenes.random_world(dims=(64, 16, 64), n=300, seed=5)
    cam = cm.Camera(position=(-6, 9, -6), pitch_deg=30.0, yaw_deg=45.0,
                    screen=(64, 48))
    _, cam_data, _, segs, ctxs = scenes.frame_setup(w, cam, LOD_DIST)
    static, dda, alive, _ = ray_init.init_rays_np(cam_data, segs, ctxs, DIMS)
    return dda, alive, static["dirs"]


def jax_visits_as_stack(visits):
    """JAX's 8-tuple visit list -> the port's (C, 13, R) int32 stack."""
    pos, ids, lod, valid, p_pos, p_tmax, p_ids, p_lod = (np.asarray(v)
                                                         for v in visits)
    fields = [pos[..., 0], pos[..., 1], bits(ids[..., 0]), bits(ids[..., 1]),
              lod, valid.astype(np.int32), p_pos[..., 0], p_pos[..., 1],
              bits(p_tmax[..., 0]), bits(p_tmax[..., 1]), bits(p_ids[..., 0]),
              bits(p_ids[..., 1]), p_lod]
    return np.stack(fields, axis=1)


def torch_roll(fn, dda, alive, dirs, device="cpu", chunk=16):
    t = {k: torch.from_numpy(v.copy()).to(device) for k, v in dda.items()}
    out = fn(trm.DDAState(**t), torch.from_numpy(alive.copy()).to(device),
             torch.from_numpy(dirs).to(device),
             torch.from_numpy(LOD_DIST).to(device), float(FAR), DIMS, chunk)
    d, a, v = out
    return ({k: getattr(d, k).cpu().numpy() for k in trm.DDAState._fields},
            a.cpu().numpy(), v.cpu().numpy())


def jax_roll(fn, dda, alive, dirs, chunk=16, **kw):
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm

    jd = jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()})
    d, a, v = fn(jd, jnp.asarray(alive), jnp.asarray(dirs),
                 jnp.asarray(LOD_DIST), jnp.float32(FAR), DIMS, chunk, **kw)
    return ({k: np.asarray(getattr(d, k)) for k in trm.DDAState._fields},
            np.asarray(a), jax_visits_as_stack(v))


def assert_same(a, b):
    (da, aa, va), (db, ab, vb) = a, b
    for k in trm.DDAState._fields:
        np.testing.assert_array_equal(bits(da[k]), bits(db[k]), err_msg=k)
    np.testing.assert_array_equal(aa, ab, err_msg="alive")
    diff = va != vb
    assert not diff.any(), (
        f"{int(diff.sum())} visit fields differ; first (step, field, ray): "
        f"{np.argwhere(diff)[:5].tolist()}")


@pytest.mark.parametrize("x", [1e20, -1e20, np.inf, -np.inf, np.nan, 0.0,
                               -0.0, 2.5, -2.5, 2147483520.0, 2147483648.0,
                               -2147483648.0, -2147483904.0])
def test_to_i32_matches_xla_convert(x):
    """The saturating cast against jnp.astype(int32) on the CPU: XLA maps
    +huge/+inf to INT32_MAX, -huge/-inf to INT32_MIN and NaN to 0."""
    import jax.numpy as jnp

    v = np.array([x], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    got = trm.to_i32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("state", ["adversarial", "frame"])
def test_roll_matches_jax_scan(state):
    from cpuvox_tpu.render import raymarch as jrm

    dda, alive, dirs = adversarial_state() if state == "adversarial" \
        else frame_state()
    assert_same(torch_roll(trm._roll_chunk, dda, alive, dirs),
                jax_roll(jrm._roll_chunk, dda, alive, dirs))


def test_roll_matches_jax_pallas_interpret():
    from cpuvox_tpu.render import raymarch as jrm

    dda, alive, dirs = adversarial_state()
    assert_same(torch_roll(trm._roll_chunk, dda, alive, dirs),
                jax_roll(jrm._roll_chunk_pallas, dda, alive, dirs,
                         interpret=True))


def test_dda_step_maps_negative_zero_like_jax():
    """``tmax + where(bump, tdelta, 0.0)`` turns a -0.0 on the axis that does
    not step into +0.0; ``where(bump, tmax + tdelta, tmax)`` would keep it.
    No rendered test scene reaches that state, so it is held here directly."""
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm

    dda = dict(pos=np.zeros((4, 2), np.int32),
               tmax=np.array([[-0.0, 1.0], [1.0, -0.0], [0.5, 0.25],
                              [-0.0, -0.0]], np.float32),
               tdelta=np.array([[1.0, 2.0]] * 4, np.float32),
               stp=np.ones((4, 2), np.int32),
               ids=np.zeros((4, 2), np.float32), lod=np.zeros(4, np.int32))
    got, got_far = trm._dda_step(
        trm.DDAState(**{k: torch.from_numpy(v) for k, v in dda.items()}), FAR)
    want, want_far = jrm._dda_step(
        jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()}),
        jnp.float32(FAR))
    for k in trm.DDAState._fields:
        np.testing.assert_array_equal(bits(getattr(got, k).numpy()),
                                      bits(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(got_far.numpy(), np.asarray(want_far))
    assert not np.signbit(got.tmax.numpy()).any()


def test_roll_wrapper_takes_plain_version_on_cpu():
    dda, alive, dirs = adversarial_state()
    before = roll_kernel.launches
    assert_same(torch_roll(roll_kernel.roll_chunk, dda, alive, dirs),
                torch_roll(roll_kernel.roll_chunk_ref, dda, alive, dirs))
    assert roll_kernel.launches == before  # the CPU path launches nothing


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["adversarial", "frame"])
def test_roll_kernel_matches_plain_on_cuda(cuda, state):
    dda, alive, dirs = adversarial_state() if state == "adversarial" \
        else frame_state()
    before = roll_kernel.launches
    got = torch_roll(roll_kernel.roll_chunk, dda, alive, dirs, cuda)
    torch.cuda.synchronize()
    assert roll_kernel.launches == before + 1
    want = torch_roll(roll_kernel.roll_chunk_ref, dda, alive, dirs, cuda)
    assert_same(got, want)  # NaN bits included: both pass the operand's NaN
