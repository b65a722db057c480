"""The port's phase-2 reprojection and raybuffer sample against the JAX
package; the previous design's CUDA sample kernel (off the frame path since
the fused phase-2 kernel, ``tests/test_torch_phase2.py``) against its plain
version on the card.
Bit-exact throughout.  JAX is imported inside the tests that compare with
it, so the ``cuda`` tests also run on the card's machine, which has no jax."""
import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.ops import reproject_kernel as trk
from cpuvox_tpu_torch.render import reproject as trp

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def random_sample_inputs(R=384, PL=128, NI=64, NJ=128, seed=7):
    rng = np.random.default_rng(seed)
    rb = rng.integers(-1, 1 << 20, size=(R, PL)).astype(np.int32)
    ri = rng.integers(-8, R + 8, size=(NI, NJ)).astype(np.int32)  # clamps
    mask = (rng.random((NI, NJ)) < 0.7).astype(np.int32)
    return rb, ri, mask


def test_sample_ref_matches_jax_pallas_interpret():
    import jax.numpy as jnp
    from cpuvox_tpu.ops import reproject_kernel as jrk

    rb, ri, mask = random_sample_inputs()
    want = np.asarray(jrk.sample_raybuffer(jnp.asarray(rb), jnp.asarray(ri),
                                           jnp.asarray(mask), interpret=True))
    got = trk.sample_raybuffer_ref(torch.from_numpy(rb), torch.from_numpy(ri),
                                   torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_wrapper_takes_plain_version_on_cpu():
    rb, ri, mask = (torch.from_numpy(x) for x in random_sample_inputs())
    before = trk.sample_launches
    assert torch.equal(trk.sample_raybuffer(rb, ri, mask),
                       trk.sample_raybuffer_ref(rb, ri, mask))
    assert trk.sample_launches == before


FRAMES = [
    ("random", (8, 10, 8), 25.0, 70.0, 0.0, (64, 48)),
    ("random_up", (8, 13, 8), -60.0, 200.0, 0.0, (64, 48)),
    ("roll180", (8, 10, 8), 25.0, 70.0, 180.0, (80, 45)),
    ("outside_world", (-6, 9, -6), 30.0, 45.0, 0.0, (48, 64)),
]


def frame(pos, pitch, yaw, roll, screen, seed=1):
    """A real frame's segment tables and a raybuffer of color indices."""
    w = scenes.random_world(n=300, seed=5)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
                    screen=screen)
    cam, _cd, vps, segs, ctxs = scenes.frame_setup(w, cam)
    n_td = segs[0].ray_count + segs[1].ray_count
    tables = trp.reproject_tables(segs, ctxs, vps, n_td)
    R = sum(s.ray_count for s in segs) + 5
    rng = np.random.default_rng(seed)
    rb = rng.integers(-1, 1 << 16, size=(R, max(screen))).astype(np.int32)
    return tables, rb


@pytest.mark.parametrize("name,pos,pitch,yaw,roll,screen", FRAMES)
def test_segment_ray_index_matches_jax(name, pos, pitch, yaw, roll, screen):
    import jax.numpy as jnp
    from cpuvox_tpu.render import reproject as jrp

    tables, _ = frame(pos, pitch, yaw, roll, screen)
    w, h = screen
    js, jr = jrp.segment_ray_index(*(jnp.asarray(tables[k]) for k in (
        "tri_a", "tri_b", "tri_c", "ray_count", "ray_base", "active")), w, h)
    ts, tr = trp.segment_ray_index(tables, w, h, "cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=name)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=name)


@pytest.mark.parametrize("name,pos,pitch,yaw,roll,screen", FRAMES)
def test_reproject_matches_jax(name, pos, pitch, yaw, roll, screen):
    import jax.numpy as jnp
    from cpuvox_tpu.render import reproject as jrp

    tables, rb = frame(pos, pitch, yaw, roll, screen)
    w, h = screen
    want = np.asarray(jrp.reproject(
        jnp.asarray(rb), *(jnp.asarray(tables[k]) for k in (
            "tri_a", "tri_b", "tri_c", "ray_count", "ray_base", "active")),
        width=w, height=h, skybox=jnp.int32(0)))
    got = trp.reproject(torch.from_numpy(rb), tables, w, h, skybox=0).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_reproject_tables_copy_matches_jax():
    """The port's numpy copy of reproject_tables gives JAX's tables."""
    from cpuvox_tpu.render import reproject as jrp

    w = scenes.random_world(n=300, seed=5)
    for pos, pitch, yaw, roll, screen in (f[1:] for f in FRAMES):
        cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw,
                        roll_deg=roll, screen=screen)
        cam, _cd, vps, segs, ctxs = scenes.frame_setup(w, cam)
        n_td = segs[0].ray_count + segs[1].ray_count
        mine = trp.reproject_tables(segs, ctxs, vps, n_td)
        ref = jrp.reproject_tables(segs, ctxs, vps, n_td)
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(384, 128, 64, 128), (1543, 1920, 1080, 1920),
                                   (1543, 1920, 1920, 1080), (5, 33, 7, 17)])
def test_sample_kernel_matches_plain_on_cuda(cuda, shape):
    R, PL, NI, NJ = shape
    rb, ri, mask = (torch.from_numpy(x).to(cuda) for x in
                    random_sample_inputs(R, PL, NI, NJ))
    before = trk.sample_launches
    got = trk.sample_raybuffer(rb, ri, mask)
    torch.cuda.synchronize()
    assert trk.sample_launches == before + 1
    assert torch.equal(got, trk.sample_raybuffer_ref(rb, ri, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("name,pos,pitch,yaw,roll,screen", FRAMES)
def test_reproject_kernel_matches_cpu_on_cuda(cuda, name, pos, pitch, yaw,
                                              roll, screen):
    tables, rb = frame(pos, pitch, yaw, roll, screen)
    w, h = screen
    want = trp.reproject(torch.from_numpy(rb), tables, w, h).numpy()
    got = trp.reproject(torch.from_numpy(rb).to(cuda), tables, w, h).cpu()
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
