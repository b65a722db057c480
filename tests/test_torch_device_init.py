"""The port's device ray init (``render/device_init.py``, plain PyTorch)
against its host init (``render/ray_init.py``, numpy) and against JAX
``device_init.init_rays_device`` on the CPU: every field of ``RayStatic``
and ``DDAState`` and ``alive``, every lane, padded and dead lanes included,
f32 compared as bits (tolerance 0).

Cameras: ``perf/check_device_init.py:41-46``'s (four along the benchmark
path, one outside the world, one looking up) at a small screen, plus pitch
0 and one whose rays all miss the world.  Also a frame with ``host_init``
False against True, and on the card (``cuda``) the same equality of every
field.  JAX is imported only inside the test that compares with it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.bench import path as bench_path
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import device_init, ray_init
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render import segments as sg
from cpuvox_tpu_torch.render.frame import Renderer

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

DIMS = (128, 32, 128)
WH = (96, 64)
R = ((3 * (WH[0] + WH[1]) + 127) // 128) * 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def cameras(dims=DIMS, wh=WH):
    cams = {f"path{t}": bench_path.benchmark_camera(
        t * bench_path.BENCH_CLIP_LENGTH, dims, wh)
        for t in (0.1, 0.35, 0.9, 0.95)}
    cams["outside"] = cm.Camera(position=(-50.0, dims[1] * 0.6, -80.0),
                                pitch_deg=10.0, yaw_deg=30.0, screen=wh)
    cams["up"] = cm.Camera(position=(dims[0] / 2, dims[1] * 0.8, dims[2] / 2),
                           pitch_deg=-25.0, yaw_deg=200.0, screen=wh)
    cams["pitch0"] = cm.Camera(position=(8.5, 5.0, 2.0), pitch_deg=0.0,
                               yaw_deg=0.0, screen=wh)
    # far outside and looking away: no ray enters the world
    cams["all_miss"] = cm.Camera(position=(-500.0, 20.0, -800.0),
                                 pitch_deg=10.0, yaw_deg=210.0, screen=wh)
    # outside along one axis only, looking along the other: rays that run
    # parallel to the near face
    cams["outside_x"] = cm.Camera(position=(-5.0, 10.0, 20.0), pitch_deg=10.0,
                                  yaw_deg=0.0, screen=wh)
    return cams


CAMERA_NAMES = sorted(cameras())


def frame_geometry(cam, dims=DIMS):
    cam = cm.limit_rotation_horizon(cam)
    lod_d, far = cm.setup_lods(cam, max(dims), 6, 1.0)
    cam_data = cm.make_camera_data(cam, lod_d, far)
    vps = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vps)
    ctxs = sg.build_segment_contexts(cam, segs, vps)
    return cam_data, segs, ctxs


def fields(static, dda, alive):
    out = {f"static.{k}": v for k, v in zip(trm.RayStatic._fields, static)}
    out.update({f"dda.{k}": v for k, v in zip(trm.DDAState._fields, dda)})
    out["alive"] = alive
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def assert_same_init(got, want, what):
    bad = []
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, k, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        n = int((a != b).sum())
        if n:
            bad.append(f"{k}: {n} lanes, first {np.argwhere(a != b)[:3].tolist()}")
    assert not bad, f"{what}: " + "; ".join(bad)


def host_and_device(cam, device, dims=DIMS, r=R):
    cam_data, segs, ctxs = frame_geometry(cam, dims)
    host = fields(*ray_init.init_rays(cam_data, segs, ctxs, dims,
                                      fixed_size=r, device="cpu")[:3])
    fp = device_init.build_frame_params(cam_data, segs, ctxs)
    dev = fields(*device_init.init_rays_device(fp, dims, r, device))
    return host, dev, fp


@pytest.mark.parametrize("name", CAMERA_NAMES)
def test_device_init_matches_host_init_and_jax(name):
    import jax
    import jax.numpy as jnp
    from cpuvox_tpu.render import device_init as jdi

    host, dev, fp = host_and_device(cameras()[name], "cpu")
    assert_same_init(dev, host, f"{name}: device against host init")
    jfp = jdi.FrameParams(*(jnp.asarray(x) for x in fp))
    js, jd, ja = jax.jit(jdi.init_rays_device, static_argnums=(1, 2))(
        jfp, DIMS, R)
    assert_same_init(dev, fields(js, jd, ja),
                     f"{name}: device init against JAX init_rays_device")
    n_alive = int(host["alive"].sum())
    assert (n_alive == 0) == (name == "all_miss"), n_alive
    assert host["alive"].shape == (R,) and not host["alive"][-1]


def test_outside_cameras_fast_forward_lods():
    """The cameras outside the world start some rays above LOD 0, so the
    host ``if`` and the fast-forward loop did run."""
    host, dev, _ = host_and_device(cameras()["outside"], "cpu")
    assert (dev["dda.lod"] > 0).any() and (host["dda.lod"] > 0).any()
    assert (dev["dda.lod"][~dev["alive"]] == 0).any()


def test_to_i32_host_matches_numpy_cast():
    x = np.array([1e20, -1e20, np.inf, -np.inf, np.nan, 0.0, -0.0, 2.5, -2.5,
                  2147483520.0, 2147483648.0, -2147483648.0, -2147483904.0],
                 np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(np.int32)
    got = device_init._to_i32_host(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene,pos,pitch,yaw", [
    ("random", (8, 10, 8), 25.0, 70.0), ("random", (-6, 9, -6), 30.0, 45.0),
    ("random", (8, 13, 8), -60.0, 200.0), ("tower", (8.5, 5, 2), 0.0, 0.0)])
def test_frame_with_device_init_equals_host_init(scene, pos, pitch, yaw):
    lods = ([scenes.random_world(n=300, seed=5)] * 6 if scene == "random"
            else [scenes.tower_world(x=8, z=12, height=10)] * 6)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw,
                    screen=(64, 48))
    cfg = RenderConfig(width=64, height=48, chunk_steps=8, max_march_chunks=64,
                       host_init=False)
    r_dev = Renderer.create(lods, cfg, device="cpu")
    r_host = dataclasses.replace(
        r_dev, config=dataclasses.replace(cfg, host_init=True),
        lod_distances=None)
    a, (atd, alr, *_) = r_dev.render(cam, return_raybuffers=True)
    b, (btd, blr, *_) = r_host.render(cam, return_raybuffers=True)
    assert np.array_equal(a, b) and np.array_equal(atd, btd)
    assert np.array_equal(alr, blr)
    assert (a != a[0, 0]).any(), "nothing was drawn"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CAMERA_NAMES)
def test_device_init_on_cuda_matches_host_init(cuda, name):
    """On the card at 1080p, at terrain2048's dims: the card's ``/`` and
    ``sqrt`` give numpy's bits in every lane."""
    dims, wh = (2048, 256, 2048), (1920, 1080)
    r = ((3 * (wh[0] + wh[1]) + 127) // 128) * 128
    host, dev, _ = host_and_device(cameras(dims, wh)[name], cuda, dims, r)
    assert_same_init(dev, host, f"{name}: device init on the card")
