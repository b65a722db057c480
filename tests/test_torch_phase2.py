"""The port's phase 2 (reprojection, color resolve, nearest upscale) against
the JAX package's, and the fused phase-2 kernel against its plain version
on the card.  Bit-exact throughout.  The JAX side is the Pallas frame's:
``reproject.reproject_pallas`` in interpret mode, ``raymarch.resolve_colors``
in index mode, then the upscale of ``cpuvox_tpu/render/frame.py:117-123``.
JAX is imported inside the tests that compare with it, so the ``cuda``
tests also run on the card's machine, which has no jax."""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu.world import rle
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import reproject_kernel as trk
from cpuvox_tpu_torch.render import reproject as trp
from cpuvox_tpu_torch.render.frame import Renderer

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

N_COLORS = 300
SKY_ARGB = int(np.uint32(0xFF191919).view(np.int32))

# tests/test_torch_reproject.py's cameras on its random world, and the same
# views with no active segment (every segment's ray count 0)
FRAMES = [
    ("random", (8, 10, 8), 25.0, 70.0, 0.0, (64, 48)),
    ("random_up", (8, 13, 8), -60.0, 200.0, 0.0, (64, 48)),
    ("roll180", (8, 10, 8), 25.0, 70.0, 180.0, (80, 45)),
    ("outside_world", (-6, 9, -6), 30.0, 45.0, 0.0, (48, 64)),
]
NO_SEGMENT = ("no_segment", (8, 10, 8), 25.0, 70.0, 0.0, (64, 48))
# (render size, output size): native, and render scales below 1
SIZES = [((64, 48), (64, 48)), ((40, 30), (64, 48)), ((33, 20), (100, 61))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def synthetic_tables(kind: str, w: int, h: int):
    """Segment tables no camera makes, for the index math's rare branches:
    "gaps", four small triangles, so most pixels lie in none and take the
    best score; "ties", segments 2 and 3 copies of 0 and 1, so equal scores
    and containers meet; "degenerate", a collinear segment 0 (a zero
    determinant: infinite weights and NaN scores) before three others."""
    f = np.float32
    vp = np.array([w * 0.4, h * 0.55], f)
    tri_a = np.tile(vp, (4, 1))
    tri_b = np.array([[w * 0.1, h * 0.1], [w * 0.9, h * 0.1],
                      [w * 0.9, h * 0.9], [w * 0.1, h * 0.9]], f)
    tri_c = np.roll(tri_b, -1, axis=0)
    if kind == "gaps":
        tri_b = vp + (tri_b - vp) * f(0.3)
        tri_c = vp + (tri_c - vp) * f(0.3)
    elif kind == "ties":
        tri_b[2:], tri_c[2:] = tri_b[:2], tri_c[:2]
    else:
        assert kind == "degenerate"
        tri_a[0], tri_b[0], tri_c[0] = 0.0, 1e7, 2e7
    ray_count = np.array([7, 11, 13, 5], np.int32)
    return dict(tri_a=tri_a, tri_b=tri_b.astype(f),
                tri_c=tri_c.astype(f), ray_count=ray_count,
                ray_base=np.concatenate([[0], np.cumsum(ray_count)[:-1]])
                .astype(np.int32), active=np.ones(4, bool))


def frame(pos, pitch, yaw, roll, screen, argb: bool, active=True, seed=1,
          synthetic=None):
    """A real frame's segment tables (or ``synthetic_tables``), a raybuffer
    (color indices with unwritten -1 texels, or ARGB words) and the color
    table."""
    if synthetic:
        tables = synthetic_tables(synthetic, *screen)
        R = 16 + int(tables["ray_count"].sum())
    else:
        w = scenes.random_world(n=300, seed=5)
        cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw,
                        roll_deg=roll, screen=screen)
        cam, _cd, vps, segs, ctxs = scenes.frame_setup(w, cam)
        if not active:
            segs = [dataclasses.replace(s, ray_count=0) for s in segs]
        n_td = segs[0].ray_count + segs[1].ray_count
        tables = trp.reproject_tables(segs, ctxs, vps, n_td)
        # at least the Pallas sample's 16-row window
        R = max(sum(s.ray_count for s in segs) + 5, 16)
    rng = np.random.default_rng(seed)
    if argb:
        rb = rng.integers(-2**31, 2**31, size=(R, max(screen)), dtype=np.int64)
    else:  # indices past the table too: the resolve clamps them
        rb = rng.integers(-1, N_COLORS + 8, size=(R, max(screen)))
    colors = rng.integers(0, 2**32, size=N_COLORS, dtype=np.uint64)
    return tables, rb.astype(np.int32), colors.astype(np.uint32)


def jax_phase2(tables, rb, colors, rw, rh, width, height, argb: bool):
    """The JAX Pallas frame's phase 2, as int32 bits."""
    import jax
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm
    from cpuvox_tpu.render import reproject as jrp

    sky = jnp.int32(SKY_ARGB if argb else 0)
    screen = jrp.reproject_pallas(
        jnp.asarray(rb), *(jnp.asarray(tables[k]) for k in (
            "tri_a", "tri_b", "tri_c", "ray_count", "ray_base", "active")),
        width=rw, height=rh, skybox=sky, interpret=True)
    if not argb:
        screen = jax.lax.bitcast_convert_type(
            jrm.resolve_colors(screen, jnp.asarray(colors)), jnp.int32)
    if (width, height) != (rw, rh):
        ys = (jnp.arange(height, dtype=jnp.int32) * rh) // height
        xs = (jnp.arange(width, dtype=jnp.int32) * rw) // width
        screen = screen[ys][:, xs]
    return np.asarray(screen)


def port_phase2(fn, tables, rb, colors, rw, rh, width, height, argb: bool,
                device="cpu"):
    t_colors = None if argb else torch.from_numpy(
        colors.view(np.int32)).to(device)
    return fn(torch.from_numpy(rb).to(device), tables, rw, rh, width, height,
              t_colors, SKY_ARGB if argb else 0).cpu().numpy()


CASES = ([(*f, "index", SIZES[0]) for f in FRAMES]
         + [(*FRAMES[2], "argb", SIZES[0]), (*FRAMES[3], "argb", SIZES[1])]
         + [(*FRAMES[0], "index", SIZES[1]), (*FRAMES[1], "index", SIZES[2])]
         + [(*NO_SEGMENT, mode, SIZES[1]) for mode in ("index", "argb")]
         + [(f"synthetic_{k}", None, 0.0, 0.0, 0.0, (64, 48), "index",
             SIZES[0]) for k in ("gaps", "ties", "degenerate")])


def case_frame(name, pos, pitch, yaw, roll, rw, rh, argb):
    return frame(pos, pitch, yaw, roll, (rw, rh), argb,
                 active=name != "no_segment",
                 synthetic=name[10:] if name.startswith("synthetic_") else None)


@pytest.mark.parametrize("name,pos,pitch,yaw,roll,screen,mode,sizes", CASES)
def test_phase2_ref_matches_jax_pallas_interpret(name, pos, pitch, yaw, roll,
                                                 screen, mode, sizes):
    (rw, rh), (width, height) = sizes
    if sizes == SIZES[0]:
        rw, rh = width, height = screen
    argb = mode == "argb"
    tables, rb, colors = case_frame(name, pos, pitch, yaw, roll, rw, rh, argb)
    args = (tables, rb, colors, rw, rh, width, height, argb)
    got = port_phase2(trk.reproject_screen_ref, *args)
    want = jax_phase2(*args)
    assert got.shape == (height, width)
    np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode} {sizes}")
    if name == "no_segment":
        sky = SKY_ARGB if argb else int(colors.view(np.int32)[0])
        assert (got == sky).all()


def test_phase2_wrapper_takes_plain_version_on_cpu():
    tables, rb, colors = frame(*FRAMES[0][1:], argb=False)
    before = (trk.launches, trk.sample_launches)
    args = (tables, rb, colors, 40, 30, 64, 48, False)
    np.testing.assert_array_equal(
        port_phase2(trk.reproject_screen, *args),
        port_phase2(trk.reproject_screen_ref, *args))
    assert (trk.launches, trk.sample_launches) == before


def test_segment_tables_struct_holds_the_tables_words():
    """The kernel's by-value tables carry reproject_tables' f32 words as
    they are, and the ints and flags as int32."""
    tables, _rb, _c = frame(*FRAMES[2][1:], argb=False)
    st = trk.segment_tables(tables)
    for k, (arr, col) in {"ax": ("tri_a", 0), "ay": ("tri_a", 1),
                          "bx": ("tri_b", 0), "by": ("tri_b", 1),
                          "cx": ("tri_c", 0), "cy": ("tri_c", 1)}.items():
        np.testing.assert_array_equal(
            np.array(getattr(st, k), np.float32).view(np.int32),
            tables[arr][:, col].view(np.int32), err_msg=k)
    for k in ("ray_count", "ray_base", "active"):
        np.testing.assert_array_equal(np.array(getattr(st, k)),
                                      tables[k].astype(np.int32), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name,pos,pitch,yaw,roll,screen,mode,sizes", CASES + [
    ("random_1080p", (8, 10, 8), 25.0, 70.0, 0.0, (1920, 1080), "index",
     ((1920, 1080), (1920, 1080))),
    ("outside_1080p", (-6, 9, -6), 30.0, 45.0, 0.0, (1920, 1080), "argb",
     ((1920, 1080), (1920, 1080))),
    ("random_upscale_1080p", (8, 13, 8), -60.0, 200.0, 0.0, (960, 540),
     "index", ((960, 540), (1920, 1080)))])
def test_phase2_kernel_matches_plain_on_cuda(cuda, name, pos, pitch, yaw,
                                             roll, screen, mode, sizes):
    (rw, rh), (width, height) = sizes
    if sizes == SIZES[0]:
        rw, rh = width, height = screen
    argb = mode == "argb"
    tables, rb, colors = case_frame(name, pos, pitch, yaw, roll, rw, rh, argb)
    args = (tables, rb, colors, rw, rh, width, height, argb, cuda)
    before = trk.launches
    got = port_phase2(trk.reproject_screen, *args)
    torch.cuda.synchronize()
    assert trk.launches == before + 1
    want = port_phase2(trk.reproject_screen_ref, *args)
    np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode} {sizes}")


@pytest.mark.cuda
@pytest.mark.parametrize("argb,render_scale", [(False, 1.0), (True, 1.0),
                                               (False, 0.6)])
def test_renderer_phase2_is_one_launch_on_cuda(cuda, argb, render_scale,
                                               monkeypatch):
    """A frame's phase 2 launches the fused kernel once, and neither the
    previous sample kernel nor the torch index math."""
    from cpuvox_tpu_torch.render import reproject

    calls = []
    index_math = reproject.segment_ray_index
    monkeypatch.setattr(reproject, "segment_ray_index",
                        lambda *a, **kw: calls.append(1) or index_math(*a, **kw))
    lods = rle.build_lod_chain(scenes.flat_floor_world(dims=(64, 16, 64)), 6)
    cfg = RenderConfig(width=64, height=48, chunk_steps=8, max_march_chunks=64,
                       argb_records=argb, render_scale=render_scale)
    r = Renderer.create(lods, cfg, device=cuda)
    assert r.argb_on == argb
    cam = cm.Camera(position=(32.5, 6, 4), pitch_deg=5.0, yaw_deg=10.0,
                    screen=(64, 48))
    f = r.frame_setup(cam)
    rb = r.march(f)
    before = (trk.launches, trk.sample_launches)
    screen = r.phase2(f, rb)
    torch.cuda.synchronize()
    assert (trk.launches, trk.sample_launches) == (before[0] + 1, before[1])
    assert not calls
    plain = dataclasses.replace(r, config=dataclasses.replace(
        cfg, backend="xla"))
    assert torch.equal(screen, plain.phase2(f, rb))
    assert calls  # the plain version runs the torch index math
