"""Three places where a plain torch twin can drift from the reference by an
ulp, each held here against JAX bit for bit:

- the side span's ``round`` is half to even (``floor(x + 0.5)`` is not);
- the screen-x lerp is ``a + (b - a) * t`` (``torch.lerp`` is not: at
  ``t`` >= 0.5 it computes ``b - (b - a) * (1 - t)``);
- ``eb / world_max_y`` is a divide (a multiply by ``1 / world_max_y`` is
  not, unless the height is a power of two).

Rendered test worlds seldom meet these: their heights are powers of two and
their projected span ends are rarely exact .5 ties.  So one case feeds the
rasterizer's step rays whose numbers are small dyadic values (exact ties)
and far-off column bases (a lerp that does not land on its end point) in a
world 48 high; the other renders a frame of a 48-high terrain at a camera
where the divide and the multiply part, held against the oracle.
"""
import numpy as np
import pytest
import torch

from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as trm

from test_torch_frame import config

torch.set_num_threads(1)

P = 16
WORLD_MAX_Y = 48.0  # not a power of two: 1 / 48 is inexact


def crafted_step(R=4096, seed=0):
    """One cell for R rays, from a seed: (raster state, planes, cell, the
    rays' camera heights), numpy.  The numbers are small dyadic values, so
    projected coordinates are exact halves and quarters (ties for the
    round); a quarter of the rays has its column base 3.3e7 away, where
    ``base_max - base_min`` rounds and the lerp at t = 1 misses base_max."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def dyadic(shape, lo, hi, den=4):
        return (rng.integers(lo * den, hi * den, size=shape) / den).astype(f)

    raybuf = np.where(rng.random((R, P)) < 0.3,
                      rng.integers(0, 50, size=(R, P)), -1).astype(np.int32)
    a, b = rng.integers(0, P, size=R), rng.integers(0, P, size=R)
    nfp_min = np.minimum(a, b).astype(np.int32)
    nfp_max = np.maximum(a, b).astype(np.int32)
    rs = dict(raybuf=raybuf, nfp_min=nfp_min, nfp_max=nfp_max,
              fb_min=(nfp_min - f(0.501)).astype(f),
              fb_max=(nfp_max + f(0.501)).astype(f),
              f_active=rng.random(R) < 0.3,
              fdir_min=dyadic(R, -2, 1), fdir_max=dyadic(R, -1, 2),
              alive=np.ones(R, bool))
    pb, pt = dyadic((R, 3), -8, 24), dyadic((R, 3), -8, 24)
    pd = dyadic((R, 3), -2, 2, 8)
    for p in (pb, pt):  # in front of the camera, positive w
        p[:, 1] = np.abs(p[:, 1]) + f(0.25)
        p[:, 2] = np.abs(p[:, 2]) + f(1.0)
    far = rng.random(R) < 0.25
    pb[far, 0] += rng.choice([f(-3.3e7), f(3.3e7)], size=int(far.sum()))
    planes = dict(plane_bottom=pb, plane_top=pt, plane_dir=pd)
    ids0 = dyadic(R, 0, 6)
    ids = np.stack([ids0, ids0 + dyadic(R, 0, 2) + f(0.25)], 1).astype(f)
    lens = rng.integers(1, 17, size=(R, 3))
    runs = np.where(rng.random((R, 3)) < 0.4, (-1 << 16) | lens,
                    lens).astype(np.int32)
    cell = dict(ids=ids, lod=np.zeros(R, np.int32), valid=np.ones(R, bool),
                n_runs=rng.integers(1, 4, size=R).astype(np.int32),
                color_off=rng.integers(1, 40, size=R).astype(np.int32),
                cmin=rng.integers(0, 24, size=R).astype(np.int32),
                cmax=rng.integers(24, 48, size=R).astype(np.int32),
                runs=runs)
    return rs, planes, cell, dyadic(R, 0, 48, 2)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("direction", [1, -1])
def test_rasterize_step_meets_ties_like_jax(direction):
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm

    rs, planes, cell, cam_y = crafted_step()
    R = cam_y.shape[0]
    t = torch.from_numpy
    got = trm._rasterize_step(
        trm.RasterState(**{k: t(v) for k, v in rs.items()}),
        tuple(t(cell[k]) for k in ("ids", "lod", "valid", "n_runs",
                                   "color_off", "cmin", "cmax", "runs"))
        + (None,),
        trm.RayStatic(dirs=torch.zeros(R, 2), orig_min=t(rs["nfp_min"]),
                      orig_max=t(rs["nfp_max"]),
                      **{k: t(v) for k, v in planes.items()}),
        trm.raster_consts(WORLD_MAX_Y, cam_y), direction, 3)

    j = jnp.asarray
    want = jrm._rasterize_step(
        jrm.RasterState(**{k: j(v) for k, v in rs.items()}),
        (j(np.zeros((R, 2), np.int32)), j(cell["ids"]), j(cell["lod"]),
         j(cell["valid"]), j(cell["n_runs"]), j(np.zeros(R, np.int32)),
         j(cell["color_off"]), j(cell["cmin"]), j(cell["cmax"]),
         j(cell["runs"])),
        None,
        jrm.RayStatic(dirs=j(np.zeros((R, 2), np.float32)),
                      orig_min=j(rs["nfp_min"]), orig_max=j(rs["nfp_max"]),
                      **{k: j(v) for k, v in planes.items()}),
        {"world_max_y": jnp.float32(WORLD_MAX_Y), "cam_y": j(cam_y),
         "cam_y_norm": j(cam_y) / jnp.float32(WORLD_MAX_Y),
         "solid_min_y": None, "solid_max_y": None},
        direction, 3)
    for k in trm.RasterState._fields:
        a, b = _bits(getattr(got, k).numpy()), _bits(getattr(want, k))
        diff = a != b
        assert not diff.any(), (
            f"{k}: {int(diff.sum())} elements differ, first "
            f"{np.argwhere(diff)[:5].tolist()}")


def test_frame_of_a_48_high_world_matches_oracle():
    """A frame of a 48-high terrain, held against the numpy oracle: the
    camera sees a span end where ``eb / 48`` and ``eb * (1 / 48)`` part.
    Not against the JAX Renderer: its XLA twin, compiled on the CPU with
    the world height as a constant, takes the multiply (one texel of this
    frame, the one the reciprocal twin gets too), while the oracle divides
    as the reference does."""
    from cpuvox_tpu.models.procedural import heightmap_world
    from cpuvox_tpu.render import oracle, segments as sg
    from cpuvox_tpu_torch.render.frame import Renderer

    lods = heightmap_world(dims=(64, 48, 64), seed=3, shell_depth=6,
                           lod_levels=4)
    cam = cm.Camera(position=(5.0, 23.0, 5.0), pitch_deg=-10.0, yaw_deg=30.0,
                    screen=(64, 48))
    r = Renderer.create(lods, config(lod_levels=4), device="cpu")
    screen, (td, lr, *_rest) = r.render(cam, return_raybuffers=True)

    c = cm.limit_rotation_horizon(cm.Camera(
        position=cam.position, pitch_deg=cam.pitch_deg, yaw_deg=cam.yaw_deg,
        screen=cam.screen, fov_y_deg=r.config.fov_y_deg,
        near=r.config.near_clip))
    cd = cm.make_camera_data(c, r.lod_distances, r.far_clip)
    vps = cm.vanishing_point_screen(c, cm.vanishing_point_world(c))
    segs = sg.build_segments(c, vps)
    ctxs = sg.build_segment_contexts(c, segs, vps)
    otd, olr = oracle.render_raybuffers_oracle(lods, c, cd, segs, ctxs)
    want = oracle.reproject_oracle(c, segs, ctxs, vps, otd, olr)
    for what, a, b in (("td", td, otd[:, :td.shape[1]]),
                       ("lr", lr, olr[:, :lr.shape[1]]),
                       ("screen", screen, want)):
        assert a.shape == b.shape, what
        diff = a != b
        assert not diff.any(), (
            f"{what}: {int(diff.sum())} texels differ from the oracle, "
            f"first {np.argwhere(diff)[:5].tolist()}")
