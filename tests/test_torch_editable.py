"""The port's editable worlds (``world/dynamic.py``: ``editable_from_lod0``,
``set_voxel_column``, ``editable_chain_snapshot``) against the JAX package
on ``tests/test_editable.py``'s worlds and edits: the records, the colors
and the chain's arrays bit for bit; against the static builder
(``world/rle.py``) voxel for voxel at every chain level; and their frames
against the port's static Renderer on the same voxels."""
import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.world import dynamic as td
from cpuvox_tpu_torch.world import rle

from test_torch_frame import cuda  # noqa: F401

# test_dynamic.py's helpers are imported inside the tests that use them: it
# imports jax, which the card's machine lacks

torch.set_num_threads(1)

DIMS = (16, 16, 16)
EDIT_XZ = (8, 8)


def edit_column():
    """test_editable.py's edit: the floor voxel, a floating block and a lone
    voxel above a gap."""
    occ = np.zeros(DIMS[1], bool)
    occ[[0, 3, 4, 5, 8]] = True
    argb = np.zeros(DIMS[1], np.uint32)
    argb[occ] = np.asarray(
        [0xFF11AA33, 0xFFCC2222, 0xFFCC3322, 0xFFCC4422, 0xFF2233EE],
        np.uint32)
    return occ, argb


# (name, world, editable_from_lod0 keywords), as test_editable.py uses
# them: the random world sizes its own capacities (int32 runs) and takes no
# edit (its columns hold fewer colors than the edit's five); the floor's
# max_runs 6 packs 16-bit runs and takes the edit
WORLDS = [("random", lambda: scenes.random_world(dims=DIMS, n=250, seed=3),
           {}),
          ("floor", lambda: scenes.flat_floor_world(dims=DIMS),
           dict(max_runs=6, col_colors=8))]


def edits(kw) -> bool:
    return bool(kw)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def assert_words(got, want, what):
    got, want = bits(got), bits(want)
    assert got.shape == want.shape, what
    diff = got != want
    assert not diff.any(), (f"{what}: {int(diff.sum())} words differ, first "
                            f"{np.argwhere(diff)[:5].tolist()}")


def edited_soup(w, edited=True):
    """The voxels of ``w`` with column EDIT_XZ replaced by the edit."""
    if not edited:
        return w
    occ, argb = edit_column()
    ci = EDIT_XZ[0] * DIMS[2] + EDIT_XZ[1]
    cols0, ys0, argb0 = td._expand_lod0(w)
    keep = cols0 != ci
    ys_new = np.nonzero(occ)[0]
    xz = np.concatenate([cols0[keep], np.full(ys_new.size, ci)])
    ys = np.concatenate([ys0[keep], ys_new])
    cc = np.concatenate([argb0[keep], argb[occ]])
    rgb = (((cc >> 16) & 0xFF).astype(np.uint8),
           ((cc >> 8) & 0xFF).astype(np.uint8), (cc & 0xFF).astype(np.uint8))
    return rle.build_lod_from_voxels(DIMS, 0, xz, ys, rgb)


@pytest.fixture(scope="module", params=WORLDS, ids=[w[0] for w in WORLDS])
def port(request):
    """The world, its editable_from_lod0 keywords, whether it takes the
    edit, and the port's (spec, EditableWorld) before and after the edit,
    on the CPU."""
    _name, make, kw = request.param
    w = make()
    occ, argb = edit_column()
    tspec, tew = td.editable_from_lod0(w, **kw, device="cpu")
    tew2 = tew
    if edits(kw):
        tew2 = td.set_voxel_column(tspec, tew, *EDIT_XZ,
                                   torch.from_numpy(occ),
                                   torch.from_numpy(argb.view(np.int32)))
    return w, kw, (tspec, tew, tew2)


@pytest.fixture(scope="module")
def both(port):
    """``port``'s world and whether it takes the edit, JAX's (spec,
    EditableWorld) before and after the edit, and the port's."""
    import jax.numpy as jnp
    from cpuvox_tpu.world import dynamic as jd

    w, kw, tworld = port
    occ, argb = edit_column()
    jspec, jew = jd.editable_from_lod0(w, **kw)
    jew2 = jew
    if edits(kw):
        jew2 = jd.set_voxel_column(jspec, jew, jnp.int32(EDIT_XZ[0]),
                                   jnp.int32(EDIT_XZ[1]), jnp.asarray(occ),
                                   jnp.asarray(argb))
    return w, edits(kw), (jspec, jew, jew2), tworld


def test_editable_records_match_jax(both):
    _w, _e, (jspec, jew, jew2), (tspec, tew, tew2) = both
    assert tuple(tspec) == tuple(jspec)
    for tag, t, j in (("built", tew, jew), ("edited", tew2, jew2)):
        for k in ("rec_fwd", "rec_rev", "colors"):
            assert_words(getattr(t, k).numpy(), getattr(j, k), f"{tag} {k}")


def test_chain_snapshot_matches_jax_and_static_chain(both):
    """Before the edit and, where the world takes it, after it."""
    from cpuvox_tpu.world import dynamic as jd
    from test_dynamic import _dense_from_surface_level, _dense_from_worldlod

    w, takes_edit, (jspec, jew, jew2), (tspec, tew, tew2) = both
    for edited in (False, True)[:1 + takes_edit]:
        wa, K = td.editable_chain_snapshot(tspec, tew2 if edited else tew, 3)
        jwa, jK = jd.editable_chain_snapshot(jspec, jew2 if edited else jew,
                                             3)
        assert K == jK and wa.max_runs == K
        arrays = {}
        for k in ("col_base", "grid_z", "col_rec", "runs", "runs_rev",
                  "colors"):
            arrays[k] = getattr(wa, k).numpy()
            assert_words(arrays[k], getattr(jwa, k), f"edited {edited} {k}")
        # voxel for voxel the static builder's chain of the same content
        chain = rle.build_lod_chain(edited_soup(w, edited), lod_levels=3)
        arrays["colors"] = arrays["colors"].view(np.uint32)
        for lvl in range(3):
            occ_s, col_s = _dense_from_worldlod(chain[lvl])
            occ_d, col_d = _dense_from_surface_level(type("WA", (), arrays),
                                                     DIMS, lvl)
            np.testing.assert_array_equal(occ_s, occ_d, err_msg=f"lvl {lvl}")
            np.testing.assert_array_equal(col_s[occ_s], col_d[occ_d],
                                          err_msg=f"lvl {lvl}")


CFG = dict(width=64, height=48, backend="xla", chunk_steps=8,
           max_march_chunks=32)


def static_lod0_renderer(w):
    r = Renderer.create([w], RenderConfig(**CFG, lod_levels=1), device="cpu")
    far = float(2 * max(DIMS))
    r.lod_distances = np.full(1, 4 * far, np.float32)
    r.far_clip = far
    return r


def test_edited_frames_match_static_worlds(port):
    """The editable Renderer (LOD0 only) renders the edited world as the
    static Renderer renders the rebuilt one, and the chain Renderer as the
    static chain, LOD distances pinned so LOD 1 and 2 draw."""
    w, kw, (tspec, tew, tew2) = port
    edited = edits(kw)
    cam = cm.Camera(position=(8, 6, 2), pitch_deg=20.0, yaw_deg=0.0,
                    screen=(64, 48))
    got = td.editable_renderer(tspec, tew2, RenderConfig(**CFG, lod_levels=1))
    assert not got.occupancy_on
    np.testing.assert_array_equal(
        got.render(cam), static_lod0_renderer(edited_soup(w, edited)).render(
            cam))

    cfg = RenderConfig(**CFG, lod_levels=3)
    chain = Renderer.create(rle.build_lod_chain(edited_soup(w, edited), 3),
                            cfg, device="cpu")
    snap = td.editable_chain_renderer(tspec, tew2, cfg, lod_levels=3)
    for r in (chain, snap):
        r.lod_distances = np.array([3.0, 6.0, 1e6], np.float32)
        r.far_clip = float(3 * max(DIMS))
    for c in (cam, cm.Camera(position=(8, 4, 8), pitch_deg=-20.0,
                             yaw_deg=190.0, screen=(64, 48))):
        screen = snap.render(c)
        assert not (screen == np.uint32(0xFFFF1493)).any()
        np.testing.assert_array_equal(screen, chain.render(c))


@pytest.mark.cuda
def test_editable_build_edit_and_chain_on_cuda_match_cpu(cuda, port):
    """The build, the edit and the chain snapshot on the card equal the CPU
    build word for word, and the editable frames through the kernels equal
    the plain path."""
    w, _kw, (tspec, tew, tew2) = port
    edited = edits(_kw)
    kw = dict(max_runs=tspec.max_runs, col_colors=tspec.col_colors)
    occ, argb = edit_column()
    spec, ew = td.editable_from_lod0(w, **kw, device=cuda)
    ew2 = ew
    if edited:
        ew2 = td.set_voxel_column(
            spec, ew, *EDIT_XZ, torch.from_numpy(occ).to(cuda),
            torch.from_numpy(argb.view(np.int32)).to(cuda))
    for k in ("rec_fwd", "rec_rev", "colors"):
        assert_words(getattr(ew2, k).cpu().numpy(), getattr(tew2, k).numpy(),
                     k)
    wa, K = td.editable_chain_snapshot(spec, ew2, 3)
    cwa, cK = td.editable_chain_snapshot(tspec, tew2, 3)
    assert K == cK
    for k in ("col_rec", "runs", "runs_rev", "colors"):
        assert_words(getattr(wa, k).cpu().numpy(), getattr(cwa, k).numpy(), k)
    cam = cm.Camera(position=(8, 6, 2), pitch_deg=20.0, yaw_deg=0.0,
                    screen=(64, 48))
    kcfg = RenderConfig(**{**CFG, "backend": "pallas"}, lod_levels=3)
    for make in (td.editable_renderer, td.editable_chain_renderer):
        got = make(spec, ew2, kcfg).render(cam)
        want = make(tspec, tew2, RenderConfig(**CFG, lod_levels=3)).render(cam)
        np.testing.assert_array_equal(got, want)
