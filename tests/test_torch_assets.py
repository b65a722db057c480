"""The port's asset pipeline against the JAX package's: the torch voxelizer
(``voxelize_mesh_device``) and LOD chain (``build_lod_chain_device``) on the
CPU against the JAX package's numpy ``voxelize_mesh`` and
``rle.build_lod_chain``, exact (tolerance 0: the same voxels in the same
order, every field of every LOD); the conversion through a .world file; and
once the JAX package's own device path, in an x64 child process.  Inputs are
made from seeds with numpy.  The ``cuda`` cases hold the same on the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpuvox_tpu.assets import voxelizer as jv
from cpuvox_tpu.assets.mesh import Material, rescale
from cpuvox_tpu.assets.obj import import_obj
from cpuvox_tpu.world import rle
from cpuvox_tpu_torch.assets import voxelizer as tv
from cpuvox_tpu_torch.bench.meshes import write_town_obj
from cpuvox_tpu_torch.world import rle_device

from test_assets import make_mesh

torch.set_num_threads(1)

F = np.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("col_offset", "col_runs", "col_color_offset", "col_min", "col_max",
          "runs", "colors")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def town(tmp_path_factory):
    """The procedural town's .obj (bench/meshes.py, seed 0)."""
    path = str(tmp_path_factory.mktemp("town") / "town.obj")
    write_town_obj(path, seed=0)
    return path


def random_mesh(seed, n_tris=20, lo=2.0, hi=29.0):
    """``tests/test_assets.py``'s random meshes."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(lo, hi, size=(n_tris, 3, 3)).astype(F)
    cols = rng.integers(0, 256, size=(n_tris * 3, 4)).astype(np.uint8)
    cols[:, 3] = 255
    return make_mesh(tris, cols)


def assert_soup_equal(got, want):
    """The same voxels in the same order: xz, y and the three channels."""
    for what, a, b in zip(("xz", "y", "r", "g", "b"), (*got[:2], *got[2]),
                          (*want[:2], *want[2])):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        diff = a != b
        assert not diff.any(), (f"{what}: {int(diff.sum())} of {a.size} "
                                f"differ, first at {np.argwhere(diff)[:3]}")


def assert_chain_equal(got, want):
    assert len(got) == len(want)
    for L, (g, w) in enumerate(zip(got, want)):
        assert (g.dims, g.lod) == (tuple(w.dims), w.lod), L
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (L, f)


def check_voxelizer(mesh, dims, chunk=8_000_000, device="cpu"):
    want = jv.voxelize_mesh(mesh, dims)
    got = tv.voxelize_mesh_device(mesh, dims, chunk_candidates=chunk,
                                  device=device)
    assert_soup_equal(got, want)
    return want


def test_town_parses_natively_as_in_python(town):
    """The town's numbers are written so that the native parser (voxio) and
    the python one read the same floats and color bytes."""
    from cpuvox_tpu_torch.assets import native
    from cpuvox_tpu_torch.assets.obj import _import_obj_python
    from cpuvox_tpu_torch.assets.obj import import_obj as port_import

    b = _import_obj_python(town)
    assert b.triangle_count == 14_600 and not b.materials
    assert len(np.unique(b.colors, axis=0)) > 100
    if native.available():
        a = port_import(town)
        for f in ("positions", "colors", "uvs", "material_index"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


# ------------------------------------------------------------ voxelizer


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voxelizer_random_meshes(seed):
    want = check_voxelizer(random_mesh(seed), (32, 32, 32))
    assert want[0].shape[0] > 1000


def test_voxelizer_non_cubic_dims():
    mesh = random_mesh(3, n_tris=40, lo=0.0, hi=31.0)
    mesh.positions[:, 1] *= F(0.4)
    mesh.positions[:, 2] *= F(2.0)
    check_voxelizer(mesh, (32, 16, 64))


def test_voxelizer_town(town):
    mesh = import_obj(town)
    dims = rescale(mesh, 96)
    assert dims[1] < dims[0]
    want = check_voxelizer(mesh, dims)
    assert want[0].shape[0] > 20_000


def test_voxelizer_windows(town):
    """Candidate windows far smaller than a triangle's candidates: every
    window boundary falls inside a triangle, in all three axis groups."""
    mesh = import_obj(town)
    dims = rescale(mesh, 48)
    tab = tv.triangle_tables(mesh, dims, "cpu")
    assert set(tab["dax"].tolist()) == {0, 1, 2}
    assert tab["total"] > 50 * 997
    check_voxelizer(mesh, dims, chunk=997)


def grazing_mesh(seed):
    """Degenerate triangles (a repeated vertex, collinear vertices, a point)
    among triangles in the planes of voxel faces (plane distance exactly 0.5
    at two layers) and through voxel centers, on a half-voxel grid."""
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(60):
        base = rng.integers(1, 20, 3) + rng.integers(0, 2, 3) * 0.5
        size = rng.integers(1, 9, 2).astype(F)
        axis = rng.integers(0, 3)
        u, v = (axis + 1) % 3, (axis + 2) % 3
        a = base.astype(F)
        b, c = a.copy(), a.copy()
        b[u] += size[0]
        c[v] += size[1]
        if rng.random() < 0.5:
            c[u] += size[0]
        tris.append([a, b, c])
    p = np.array([5.5, 6.0, 7.5], F)
    tris += [[p, p, p], [p, p + 1, p + 1], [p, p + 1, p + 2],
             [p, p + (2, 0, 0), p + (4, 0, 0)]]
    tris = np.asarray(tris, F)
    cols = rng.integers(0, 256, size=(tris.shape[0] * 3, 4)).astype(np.uint8)
    return make_mesh(tris, cols)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelizer_degenerate_and_grazing(seed):
    check_voxelizer(grazing_mesh(seed), (32, 32, 32))


def right_triangles(seed, n=400):
    """Right triangles with legs of 2^k voxels in an axis plane through voxel
    centers, vertices on voxel centers: undilated, their edges pass through
    voxel centers, so barycentric coordinates of exactly 0, 1/2 and 1 occur
    (keep or drop decided in the last bit of the reciprocal) and the color
    blends land on exact halves (round half to even)."""
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        axis = rng.integers(0, 3)
        u, v = (axis + 1) % 3, (axis + 2) % 3
        a = rng.integers(0, 20, 3) + 0.5
        legs = 2.0 ** rng.integers(1, 4, 2) * rng.choice([-1, 1], 2)
        b, c = a.copy(), a.copy()
        b[u] += legs[0]
        c[v] += legs[1]
        if rng.random() < 0.3:  # a slanted hypotenuse plane
            c[axis] += legs[1] / 2
        tris.append([a, b, c])
    cols = rng.integers(0, 256, size=(n * 3, 4)).astype(np.uint8)
    return make_mesh(np.clip(np.asarray(tris, F), 0.5, 30.5), cols)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelizer_exact_edges_undilated(seed, monkeypatch):
    """``right_triangles`` with the half-voxel dilation off in both packages
    (``_normalize`` patched to zero in each): the edge and rounding cases
    the dilated meshes almost never reach."""
    for mod in (jv, tv):
        monkeypatch.setattr(mod, "_normalize", lambda v: np.zeros_like(v))
    mesh = right_triangles(seed)
    want = check_voxelizer(mesh, (32, 32, 32))
    # the case holds exact ties: rounding half up changes the reference
    monkeypatch.setattr(np, "round", lambda x: np.floor(x + 0.5))
    half_up = jv.voxelize_mesh(mesh, (32, 32, 32))
    assert any((a != b).any() for a, b in zip(half_up[2], want[2]))


def test_triangle_of_candidates():
    """A candidate's triangle from the inclusive counts; triangles of count
    0 own no candidate."""
    counts = np.array([0, 3, 0, 0, 1, 5, 0, 2, 0])
    csum = torch.from_numpy(np.cumsum(counts))
    idx = torch.arange(int(counts.sum()))
    got = tv._triangle_of(csum, idx).numpy()
    np.testing.assert_array_equal(got, np.repeat(np.arange(counts.size),
                                                 counts))


def test_textured_mesh_goes_to_numpy():
    """A mesh with a textured material is voxelized in numpy (texture
    sampling stays on the host), as in the JAX package."""
    mesh = random_mesh(4)
    rng = np.random.default_rng(4)
    tex = rng.integers(0, 256, (8, 8, 4)).astype(np.uint8)
    tex[..., 3] = np.where(rng.random((8, 8)) < 0.2, 128, 255)
    mesh.materials = [Material(name="m", index=0, diffuse=tex)]
    mesh.material_index[:] = 0
    mesh.uvs[:] = rng.random(mesh.uvs.shape).astype(F)
    calls = (tv.device_calls, tv.host_calls)
    check_voxelizer(mesh, (32, 32, 32))
    assert (tv.device_calls, tv.host_calls) == (calls[0], calls[1] + 1)


# ------------------------------------------------------------ LOD chain


def random_soup(dims, n, seed):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.integers(0, d, n) for d in dims)
    rgb = tuple(rng.integers(0, 256, n).astype(np.uint8) for _ in range(3))
    return x * dims[2] + z, y, rgb


@pytest.mark.parametrize("dims,n,levels", [((64, 64, 64), 60000, 6),
                                           ((512, 512, 512), 4000, 10),
                                           ((16, 16, 16), 0, 3)])
@pytest.mark.parametrize("cascade", [True, False])
def test_lod_chain_matches_numpy(dims, n, levels, cascade):
    xz, y, (r, g, b) = random_soup(dims, n, seed=7)
    want = rle.build_lod_chain(
        rle.build_lod_from_voxels(dims, 0, xz, y, (r, g, b)), levels)
    rgbp = r.astype(np.int64) | (g.astype(np.int64) << 8) | (
        b.astype(np.int64) << 16)
    # padded with rows the mask drops, as the JAX test feeds its builder
    pad = 100
    valid = np.arange(n + pad) < n
    got = rle_device.build_lod_chain_device(
        *(torch.from_numpy(np.concatenate([a, np.zeros(pad, np.int64)]))
          for a in (xz, y, rgbp)), torch.from_numpy(valid), dims, levels,
        cascade=cascade)
    assert_chain_equal(got, want)
    for w in got:
        rle.validate_world(w)


def test_cascade_sums_are_int64():
    xz, y, (r, g, b) = random_soup((64, 64, 64), 5000, seed=3)
    rgbp = r.astype(np.int64) | (g.astype(np.int64) << 8) | (
        b.astype(np.int64) << 16)
    outs = rle_device.chain_levels(rle_device.level0(
        torch.from_numpy(xz), torch.from_numpy(y), torch.from_numpy(rgbp),
        None, (64, 64, 64)), (64, 64, 64), 6)
    for o in outs:
        assert o["sums_d"].dtype == torch.int64
    # a level's carried source counts are the LOD0 voxels in its cubes
    n0 = outs[0]["n_dedupe"]
    assert all(int(o["sums_d"][3].sum()) == n0 for o in outs[1:])


def test_dedupe_sort_is_stable():
    """Equal keys keep their order, as numpy's stable argsort (the
    reference's dedupe) and ``lax.sort`` keep it."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 50, 4000)
    cargo = np.arange(4000)
    ks, cs = rle_device._sort_soup(torch.from_numpy(key),
                                   torch.from_numpy(cargo))
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(ks.numpy(), key[order])
    np.testing.assert_array_equal(cs.numpy(), cargo[order])


def test_tall_world_refused():
    with pytest.raises(ValueError):
        rle_device.build_lod_chain_device(
            np.zeros(1, np.int64), np.zeros(1, np.int64),
            np.zeros(1, np.int64), None, (4, 65536, 4))


# ------------------------------------------------------------ pipeline


def test_convert_matches_jax_through_world_file(town, tmp_path):
    from cpuvox_tpu.assets.pipeline import convert_obj_to_world as jax_convert
    from cpuvox_tpu.world.save import load_world as jax_load
    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world
    from cpuvox_tpu_torch.world.save import load_world

    want = jax_convert(town, max_dimension=64, lod_levels=6)
    timings = {}
    path = str(tmp_path / "town.world")
    got = convert_obj_to_world(town, max_dimension=64, lod_levels=6,
                               save_path=path, device="cpu", timings=timings)
    assert list(timings) == ["parse", "rescale", "tables", "voxelize", "lod0",
                             "cascade", "host_tables", "save"]
    assert_chain_equal(got, want)
    assert_chain_equal(load_world(path), want)
    assert_chain_equal(jax_load(path), want)
    assert_chain_equal(convert_obj_to_world(town, max_dimension=64,
                                            device=None), want)


def test_convert_cli(town, tmp_path):
    from cpuvox_tpu_torch.assets import convert_cli
    from cpuvox_tpu_torch.world.save import load_world

    out = str(tmp_path / "cli.world")
    convert_cli.main([town, out, "--max-dim", "32", "--lod-levels", "4",
                      "--device", "cpu"])
    want = rle.build_lod_chain(rle.build_lod_from_voxels(
        *_numpy_lod0(town, 32)), 4)
    assert_chain_equal(load_world(out), want)


def _numpy_lod0(path, max_dim):
    mesh = import_obj(path)
    dims = rescale(mesh, max_dim)
    xz, y, rgb = jv.voxelize_mesh(mesh, dims)
    return dims, 0, xz, y, rgb


def test_jax_device_path_in_x64_child(town, tmp_path):
    """The JAX package's own device voxelizer and cascade (x64, the JAX CPU
    backend, in a child process: x64 is a process-wide mode) against the
    port's, on the town at max_dimension 48 with small windows."""
    out = str(tmp_path / "jax_device.npz")
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
from cpuvox_tpu.assets.obj import import_obj
from cpuvox_tpu.assets.mesh import rescale
from cpuvox_tpu.assets.voxelizer import voxelize_mesh_device
from cpuvox_tpu.world.rle_device import build_lod_chain_device

mesh = import_obj({town!r})
dims = rescale(mesh, 48)
soup = voxelize_mesh_device(mesh, dims, chunk_candidates=65536)
dev = voxelize_mesh_device(mesh, dims, chunk_candidates=65536,
                           return_device=True)
lods = build_lod_chain_device(*dev, dims, 6, cascade=True)
arrays = {{"xz": soup[0], "y": soup[1], "r": soup[2][0], "g": soup[2][1],
          "b": soup[2][2]}}
for w in lods:
    for f in {FIELDS!r}:
        arrays[f"{{w.lod}}_{{f}}"] = getattr(w, f)
np.savez({out!r}, **arrays)
"""
    env = dict(os.environ, JAX_ENABLE_X64="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_out = np.load(out)
    mesh = import_obj(town)
    dims = rescale(mesh, 48)
    soup = tv.voxelize_mesh_device(mesh, dims, chunk_candidates=65536,
                                   device="cpu")
    assert_soup_equal(soup, (jax_out["xz"], jax_out["y"],
                             (jax_out["r"], jax_out["g"], jax_out["b"])))
    dev = tv.voxelize_mesh_device(mesh, dims, device="cpu",
                                  return_device=True)
    for w in rle_device.build_lod_chain_device(*dev, dims, 6):
        for f in FIELDS:
            a, b = getattr(w, f), jax_out[f"{w.lod}_{f}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (w.lod, f)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_voxelizer_on_card(cuda, town):
    for seed in range(3):
        check_voxelizer(random_mesh(seed), (32, 32, 32), device=cuda)
    mesh = import_obj(town)
    check_voxelizer(mesh, rescale(mesh, 256), chunk=99_991, device=cuda)
    check_voxelizer(grazing_mesh(0), (32, 32, 32), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("cascade", [True, False])
def test_lod_chain_on_card(cuda, cascade):
    for dims, n, levels in (((64, 64, 64), 60000, 6),
                            ((512, 512, 512), 4000, 10)):
        xz, y, (r, g, b) = random_soup(dims, n, seed=7)
        want = rle.build_lod_chain(
            rle.build_lod_from_voxels(dims, 0, xz, y, (r, g, b)), levels)
        rgbp = r.astype(np.int64) | (g.astype(np.int64) << 8) | (
            b.astype(np.int64) << 16)
        got = rle_device.build_lod_chain_device(
            *(torch.from_numpy(a).to(cuda) for a in (xz, y, rgbp)), None,
            dims, levels, cascade=cascade)
        assert_chain_equal(got, want)


@pytest.mark.cuda
def test_convert_on_card(cuda, town):
    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world

    want = convert_obj_to_world(town, max_dimension=128, device=None)
    assert_chain_equal(convert_obj_to_world(town, max_dimension=128,
                                            device=cuda), want)
