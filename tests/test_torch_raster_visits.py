"""The march's rasterize op, ``ops/phase1_kernel.py::rasterize_visits``: the
cells as the march makes them (the roll's visits on the dense march, a gated
group's ``PackedCells`` on the gated march), the column records read from
the world tables by the op itself.  Tolerance 0 everywhere, f32 as bits.

- CPU: the op's CPU route equals the previous design's plain version on the
  fetched cells, on every inline record format (int32 runs, 16-bit packed
  runs, each with and without ARGB colors), dense and gated, in both
  iteration directions, and launches nothing.  Through ``march`` and
  ``march_gated`` the same route is held against JAX ``raymarch.phase1``
  and ``phase1_pallas`` (interpret mode) by test_torch_raster*.py,
  test_torch_gated.py, test_torch_compact.py, test_torch_argb.py and
  test_torch_frame.py (the split layout); ARGB records with int32 runs here.
- On the card (``cuda``): the group kernel against its plain version and
  against the previous kernel design on the fetched cells, in the raybuffer
  and all 8 state fields, on every format (the split layout and a packed
  record of more than 32 runs included), dense and gated, with and without a
  live-ray index, at P = 160, 320 and 100; and a march through the kernels
  runs no torch column fetch.

JAX is imported only inside the test that compares with it.
"""
import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.bench.capture import capture, clone
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import phase1_kernel
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.world import rle

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def terrain():
    from cpuvox_tpu_torch.models.procedural import heightmap_world

    return heightmap_world(dims=(64, 32, 64), seed=3, shell_depth=6,
                           lod_levels=6)


def striped(top: int):
    """One column of alternating voxel and air up to ``top``: about ``top``
    runs (48: a packed record over 32 runs; 66: the split layout)."""
    dims = (16, 96, 16)
    ys = np.arange(0, top, 2)
    xz = np.full(ys.shape[0], 5 * dims[2] + 7)
    rgb = tuple((ys * (5 + i) % 251).astype(np.uint8) for i in range(3))
    return [rle.build_lod_from_voxels(dims, 0, xz, ys, rgb)] * 6


WORLDS = {
    "terrain": terrain,
    "deep": scenes.deep_tower_world,
    "striped48": lambda: striped(48),
    "striped66": lambda: striped(66),
}
# format -> (world, ARGB records asked for, the record's max_runs and MCC)
FORMATS = {
    "int32": ("terrain", False, 3, 0),
    "int32_argb": ("terrain", True, 3, 6),
    "packed": ("deep", False, 20, 0),
    "packed_argb": ("deep", True, 20, 23),
    "packed48_argb": ("striped48", True, 48, 24),
    "split": ("striped66", False, 66, 0),
}
# a camera of each iteration direction for each world
CAMERAS = {
    "terrain": {1: ((20, 30, 20), 25.0, 40.0), -1: ((32, 2, 32), -30.0, 200.0)},
    "deep": {1: ((-4, 40, 20), 20.0, 60.0), -1: ((30, 6, 30), -30.0, 120.0)},
    "striped": {1: ((8.0, 60.0, -6.0), 20.0, 15.0),
                -1: ((8.0, 10.0, -6.0), -30.0, 10.0)},
}


def renderer(fmt, gated: bool, device, wh=(64, 48), backend="pallas"):
    world, argb, maxr, mcc = FORMATS[fmt]
    r = Renderer.create(WORLDS[world](), RenderConfig(
        width=wh[0], height=wh[1], chunk_steps=8, max_march_chunks=64,
        occupancy_gate="on" if gated else "off", argb_records=argb,
        backend=backend), device=device)
    dw = r.device_world
    assert (dw.max_runs, dw.max_col_colors) == (maxr, mcc)
    assert (dw.rec_fwd is None) == (fmt == "split")
    return r


def camera(fmt, direction):
    world = FORMATS[fmt][0]
    pos, pitch, yaw = CAMERAS[world.rstrip("0123456789")][direction]
    return cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw)


def mid_chunk(r, fmt, direction):
    """The state after one march iteration and the next one's cells."""
    cap = capture(r, camera(fmt, direction), k=1, compact=False)
    assert cap.frame.iteration_direction == direction
    assert isinstance(cap.src, trm.PackedCells) == r.occupancy_on
    return cap


def assert_states_equal(got, want, what):
    for k, x, y in zip(trm.RasterState._fields, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), (
            f"{what}: {k} differs in {int((x != y).sum())} elements")


# (format, gated, direction): each format dense and gated, and each in both
# iteration directions
CPU_CASES = [("int32", False, 1), ("int32", True, -1),
             ("int32_argb", False, -1), ("int32_argb", True, 1),
             ("packed", False, 1), ("packed", True, -1),
             ("packed_argb", False, -1), ("packed_argb", True, 1)]


@pytest.mark.parametrize("fmt,gated,direction", CPU_CASES)
def test_visits_op_takes_plain_version_on_cpu(fmt, gated, direction):
    r = renderer(fmt, gated, "cpu")
    cap = mid_chunk(r, fmt, direction)
    args = (cap.frame.static, cap.consts, direction)
    before = (phase1_kernel.launches, phase1_kernel.chunk_launches)
    got = phase1_kernel.rasterize_visits(clone(cap.rs), cap.wa, cap.src,
                                         *args)
    assert (phase1_kernel.launches, phase1_kernel.chunk_launches) == before
    want = phase1_kernel.rasterize_chunk_ref(clone(cap.rs), cap.cells, *args)
    assert_states_equal(got, want, f"{fmt} gated={gated} {direction:+d}")
    assert (want.raybuf >= 0).sum() > (cap.rs.raybuf >= 0).sum()


@pytest.mark.parametrize("direction", [1, -1])
def test_int32_argb_frames_match_jax(direction):
    """ARGB records whose runs stay int32 (terrain: MAXR 3, MCC 6), dense
    and gated, through the op's CPU route: the screen equals the JAX
    Renderer's (XLA, index mode), which the ARGB screen must equal."""
    from test_torch_frame import jax_reference

    cam = camera("int32_argb", direction)
    cam = cm.Camera(position=cam.position, pitch_deg=cam.pitch_deg,
                    yaw_deg=cam.yaw_deg, screen=(64, 48))
    want, (_td, _lr, *rest) = jax_reference(WORLDS["terrain"](), cam)
    assert rest[3].inverse_element_iteration_direction == (direction < 0)
    for gated in (False, True):
        r = renderer("int32_argb", gated, "cpu")
        assert r.argb_on
        got = r.render(cam)
        diff = got != want
        assert not diff.any(), (
            f"gated={gated}: {int(diff.sum())} pixels differ, first "
            f"{np.argwhere(diff)[:5].tolist()}")
    assert (want != want[0, 0]).any(), "nothing was drawn"


# ------------------------------------------------------------- on the card


def restrict(src, i):
    """The cells of the rays ``i`` (int64) of a full-width input."""
    if isinstance(src, trm.PackedCells):
        return trm.PackedCells(src.rows[:, i].contiguous(),
                               src.proc[:, i].contiguous())
    return src[:, :, i].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("wh", [(160, 120), (320, 180), (100, 75)],
                         ids=["P160", "P320", "P100"])
@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_visits_kernel_matches_plain_on_cuda(cuda, fmt, gated, wh):
    """Both iteration directions, at full width and on a live-ray index: the
    group kernel == its plain version == the previous kernel on the fetched
    cells, raybuffer and 8 state fields."""
    r = renderer(fmt, gated, cuda, wh)
    for direction in (1, -1):
        cap = mid_chunk(r, fmt, direction)
        args = (cap.frame.static, cap.consts, direction)
        live = cap.alive & cap.rs.alive
        index = trm.live_index(live, int(live.sum()))
        assert 0 < index.shape[0] < live.shape[0]
        full = phase1_kernel.rasterize_visits_ref(clone(cap.rs), cap.wa,
                                                  cap.src, *args)
        what = f"{fmt} gated={gated} P={max(wh)} {direction:+d}"
        for idx in (None, index):
            src = cap.src if idx is None else restrict(cap.src, idx.long())
            n0 = phase1_kernel.launches
            got = phase1_kernel.rasterize_visits(clone(cap.rs), cap.wa, src,
                                                 *args, index=idx)
            torch.cuda.synchronize()
            assert phase1_kernel.launches == n0 + 1
            want = phase1_kernel.rasterize_visits_ref(clone(cap.rs), cap.wa,
                                                      src, *args, index=idx)
            tag = f"{what} index={idx is not None}"
            assert_states_equal(got, want, tag)
            # a dead ray's cells are not valid: the full-width result agrees
            assert_states_equal(got, full, tag + " against full width")
        m0 = phase1_kernel.chunk_launches
        old = phase1_kernel.rasterize_chunk(clone(cap.rs), cap.cells, *args)
        torch.cuda.synchronize()
        assert phase1_kernel.chunk_launches == m0 + 1
        assert_states_equal(old, full, what + ": the previous kernel")
        assert (full.raybuf >= 0).sum() > (cap.rs.raybuf >= 0).sum()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["packed_argb", "split"])
def test_march_runs_no_torch_fetch_on_cuda(cuda, fmt, monkeypatch):
    """With the kernels on, neither march calls ``_fetch_columns``; the
    raybuffer is the plain path's."""
    for direction in (1, -1):
        cam = camera(fmt, direction)
        for gated in (False, True):
            plain = renderer(fmt, gated, cuda, (160, 120), backend="xla")
            want = plain.march(plain.frame_setup(cam))
            r = renderer(fmt, gated, cuda, (160, 120))
            with monkeypatch.context() as m:
                m.setattr(trm, "_fetch_columns", no_fetch)
                for compact in (False, True):
                    got = r.march(r.frame_setup(cam), compact=compact)
                    assert torch.equal(got, want), (direction, gated, compact)


def no_fetch(*_args, **_kw):
    raise AssertionError("a march with the kernels on fetched records in torch")
