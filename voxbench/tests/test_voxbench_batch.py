"""A camera-batch mix (``"entry": "render_camera_batch"``): the agents, the
warm-up's variants, a sound run, the faults and the control, the batch's
spans, and the single-frame cells' result left as it was; on the tiny world
of ``conftest.py`` with 8 agents a step at 48 x 32."""
import json
import time

import numpy as np
import pytest
from conftest import TINY_CONFIG, tiny_batch_traffic

from voxbench import control, faults, harness, program, spec, traffic
from voxbench.reference import frame as rf
from voxbench.trace import BatchSpans, KeepBatch, Trace
from voxbench.worldgen import cache

SEED = 2**31 + 424242


def _cell(tiny_dir, workload):
    return spec.cell(spec.load(str(tiny_dir)), workload, root=str(tiny_dir),
                     traffic_dir=str(tiny_dir / "traffic"))


def _run(tiny_dir, workload, fault=None, trace=False, seed=SEED):
    return harness.run_cell(_cell(tiny_dir, workload), seed, 0.01, trace,
                            time.perf_counter(), device="cpu",
                            cache_dir=str(tiny_dir / "cache"), fault=fault)


def _lods(tmp_path):
    return cache.world(TINY_CONFIG, str(tmp_path / "cache"), log=lambda *a: None)


def _direction(pose, wh=(48, 32)):
    """The iteration direction the reference gives a pose's camera."""
    render = TINY_CONFIG["render"]
    g = rf.geometry(pose, render, wh, rf.lod_distances(pose, render, wh, 64))
    return -1 if g.cam_data.inverse_element_iteration_direction else 1


def test_agents_are_deterministic_by_seed_and_differ_between_seeds(tmp_path):
    lods = _lods(tmp_path)
    tr = tiny_batch_traffic()
    a = traffic.Agents(tr, lods[0], SEED)
    b = traffic.Agents(tr, lods[0], SEED)
    late = b.step(9)  # drawn without asking for the steps before it
    assert [a.step(k) for k in range(10)][9] == late
    assert traffic.Agents(tr, lods[0], SEED + 1).step(9) != late
    top = lods[0].col_max.reshape(64, 64)
    lo, hi = tr["pitch_deg"]
    for k in range(10):
        poses = a.step(k)
        assert len(poses) == 8
        for p in poses:
            x, y, z = p["position"]
            assert 6.4 <= x <= 57.6 and 6.4 <= z <= 57.6
            assert y == top[int(x), int(z)] + tr["eye_height"]
            assert lo <= p["pitch_deg"] <= hi and p["roll_deg"] == 0.0
    # each agent walks ``speed`` a step, bouncing inside the region
    step = np.hypot(*(np.array([p["position"] for p in a.step(4)])
                      - np.array([p["position"] for p in a.step(3)]))[:, [0, 2]].T)
    assert np.all(step <= tr["speed"] + 1e-9) and np.any(step > 0)


@pytest.mark.parametrize("n", [8, 6, 64])
def test_warmup_covers_every_direction_and_bucket(tmp_path, n):
    lods = _lods(tmp_path)
    tr = dict(tiny_batch_traffic(), cameras_per_step=n)
    want = {(d, program.bucket_size(k, n)) for d in (1, -1)
            for k in range(1, n + 1)}
    firsts = []
    for seed in (SEED, 7):
        warm = traffic.Agents(tr, lods[0], seed).warmup(program.bucket_size)
        got = set()
        for poses in warm:
            assert len(poses) == n
            dirs = [_direction(p) for p in poses]
            for d in (1, -1):
                if dirs.count(d):
                    got.add((d, program.bucket_size(dirs.count(d), n)))
        assert got == want
        firsts.append(warm[0][0])
    assert firsts[0] == firsts[1]  # the LOD distances are every seed's


def test_a_batch_mix_lacking_a_key_is_refused(tmp_path):
    lods = _lods(tmp_path)
    for key in traffic.BATCH_KEYS:
        tr = tiny_batch_traffic()
        del tr[key]
        with pytest.raises(ValueError, match=key):
            traffic.Agents(tr, lods[0], SEED)
    with pytest.raises(ValueError, match="dispatch"):
        traffic.Agents(dict(tiny_batch_traffic(), dispatch="open"), lods[0], 1)


def _fake_captures(monkeypatch):
    """On the CPU nothing is captured; count instead each (direction,
    bucket) a group marches at, as the card captures each once."""
    from cpuvox_tpu_torch.parallel import batch

    seen = set()
    inner = batch.march_group

    def march_group(renderer, frames, direction, bucket, *a, **k):
        seen.add((direction, bucket))
        return inner(renderer, frames, direction, bucket, *a, **k)

    monkeypatch.setattr(batch, "march_group", march_group)
    monkeypatch.setattr(program, "captures", lambda r: len(seen))
    return seen


@pytest.mark.parametrize("workload", ["tiny-batch-waited", "tiny-batch-ahead"])
def test_a_sound_batch_run_is_correct(tiny_dir, monkeypatch, workload):
    seen = _fake_captures(monkeypatch)
    res = _run(tiny_dir, workload)
    assert res["correct"] and res["failed"] == 0, res["check"]
    steps = res["attempted"] // 8
    assert steps >= 1 and res["attempted"] == 8 * steps
    kept = min(steps, 2)
    assert res["check"]["frames_checked"]["value"] == 8 * kept
    assert res["check"]["rays_checked"]["value"] == 2 * 12 * kept
    for k in ("texels_off", "pixels_off", "magenta_pixels"):
        assert res["check"][k] == {"value": 0, "op": "<=", "limit": 0}
    assert set(res["metrics"]) == {"fps", "frame_ms_p95", "latency_ms_p95",
                                   "setup_s"}
    assert len(seen) == 8  # both directions at buckets 1, 2, 4 and 8


def test_a_variant_left_out_of_the_warmup_fails_the_run(tiny_dir, monkeypatch):
    _fake_captures(monkeypatch)
    whole = traffic.Agents.warmup

    def looking_up_only(self, bucket_size):
        return [[dict(p, pitch_deg=-abs(p["pitch_deg"]) - 1.0)
                 for p in whole(self, bucket_size)[0]]]

    monkeypatch.setattr(traffic.Agents, "warmup", looking_up_only)
    with pytest.raises(RuntimeError, match="captured inside the window"):
        _run(tiny_dir, "tiny-batch-waited")


@pytest.mark.parametrize("name,number", [
    ("stale", "texels_off"), ("half_rays", "texels_off"),
    ("pixel", "pixels_off")])
def test_a_batch_fault_is_not_correct(tiny_dir, name, number):
    from cpuvox_tpu_torch.parallel import batch

    phase2 = batch.phase2_group
    res = _run(tiny_dir, "tiny-batch-ahead", fault=faults.BATCH_FAULTS[name])
    assert not res["correct"] and res["failed"] >= 1, res["check"]
    assert res["check"][number]["value"] > 0, res["check"]
    assert batch.phase2_group is phase2  # a fault's hook is undone


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_the_batch_control_fails(tiny_dir, seed):
    cell = _cell(tiny_dir, "tiny-batch-waited")
    lods = _lods(tiny_dir)
    path = cache.path(cell.config, str(tiny_dir / "cache"))
    out = control.control(cell, seed, lods, path)
    assert not out["correct"], json.dumps(out)
    assert out["check"]["rays_checked"]["value"] == 2 * 2 * 12
    assert out["check"]["texels_off"]["value"] > 0, json.dumps(out)
    same = control.control(cell, seed, lods, path, dtype=np.float32)
    assert same["correct"] and same["rays_unfinished"] == 0, json.dumps(same)


class _Event:
    """A host-clock stand-in for a CUDA timing event."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_batch_spans_give_per_step_numbers_to_the_span_readers(tmp_path):
    from cpuvox_tpu_torch.parallel import batch

    lods = _lods(tmp_path)
    tr = tiny_batch_traffic()
    r = program.renderer(lods, TINY_CONFIG, tr, "cpu")
    agents = traffic.Agents(tr, lods[0], SEED)
    phase2 = batch.phase2_group
    spans = BatchSpans(r, event=_Event)
    t0 = time.perf_counter()
    with KeepBatch(r) as keep:
        screens = spans.render(r, [program.camera(p, tr) for p in agents.step(0)])
    spans.render(r, [program.camera(p, tr) for p in agents.step(1)])
    t = Trace(frames=2, window_s=time.perf_counter() - t0, iterations=20,
              phase2_bytes=[8 * 4 * 48 * 32])
    spans.fill(t, 0)
    spans.remove()
    assert batch.phase2_group is phase2 and "march_rays" not in vars(r)
    assert screens.shape == (8, 32, 48)
    dirs = [{f.iteration_direction for f in fs} for _, fs in keep.groups]
    for s in spans.steps:
        # a march and a phase 2 a direction group, the set-up before them
        assert len(s["march"]) == len(s["phase2"]) in (1, 2)
        assert s["t0"] < s["first"]
    assert all(len(d) == 1 for d in dirs)
    assert len(t.march_ms) == len(t.phase2_ms) == len(t.busy_ms) == 2
    for m, p, b in zip(t.march_ms, t.phase2_ms, t.busy_ms):
        assert 0 < m and 0 < p and m + p <= b
    assert len(t.setup_host_s) == 2 and all(x > 0 for x in t.setup_host_s)
    read = {m: spec.reader(m).read(t) for m in (
        "frame_setup_ms", "march_ms", "march_iterations", "phase2_roofline",
        "device_idle_pct")}
    assert read["frame_setup_ms"] == pytest.approx(
        1e3 * sum(t.setup_host_s) / 2)
    assert read["march_ms"] == pytest.approx(sum(t.march_ms) / 2)
    assert read["march_iterations"] == 10
    assert 0 < read["phase2_roofline"] and 0 <= read["device_idle_pct"] < 100
    layers = [name for name, _ in spans.device_ops(0)]
    assert any("batch march" in n for n in layers)
    assert any("batch phase 2" in n for n in layers)


def test_the_kept_blocks_are_each_cameras_own_raybuffer(tmp_path):
    lods = _lods(tmp_path)
    tr = tiny_batch_traffic()
    r = program.renderer(lods, TINY_CONFIG, tr, "cpu")
    poses = traffic.Agents(tr, lods[0], SEED).step(0)
    cams = [program.camera(p, tr) for p in poses]
    with KeepBatch(r) as keep:
        screens = program.camera_batch(r, cams)
    blocks = keep.blocks(8)
    assert "frame_geometry" not in vars(r)
    dirs = [_direction(p) for p in poses]
    assert 1 in dirs and -1 in dirs  # both groups
    for i in (dirs.index(1), dirs.index(-1), 7):
        screen, raybuf, _ = r.render_device(cams[i])
        assert np.array_equal(screens[i].numpy(), screen.numpy())
        assert np.array_equal(blocks[i].numpy(), raybuf.numpy())


@pytest.mark.parametrize("trace", [False, True])
def test_a_single_frame_cells_result_keeps_its_keys(tiny_dir, trace):
    cell = _cell(tiny_dir, "tiny-ahead")
    res = _run(tiny_dir, "tiny-ahead", trace=trace)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"], res["check"]
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    assert set(res["metrics"]) <= set(names)
    if not trace:
        assert list(res["metrics"]) == names
    assert list(res["check"]) == ["texels_off", "pixels_off",
                                  "magenta_pixels", "frames_checked",
                                  "rays_checked"]
    assert res["check"]["frames_checked"]["value"] >= 1
