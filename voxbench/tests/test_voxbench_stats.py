"""The rate and tail arithmetic on synthetic timestamps."""
import statistics

import pytest

from voxbench import stats


def test_steady_frames():
    done = [0.010 * (i + 1) for i in range(100)]
    assert stats.rate(len(done), 0.0, done[-1]) == pytest.approx(100.0)
    gaps = stats.intervals(done, 0.0)
    assert len(gaps) == 100 and stats.percentile(gaps, 95) == pytest.approx(0.010)


def test_a_stall_moves_the_tail_and_the_rate():
    # 100 frames of 10 ms, then 6 of them stall to 60 ms: more than the 5 %
    # beyond the 95th percentile, so the p95 has to move to the stall
    base = [0.010] * 100
    stalled = [0.060 if i % 17 == 5 else 0.010 for i in range(100)]
    assert sum(1 for g in stalled if g > 0.01) == 6
    done_a, done_b, t = [], [], 0.0
    for g in base:
        t += g
        done_a.append(t)
    t = 0.0
    for g in stalled:
        t += g
        done_b.append(t)
    p_a = stats.percentile(stats.intervals(done_a, 0.0), 95)
    p_b = stats.percentile(stats.intervals(done_b, 0.0), 95)
    assert p_a == pytest.approx(0.010) and p_b == pytest.approx(0.060)
    assert stats.rate(100, 0.0, done_b[-1]) < stats.rate(100, 0.0, done_a[-1])
    # a median of chunk medians would hide the stall
    chunks = [statistics.median(stalled[i:i + 10]) for i in range(0, 100, 10)]
    assert max(chunks) == pytest.approx(0.010)


def test_nearest_rank_and_latency():
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.latencies([0.0, 1.0], [0.5, 2.0]) == [0.5, 1.0]
    with pytest.raises(ValueError):
        stats.latencies([0.0], [])
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)


def test_readers_on_a_synthetic_trace():
    from voxbench import spec
    from voxbench.trace import Trace

    t = Trace(frames=4, window_s=0.05, setup_host_s=[0.004, 0.006],
              march_ms=[9.0, 9.2, 8.8, 9.0], phase2_ms=[0.04, 0.04, 0.40, 0.04],
              busy_ms=[9.1, 9.3, 9.2, 9.4], iterations=248,
              phase2_bytes=[13.4e6, 12.6e6])
    read = {m: spec.reader(m).read for m in (
        "frame_setup_ms", "march_ms", "march_iterations", "phase2_roofline",
        "device_idle_pct")}
    assert read["frame_setup_ms"](t) == pytest.approx(5.0)
    assert read["march_ms"](t) == pytest.approx(9.0)
    assert read["march_iterations"](t) == 62
    # 13 MB at 3.35 TB/s over the median 0.04 ms; the one launch that waited
    # for the host does not move it
    assert read["phase2_roofline"](t) == pytest.approx(
        100 * 13e6 / 3.35e12 * 1e3 / 0.04)
    assert read["device_idle_pct"](t) == pytest.approx(100 * (1 - 0.037 / 0.05))
    empty = Trace()
    assert all(r(empty) is None for r in read.values())
