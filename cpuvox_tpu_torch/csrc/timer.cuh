// Sampled device timers inside the march graph.
//
// CUDA events cannot go inside a graph's conditional bodies, and the
// profiler sees few of the kernels that run there, so the kernels of a
// Renderer's frame graph time themselves (render/march_graph.py,
// utils/profiling.py).  That graph hands its roll, rasterizer and control
// kernels one int64 buffer of kTimerWords words; every other launch (the
// eager wrappers, the batch and shard graphs) hands them a null pointer and
// pays nothing.  The host sets word kSampled, in stream order, before each
// launch of the graph: on a frame that leaves it 0 a kernel reads that one
// word and nothing more.  On a sampled frame the clock is %globaltimer
// (the card's, in ns):
//  - a roll or rasterizer launch only stamps: the first thread of each
//    block the earliest start into its pending pair (kPending + 2 * kind),
//    and each ray as it finishes the latest end (a fire-and-forget atomic
//    each, no barrier, no count: anything more changed how the compiler
//    built the rasterizer, rasterize.cu);
//  - the control kernel, which follows every iteration's roll and
//    rasterizer in stream order, folds the pending launches and then its
//    own: each launch's span (start to end) into its kernel's sum
//    (kSpan + kind) and a launch into kLaunches + kind, and the gap from
//    the previous launch's end to its start into kGap + 3 * previous kind
//    + kind (the frame's first launch sets kFirstStart instead).
// So the spans and gaps partition the frame's time from the first control
// kernel's start to the last one's end.  Before each iteration it lets
// run, the control kernel also adds the live rays and the stage's width
// into kLive and kSlots.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace cpuvox {

enum TimerKind : int { kRollTimer = 0, kRasterTimer = 1, kControlTimer = 2,
                       kTimerKinds = 3 };

// the buffer's words (utils/profiling.py mirrors them)
enum TimerWord : int {
  kSampled = 0,     // 1: this frame is timed (set by the host)
  kLastEnd = 1,     // the last folded launch's end, 0 before the first
  kLastKind = 2,    // its kernel
  kFirstStart = 3,  // the frame's first launch's start
  kPending = 4,     // the roll's and the rasterizer's unfolded launch:
                    // start (all ones: none) and end, a pair each
  kSpan = kPending + 4,  // a kernel's launches' spans, ns
  kLaunches = kSpan + kTimerKinds,
  kGap = kLaunches + kTimerKinds,  // by (previous kernel, kernel), ns
  kLive = kGap + kTimerKinds * kTimerKinds,  // live rays before iterations
  kSlots,           // the stage widths of those iterations
  kTimerWords
};

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// Whether this launch is timed: a buffer, on a sampled frame.
__device__ __forceinline__ bool timed(const long long* t) {
  return t != nullptr && t[kSampled] != 0;
}

// A timed roll or rasterizer launch's start: `at`, as one of its blocks
// began.
__device__ __forceinline__ void stamp_start(long long* t, int kind,
                                            long long at) {
  atomicMin(reinterpret_cast<unsigned long long*>(t + kPending + 2 * kind),
            static_cast<unsigned long long>(at));
}

// A timed roll or rasterizer launch's end, as one of its rays finishes.
__device__ __forceinline__ void stamp_end(long long* t, int kind) {
  atomicMax(reinterpret_cast<unsigned long long*>(t + kPending + 2 * kind + 1),
            static_cast<unsigned long long>(globaltimer()));
}

// The launch [start, end] of `kind` into the sums; one thread calls it.
__device__ __forceinline__ void fold_launch(long long* t, int kind,
                                            long long start, long long end) {
  if (t[kLastEnd] != 0) {
    t[kGap + kTimerKinds * static_cast<int>(t[kLastKind]) + kind] +=
        start - t[kLastEnd];
  } else {
    t[kFirstStart] = start;
  }
  t[kSpan + kind] += end - start;
  t[kLaunches + kind] += 1;
  t[kLastEnd] = end;
  t[kLastKind] = kind;
}

// The pending launch of `kind`, if there is one, into the sums (a launch
// whose rays all ended before their first cell stamps no end: its span is
// 0).  One thread of a later kernel calls it.
__device__ __forceinline__ void fold_pending(long long* t, int kind) {
  volatile long long* p = t + kPending + 2 * kind;
  const long long start = p[0];
  if (start == -1) return;
  const long long end = p[1] > start ? p[1] : start;
  p[0] = -1;
  p[1] = 0;
  fold_launch(t, kind, start, end);
}

}  // namespace cpuvox
