// Kernel 2: the phase-1 chunk rasterizer, in two designs.
//
// Both replace cpuvox_tpu/ops/phase1_kernel.py::rasterize_chunk (the Pallas
// kernel that phase1_pallas calls once per chunk on the dense march and once
// per gated group on the occupancy-gated march).  The plain version is the
// torch cpuvox_tpu_torch.render.raymarch._rasterize_step looped over the
// cells (raymarch.rasterize_cells); both kernels equal it bit for bit in the
// raybuffer and in all 8 state fields.  A cell that is not valid (a gated
// group's tail cell past the ray's gated count) leaves the ray untouched.
//
//  - cpuvox_rasterize_visits, the main path's: a group of kGroup = 16 lanes
//    a ray (half a warp).  It reads the cells as the march makes them, the
//    roll's visits (C, 13, Rk) or a gated group's packed (GK, Rk, 4) [ci,
//    ids0, ids1, lod] rows and their proc mask, and reads and unpacks each
//    cell's column record itself (inline int32 runs, 16-bit packed runs, or
//    the split layout's meta row and flat run array), so the march runs no
//    torch column fetch.
//  - cpuvox_rasterize_chunk, the previous design: one thread a ray, on cells
//    fetched by torch (raymarch.chunk_cells / packed_cells).  Off every path;
//    kept to be timed against the group kernel.
//
// The value written (phase1_kernel.py:462-473, :556-566): in index mode
// (MCC 0) a texel gets color_off + the color's index local to the column,
// resolved to ARGB after the reprojection.  In ARGB mode (MCC > 0) the
// record carries the column's MCC color words (bit 31 cleared, so a written
// texel stays >= 0) and the texel gets colors[local index]: one load, where
// the TPU kernel runs an MCC-way select chain for want of a per-lane gather.
// A local index outside the MCC words writes 0, as that chain does.
//
// Live-ray index: with `index` (ascending int32, Rk entries) lane group
// (or thread) t works on ray index[t]: its cells are column t of the (C, ., Rk)
// cell arrays, its row, state and planes stay in place at full width.  A
// null index is every ray.  See roll.cu.
//
// Camera height: a single camera's frame passes cam_y and cam_y_norm =
// cam_y / world_max_y as scalars (Consts).  A batch of cameras marched
// together (parallel/batch.py) gives the group kernel both as (R,) arrays,
// read by the ray's slot like its state (phase1_kernel.py:719, :764 take
// them per ray too); the previous design keeps the scalars.
//
// What bounds the group kernel on the H100: the serial chain of its
// busiest ray, not bytes.  A ray's cells are a dependent chain (each cell's
// state is the last one's): per cell one record read (a 32-96 B row, or a
// meta row and the run words) and ~250 scalar f32/int operations with ~20
// correctly rounded divisions, per drawn run a side span and a cap over the
// ray's row.  Every ray of a launch is resident at once, so the launch takes
// as long as its longest chain.  The design shortens the chain and fills the
// card:
//  - a group of lanes a ray: the lanes compute the cell's geometry
//    redundantly (it is uniform per ray, so nothing diverges) and split the
//    texel work.  A whole warp a ray dispatched 32 times the warp
//    instructions of one thread a ray and was bound by the schedulers'
//    dispatch rate; 16 lanes (two rays a warp) timed fastest, ahead of 8
//    and 32 (PERF.md);
//  - every cell's visit fields (and its record's meta words) are read
//    before the first cell is drawn, one cell a lane, so their latency is
//    paid once per 16 cells, and each cell's run words are read at the top
//    of the cell, ahead of the geometry that hides their latency; lane l
//    holds runs l, l + 16, l + 32, l + 48, and a 16-bit packed record is
//    unpacked there: the color index is the exclusive prefix sum of solid
//    lengths, a group scan, and for the reversed table total - before -
//    length, exactly as raymarch._fetch_columns computes it;
//  - in a world of more than kSerialRuns runs a column (layered2048's 29)
//    each cell is swept in parallel, a run a lane: the extents by a prefix sum of the
//    integer run heights, the draw geometry of every run at once, then only
//    the draws that depend on the ray's state in order (`sweep`);
//  - a written-texel bitmask a ray, ceil(P/32) words in shared memory, built
//    from the ray's row with coalesced loads the first time the ray needs it
//    (a ray that never reaches a texel reads none of its row).  The frontier
//    scans are a ballot over 16 mask words at a time plus __ffs/__clz: the
//    EXACT scans of _next_unwritten_geq/_prev_unwritten_leq.  A span write
//    is one pass of the lanes over the unwritten texels of each of its
//    32-texel words (coalesced), or-ed into the mask.  Within a span the
//    texels are independent; spans stay in the reference's order (run by
//    run, side then cap), so the first covering span wins as before.
// Shared memory holds only the masks (8 rays x 4 ceil(P/32) B a block,
// 1,920 B at P = 1,920), so P is not bounded by registers.
//
// Bit-exactness against the plain version (and through it the JAX twin):
//  - built with -fmad=false, and every `a + b * c` is written in the
//    reference's order, so no product is fused into a sum;
//  - divisions are real divisions where the reference divides
//    (portion = eb / world_max_y, uv = (1, u) / w);
//  - f32 -> i32 casts go through cpuvox::to_i32 (saturating, NaN -> 0, as
//    XLA converts); rounding is rintf (half to even, as jnp.round), never
//    roundf;
//  - min/max propagate NaN (cpuvox::min_nan/max_nan), fminf/fmaxf would not;
//  - `run >> 16` is an arithmetic shift (air runs are negative), and a
//    packed run is rebuilt as the int32 word (cidx << 16 | length) the plain
//    version builds, then decoded the same way;
//  - the frontier scans are exact (above).
// The raybuffer and state are updated in place.
//
// No checkpoint sweep skip (phase1_kernel.py:630-675): the TPU kernel sweeps
// a column's runs in RB-run blocks shared by 128 lanes, and a lane-consensus
// checkpoint lets all of them jump past blocks that lie wholly on the far
// side of every lane's window.  The serial loop leaves such a run with the
// far-side `continue` after a scale and two compares (a skip loop ahead of
// it timed 9-16 % slower than none with one thread a ray on layered2048's
// gated groups, PERF.md); the parallel sweep passes 16 runs in one step.
//
// Rolled loops: every loop over texels or mask words whose trip count comes
// from a kernel parameter carries `#pragma unroll 1`, against a ptxas
// miscompile.  ptxas of CUDA 12.9 (V12.9.86, sm_90a, at its default -O3)
// fuses max(max(-p, a), b), p a kernel parameter, into one three-input
// VIMNMX3 whose operand is p itself: the negation is lost.  A four-line
// kernel,
//   out[i] = max(max(-P, a[i]), b[i]);
// returns max(P, a, b) on the card (right at -Xptxas -O0).  With every texel
// loop unrolled, NVVM writes each span loop's trip count in exactly that form
// (-(e + 1) = max(-P, ~nfp_max, ~rb_max)), so the count came out as
// -(y0 + P), the unrolled loop ran on for about 2^30 iterations and left the
// raybuffer with an illegal address; a build that checks every row index
// traps at y == P.  A rolled loop compares its counter with the end on every
// step and has no trip count to compute.  The deep-RLE case of
// tests/test_torch_raster.py::test_rasterize_kernel_matches_plain_on_cuda
// faults without these pragmas, and test_kernel_library_holds_no_vimnmx3
// fails if any kernel brings the fused instruction back.

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 24;
constexpr unsigned kFull = 0xFFFFFFFFu;
// lanes a ray (a group) in the group kernel, and its threads a block: 16
// and 128 timed fastest on the H100 against 8, 32 and 64 threads (PERF.md)
constexpr int kGroup = 16;
constexpr int kThreads = 128;
// a world of at most this many runs a column is swept serially, a deeper
// one in parallel (`sweep`): with few runs the lanes' parallel run geometry
// costs more than it saves.  The choice is the launch's, not the cell's:
// the two rays of a warp diverge when their cells choose differently, and a
// per-cell choice timed slower than either path alone (PERF.md)
constexpr int kSerialRuns = 8;

// record formats of the group kernel (ops/phase1_kernel.py names them)
constexpr int kInline32 = 0;  // inline record, int32 runs
constexpr int kPacked = 1;    // inline record, 16-bit packed runs
constexpr int kSplit = 2;     // 8-int meta row + the flat run array
// an inline record's leading meta words: n_runs, color_off, cmin, cmax
constexpr int kRecMeta = 4;

struct Consts {
  float world_max_y, cam_y, cam_y_norm;
  int has_solid;
  float solid_min_y, solid_max_y;
  int dir;  // iteration direction, +1 or -1
  int P;
};

// A projected point (pixel, nearval, w), held by value: every helper below
// is inlined and the whole per-ray state stays in registers.
struct F3 {
  float x, y, z;
};

// base + dir * t, componentwise (DrawSegmentRayJob.cs:289-293's projection)
__device__ __forceinline__ F3 along(F3 base, F3 dir, float t) {
  return {base.x + dir.x * t, base.y + dir.y * t, base.z + dir.z * t};
}

// a + (b - a) * t, componentwise, in the reference's order
__device__ __forceinline__ F3 lerp3(F3 a, F3 b, float t) {
  return {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
          a.z + (b.z - a.z) * t};
}

struct RayState {
  int nfp_min, nfp_max;
  float fb_min, fb_max;
  bool f_active;
  float fdir_min, fdir_max;
  bool alive;
};

// The value a texel gets for the column-local color index `local`: the
// index into the world's colors, or in ARGB mode (mcc > 0) the color itself
// from the record's inline words.  The range test is one unsigned compare,
// not a min/max pair (see "Rolled loops" above: no new three-input min/max).
__device__ __forceinline__ int texel_value(int color_off, int local,
                                           const int* colors, int mcc) {
  if (mcc == 0) return color_off + local;
  return static_cast<unsigned>(local) < static_cast<unsigned>(mcc)
             ? colors[local]
             : 0;
}

// The side span's perspective-correct color index at texel y (:519-533).
struct SideSpan {
  float rbf_lo, rbf_hi, uv_lo0, uv_lo1, uv_hi0, uv_hi1;
  int length, cidx, color_off, mcc;
  const int* colors;

  __device__ __forceinline__ int value(int y) const {
    const float l = (static_cast<float>(y) - rbf_lo) / (rbf_hi - rbf_lo);
    const float wu0 = uv_lo0 + (uv_hi0 - uv_lo0) * l;
    const float wu1 = uv_lo1 + (uv_hi1 - uv_lo1) * l;
    const float u = wu1 / wu0;
    const int iu = (u != u) ? 0 : cpuvox::to_i32(floorf(u));
    return texel_value(color_off, min(max(iu, 0), length - 1) + cidx, colors,
                       mcc);
  }
};

// ---------------------------------------------------------------- one thread
// a ray: its row in global memory, walked texel by texel

struct ThreadRow {
  int* row;
  int P;

  // first y >= c with row[y] unwritten (< 0), else BIG
  __device__ __forceinline__ int next_unwritten_geq(int c) {
    #pragma unroll 1  // see "Rolled loops" above
    for (int y = max(c, 0); y < P; ++y)
      if (row[y] < 0) return y;
    return kBig;
  }

  // last y <= c with row[y] unwritten, else -BIG
  __device__ __forceinline__ int prev_unwritten_leq(int c) {
    #pragma unroll 1  // see "Rolled loops" above
    for (int y = min(c, P - 1); y >= 0; --y)
      if (row[y] < 0) return y;
    return -kBig;
  }

  __device__ __forceinline__ bool write_side(int rb_min, int rb_max,
                                             const SideSpan& sp) {
    bool wrote = false;
    #pragma unroll 1  // see "Rolled loops" above
    for (int y = max(rb_min, 0), e = min(rb_max, P - 1); y <= e; ++y) {
      if (row[y] >= 0) continue;
      row[y] = sp.value(y);
      wrote = true;
    }
    return wrote;
  }

  __device__ __forceinline__ bool write_cap(int rb_min, int rb_max,
                                            int value) {
    bool wrote = false;
    #pragma unroll 1  // see "Rolled loops" above
    for (int y = max(rb_min, 0), e = min(rb_max, P - 1); y <= e; ++y) {
      if (row[y] < 0) {
        row[y] = value;
        wrote = true;
      }
    }
    return wrote;
  }
};

// the fetched cell's run words, (maxr,) int32
struct ThreadRuns {
  const int* runs;
  __device__ __forceinline__ int at(int kk) { return runs[kk]; }
};

// ---------------------------------------------------------------- a group of
// G lanes a ray (G = kGroup): the row's written-texel bitmask in shared
// memory

// The G lanes of one ray inside a warp.  Shuffles, scans and ballots name
// only the group's lanes, so the warp's groups need not run in step.
template <int G>
struct Group {
  int sl;       // lane within the group
  int base;     // the group's first lane in the warp
  unsigned gm;  // the group's lanes

  __device__ __forceinline__ explicit Group(int lane)
      : sl(lane % G), base(lane - lane % G) {
    if constexpr (G == 32) {
      gm = kFull;
    } else {
      gm = ((1u << G) - 1u) << base;
    }
  }

  __device__ __forceinline__ int shfl(int v, int src) const {
    return __shfl_sync(gm, v, src, G);
  }

  __device__ __forceinline__ float shfl(float v, int src) const {
    return __shfl_sync(gm, v, src, G);
  }

  __device__ __forceinline__ int sum(int x) const {
    #pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) x += __shfl_xor_sync(gm, x, d, G);
    return x;
  }

  // bit i = lane i of the group
  __device__ __forceinline__ unsigned ballot(bool p) const {
    if constexpr (G == 32) {
      return __ballot_sync(kFull, p);
    } else {
      return (__ballot_sync(gm, p) >> base) & ((1u << G) - 1u);
    }
  }

  // inclusive prefix sum over the group's lanes
  __device__ __forceinline__ int scan(int x) const {
    #pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int y = __shfl_up_sync(gm, x, d, G);
      if (sl >= d) x += y;
    }
    return x;
  }
};

template <int G>
struct GroupRow {
  static constexpr int kSteps = 32 / G;  // lane passes over a 32-texel word
  int* row;
  unsigned* mask;  // ceil(P/32) words; bit set = written or y >= P
  int P, nw;
  Group<G> g;
  bool ready;  // the mask has been built from the row

  // Bit y of word y >> 5 says row[y] >= 0; texels past P read as written,
  // so no scan returns them.  Four words an iteration keep their loads in
  // flight together.  Every lane of the group stores the (equal) word, so
  // each lane reads back its own store.
  __device__ __forceinline__ void ensure() {
    if (ready) return;
    ready = true;
    #pragma unroll 1  // see "Rolled loops" above
    for (int w = 0; w < nw; w += 4) {
      int v[4][kSteps];
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        #pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int y = ((w + j) << 5) + s * G + g.sl;
          v[j][s] = y < P ? row[y] : 0;
        }
      }
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned bits = 0;
        #pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int y = ((w + j) << 5) + s * G + g.sl;
          bits |= g.ballot(y >= P || v[j][s] >= 0) << (s * G);
        }
        if (w + j < nw) mask[w + j] = bits;
      }
    }
  }

  // first y >= c with y unwritten, else BIG: G mask words a step
  __device__ __forceinline__ int next_unwritten_geq(int c) {
    ensure();
    const int y0 = max(c, 0);
    if (y0 >= P) return kBig;
    const int w0 = y0 >> 5;
    #pragma unroll 1  // see "Rolled loops" above
    for (int b = w0; b < nw; b += G) {
      const int w = b + g.sl;
      unsigned free = w < nw ? ~mask[w] : 0u;
      if (w == w0) free &= kFull << (y0 & 31);
      const unsigned bal = g.ballot(free != 0u);
      if (bal) {
        const int src = __ffs(bal) - 1;
        const unsigned f = g.shfl(static_cast<int>(free), src);
        return ((b + src) << 5) + __ffs(f) - 1;
      }
    }
    return kBig;
  }

  // last y <= c with y unwritten, else -BIG
  __device__ __forceinline__ int prev_unwritten_leq(int c) {
    ensure();
    const int y0 = min(c, P - 1);
    if (y0 < 0) return -kBig;
    const int w0 = y0 >> 5;
    #pragma unroll 1  // see "Rolled loops" above
    for (int top = w0; top >= 0; top -= G) {
      const int w = top - g.sl;
      unsigned free = w >= 0 ? ~mask[w] : 0u;
      if (w == w0) free &= kFull >> (31 - (y0 & 31));
      const unsigned bal = g.ballot(free != 0u);
      if (bal) {
        const int src = __ffs(bal) - 1;
        const unsigned f = g.shfl(static_cast<int>(free), src);
        return ((top - src) << 5) + 31 - __clz(f);
      }
    }
    return -kBig;
  }

  // One pass over the span's mask words.  A word's texels to write are the
  // span's that are unwritten (`need`, the same in every lane); lane l takes
  // texel 32 w + G s + l in pass s, and passes with nothing to write are
  // skipped.
  template <class Value>
  __device__ __forceinline__ bool write(int rb_min, int rb_max,
                                        const Value& value) {
    ensure();
    const int ys = max(rb_min, 0), ye = min(rb_max, P - 1);
    bool wrote = false;
    #pragma unroll 1  // see "Rolled loops" above
    for (int w = ys >> 5; w <= (ye >> 5); ++w) {
      const int y0 = w << 5;
      unsigned span = kFull;  // the word's texels in [ys, ye]
      if (ys > y0) span &= kFull << (ys - y0);
      if (ye < y0 + 31) span &= kFull >> (y0 + 31 - ye);
      const unsigned m = mask[w];
      const unsigned need = span & ~m;
      if (!need) continue;
      #pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int i = s * G + g.sl;
        if ((need >> i) & 1u) row[y0 + i] = value(y0 + i);
      }
      mask[w] = m | need;
      wrote = true;
    }
    return wrote;
  }

  __device__ __forceinline__ bool write_side(int rb_min, int rb_max,
                                             const SideSpan& sp) {
    return write(rb_min, rb_max, [&](int y) { return sp.value(y); });
  }

  __device__ __forceinline__ bool write_cap(int rb_min, int rb_max,
                                            int value) {
    return write(rb_min, rb_max, [=](int) { return value; });
  }
};

// A cell's runs held across the group: lane l has runs l, l + G, l + 2G, ...
// (up to 64 runs: kBlocks registers) as int32 words [color index << 16 |
// length], read with one shuffle.  The record's words are loaded when the
// cell starts; a 16-bit packed record is unpacked the first time a run is
// read: the color index is the exclusive prefix sum of the solid lengths,
// one group scan a block, and for the reversed table total - before -
// length, as raymarch._fetch_columns computes it.  The split layout streams
// its flat run array G runs at a time.  Runs are read in order from 0, so
// the block in use is always r[0]: the next one moves down when a block is
// done.
template <int G>
struct GroupRuns {
  static constexpr int kBlocks = 64 / G;
  int r[kBlocks];
  const int* split;  // split layout: the column's first run, else null
  int fmt, maxr, n_rec, dir;
  Group<G> g;
  bool ready;

  __device__ __forceinline__ void unpack() {
    int len[kBlocks], sol[kBlocks], cum[kBlocks];
    int carry = 0;
    #pragma unroll
    for (int b = 0; b < kBlocks; ++b) {  // raw halves: air bit | length
      len[b] = r[b] & 0x7FFF;
      sol[b] = (r[b] & 0x8000) ? 0 : len[b];
      cum[b] = carry;
      if (b * G < maxr) {
        cum[b] = g.scan(sol[b]) + carry;
        carry = g.shfl(cum[b], G - 1);
      }
    }
    const int total = carry;
    #pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      const int before = cum[b] - sol[b];  // solid before run k
      const int x = dir > 0 ? before : total - before - len[b];
      const int word =
          (r[b] & 0x8000)
              ? static_cast<int>(0xFFFF0000u | static_cast<unsigned>(len[b]))
              : static_cast<int>((static_cast<unsigned>(x) << 16) |
                                 static_cast<unsigned>(len[b]));
      r[b] = b * G + g.sl < n_rec ? word : 0;  // past n_runs: 0
    }
  }

  __device__ __forceinline__ void prepare() {
    if (!ready) {
      ready = true;
      if (fmt == kPacked) unpack();
    }
  }

  // the next block of G runs into r[0]; `from` is its first run
  __device__ __forceinline__ void next(int from) {
    #pragma unroll
    for (int b = 0; b + 1 < kBlocks; ++b) r[b] = r[b + 1];
    if (fmt == kSplit)
      r[0] = from + g.sl < maxr ? __ldg(split + from + g.sl) : 0;
  }

  __device__ __forceinline__ int at(int kk) {
    prepare();
    if (kk > 0 && kk % G == 0) next(kk);
    return g.shfl(r[0], kk % G);
  }
};

// ReducePixelHorizon (DrawSegmentRayJob.cs:660-697) for one ray whose span
// overlaps its free range; narrows [rb_min, rb_max] to the writable part.
template <class Row>
__device__ __forceinline__ void reduce_pixel_horizon(RayState& s, Row& row,
                                                     int& rb_min,
                                                     int& rb_max) {
  const bool c1 = rb_min <= s.nfp_min;
  const int rb_min2 = c1 ? s.nfp_min : rb_min;
  const int nfp_max0 = s.nfp_max;
  if (c1 && rb_max >= s.nfp_min) {
    const int y = row.next_unwritten_geq(cpuvox::add_wrap(rb_max, 1));
    s.nfp_min = y;
    s.fb_min = static_cast<float>(y) - 0.501f;
  }
  const bool c2 = rb_max >= nfp_max0;
  const int rb_max2 = c2 ? nfp_max0 : rb_max;
  if (c2 && rb_min2 <= nfp_max0) {
    const int y = row.prev_unwritten_leq(cpuvox::add_wrap(rb_min2, -1));
    s.nfp_max = y;
    s.fb_max = static_cast<float>(y) + 0.501f;
  }
  rb_min = rb_min2;
  rb_max = rb_max2;
}

// After a span write: a write clears frustum narrowing (:522,598); a closed
// free range kills the ray (:535-539).
__device__ __forceinline__ void after_write(RayState& s, bool wrote) {
  if (wrote) s.f_active = false;
  if (s.nfp_min > s.nfp_max) s.alive = false;
}

struct Clip {
  bool clipped;
  float min_lerp, max_lerp;
};

// CameraData.GetWorldBoundsClippingCamSpace (CameraData.cs:51-121).
__device__ __forceinline__ Clip clip_world_bounds(F3 p_min, F3 p_max,
                                                  float fmin, float fmax) {
  const float finv_hi = 1.0f / fmax;
  const float c0_hi = p_max.x * finv_hi - p_max.z;
  const float c1_hi = p_min.x * finv_hi - p_min.z;
  const float min_at_fmax = 1.0f - (c0_hi / (c0_hi - c1_hi));
  const float max_at_fmax = c1_hi / (c1_hi - c0_hi);
  const float finv_lo = 1.0f / fmin;
  const float c0_lo = p_max.x * finv_lo - p_max.z;
  const float c1_lo = p_min.x * finv_lo - p_min.z;
  const float min_at_fmin = 1.0f - (c0_lo / (c0_lo - c1_lo));
  const float max_at_fmin = c1_lo / (c1_lo - c0_lo);
  const bool amin = p_min.x > p_min.z * fmax;  // min end above the max frustum
  const bool amax = p_max.x > p_max.z * fmax;
  const bool bmin = p_min.x < p_min.z * fmin;  // below the min frustum
  const bool bmax = p_max.x < p_max.z * fmin;
  Clip c;
  c.clipped = (amin && amax) || (!amin && !amax && bmin && bmax);
  c.min_lerp = amin ? min_at_fmax
                    : (amax ? (bmin ? min_at_fmin : 0.0f)
                            : ((bmin && !bmax) ? min_at_fmin : 0.0f));
  c.max_lerp = amin ? (bmax ? max_at_fmin : 1.0f)
                    : (amax ? max_at_fmax
                            : ((!bmin && bmax) ? max_at_fmin : 1.0f));
  return c;
}

struct Line {
  bool visible;
  F3 a, b;
  float u_a, u_b;
};

// CameraData.ClipHomogeneousCameraSpaceLine (:124-157), with the texture
// coordinate u carried along (the caps pass 0 and ignore it).
__device__ __forceinline__ Line near_clip_line(F3 a, F3 b, float u_a,
                                               float u_b) {
  const bool a_behind = a.y <= 0.0f;
  const bool b_behind = b.y <= 0.0f;
  const float v_a = b.y / (b.y - a.y);
  const float v_b = a.y / (a.y - b.y);
  const bool clip_a = a_behind && !b_behind;
  const bool clip_b = b_behind && !a_behind;
  Line l;
  l.visible = !(a_behind && b_behind);
  l.a = clip_a ? lerp3(b, a, v_a) : a;  // b + (a - b) * v_a
  l.b = clip_b ? lerp3(a, b, v_b) : b;  // a + (b - a) * v_b
  l.u_a = clip_a ? u_b + (u_a - u_b) * v_a : u_a;
  l.u_b = clip_b ? u_a + (u_b - u_a) * v_b : u_b;
  return l;
}

// What the run sweep of one cell reads: the projected column lines at both
// intersections, the cell's world-Y window, and its record's fields.
struct CellGeom {
  F3 min_last, max_last, min_next, max_next;
  float wb_min, wb_max;
  int lod, n_runs, color_off, mcc, maxr;
  const int* colors;
};

// A drawn run's side span (:477-542): the projected full-world lines lerped
// to the run's extent, near-clipped, and its texel range.
struct RunSide {
  float portion_bottom, portion_top;
  F3 front_bottom, front_top;
  SideSpan sp;
  int rb_min, rb_max;
  bool visible;
};

__device__ __forceinline__ RunSide run_side(const Consts& k,
                                            const CellGeom& c, float eb_min,
                                            float eb_max, int length,
                                            int cidx) {
  RunSide d;
  d.portion_bottom = eb_min / k.world_max_y;
  d.portion_top = eb_max / k.world_max_y;
  d.front_bottom = lerp3(c.min_last, c.max_last, d.portion_bottom);
  d.front_top = lerp3(c.min_last, c.max_last, d.portion_top);
  const Line side = near_clip_line(d.front_bottom, d.front_top,
                                   static_cast<float>(length), 0.0f);
  const float uva0 = 1.0f / side.a.z, uva1 = side.u_a / side.a.z;
  const float uvb0 = 1.0f / side.b.z, uvb1 = side.u_b / side.b.z;
  const float rbf_a = side.a.x / side.a.z;
  const float rbf_b = side.b.x / side.b.z;
  const bool flip = rbf_a > rbf_b;
  d.sp.rbf_lo = flip ? rbf_b : rbf_a;
  d.sp.rbf_hi = flip ? rbf_a : rbf_b;
  d.sp.uv_lo0 = flip ? uvb0 : uva0;
  d.sp.uv_lo1 = flip ? uvb1 : uva1;
  d.sp.uv_hi0 = flip ? uva0 : uvb0;
  d.sp.uv_hi1 = flip ? uva1 : uvb1;
  d.sp.length = length;
  d.sp.cidx = cidx;
  d.sp.color_off = c.color_off;
  d.sp.colors = c.colors;
  d.sp.mcc = c.mcc;
  d.rb_min = cpuvox::to_i32(rintf(d.sp.rbf_lo));
  d.rb_max = cpuvox::to_i32(rintf(d.sp.rbf_hi));
  d.visible = side.visible;
  return d;
}

// The run's top or bottom cap (:544-610), if it has a visible one.
struct RunCap {
  bool on;
  int rb_min, rb_max, value;
};

__device__ __forceinline__ RunCap run_cap(const Consts& k, const CellGeom& c,
                                          const RunSide& d, float eb_min,
                                          float eb_max, int length,
                                          int cidx) {
  RunCap cp{false, 0, 0, 0};
  const bool top_cap = d.portion_top < k.cam_y_norm;
  const bool bot_cap = !top_cap && d.portion_bottom > k.cam_y_norm;
  const bool skip_top = top_cap && eb_max > c.wb_max;
  const bool skip_bot = bot_cap && eb_min < c.wb_min;
  if (!((top_cap && !skip_top) || (bot_cap && !skip_bot))) return cp;
  cp.value = texel_value(c.color_off, top_cap ? cidx : cidx + length - 1,
                         c.colors, c.mcc);
  const float portion_cap = top_cap ? d.portion_top : d.portion_bottom;
  const Line cap = near_clip_line(
      lerp3(c.min_next, c.max_next, portion_cap),
      top_cap ? d.front_top : d.front_bottom, 0.0f, 0.0f);
  if (!cap.visible) return cp;
  const float r2a = rintf(cap.a.x / cap.a.z);
  const float r2b = rintf(cap.b.x / cap.b.z);
  cp.on = true;
  cp.rb_min = cpuvox::to_i32(cpuvox::min_nan(r2a, r2b));
  cp.rb_max = cpuvox::to_i32(cpuvox::max_nan(r2a, r2b));
  return cp;
}

// The serial RLE run iteration (:424-611): runs arrive ordered for the
// direction, `runs.at(kk)` gives the kk-th run word.
template <class Row, class Runs>
__device__ __forceinline__ void sweep_serial(RayState& s, Row& row,
                                             Runs& runs, const Consts& k,
                                             const CellGeom& c) {
  float eb_min = k.dir > 0 ? k.world_max_y : 0.0f;
  float eb_max = eb_min;
  bool run_done = false;
  for (int kk = 0; kk < c.maxr; ++kk) {
    // once a run is not valid no later one is (alive and run_done are
    // monotone), so the loop stops there
    if (!(s.alive && kk < c.n_runs && !run_done)) break;
    const int run = runs.at(kk);
    const int length = run & 0xFFFF;
    const int cidx = run >> 16;  // arithmetic: air runs are negative
    const bool is_air = run < 0;
    const float len_scaled = static_cast<float>(length * (1 << c.lod));
    if (k.dir > 0) {
      eb_max = eb_min;
      eb_min = eb_min - len_scaled;
    } else {
      eb_min = eb_max;
      eb_max = eb_min + len_scaled;
    }
    const bool above = eb_min > c.wb_max;
    const bool below = eb_max < c.wb_min;
    if (!is_air && (k.dir > 0 ? below : above)) run_done = true;
    if (is_air || above || below) continue;  // nothing to draw

    const RunSide d = run_side(k, c, eb_min, eb_max, length, cidx);
    if (d.visible && d.rb_max >= s.nfp_min && d.rb_min <= s.nfp_max) {
      int rb_min = d.rb_min, rb_max = d.rb_max;
      reduce_pixel_horizon(s, row, rb_min, rb_max);
      after_write(s, row.write_side(rb_min, rb_max, d.sp));
    }
    if (!s.alive) continue;
    const RunCap cp = run_cap(k, c, d, eb_min, eb_max, length, cidx);
    if (cp.on && cp.rb_max >= s.nfp_min && cp.rb_min <= s.nfp_max) {
      int rb_min = cp.rb_min, rb_max = cp.rb_max;
      reduce_pixel_horizon(s, row, rb_min, rb_max);
      after_write(s, row.write_cap(rb_min, rb_max, cp.value));
    }
  }
}

// The previous design's runs: the serial loop.
template <class Row>
__device__ __forceinline__ void sweep(RayState& s, Row& row, ThreadRuns& runs,
                                      const Consts& k, const CellGeom& c) {
  sweep_serial(s, row, runs, k, c);
}

// A group's runs.  In a world of more than kSerialRuns runs a column, a
// cell is swept in parallel: each lane works out its own run's extent and
// draw geometry, G runs at a time, and the group then draws the runs that
// draw, in order.
// Only the draws (the frontier scans and the span writes) depend on the
// ray's state, so only they stay serial.  A run's extent is the prefix sum
// of the run heights (length << lod, integers): summed in int32 it equals
// the serial loop's float sums exactly while every partial sum and
// world_max_y are integers below 2^23, which is checked per cell.  Shallow
// worlds, cells that fail the check and the split layout's streamed runs
// take the serial loop.
template <class Row, int G>
__device__ __forceinline__ void sweep(RayState& s, Row& row,
                                      GroupRuns<G>& runs, const Consts& k,
                                      const CellGeom& c) {
  const Group<G>& g = runs.g;
  const float wmy = k.world_max_y;
  bool exact = c.maxr > kSerialRuns && runs.fmt != kSplit && c.lod >= 0 &&
               c.lod <= 8 && wmy == floorf(wmy) && fabsf(wmy) <= 8388608.0f;
  if (exact) {
    runs.prepare();
    int sum = 0;  // every height is below 2^24 (lod <= 8): no overflow
    #pragma unroll
    for (int b = 0; b < GroupRuns<G>::kBlocks; ++b)
      if (b * G + g.sl < c.n_runs) sum += (runs.r[b] & 0xFFFF) << c.lod;
    exact = g.sum(sum) <= (1 << 23);
  }
  if (!exact) {
    sweep_serial(s, row, runs, k, c);
    return;
  }
  const int wmy_i = static_cast<int>(wmy);
  int carry = 0;  // the heights of the earlier blocks
  #pragma unroll 1
  for (int b = 0; b * G < c.n_runs; ++b) {
    if (!s.alive) return;
    const int run = runs.r[0];
    runs.next((b + 1) * G);
    const int kr = b * G + g.sl;
    const int length = run & 0xFFFF;
    const int cidx = run >> 16;  // arithmetic: air runs are negative
    const bool is_air = run < 0;
    const bool in_cell = kr < c.n_runs;
    const int height = in_cell ? length << c.lod : 0;
    const int incl = g.scan(height) + carry;
    carry = g.shfl(incl, G - 1);
    const int excl = incl - height;
    const float eb_min = static_cast<float>(k.dir > 0 ? wmy_i - incl : excl);
    const float eb_max = static_cast<float>(k.dir > 0 ? wmy_i - excl : incl);
    const bool above = eb_min > c.wb_max;
    const bool below = eb_max < c.wb_min;
    // the serial loop stops after the first solid run past the window
    const unsigned stops =
        g.ballot(in_cell && !is_air && (k.dir > 0 ? below : above));
    unsigned draws = g.ballot(in_cell && !is_air && !above && !below);
    if (stops) draws &= (1u << (__ffs(stops) - 1)) - 1u;
    if (draws) {
      const RunSide d = run_side(k, c, eb_min, eb_max, length, cidx);
      const RunCap cp = run_cap(k, c, d, eb_min, eb_max, length, cidx);
      #pragma unroll 1
      while (draws && s.alive) {
        const int j = __ffs(draws) - 1;
        draws &= draws - 1;
        int rb_min = g.shfl(d.rb_min, j), rb_max = g.shfl(d.rb_max, j);
        if (g.shfl(static_cast<int>(d.visible), j) && rb_max >= s.nfp_min &&
            rb_min <= s.nfp_max) {
          SideSpan sp = d.sp;
          sp.rbf_lo = g.shfl(d.sp.rbf_lo, j);
          sp.rbf_hi = g.shfl(d.sp.rbf_hi, j);
          sp.uv_lo0 = g.shfl(d.sp.uv_lo0, j);
          sp.uv_lo1 = g.shfl(d.sp.uv_lo1, j);
          sp.uv_hi0 = g.shfl(d.sp.uv_hi0, j);
          sp.uv_hi1 = g.shfl(d.sp.uv_hi1, j);
          sp.length = g.shfl(length, j);
          sp.cidx = g.shfl(cidx, j);
          reduce_pixel_horizon(s, row, rb_min, rb_max);
          after_write(s, row.write_side(rb_min, rb_max, sp));
        }
        if (!s.alive || !g.shfl(static_cast<int>(cp.on), j)) continue;
        rb_min = g.shfl(cp.rb_min, j);
        rb_max = g.shfl(cp.rb_max, j);
        if (rb_max >= s.nfp_min && rb_min <= s.nfp_max) {
          reduce_pixel_horizon(s, row, rb_min, rb_max);
          after_write(s, row.write_cap(rb_min, rb_max, g.shfl(cp.value, j)));
        }
      }
    }
    if (stops) return;
  }
}

// One valid cell for one ray (the body of ExecuteRay:245-611); `row` scans
// and writes the ray's raybuffer row, `sweep` draws the column's runs.
template <class Row, class Runs>
__device__ __forceinline__ void rasterize_cell(
    RayState& s, Row& row, Runs& runs, const Consts k, float ids0, float ids1,
    int lod, int n_runs, int color_off, int cmin, int cmax, int maxr,
    const int* colors, int mcc, F3 pb, F3 pt, F3 pd) {
  const float wmy = k.world_max_y;
  bool alive = s.alive;

  // ---- frustum-vs-column cull (:258-281)
  const float dist_top = s.fdir_max > 0.0f ? ids1 : ids0;
  const float dist_bot = s.fdir_min < 0.0f ? ids1 : ids0;
  const float new_max = k.cam_y + s.fdir_max * dist_top;
  const float new_min = k.cam_y + s.fdir_min * dist_bot;
  const bool f_act = s.f_active;
  if (alive && n_runs > 0 && f_act && (new_min > wmy || new_max < 0.0f))
    alive = false;
  if (k.has_solid && alive && f_act &&
      ((s.fdir_min >= 0.0f && new_min > k.solid_max_y) ||
       (s.fdir_max <= 0.0f && new_max < k.solid_min_y)))
    alive = false;  // solid-bound kill (output-exact, see the reference)
  const bool skip_col = f_act && (static_cast<float>(cmin) > new_max ||
                                  static_cast<float>(cmax) < new_min);
  float wb_min = f_act ? new_min : 0.0f;
  float wb_max = f_act ? new_max : wmy;
  bool process = alive && !skip_col && n_runs > 0;

  // ---- project the world column at both intersections (:289-293)
  const F3 cs_min_last = along(pb, pd, ids0);
  const F3 cs_min_next = along(pb, pd, ids1);
  const F3 cs_max_last = along(pt, pd, ids0);
  const F3 cs_max_next = along(pt, pd, ids1);

  // ---- writable-frustum re-clip when dirty (:295-422)
  bool do_clip = process && ids0 > 2.0f && !f_act;
  const Clip cl = clip_world_bounds(cs_min_last, cs_max_last, s.fb_min,
                                    s.fb_max);
  const Clip cn = clip_world_bounds(cs_min_next, cs_max_next, s.fb_min,
                                    s.fb_max);
  if (do_clip && cl.clipped && cn.clipped) {
    alive = false;
    process = false;
    do_clip = false;
  }
  const bool case_l = cl.clipped;
  const bool case_n = !cl.clipped && cn.clipped;
  const float sel_min_lerp =
      case_l ? cn.min_lerp
             : (case_n ? cl.min_lerp
                       : cpuvox::min_nan(cl.min_lerp, cn.min_lerp));
  const float sel_max_lerp =
      case_l ? cn.max_lerp
             : (case_n ? cl.max_lerp
                       : cpuvox::max_nan(cl.max_lerp, cn.max_lerp));
  const float wbc_min = wmy * sel_min_lerp;
  const float wbc_max = wmy * sel_max_lerp;
  const float dist_for_min =
      case_l ? ids1
             : (case_n ? ids0 : (cl.min_lerp < cn.min_lerp ? ids0 : ids1));
  const float dist_for_max =
      case_l ? ids1
             : (case_n ? ids0 : (cl.max_lerp > cn.max_lerp ? ids0 : ids1));
  const float fdir_min_new = (wbc_min - k.cam_y) / dist_for_min;
  const float fdir_max_new = (wbc_max - k.cam_y) / dist_for_max;

  // screen x of the column line at lerp t (the camSpaceClippedMin/Max dance)
  const F3 l_min = lerp3(cs_min_last, cs_max_last, cl.min_lerp);
  const F3 l_max = lerp3(cs_min_last, cs_max_last, cl.max_lerp);
  const F3 n_min = lerp3(cs_min_next, cs_max_next, cn.min_lerp);
  const F3 n_max = lerp3(cs_min_next, cs_max_next, cn.max_lerp);
  const float l_min_x = l_min.x / l_min.z, l_max_x = l_max.x / l_max.z;
  const float n_min_x = n_min.x / n_min.z, n_max_x = n_max.x / n_max.z;
  const float l_lo = cpuvox::min_nan(l_min_x, l_max_x);
  const float l_hi = cpuvox::max_nan(l_min_x, l_max_x);
  const float n_lo = cpuvox::min_nan(n_min_x, n_max_x);
  const float n_hi = cpuvox::max_nan(n_min_x, n_max_x);
  const float cs_clip_min =
      case_l ? n_lo : (case_n ? l_lo : cpuvox::min_nan(l_lo, n_lo));
  const float cs_clip_max =
      case_l ? n_hi : (case_n ? l_hi : cpuvox::max_nan(l_hi, n_hi));

  if (do_clip) {
    wb_min = floorf(wbc_min);
    wb_max = ceilf(wbc_max);
  }
  const float fdir_min_st = do_clip ? fdir_min_new : s.fdir_min;
  const float fdir_max_st = do_clip ? fdir_max_new : s.fdir_max;
  const bool f_active_new = s.f_active || do_clip;

  const int writable_min = cpuvox::to_i32(floorf(cs_clip_min));
  const int writable_max = cpuvox::to_i32(ceilf(cs_clip_max));
  if (do_clip && (writable_max < s.nfp_min || writable_min > s.nfp_max)) {
    alive = false;
    process = false;
    do_clip = false;
  }
  int nfp_min2 = s.nfp_min, nfp_max2 = s.nfp_max;
  if (do_clip && writable_min > s.nfp_min)
    nfp_min2 = row.next_unwritten_geq(writable_min);
  if (do_clip && writable_max < s.nfp_max)
    nfp_max2 = row.prev_unwritten_leq(writable_max);
  if (do_clip && nfp_min2 > nfp_max2) {
    alive = false;
    process = false;
  }
  s.nfp_min = nfp_min2;
  s.nfp_max = nfp_max2;
  s.fdir_min = fdir_min_st;
  s.fdir_max = fdir_max_st;
  s.f_active = f_active_new;
  s.alive = alive;

  // ---- RLE run iteration (:424-611)
  if (!process) return;
  const CellGeom c{cs_min_last, cs_max_last, cs_min_next, cs_max_next,
                   wb_min,      wb_max,      lod,         n_runs,
                   color_off,   mcc,         maxr,        colors};
  sweep(s, row, runs, k, c);
}

struct StatePtrs {
  int* nfp_min;
  int* nfp_max;
  float* fb_min;
  float* fb_max;
  uint8_t* f_active;
  float* fdir_min;
  float* fdir_max;
  uint8_t* alive;
  const float* plane_bottom;
  const float* plane_top;
  const float* plane_dir;

  __device__ __forceinline__ RayState load(int r) const {
    RayState s;
    s.nfp_min = nfp_min[r];
    s.nfp_max = nfp_max[r];
    s.fb_min = fb_min[r];
    s.fb_max = fb_max[r];
    s.f_active = f_active[r] != 0;
    s.fdir_min = fdir_min[r];
    s.fdir_max = fdir_max[r];
    s.alive = alive[r] != 0;
    return s;
  }

  __device__ __forceinline__ void store(int r, const RayState& s) const {
    nfp_min[r] = s.nfp_min;
    nfp_max[r] = s.nfp_max;
    fb_min[r] = s.fb_min;
    fb_max[r] = s.fb_max;
    f_active[r] = s.f_active ? 1 : 0;
    fdir_min[r] = s.fdir_min;
    fdir_max[r] = s.fdir_max;
    alive[r] = s.alive ? 1 : 0;
  }

  __device__ __forceinline__ F3 plane(const float* p, int r) const {
    return {p[3 * r], p[3 * r + 1], p[3 * r + 2]};
  }
};

// ---------------------------------------------------------------- the PR-3
// kernel: one thread a ray, cells fetched by torch

__global__ void rasterize_chunk_kernel(
    int* __restrict__ raybuf, const StatePtrs st, const float* __restrict__ ids,
    const int* __restrict__ lod, const uint8_t* __restrict__ valid,
    const int* __restrict__ n_runs, const int* __restrict__ color_off,
    const int* __restrict__ cmin, const int* __restrict__ cmax,
    const int* __restrict__ runs, const int* __restrict__ colors,
    const Consts k, int C, int maxr, int mcc, const int* __restrict__ index,
    int Rk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Rk) return;
  const int r = index ? index[t] : t;
  RayState s = st.load(r);
  const F3 pb = st.plane(st.plane_bottom, r);
  const F3 pt = st.plane(st.plane_top, r);
  const F3 pd = st.plane(st.plane_dir, r);
  ThreadRow row{raybuf + static_cast<size_t>(r) * k.P, k.P};
  for (int c = 0; c < C; ++c) {
    const size_t i = static_cast<size_t>(c) * Rk + t;
    if (!valid[i]) continue;  // not this ray's cell: an exact no-op
    ThreadRuns rr{runs + i * maxr};
    rasterize_cell(s, row, rr, k, ids[2 * i], ids[2 * i + 1], lod[i],
                   n_runs[i], color_off[i], cmin[i], cmax[i], maxr,
                   mcc ? colors + i * mcc : nullptr, mcc, pb, pt, pd);
  }
  st.store(r, s);
}

// ---------------------------------------------------------------- the group
// kernel: kGroup lanes a ray, the column record read inside

struct World {
  const int* rec;       // inline: (n_cols, rw) records of the direction;
                        // split: (n_cols, 8) meta rows
  const int* runs;      // split: the flat run array of the direction
  const int* col_base;  // (8,) first column of each LOD
  const int* grid_z;    // (8,) columns per x-row of each LOD
  int rw, fmt, maxr, mcc;
  int rwords;  // inline: the run region's words; the colors follow
};

struct CellSrc {
  const int* visits;     // layout (a): (C, 13, Rk) roll visits, or null
  const int* packed;     // layout (b): (C, Rk, 4) [ci, ids0, ids1, lod]
  const uint8_t* proc;   // layout (b): (C, Rk)
  int C;
};

// A camera height a ray (a batch of cameras in one march), read by the
// ray's slot like its state: cam_y and cam_y / world_max_y (an f32 divide
// made by the caller, as the reference makes it).  Null pointers leave the
// launch's scalars in Consts, as a single camera's frame passes them.
struct RayCamY {
  const float* cam_y;
  const float* cam_y_norm;
};

template <int G>
__global__ void __launch_bounds__(kThreads) rasterize_visits_kernel(
    int* __restrict__ raybuf, const StatePtrs st, const CellSrc cs,
    const World w, const Consts k0, const RayCamY cy,
    const int* __restrict__ index, int Rk) {
  extern __shared__ unsigned masks[];
  const Group<G> g(threadIdx.x & 31);
  const int rib = threadIdx.x / G;  // the block's ray
  const int t = blockIdx.x * (kThreads / G) + rib;
  if (t >= Rk) return;  // the whole group: t is the group's
  const int r = index ? index[t] : t;
  RayState s = st.load(r);
  if (!s.alive) return;  // a dead ray's cells are all exact no-ops
  Consts k = k0;
  if (cy.cam_y != nullptr) {
    k.cam_y = __ldg(cy.cam_y + r);
    k.cam_y_norm = __ldg(cy.cam_y_norm + r);
  }
  const F3 pb = st.plane(st.plane_bottom, r);
  const F3 pt = st.plane(st.plane_top, r);
  const F3 pd = st.plane(st.plane_dir, r);
  const int nw = (k.P + 31) >> 5;
  GroupRow<G> row{raybuf + static_cast<size_t>(r) * k.P, masks + rib * nw,
                  k.P, nw, g, false};

  #pragma unroll 1
  for (int cb = 0; cb < cs.C; cb += G) {
    // lane j reads cell cb + j's visit fields and its record's meta words
    const int cj = cb + g.sl;
    bool v_valid = false;
    int v_ci = 0, v_lod = 0, v_i0 = 0, v_i1 = 0;
    if (cj < cs.C) {
      if (cs.visits) {
        const int* v = cs.visits + static_cast<size_t>(cj) * 13 * Rk + t;
        const int x = __ldg(v), z = __ldg(v + Rk);
        v_i0 = __ldg(v + 2 * Rk);
        v_i1 = __ldg(v + 3 * Rk);
        v_lod = __ldg(v + 4 * Rk);
        v_valid = __ldg(v + 5 * Rk) != 0;
        if (v_valid) {  // raymarch._cell_index (lod clamped for the tables)
          const int lc = v_lod < 0 ? 0 : (v_lod > 7 ? 7 : v_lod);
          v_ci = __ldg(w.col_base + lc) + (x >> v_lod) * __ldg(w.grid_z + lc) +
                 (z >> v_lod);
        }
      } else {
        const size_t i = static_cast<size_t>(cj) * Rk + t;
        const int4 p = __ldg(reinterpret_cast<const int4*>(cs.packed) + i);
        v_ci = p.x;
        v_i0 = p.y;
        v_i1 = p.z;
        v_lod = p.w;
        v_valid = __ldg(cs.proc + i) != 0;
      }
    }
    int m_n = 0, m_off = 0, m_color = 0, m_cmin = 0, m_cmax = 0;
    if (v_valid) {
      const int* row_rec = w.rec + static_cast<size_t>(v_ci) * w.rw;
      const int4 m = __ldg(reinterpret_cast<const int4*>(row_rec));
      m_n = m.x;
      if (w.fmt == kSplit) {  // [n_runs, run_off, color_off, cmin, cmax, ..]
        m_off = m.y;
        m_color = m.z;
        m_cmin = m.w;
        m_cmax = __ldg(row_rec + 4);
      } else {  // [n_runs, color_off, cmin, cmax, runs..., colors...]
        m_color = m.y;
        m_cmin = m.z;
        m_cmax = m.w;
      }
    }
    const int n_here = min(G, cs.C - cb);
    #pragma unroll 1
    for (int j = 0; j < n_here; ++j) {
      if (!s.alive) break;  // a dead ray's remaining cells are no-ops
      if (!g.shfl(static_cast<int>(v_valid), j)) continue;
      const int ci = g.shfl(v_ci, j);
      const int lod = g.shfl(v_lod, j);
      const float ids0 = __int_as_float(g.shfl(v_i0, j));
      const float ids1 = __int_as_float(g.shfl(v_i1, j));
      const int n_runs = g.shfl(m_n, j);
      const int color_off = g.shfl(m_color, j);
      const int cmin = g.shfl(m_cmin, j);
      const int cmax = g.shfl(m_cmax, j);
      const int* row_rec = w.rec + static_cast<size_t>(ci) * w.rw;
      // the cell's run words, read now, used after the geometry
      GroupRuns<G> rr{{}, nullptr, w.fmt, w.maxr, n_runs, k.dir, g, false};
      if (w.fmt == kSplit) {
        rr.split = w.runs + g.shfl(m_off, j);
        rr.r[0] = g.sl < w.maxr ? __ldg(rr.split + g.sl) : 0;
      } else {
        #pragma unroll
        for (int b = 0; b < GroupRuns<G>::kBlocks; ++b) {
          const int kr = b * G + g.sl;
          if (kr >= w.maxr) continue;
          if (w.fmt == kInline32) {
            rr.r[b] = __ldg(row_rec + kRecMeta + kr);
          } else {  // 16-bit halves, two a word, low half first
            const unsigned word = static_cast<unsigned>(
                __ldg(row_rec + kRecMeta + (kr >> 1)));
            rr.r[b] = static_cast<int>((word >> ((kr & 1) << 4)) & 0xFFFFu);
          }
        }
      }
      rasterize_cell(s, row, rr, k, ids0, ids1, lod, n_runs, color_off, cmin,
                     cmax, w.maxr,
                     w.mcc ? row_rec + kRecMeta + w.rwords : nullptr, w.mcc,
                     pb, pt, pd);
    }
  }
  if (g.sl == 0) st.store(r, s);
}

Consts make_consts(float world_max_y, float cam_y, float cam_y_norm,
                   int has_solid, float solid_min_y, float solid_max_y,
                   int dir, int P) {
  return Consts{world_max_y, cam_y, cam_y_norm, has_solid, solid_min_y,
                solid_max_y, dir, P};
}

StatePtrs make_state(void* nfp_min, void* nfp_max, void* fb_min, void* fb_max,
                     void* f_active, void* fdir_min, void* fdir_max,
                     void* alive, void* plane_bottom, void* plane_top,
                     void* plane_dir) {
  return StatePtrs{static_cast<int*>(nfp_min),
                   static_cast<int*>(nfp_max),
                   static_cast<float*>(fb_min),
                   static_cast<float*>(fb_max),
                   static_cast<uint8_t*>(f_active),
                   static_cast<float*>(fdir_min),
                   static_cast<float*>(fdir_max),
                   static_cast<uint8_t*>(alive),
                   static_cast<const float*>(plane_bottom),
                   static_cast<const float*>(plane_top),
                   static_cast<const float*>(plane_dir)};
}

}  // namespace

extern "C" int cpuvox_rasterize_chunk(
    void* raybuf, void* nfp_min, void* nfp_max, void* fb_min, void* fb_max,
    void* f_active, void* fdir_min, void* fdir_max, void* alive, void* ids,
    void* lod, void* valid, void* n_runs, void* color_off, void* cmin,
    void* cmax, void* runs, void* colors, void* plane_bottom, void* plane_top,
    void* plane_dir, float world_max_y, float cam_y, float cam_y_norm,
    int has_solid, float solid_min_y, float solid_max_y, int dir, int C,
    int maxr, int mcc, void* index, int Rk, int P, void* stream) {
  if (Rk > 0 && C > 0) {
    const int threads = 128;
    rasterize_chunk_kernel<<<(Rk + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(raybuf),
        make_state(nfp_min, nfp_max, fb_min, fb_max, f_active, fdir_min,
                   fdir_max, alive, plane_bottom, plane_top, plane_dir),
        static_cast<const float*>(ids), static_cast<const int*>(lod),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(n_runs),
        static_cast<const int*>(color_off), static_cast<const int*>(cmin),
        static_cast<const int*>(cmax), static_cast<const int*>(runs),
        static_cast<const int*>(colors),
        make_consts(world_max_y, cam_y, cam_y_norm, has_solid, solid_min_y,
                    solid_max_y, dir, P),
        C, maxr, mcc, static_cast<const int*>(index), Rk);
  }
  return static_cast<int>(cudaGetLastError());
}

// visits: layout (a), or null and packed + proc: layout (b).  rec/rw/fmt:
// the record table of the direction; runs: the split layout's flat run
// array of the direction (else null); rwords: the inline run region's words;
// cam_y_ray / cam_y_norm_ray: (R,) f32 a ray, or null for the scalars.
extern "C" int cpuvox_rasterize_visits(
    void* raybuf, void* nfp_min, void* nfp_max, void* fb_min, void* fb_max,
    void* f_active, void* fdir_min, void* fdir_max, void* alive,
    void* plane_bottom, void* plane_top, void* plane_dir, void* visits,
    void* packed, void* proc, int C, void* rec, int rw, int fmt, void* runs,
    int maxr, int rwords, int mcc, void* col_base, void* grid_z,
    float world_max_y, float cam_y, float cam_y_norm, int has_solid,
    float solid_min_y, float solid_max_y, int dir, void* cam_y_ray,
    void* cam_y_norm_ray, void* index, int Rk, int P, void* stream) {
  if (Rk > 0 && C > 0) {
    const World w{static_cast<const int*>(rec), static_cast<const int*>(runs),
                  static_cast<const int*>(col_base),
                  static_cast<const int*>(grid_z), rw, fmt, maxr, mcc,
                  rwords};
    const CellSrc cs{static_cast<const int*>(visits),
                     static_cast<const int*>(packed),
                     static_cast<const uint8_t*>(proc), C};
    constexpr int rays = kThreads / kGroup;  // a block's
    const size_t smem = sizeof(unsigned) * rays * ((P + 31) / 32);
    rasterize_visits_kernel<kGroup>
        <<<(Rk + rays - 1) / rays, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(raybuf),
        make_state(nfp_min, nfp_max, fb_min, fb_max, f_active, fdir_min,
                   fdir_max, alive, plane_bottom, plane_top, plane_dir),
        cs, w,
        make_consts(world_max_y, cam_y, cam_y_norm, has_solid, solid_min_y,
                    solid_max_y, dir, P),
        RayCamY{static_cast<const float*>(cam_y_ray),
                static_cast<const float*>(cam_y_norm_ray)},
        static_cast<const int*>(index), Rk);
  }
  return static_cast<int>(cudaGetLastError());
}
