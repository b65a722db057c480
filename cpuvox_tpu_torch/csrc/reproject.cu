// Phase 2 in one kernel: the screen from the raybuffer.
//
// Replaces cpuvox_tpu/ops/reproject_kernel.py::sample_raybuffer and the XLA
// steps around it in the reference's frame (reproject.segment_ray_index,
// raymarch.resolve_colors, the nearest upscale of frame.py:117-123).  The
// plain version is cpuvox_tpu_torch.ops.reproject_kernel.reproject_screen_ref,
// which runs those steps in eager torch, some 200 launches a frame; this is
// one launch, bit-equal to it.
//
// Per output pixel (X, Y) of the (H, W) screen: the render pixel
// (sx, sy) = ((X * rw) / W, (Y * rh) / H) (the identity at native size);
// its segment and raybuffer row from the per-segment tables, in the
// reference's float order; the raybuffer texel rb[clamp(row), t] with
// t = sy for the top/down segments 0/1 and t = sx for the left/right
// segments 2/3; in index mode (colors given) -1 becomes magenta and any
// other value colors[clamp(v, 0, n - 1)].  With no segment active every
// pixel is `skybox`, resolved the same way.
//
// What bounds it on the H100: bytes, in principle.  Per render pixel one
// raybuffer texel and in index mode one color word are read, per output
// pixel 4 B written: at 1080p about 17-25 MB, 5-7.5 us at 3.35 TB/s.  The
// index math (a few correctly rounded divisions a pixel) and the two
// dependent gathers (the texel, then its color) come on top of that;
// bench/phase2_variants.py times the kernel without each, to split a
// launch between them (PERF.md).  The design:
//  - the tables ride in the kernel's parameters (a struct by value), so
//    nothing is copied to the card and nothing waits for the host; the
//    per-segment edge vectors and determinants are worked out once a
//    thread, the upscale's integer divisions once a lane and row (none at
//    native size);
//  - the segment scan skips inactive segments and stops at the first that
//    contains the pixel, which is exact (see pixel_code): where one segment
//    covers the screen (the first half of the benchmark path), a pixel
//    costs three correctly rounded divisions, not nine;
//  - a block works on a 32 x 32 tile of the screen.  First every pixel's
//    (family, row) is computed with lanes along x into shared memory.  Then
//    the gathers: a left/right pixel reads texel sx, so lanes along x read
//    neighbouring texels of mostly one row; a top/down pixel reads texel
//    sy, so its gather runs with lanes along y (the tile read transposed,
//    conflict-free at a row pitch of 33 words), again neighbouring texels
//    of mostly one row.  The two-pass kernel it replaces got the same
//    coalescing by transposing the maps through device memory;
//  - the resolve and the write run with lanes along x, one coalesced row
//    of the tile at a time.
// reproject_screens_kernel is the same tile for a batch of cameras whose
// rays are consecutive blocks of one raybuffer (parallel/batch.py): the
// camera is the grid's z axis, and its tables come from a (B, 36)-word
// array on the device (one copy a batch) into shared memory, in place of
// the by-value struct.  At the rollout's 256x256 a camera is 64 tiles, too
// few to fill the card, so one launch for all of them spares B - 1
// launches.
//
// Bit-exactness: built with -fmad=false (each product rounded, as torch
// rounds each op); divisions are IEEE divisions; min/max propagate NaN
// (common.cuh) as torch.minimum/maximum do; f32 -> i32 through
// cpuvox::to_i32 (saturating, NaN -> 0).

#include <math_constants.h>

#include "common.cuh"

// render/reproject.py::reproject_tables: vp (a), the max corner (b), the
// min corner (c) of each segment's screen triangle, its ray count, its
// first row in the raybuffer and whether it has rays.
struct SegmentTables {
  float ax[4], ay[4], bx[4], by[4], cx[4], cy[4];
  int ray_count[4], ray_base[4], active[4];
};

namespace {

constexpr int kTile = 32;  // a block's tile is kTile x kTile output pixels
constexpr int kRows = 8;   // blockDim.y: a thread works on kTile / kRows rows
constexpr int kMagenta = static_cast<int>(0xFFFF1493u);  // unwritten texel
constexpr int kNone = INT_MIN;  // a tile pixel with no texel to read
// Diagnostics for bench/phase2_variants.py, 1 on every path: kIndexMath 0
// puts a fixed map in place of the index math (the left half of the screen
// left/right pixels on render row y, the right half top/down pixels on
// render row x), kGather 0 skips the raybuffer reads (a pixel resolves its
// own code).  Neither gives the right screen.
constexpr int kIndexMath = 1;
constexpr int kGather = 1;

// A segment's edge vectors from the vanishing point and their determinant,
// as render/reproject.py::segment_ray_index computes them (a zero
// determinant becomes 1e-30).  Per frame, not per pixel.
struct SegmentBasis {
  float ax, ay, v0x, v0y, v1x, v1y, den;
};

__device__ __forceinline__ SegmentBasis segment_basis(const SegmentTables& t,
                                                      int s) {
  SegmentBasis b;
  b.ax = t.ax[s];
  b.ay = t.ay[s];
  b.v0x = t.bx[s] - t.ax[s];
  b.v0y = t.by[s] - t.ay[s];
  b.v1x = t.cx[s] - t.ax[s];
  b.v1y = t.cy[s] - t.ay[s];
  const float den = b.v0x * b.v1y - b.v1x * b.v0y;
  b.den = den == 0.0f ? 1e-30f : den;
  return b;
}

// The pixel center's weights of the max corner (bm) and the min corner (bn)
__device__ __forceinline__ void barycentric(const SegmentBasis& b, float px,
                                            float py, float& bm, float& bn) {
  const float v2x = px - b.ax, v2y = py - b.ay;
  bm = (v2x * b.v1y - b.v1x * v2y) / b.den;
  bn = (b.v0x * v2y - v2x * b.v0y) / b.den;
}

// The render pixel's segment family and raybuffer row, as
// render/reproject.py::segment_ray_index and the sample's clamp compute
// them: the row (>= 0) for the left/right segments, ~row (< 0) for the
// top/down ones.  The reference scores all four segments, takes the first
// whose score is >= 0 (the pixel lies inside it), else the first of the
// highest scores.  An inactive segment scores -inf, which changes neither
// choice, so it is skipped; and once a segment contains the pixel no later
// one can change the choice, so the scan stops there: a pixel of the
// first active segment costs two divisions, not eight.
__device__ __forceinline__ int pixel_code(const SegmentTables& t,
                                          const SegmentBasis (&sb)[4], int sx,
                                          int sy, int R) {
  const float px = static_cast<float>(sx) + 0.5f;
  const float py = static_cast<float>(sy) + 0.5f;
  int seg = -1;
  float bm = 0.0f, bn = 0.0f;
  float best_score = -CUDART_INF_F, best_bm = 0.0f, best_bn = 0.0f;
  int best_id = 0;
  bool have_best = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (seg < 0 && t.active[s]) {
      float m, n;
      barycentric(sb[s], px, py, m, n);
      const float b_vp = (1.0f - m) - n;
      const float score = cpuvox::min_nan(cpuvox::min_nan(b_vp, m), n);
      if (score >= 0.0f) {  // the first container wins
        seg = s;
        bm = m;
        bn = n;
      } else {
        if (score > best_score) {  // strict: the first of equal maxima
          best_id = s;
          best_bm = m;
          best_bn = n;
          have_best = true;
        }
        best_score = cpuvox::max_nan(best_score, score);
      }
    }
  }
  if (seg < 0) {
    seg = best_id;
    if (have_best) {
      bm = best_bm;
      bn = best_bn;
    } else {  // no score above -inf: segment 0, active or not
      barycentric(sb[0], px, py, bm, bn);
    }
  }
  int rc = t.ray_count[0], base = t.ray_base[0];
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    if (seg == s) {
      rc = t.ray_count[s];
      base = t.ray_base[s];
    }
  }
  const float denom = bm + bn;
  const float x = denom != 0.0f ? bm / denom : 0.0f;
  // jnp.clip's order: max with 0, then min with rc - 1
  const int ridx =
      min(max(cpuvox::to_i32(floorf(x * static_cast<float>(rc))), 0), rc - 1);
  const int row = min(max(cpuvox::add_wrap(ridx, base), 0), R - 1);
  return seg >= 2 ? row : ~row;
}

// The nearest upscale's render coordinate of output coordinate i (of n),
// at render size r: (i * r) / n, or i itself at native size.
__device__ __forceinline__ int render_coord(int i, int r, int n) {
  return r == n ? i : (i * r) / n;
}

// One block's 32 x 32 output tile of one camera's screen.
__device__ __forceinline__ void reproject_tile(
    const int* __restrict__ rb, int R, int P, const SegmentTables& t,
    bool any_active, int rw, int rh, int W, int H,
    const int* __restrict__ colors, int n_colors, int skybox,
    int* __restrict__ out) {
  __shared__ int s_code[kTile][kTile + 1];
  __shared__ int s_val[kTile][kTile + 1];
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int X = x0 + lane;
  // this lane's render column (its pixels' x) and render row as a top/down
  // gather's lane (texel y0 + lane)
  const int sx = render_coord(min(X, W - 1), rw, W);
  const int sy_td = render_coord(min(y0 + lane, H - 1), rh, H);

  // 1. each pixel's family and row, lanes along x
  if (any_active) {
    SegmentBasis sb[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) sb[s] = segment_basis(t, s);
    for (int ly = threadIdx.y; ly < kTile; ly += kRows) {
      const int Y = y0 + ly;
      const int sy = render_coord(Y, rh, H);
      s_code[ly][lane] =
          X >= W || Y >= H ? kNone
          : kIndexMath     ? pixel_code(t, sb, sx, sy, R)
          : 2 * sx < rw    ? min(sy, R - 1)
                           : ~min(sx, R - 1);
    }
  }
  __syncthreads();

  // 2. the gathers: left/right pixels (texel sx) with lanes along x,
  // top/down pixels (texel sy) with lanes along y
  if (any_active) {
    for (int k = threadIdx.y; k < kTile; k += kRows) {
      const int lr = s_code[k][lane];  // pixel (lane, k)
      if (lr >= 0)
        s_val[k][lane] = kGather ? rb[static_cast<size_t>(lr) * P + sx] : lr;
      const int td = s_code[lane][k];  // pixel (k, lane)
      if (td < 0 && td != kNone)
        s_val[lane][k] =
            kGather ? rb[static_cast<size_t>(~td) * P + sy_td] : td;
    }
  }
  __syncthreads();

  // 3. the resolve and the coalesced write, lanes along x
  for (int ly = threadIdx.y; ly < kTile; ly += kRows) {
    const int Y = y0 + ly;
    if (X >= W || Y >= H) continue;
    int v = any_active ? s_val[ly][lane] : skybox;
    if (colors != nullptr)
      v = v < 0 ? kMagenta : colors[min(max(v, 0), n_colors - 1)];
    out[static_cast<size_t>(Y) * W + X] = v;
  }
}

__global__ void __launch_bounds__(kTile * kRows) reproject_screen_kernel(
    const int* __restrict__ rb, int R, int P, SegmentTables t, int any_active,
    int rw, int rh, int W, int H, const int* __restrict__ colors,
    int n_colors, int skybox, int* __restrict__ out) {
  reproject_tile(rb, R, P, t, any_active != 0, rw, rh, W, H, colors,
                 n_colors, skybox, out);
}

// A batch of cameras in one launch (parallel/batch.py): the camera is the
// grid's z axis.  Camera b's rays are rows [b * R1, (b + 1) * R1) of the
// raybuffer, its tables (row ids relative to its block) are tables[b] on the
// device, copied once a batch, and its screen is out[b].  A block first
// reads its camera's 36 table words into shared memory.
__global__ void __launch_bounds__(kTile * kRows) reproject_screens_kernel(
    const int* __restrict__ rb, int R1, int P,
    const SegmentTables* __restrict__ tables, int rw, int rh, int W, int H,
    const int* __restrict__ colors, int n_colors, int skybox,
    int* __restrict__ out) {
  constexpr int kWords = sizeof(SegmentTables) / sizeof(int);
  __shared__ SegmentTables t;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (tid < kWords)
    reinterpret_cast<int*>(&t)[tid] =
        reinterpret_cast<const int*>(tables + b)[tid];
  __syncthreads();
  const bool any_active =
      t.active[0] | t.active[1] | t.active[2] | t.active[3];
  reproject_tile(rb + static_cast<size_t>(b) * R1 * P, R1, P, t, any_active,
                 rw, rh, W, H, colors, n_colors, skybox,
                 out + static_cast<size_t>(b) * H * W);
}

}  // namespace

extern "C" int cpuvox_reproject_screen(void* rb, int R, int P,
                                       SegmentTables tables, int any_active,
                                       int rw, int rh, int W, int H,
                                       void* colors, int n_colors, int skybox,
                                       void* out, void* stream) {
  if (W > 0 && H > 0) {
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
    reproject_screen_kernel<<<grid, dim3(kTile, kRows), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rb), R, P, tables, any_active, rw, rh, W, H,
        static_cast<const int*>(colors), n_colors, skybox,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cpuvox_reproject_screens(void* rb, int R1, int P, int B,
                                        void* tables, int rw, int rh, int W,
                                        int H, void* colors, int n_colors,
                                        int skybox, void* out, void* stream) {
  if (W > 0 && H > 0 && B > 0) {
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
    reproject_screens_kernel<<<grid, dim3(kTile, kRows), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rb), R1, P,
        static_cast<const SegmentTables*>(tables), rw, rh, W, H,
        static_cast<const int*>(colors), n_colors, skybox,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
