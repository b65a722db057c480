// Kernel 2: the phase-1 chunk rasterizer.
//
// Replaces cpuvox_tpu/ops/phase1_kernel.py::rasterize_chunk (the Pallas
// kernel that phase1_pallas calls once per chunk on the dense march and once
// per gated group on the occupancy-gated march).  The plain version is the
// torch cpuvox_tpu_torch.render.raymarch._rasterize_step looped over the
// cells (raymarch.rasterize_cells); this kernel is a per-ray transliteration
// of it and equals it bit for bit in the raybuffer and in all 8 state
// fields.  A cell that is not valid (a gated group's tail cell past the
// ray's gated count) leaves the ray untouched.
//
// What bounds it on the H100: memory latency, not arithmetic.  Per visited
// cell a ray reads its column record (8 + MAXR int32, coalesced across the
// warp in (C, R) layout) and does ~100 f32 operations; per drawn run it
// writes a span of its own raybuffer row, texel by texel, and scans that row
// for the next unwritten texel.  Rows are P int32 apart, so a warp's span
// writes do not coalesce, and the (R, P) raybuffer (~70 MB at 1080p) is
// larger than the 50 MB L2.  The design keeps every piece of per-ray state
// in registers for the whole chunk (one read and one write of the state per
// chunk), writes only texels that are still unwritten, and stops a ray's run
// loop at its first run that can no longer draw.  One thread per ray leaves
// the card mostly idle at ~9k rays; a faster layout is later work.
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
//  - `run >> 16` is an arithmetic shift (air runs are negative);
//  - the frontier scans are the EXACT sequential scans of
//    _next_unwritten_geq/_prev_unwritten_leq, cheap for one thread walking
//    its own row.
// The raybuffer and state are updated in place.
//
// No checkpoint sweep skip (phase1_kernel.py:630-675): the TPU kernel sweeps
// a column's runs in RB-run blocks shared by 128 lanes, and a lane-consensus
// checkpoint lets all of them jump past blocks that lie wholly on the far
// side of every lane's window.  One thread per ray meets such a run in the
// run loop below and leaves it with the far-side `continue` after one load,
// a scale and two compares; a per-thread skip loop ahead of the sweep does
// the same work per run, and timed 9-16 % slower than none on an H100 on
// layered2048's gated groups (PERF.md), so the kernel has none.
//
// Rolled loops: the four texel loops (the two frontier scans and the two span
// writes) carry `#pragma unroll 1`, against a ptxas miscompile.  ptxas of
// CUDA 12.9 (V12.9.86, sm_90a, at its default -O3) fuses
// max(max(-p, a), b), p a kernel parameter, into one three-input VIMNMX3
// whose operand is p itself: the negation is lost.  A four-line kernel,
//   out[i] = max(max(-P, a[i]), b[i]);
// returns max(P, a, b) on the card (right at -Xptxas -O0).  With every texel
// loop unrolled, NVVM writes each span loop's trip count in exactly that form
// (-(e + 1) = max(-P, ~nfp_max, ~rb_max)), so the count came out as
// -(y0 + P), the unrolled loop ran on for about 2^30 iterations and left the
// raybuffer with an illegal address; a build that checks every row index
// traps at y == P.  A rolled loop compares y with e on every step and has no
// trip count to compute.  The deep-RLE case of
// tests/test_torch_raster.py::test_rasterize_kernel_matches_plain_on_cuda
// faults without these pragmas, and
// test_kernel_library_holds_no_vimnmx3 fails if any kernel brings the fused
// instruction back.  A loop over one thread's own row gains little from
// unrolling anyway.

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 24;

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

// first y >= c with row[y] unwritten (< 0), else BIG
__device__ __forceinline__ int next_unwritten_geq(const int* row, int P,
                                                  int c) {
  #pragma unroll 1  // see "Rolled loops" above
  for (int y = max(c, 0); y < P; ++y)
    if (row[y] < 0) return y;
  return kBig;
}

// last y <= c with row[y] unwritten, else -BIG
__device__ __forceinline__ int prev_unwritten_leq(const int* row, int P,
                                                  int c) {
  #pragma unroll 1  // see "Rolled loops" above
  for (int y = min(c, P - 1); y >= 0; --y)
    if (row[y] < 0) return y;
  return -kBig;
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

// ReducePixelHorizon (DrawSegmentRayJob.cs:660-697) for one ray whose span
// overlaps its free range; narrows [rb_min, rb_max] to the writable part.
__device__ __forceinline__ void reduce_pixel_horizon(RayState& s,
                                                     const int* row, int P,
                                                     int& rb_min,
                                                     int& rb_max) {
  const bool c1 = rb_min <= s.nfp_min;
  const int rb_min2 = c1 ? s.nfp_min : rb_min;
  const int nfp_max0 = s.nfp_max;
  if (c1 && rb_max >= s.nfp_min) {
    const int y = next_unwritten_geq(row, P, cpuvox::add_wrap(rb_max, 1));
    s.nfp_min = y;
    s.fb_min = static_cast<float>(y) - 0.501f;
  }
  const bool c2 = rb_max >= nfp_max0;
  const int rb_max2 = c2 ? nfp_max0 : rb_max;
  if (c2 && rb_min2 <= nfp_max0) {
    const int y = prev_unwritten_leq(row, P, cpuvox::add_wrap(rb_min2, -1));
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

__device__ __forceinline__ void rasterize_cell(
    RayState& s, int* row, const Consts k, float ids0, float ids1, int lod,
    bool valid, int n_runs, int color_off, int cmin, int cmax,
    const int* runs, int maxr, F3 pb, F3 pt, F3 pd) {
  if (!valid) return;  // not this ray's cell: an exact no-op
  const float wmy = k.world_max_y;
  const int P = k.P;
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
    nfp_min2 = next_unwritten_geq(row, P, writable_min);
  if (do_clip && writable_max < s.nfp_max)
    nfp_max2 = prev_unwritten_leq(row, P, writable_max);
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

  // ---- RLE run iteration (:424-611); runs arrive ordered for the direction
  float eb_min = k.dir > 0 ? wmy : 0.0f;
  float eb_max = eb_min;
  bool run_done = false;
  for (int kk = 0; kk < maxr; ++kk) {
    // once a run is not valid no later one is (alive and run_done are
    // monotone), so the loop stops there
    if (!(process && s.alive && kk < n_runs && !run_done)) break;
    const int run = runs[kk];
    const int length = run & 0xFFFF;
    const int cidx = run >> 16;  // arithmetic: air runs are negative
    const bool is_air = run < 0;
    const float len_scaled = static_cast<float>(length * (1 << lod));
    if (k.dir > 0) {
      eb_max = eb_min;
      eb_min = eb_min - len_scaled;
    } else {
      eb_min = eb_max;
      eb_max = eb_min + len_scaled;
    }
    const bool above = eb_min > wb_max;
    const bool below = eb_max < wb_min;
    if (!is_air && (k.dir > 0 ? below : above)) run_done = true;
    if (is_air || above || below) continue;  // nothing to draw

    // lerp the projected full-world lines per run (:477-481)
    const float portion_bottom = eb_min / wmy;
    const float portion_top = eb_max / wmy;
    const F3 front_bottom = lerp3(cs_min_last, cs_max_last, portion_bottom);
    const F3 front_top = lerp3(cs_min_last, cs_max_last, portion_top);

    // --- side span (:484-542)
    const Line side = near_clip_line(front_bottom, front_top,
                                     static_cast<float>(length), 0.0f);
    const float uva0 = 1.0f / side.a.z, uva1 = side.u_a / side.a.z;
    const float uvb0 = 1.0f / side.b.z, uvb1 = side.u_b / side.b.z;
    const float rbf_a = side.a.x / side.a.z;
    const float rbf_b = side.b.x / side.b.z;
    const bool flip = rbf_a > rbf_b;
    const float rbf_lo = flip ? rbf_b : rbf_a;
    const float rbf_hi = flip ? rbf_a : rbf_b;
    const float uv_lo0 = flip ? uvb0 : uva0, uv_lo1 = flip ? uvb1 : uva1;
    const float uv_hi0 = flip ? uva0 : uvb0, uv_hi1 = flip ? uva1 : uvb1;
    int rb_min = cpuvox::to_i32(rintf(rbf_lo));
    int rb_max = cpuvox::to_i32(rintf(rbf_hi));
    if (side.visible && rb_max >= s.nfp_min && rb_min <= s.nfp_max) {
      reduce_pixel_horizon(s, row, P, rb_min, rb_max);
      bool wrote = false;
      #pragma unroll 1  // see "Rolled loops" above
      for (int y = max(rb_min, 0), e = min(rb_max, P - 1); y <= e; ++y) {
        if (row[y] >= 0) continue;
        // perspective-correct color index (:519-533)
        const float l = (static_cast<float>(y) - rbf_lo) / (rbf_hi - rbf_lo);
        const float wu0 = uv_lo0 + (uv_hi0 - uv_lo0) * l;
        const float wu1 = uv_lo1 + (uv_hi1 - uv_lo1) * l;
        const float u = wu1 / wu0;
        const int iu = (u != u) ? 0 : cpuvox::to_i32(floorf(u));
        row[y] = color_off + (min(max(iu, 0), length - 1) + cidx);
        wrote = true;
      }
      after_write(s, wrote);
    }

    // --- top/bottom cap (:544-610)
    if (!s.alive) continue;
    const bool top_cap = portion_top < k.cam_y_norm;
    const bool bot_cap = !top_cap && portion_bottom > k.cam_y_norm;
    const bool skip_top = top_cap && eb_max > wb_max;
    const bool skip_bot = bot_cap && eb_min < wb_min;
    if (!((top_cap && !skip_top) || (bot_cap && !skip_bot))) continue;
    const int cap_value = color_off + (top_cap ? cidx : cidx + length - 1);
    const float portion_cap = top_cap ? portion_top : portion_bottom;
    const Line cap = near_clip_line(
        lerp3(cs_min_next, cs_max_next, portion_cap),
        top_cap ? front_top : front_bottom, 0.0f, 0.0f);
    if (!cap.visible) continue;
    const float r2a = rintf(cap.a.x / cap.a.z);
    const float r2b = rintf(cap.b.x / cap.b.z);
    int rb2_min = cpuvox::to_i32(cpuvox::min_nan(r2a, r2b));
    int rb2_max = cpuvox::to_i32(cpuvox::max_nan(r2a, r2b));
    if (rb2_max >= s.nfp_min && rb2_min <= s.nfp_max) {
      reduce_pixel_horizon(s, row, P, rb2_min, rb2_max);
      bool wrote = false;
      #pragma unroll 1  // see "Rolled loops" above
      for (int y = max(rb2_min, 0), e = min(rb2_max, P - 1); y <= e; ++y) {
        if (row[y] < 0) {
          row[y] = cap_value;
          wrote = true;
        }
      }
      after_write(s, wrote);
    }
  }
}

__global__ void rasterize_chunk_kernel(
    int* __restrict__ raybuf, int* __restrict__ nfp_min,
    int* __restrict__ nfp_max, float* __restrict__ fb_min,
    float* __restrict__ fb_max, uint8_t* __restrict__ f_active,
    float* __restrict__ fdir_min, float* __restrict__ fdir_max,
    uint8_t* __restrict__ alive, const float* __restrict__ ids,
    const int* __restrict__ lod, const uint8_t* __restrict__ valid,
    const int* __restrict__ n_runs, const int* __restrict__ color_off,
    const int* __restrict__ cmin, const int* __restrict__ cmax,
    const int* __restrict__ runs, const float* __restrict__ plane_bottom,
    const float* __restrict__ plane_top, const float* __restrict__ plane_dir,
    const Consts k, int C, int maxr, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  RayState s;
  s.nfp_min = nfp_min[r];
  s.nfp_max = nfp_max[r];
  s.fb_min = fb_min[r];
  s.fb_max = fb_max[r];
  s.f_active = f_active[r] != 0;
  s.fdir_min = fdir_min[r];
  s.fdir_max = fdir_max[r];
  s.alive = alive[r] != 0;
  const F3 pb = {plane_bottom[3 * r], plane_bottom[3 * r + 1],
                 plane_bottom[3 * r + 2]};
  const F3 pt = {plane_top[3 * r], plane_top[3 * r + 1], plane_top[3 * r + 2]};
  const F3 pd = {plane_dir[3 * r], plane_dir[3 * r + 1], plane_dir[3 * r + 2]};
  int* row = raybuf + static_cast<size_t>(r) * k.P;
  for (int c = 0; c < C; ++c) {
    const size_t i = static_cast<size_t>(c) * R + r;
    rasterize_cell(s, row, k, ids[2 * i], ids[2 * i + 1], lod[i], valid[i] != 0,
                   n_runs[i], color_off[i], cmin[i], cmax[i],
                   runs + i * maxr, maxr, pb, pt, pd);
  }
  nfp_min[r] = s.nfp_min;
  nfp_max[r] = s.nfp_max;
  fb_min[r] = s.fb_min;
  fb_max[r] = s.fb_max;
  f_active[r] = s.f_active ? 1 : 0;
  fdir_min[r] = s.fdir_min;
  fdir_max[r] = s.fdir_max;
  alive[r] = s.alive ? 1 : 0;
}

}  // namespace

extern "C" int cpuvox_rasterize_chunk(
    void* raybuf, void* nfp_min, void* nfp_max, void* fb_min, void* fb_max,
    void* f_active, void* fdir_min, void* fdir_max, void* alive, void* ids,
    void* lod, void* valid, void* n_runs, void* color_off, void* cmin,
    void* cmax, void* runs, void* plane_bottom, void* plane_top,
    void* plane_dir, float world_max_y, float cam_y, float cam_y_norm,
    int has_solid, float solid_min_y, float solid_max_y, int dir, int C,
    int maxr, int R, int P, void* stream) {
  if (R > 0 && C > 0) {
    Consts k{world_max_y, cam_y, cam_y_norm, has_solid, solid_min_y,
             solid_max_y, dir, P};
    const int threads = 128;
    rasterize_chunk_kernel<<<(R + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(raybuf), static_cast<int*>(nfp_min),
        static_cast<int*>(nfp_max), static_cast<float*>(fb_min),
        static_cast<float*>(fb_max), static_cast<uint8_t*>(f_active),
        static_cast<float*>(fdir_min), static_cast<float*>(fdir_max),
        static_cast<uint8_t*>(alive), static_cast<const float*>(ids),
        static_cast<const int*>(lod), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(n_runs), static_cast<const int*>(color_off),
        static_cast<const int*>(cmin), static_cast<const int*>(cmax),
        static_cast<const int*>(runs), static_cast<const float*>(plane_bottom),
        static_cast<const float*>(plane_top),
        static_cast<const float*>(plane_dir), k, C, maxr, R);
  }
  return static_cast<int>(cudaGetLastError());
}
