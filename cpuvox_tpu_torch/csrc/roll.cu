// Kernel 1: the content-independent DDA chunk roll.
//
// Replaces cpuvox_tpu/ops/roll_kernel.py::roll_chunk_pallas (the TPU kernel
// behind raymarch._roll_chunk_pallas).  The plain version is the torch
// cpuvox_tpu_torch.render.raymarch._roll_chunk.
//
// What bounds it on the H100: the serial chain of each ray's C steps, not
// bytes.  A step is ~40 integer/f32 operations, each depending on the last
// (the LOD switch, the in-world test, the step, the far-clip retire), and
// the closed form tmax + n * tdelta is not bit-equal to repeated adds, so a
// ray's steps cannot be split among lanes.  Per step it writes its 13-field
// visit record, (C, 13, Rk) int32 in all (5.8 MB at C 32 and 3,261 rays):
// field f of step c for ray slot t is stored at (c * 13 + f) * Rk + t, so a
// warp's 32 stores are one contiguous 128-byte line.  At 3,261-9,088 rays
// every ray is resident at once and the launch takes as long as one ray's
// chain plus the stores.  The design works on everything around the chain:
//  - blocks of kBlock = 32 threads, one warp: 3,261 rays make 102 blocks, so
//    the rays and their stores spread over most of the card's 132 SMs (the
//    first design's 128-thread blocks put them on 26-71 SMs);
//  - the LOD distances (at most kMaxLods) are read into registers once, and
//    the distance of the ray's current LOD is held in a register that only
//    an LOD switch updates (an unrolled select), where the first design
//    loaded lod_dist[lod] from memory on every step.  A frame of more than
//    kMaxLods distances (RenderConfig.lod_levels 9 and up) launches the
//    memory form, the template's Regs = false: the same steps with the
//    distance loaded every step, so any count of LODs rolls;
// bench/roll_variants.py builds the kernel with each of these turned back
// (kBlock, kLodRegisters), with the first design's settings, and without
// the visit stores (kStoreVisits 0, a diagnostic: the visits are not
// written), and times them on the card (PERF.md).  Reading the state pairs
// as 8-byte words timed no faster, so they stay 4-byte words.
//
// Live-ray index: with `index` (ascending int32, Rk entries) thread t rolls
// ray index[t] and writes visit field f of step c at (c * 13 + f) * Rk + t,
// still one contiguous line a warp; the state is gathered from and written
// back to its place in the full-width arrays.  A null index is every ray.
// This replaces the reference's staged compaction (raymarch.py:1593-1605),
// which sorts every per-ray array because a jitted TPU program needs static
// shapes: here the dead rays cost no thread and no visit row.
//
// Timing: a Renderer's frame graph hands the kernel its timer buffer
// (timer.cuh); on a sampled frame each block's first thread stamps the
// launch's start (its clock as it began) and end once its ray is rolled,
// the sampled word read as it begins and waited for only then.
//
// Bit-exactness: the roll has no a*b+c shape (built with -fmad=false all the
// same), the step keeps `tmax + (bump ? tdelta : 0.0f)`, which maps -0.0 to
// +0.0 like the reference, and min/max propagate NaN (common.cuh).

#include "common.cuh"
#include "timer.cuh"

namespace {

constexpr int kNVF = 13;
constexpr int kBlock = 32;         // threads a block
constexpr int kMaxLods = 8;        // LOD distances held in registers
// 1: the register form for at most kMaxLods distances, the memory form
// above; 0: the memory form always (bench/roll_variants.py)
constexpr int kLodRegisters = 1;
constexpr int kStoreVisits = 1;    // 0: no visit stores (diagnostic only)

// lod_dist[clamp(lv, 0, nld - 1)] from the registers: an unrolled select,
// so the table never leaves them
__device__ __forceinline__ float lod_threshold(const float (&d)[kMaxLods],
                                               int nld, int lv) {
  const int lc = min(max(lv, 0), nld - 1);
  float v = d[0];
#pragma unroll
  for (int k = 1; k < kMaxLods; ++k)
    if (lc == k) v = d[k];
  return v;
}

template <bool Regs>
__global__ void __launch_bounds__(kBlock) roll_chunk_kernel(
    int* __restrict__ pos, float* __restrict__ tmax,
    float* __restrict__ tdelta, int* __restrict__ stp,
    float* __restrict__ ids, int* __restrict__ lod,
    uint8_t* __restrict__ alive, const float* __restrict__ dirs,
    const float* __restrict__ lod_dist, int nld, float far_clip, int X, int Z,
    int C, const int* __restrict__ index, int Rk, int* __restrict__ visits,
    long long* timer) {
  const bool stamps = threadIdx.x == 0 && cpuvox::timed(timer);
  const long long began = timer != nullptr ? cpuvox::globaltimer() : 0;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Rk) return;
  const int r = index ? index[t] : t;
  int px = pos[2 * r], pz = pos[2 * r + 1];
  float tmx = tmax[2 * r], tmz = tmax[2 * r + 1];
  float tdx = tdelta[2 * r], tdz = tdelta[2 * r + 1];
  int spx = stp[2 * r], spz = stp[2 * r + 1];
  float i0 = ids[2 * r], i1 = ids[2 * r + 1];
  const float dx = dirs[2 * r], dz = dirs[2 * r + 1];
  int lv = lod[r];
  bool al = alive[r] != 0;
  float d[kMaxLods];
#pragma unroll
  for (int k = 0; k < kMaxLods; ++k)
    d[k] = (Regs && k < nld) ? lod_dist[k] : 0.0f;
  float thr = Regs ? lod_threshold(d, nld, lv) : 0.0f;

  int* v = visits + t;
  for (int c = 0; c < C; ++c, v += kNVF * Rk) {
    // pre-switch snapshot (the gated march's rewind anchor)
    const int p_px = px, p_pz = pz, p_lv = lv;
    const float p_tmx = tmx, p_tmz = tmz, p_i0 = i0, p_i1 = i1;

    const float ld = Regs ? thr : lod_dist[min(max(lv, 0), nld - 1)];
    if (al && i0 >= ld) {  // NextLOD (SegmentDDAData.cs:31-73)
      const int vsize = 1 << lv;
      const int mask2 = 2 * vsize - 1;
      const int rx = px & mask2, rz = pz & mask2;
      const float tpx = tmx - tdx, tpz = tmz - tdz;
      const bool inc_x = (dx >= 0.0f) == (rx < vsize);
      const bool inc_z = (dz >= 0.0f) == (rz < vsize);
      const float ntmx = inc_x ? tmx + tdx : tmx;
      const float ntmz = inc_z ? tmz + tdz : tmz;
      const float ntpx = inc_x ? tpx : tpx - tdx;
      const float ntpz = inc_z ? tpz : tpz - tdz;
      i0 = cpuvox::max_nan(ntpx, ntpz);
      i1 = cpuvox::min_nan(ntmx, ntmz);
      px -= rx;
      pz -= rz;
      tmx = ntmx;
      tmz = ntmz;
      tdx = tdx * 2.0f;
      tdz = tdz * 2.0f;
      spx *= 2;
      spz *= 2;
      lv += 1;
      if (Regs) thr = lod_threshold(d, nld, lv);
    }
    al = al && px >= 0 && px < X && pz >= 0 && pz < Z;

    if (kStoreVisits) {
      v[0 * Rk] = px;
      v[1 * Rk] = pz;
      v[2 * Rk] = __float_as_int(i0);
      v[3 * Rk] = __float_as_int(i1);
      v[4 * Rk] = lv;
      v[5 * Rk] = al ? 1 : 0;
      v[6 * Rk] = p_px;
      v[7 * Rk] = p_pz;
      v[8 * Rk] = __float_as_int(p_tmx);
      v[9 * Rk] = __float_as_int(p_tmz);
      v[10 * Rk] = __float_as_int(p_i0);
      v[11 * Rk] = __float_as_int(p_i1);
      v[12 * Rk] = p_lv;
    }

    // Step (SegmentDDAData.cs:135-150)
    const bool x_first = tmx < tmz;
    const float crossed = x_first ? tmx : tmz;
    const float stmx = tmx + (x_first ? tdx : 0.0f);
    const float stmz = tmz + (x_first ? 0.0f : tdz);
    if (al) {
      px += x_first ? spx : 0;
      pz += x_first ? 0 : spz;
      tmx = stmx;
      tmz = stmz;
      i0 = crossed;
      i1 = cpuvox::min_nan(stmx, stmz);
    }
    al = al && !(crossed >= far_clip);
  }

  pos[2 * r] = px;
  pos[2 * r + 1] = pz;
  tmax[2 * r] = tmx;
  tmax[2 * r + 1] = tmz;
  tdelta[2 * r] = tdx;
  tdelta[2 * r + 1] = tdz;
  stp[2 * r] = spx;
  stp[2 * r + 1] = spz;
  ids[2 * r] = i0;
  ids[2 * r + 1] = i1;
  lod[r] = lv;
  alive[r] = al ? 1 : 0;
  if (stamps) {
    cpuvox::stamp_start(timer, cpuvox::kRollTimer, began);
    cpuvox::stamp_end(timer, cpuvox::kRollTimer);
  }
}

}  // namespace

extern "C" int cpuvox_roll_chunk(void* pos, void* tmax, void* tdelta,
                                 void* stp, void* ids, void* lod, void* alive,
                                 void* dirs, void* lod_dist, int nld,
                                 float far_clip, int X, int Z, int C,
                                 void* index, int Rk, void* visits,
                                 void* timer, void* stream) {
  if (Rk > 0) {
    auto kernel = kLodRegisters && nld <= kMaxLods ? roll_chunk_kernel<true>
                                                   : roll_chunk_kernel<false>;
    kernel<<<(Rk + kBlock - 1) / kBlock, kBlock, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(pos), static_cast<float*>(tmax),
        static_cast<float*>(tdelta), static_cast<int*>(stp),
        static_cast<float*>(ids), static_cast<int*>(lod),
        static_cast<uint8_t*>(alive), static_cast<const float*>(dirs),
        static_cast<const float*>(lod_dist), nld, far_clip, X, Z, C,
        static_cast<const int*>(index), Rk, static_cast<int*>(visits),
        static_cast<long long*>(timer));
  }
  return static_cast<int>(cudaGetLastError());
}
