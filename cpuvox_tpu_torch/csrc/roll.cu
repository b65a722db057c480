// Kernel 1: the content-independent DDA chunk roll.
//
// Replaces cpuvox_tpu/ops/roll_kernel.py::roll_chunk_pallas (the TPU kernel
// behind raymarch._roll_chunk_pallas).  The plain version is the torch
// cpuvox_tpu_torch.render.raymarch._roll_chunk.
//
// What bounds it on the H100: almost nothing is computed (integer adds,
// shifts, f32 adds and compares per step); the cost is the visit list it
// writes, 13 int32 per ray per step, (C, 13, R) = 32 x 13 x ~9k x 4 B ~ 15 MB
// per chunk at 1080p, plus launch latency.  One thread per ray keeps the
// whole DDA state in registers for the chunk's C steps, reads it once and
// writes it back once; visit field f of step c for ray r is stored at
// (c * 13 + f) * R + r, so a warp's 32 stores are one contiguous 128-byte
// line.  At ~9k rays the card is mostly idle (about 70 blocks of 128 threads
// for 132 SMs); that is accepted for this first, exact version.
//
// Live-ray index: with `index` (ascending int32, Rk entries) thread t rolls
// ray index[t] and writes visit field f of step c at (c * 13 + f) * Rk + t,
// still one contiguous line a warp; the state is gathered from and written
// back to its place in the full-width arrays.  A null index is every ray.
// This replaces the reference's staged compaction (raymarch.py:1593-1605),
// which sorts every per-ray array because a jitted TPU program needs static
// shapes: here the dead rays cost no thread and no visit row.
//
// Bit-exactness: the roll has no a*b+c shape (built with -fmad=false all the
// same), the step keeps `tmax + (bump ? tdelta : 0.0f)`, which maps -0.0 to
// +0.0 like the reference, and min/max propagate NaN (common.cuh).

#include "common.cuh"

namespace {

constexpr int kNVF = 13;

__global__ void roll_chunk_kernel(
    int* __restrict__ pos, float* __restrict__ tmax,
    float* __restrict__ tdelta, int* __restrict__ stp,
    float* __restrict__ ids, int* __restrict__ lod,
    uint8_t* __restrict__ alive, const float* __restrict__ dirs,
    const float* __restrict__ lod_dist, int nld, float far_clip, int X, int Z,
    int C, const int* __restrict__ index, int Rk, int* __restrict__ visits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Rk) return;
  const int r = index ? index[t] : t;
  int px = pos[2 * r], pz = pos[2 * r + 1];
  float tmx = tmax[2 * r], tmz = tmax[2 * r + 1];
  float tdx = tdelta[2 * r], tdz = tdelta[2 * r + 1];
  int spx = stp[2 * r], spz = stp[2 * r + 1];
  float i0 = ids[2 * r], i1 = ids[2 * r + 1];
  int lv = lod[r];
  bool al = alive[r] != 0;
  const float dx = dirs[2 * r], dz = dirs[2 * r + 1];

  for (int c = 0; c < C; ++c) {
    // pre-switch snapshot (the gated march's rewind anchor)
    const int p_px = px, p_pz = pz, p_lv = lv;
    const float p_tmx = tmx, p_tmz = tmz, p_i0 = i0, p_i1 = i1;

    const int lc = min(max(lv, 0), nld - 1);
    if (al && i0 >= lod_dist[lc]) {  // NextLOD (SegmentDDAData.cs:31-73)
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
    }
    al = al && px >= 0 && px < X && pz >= 0 && pz < Z;

    int* v = visits + static_cast<size_t>(c) * kNVF * Rk + t;
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
}

}  // namespace

extern "C" int cpuvox_roll_chunk(void* pos, void* tmax, void* tdelta,
                                 void* stp, void* ids, void* lod, void* alive,
                                 void* dirs, void* lod_dist, int nld,
                                 float far_clip, int X, int Z, int C,
                                 void* index, int Rk, void* visits,
                                 void* stream) {
  if (Rk > 0) {
    const int threads = 128;
    roll_chunk_kernel<<<(Rk + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(pos), static_cast<float*>(tmax),
        static_cast<float*>(tdelta), static_cast<int*>(stp),
        static_cast<float*>(ids), static_cast<int*>(lod),
        static_cast<uint8_t*>(alive), static_cast<const float*>(dirs),
        static_cast<const float*>(lod_dist), nld, far_clip, X, Z, C,
        static_cast<const int*>(index), Rk, static_cast<int*>(visits));
  }
  return static_cast<int>(cudaGetLastError());
}
