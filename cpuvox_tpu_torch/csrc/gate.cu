// The gated march's glue: the gate kernel and the rewind kernel.
//
// They replace no TPU kernel: the JAX package runs the gate (stage A's tile
// gather, the window gate, the solid pre-kill, stage B's pack) and the
// rewind as XLA code inside its while_loop (cpuvox_tpu/render/raymarch.py
// :1228-1333, :1542-1583).  On the card their plain torch versions,
// cpuvox_tpu_torch.render.raymarch.gated_group and .rewind_snapshot /
// .rewind_apply, took some dozens of small launches an iteration between
// the roll and the rasterizer, most of a layered world's march.  Both
// kernels equal them bit for bit (ops/gate_kernel.py holds the plain
// versions beside them).
//
// cpuvox_gate (one launch an iteration, after the roll): for each ray of
// the stage, along the chunk's C steps in order,
//  - stage A: the step's occupancy tile; a new tile takes the next of TS =
//    C / 8 + 4 slots, and a step whose slot is past the budget is fetched
//    conservatively (it may draw).  A step's tile row is the one its slot
//    holds, i.e. occ_tiles[clamp(tile)], so a step within the budget reads
//    its row directly (the steps of one tile read the same 32-byte row);
//  - the frustum-window gate with taint: while nothing before the step
//    could have changed the ray's narrowing, a tile whose [cmin, cmax]
//    misses the frozen window (with a margin) is a provable skip;
//  - the solid pre-kill, which clears alive[r] in place;
//  - stage B: the first GK gated cells packed as the rasterizer reads them,
//    (GK, Rk, 4) [column index, ids0, ids1, lod] and proc (GK, Rk), the
//    slots past a ray's count zero; and for the rewind the ray's gated
//    count, cap = min(count, GK) and the seven pre-switch snapshot words of
//    the step where gate & rank == cap: what raymarch.rewind_snapshot's
//    masked sums give (an f32 word through an add of +0.0, as the sums
//    round it: -0.0 reads +0.0), zero where there is no such step.
// cpuvox_gate_rewind (one launch an iteration, after the rasterizer): a
// thread a ray; where count > cap and the ray is still alive it writes the
// snapshot into the DDA state in place (tdelta and stp rescaled to the
// snapshot's LOD, as raymarch.rewind_apply does), sets the march's alive
// and adds the stage's rewinds to the device's count.
// Each kernel adds its launch to its own word of a (3,) int64 device
// counter [gate launches, overflow steps, rewind launches], in block 0.
//
// What bounds the gate on the H100: the per-ray scans along the steps (a
// new tile's slot, the taint, the kill, a gated cell's rank) and the visit
// loads, not arithmetic.  A stage is 256-9,088 rays wide, so a thread a ray
// walking its C steps would leave the narrow stages a handful of warps,
// each waiting on its loads in turn.  Here a warp works on one ray, a lane
// a step, 32 steps a round: each scan is a ballot and a popcount, carried
// from round to round in registers.  A block of kRays warps first copies
// its rays' six visit fields into shared memory with loads coalesced along
// the rays (the visits are (C, 13, Rk), ray-contiguous: a warp's load is
// four full 32-byte sectors), and only the rounds up to a ray's last valid
// step (a dead ray's visits are never read past the valid flags).  Bytes
// at C 128: 3 KB of visits a live ray, a 32-byte tile row per tile, the
// packed group written (16 B a slot) and 28 B of snapshot.
//
// Bit-exactness: every f32 operation is written as the correctly rounded
// intrinsic the plain version's op is (no contraction whatever the build),
// in the plain version's order; integer indices as torch's int32 ops.

#include "common.cuh"

namespace {

constexpr int kNVF = 13;
constexpr int kRays = 8;              // rays a block, a warp each
constexpr int kThreads = 32 * kRays;
constexpr int kStride = kRays + 1;    // shared words a step: no bank clash
constexpr int kFields = 6;            // visit fields the gate reads
constexpr int kOccRow = 8;            // render/device.py OCC_ROW
constexpr int kSnap = 7;              // snapshot words
constexpr unsigned kAll = 0xFFFFFFFFu;

struct GateWorld {
  const int* occ;        // (n_tiles, kOccRow) occupancy tiles
  int n_tiles;
  const int* tile_base;  // (8,) first tile row of each LOD
  const int* tile_gz;    // (8,) tiles per x-row of each LOD
  const int* col_base;   // (8,) first column of each LOD
  const int* grid_z;     // (8,) columns per x-row of each LOD
  // the world-shard tile window (raymarch._window_slot), (4,) int32 on the
  // device [tx0, tz0, log2 of the tile side, W], or null
  const int* win;
};

// The per-ray state the gate reads, by the ray's place r, and the camera
// height: a scalar, or (R,) a ray for a batch of cameras.
struct GateRays {
  const float* fdir_min;
  const float* fdir_max;
  const uint8_t* f_active;
  uint8_t* alive;        // rs.alive: the solid pre-kill clears it
  const float* cam_y;    // null: the scalar
};

struct GateConsts {
  float cam_y, world_max_y, eps, solid_min_y, solid_max_y;
  int has_solid, C, GK, TS;
};

struct Window {
  int tx0, tz0, tl, w;
  bool on;
};

// raymarch._window_slot: (slot, tile mask) of a LOD0 cell
__device__ __forceinline__ int window_slot(const Window& win, int xc, int zc) {
  const int txr = (xc >> win.tl) - win.tx0;
  const int tzr = (zc >> win.tl) - win.tz0;
  const bool inw = txr >= 0 && txr < win.w && tzr >= 0 && tzr < win.w;
  return inw ? txr * win.w + tzr : win.w * win.w;
}

// raymarch._occ_tile_index
__device__ __forceinline__ int tile_index(const GateWorld& gw,
                                          const Window& win, int lodc,
                                          int lod, int xc, int zc) {
  if (win.on && lod == 0) {
    const int tmask = (1 << win.tl) - 1;
    return window_slot(win, xc, zc) * (1 << (2 * win.tl - 7))
           + ((xc & tmask) >> 4) * (1 << (win.tl - 3)) + ((zc & tmask) >> 3);
  }
  return __ldg(gw.tile_base + lodc) + (xc >> 4) * __ldg(gw.tile_gz + lodc)
         + (zc >> 3);
}

// raymarch._cell_index
__device__ __forceinline__ int cell_index(const GateWorld& gw,
                                          const Window& win, int lodc,
                                          int lod, int xc, int zc) {
  if (win.on && lod == 0) {
    const int tmask = (1 << win.tl) - 1;
    return (window_slot(win, xc, zc) << (2 * win.tl))
           + ((xc & tmask) << win.tl) + (zc & tmask);
  }
  return __ldg(gw.col_base + lodc) + xc * __ldg(gw.grid_z + lodc) + zc;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// visit field f of step c for slot t: (c * 13 + f) * Rk + t
__global__ void __launch_bounds__(kThreads) gate_kernel(
    const int* __restrict__ visits, int Rk, const int* __restrict__ index,
    const GateWorld gw, const GateRays ry, const GateConsts k,
    int4* __restrict__ packed, uint8_t* __restrict__ proc,
    int* __restrict__ count_out, int* __restrict__ cap_out,
    int* __restrict__ snap_out, unsigned long long* __restrict__ counters) {
  // field f of step c of the block's ray j at sm[(f * C + c) * kStride + j]:
  // fields 0-4 are the visit's pos x/z, ids0/1 and lod, 5 its valid flag
  extern __shared__ int sm[];
  __shared__ int rounds_of[kRays];  // rounds up to the ray's last valid step
  const int C = k.C;
  const int nr = (C + 31) >> 5;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kRays;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counters, 1ull);

  // the copy: thread (j, s) takes ray j's steps s, s + 32, ...
  const int cj = threadIdx.x % kRays, cs = threadIdx.x / kRays;
  const bool c_in = t0 + cj < Rk;
  auto copy = [&](int f, int m) {
    const int c = 32 * m + cs;
    if (c_in && c < C) {
      sm[(f * C + c) * kStride + cj] =
          __ldg(visits + static_cast<size_t>(c * kNVF + f) * Rk + t0 + cj);
    }
  };
  for (int m = 0; m < nr; ++m) copy(5, m);
  __syncthreads();
  const int t = t0 + wid;
  int last = 0;
  for (int m = 0; m < nr; ++m) {
    const int c = 32 * m + lane;
    const bool v = t < Rk && c < C && sm[(5 * C + c) * kStride + wid] != 0;
    if (__ballot_sync(kAll, v)) last = m + 1;
  }
  if (lane == 0) rounds_of[wid] = last;
  __syncthreads();
  const int mine = rounds_of[cj];
  for (int f = 0; f < 5; ++f)
    for (int m = 0; m < mine; ++m) copy(f, m);
  __syncthreads();
  if (t >= Rk) return;

  const int r = index ? __ldg(index + t) : t;
  const float fdmin = __ldg(ry.fdir_min + r);
  const float fdmax = __ldg(ry.fdir_max + r);
  const bool fact0 = __ldg(ry.f_active + r) != 0;
  const float cam_y = ry.cam_y ? __ldg(ry.cam_y + r) : k.cam_y;
  Window win{0, 0, 0, 0, gw.win != nullptr};
  if (win.on) {
    win.tx0 = __ldg(gw.win);
    win.tz0 = __ldg(gw.win + 1);
    win.tl = __ldg(gw.win + 2);
    win.w = __ldg(gw.win + 3);
  }
  const unsigned below = lanes_below(lane);
  const unsigned upto = below | (1u << lane);
  int tiles = 0;        // new tiles before this round
  int prev_ti = 0;      // the tile of the step before this round
  bool taint = false;   // a trigger before this round
  bool killed = false;  // a kill at or before this round's steps
  int gated = 0;        // gated steps before this round
  int overflow_steps = 0;
  const int rounds = rounds_of[wid];
  for (int m = 0; m < rounds; ++m) {
    const int c = 32 * m + lane;
    const bool in = c < C;
    const int* col = sm + c * kStride + wid;  // field f at col[f * C * kStride]
    int x = 0, z = 0, i0 = 0, i1 = 0, lod = 0;
    bool valid = false;
    if (in) {
      x = col[0];
      z = col[C * kStride];
      i0 = col[2 * C * kStride];
      i1 = col[3 * C * kStride];
      lod = col[4 * C * kStride];
      valid = col[5 * C * kStride] != 0;
    }
    const int lodc = min(max(lod, 0), 7);
    const int xc = x >> lod, zc = z >> lod;

    // stage A: the step's slot among the chunk's distinct tiles
    const int ti = tile_index(gw, win, lodc, lod, xc, zc);
    int before = __shfl_up_sync(kAll, ti, 1);
    if (lane == 0) before = prev_ti;
    const bool fresh = in && (c == 0 || ti != before);
    const unsigned fresh_mask = __ballot_sync(kAll, fresh);
    const int slot = tiles + __popc(fresh_mask & upto) - 1;
    tiles += __popc(fresh_mask);
    prev_ti = __shfl_sync(kAll, ti, 31);
    const bool overflow = slot >= k.TS;
    overflow_steps += __popc(__ballot_sync(kAll, valid && overflow));
    bool bitish = overflow;
    int tcmin = 0, tcmax = 0;
    if (valid && !overflow) {
      const int* row = gw.occ
          + static_cast<size_t>(min(max(ti, 0), gw.n_tiles - 1)) * kOccRow;
      const int wv = __ldg(row + ((xc & 15) >> 2));
      tcmin = __ldg(row + 4);
      tcmax = __ldg(row + 5);
      bitish = ((wv >> (((xc & 3) << 3) | (zc & 7))) & 1) != 0;
    }

    // the frustum-window gate with taint
    const float f0 = __int_as_float(i0), f1 = __int_as_float(i1);
    const float dt = fdmax > 0.0f ? f1 : f0;
    const float db = fdmin < 0.0f ? f1 : f0;
    const float new_max = __fadd_rn(cam_y, __fmul_rn(fdmax, dt));
    const float new_min = __fadd_rn(cam_y, __fmul_rn(fdmin, db));
    const float margin = __fmul_rn(
        k.eps, __fadd_rn(__fadd_rn(fabsf(new_max), fabsf(new_min)), 1.0f));
    const bool cull_might = __fadd_rn(new_min, margin) > k.world_max_y
                            || __fsub_rn(new_max, margin) < 0.0f;
    const bool excl = fact0 && !cull_might && !overflow
        && (__int2float_rn(tcmin) > __fadd_rn(new_max, margin)
            || __int2float_rn(tcmax) < __fsub_rn(new_min, margin));
    const unsigned trig = __ballot_sync(kAll, valid && bitish && !excl);
    const bool taint_before = taint || (trig & below) != 0;
    taint = taint || trig != 0;
    bool gate = valid && bitish && (taint_before || !excl);

    // the solid-bound pre-kill: cells from the killing step on are skipped
    if (k.has_solid) {
      const bool kill_pre = fact0 && valid && !taint_before
          && ((fdmin >= 0.0f && __fsub_rn(new_min, margin) > k.solid_max_y)
              || (fdmax <= 0.0f
                  && __fadd_rn(new_max, margin) < k.solid_min_y));
      const unsigned kills = __ballot_sync(kAll, kill_pre);
      gate = gate && !(killed || (kills & upto) != 0);
      killed = killed || kills != 0;
    }

    // stage B: a gated step's rank among the ray's gated steps
    const unsigned gates = __ballot_sync(kAll, gate);
    const int rank = gated + __popc(gates & below);
    gated += __popc(gates);
    if (gate && rank < k.GK) {
      const size_t i = static_cast<size_t>(rank) * Rk + t;
      packed[i] = make_int4(cell_index(gw, win, lodc, lod, xc, zc), i0, i1,
                            lod);
      proc[i] = 1;
    } else if (gate && rank == k.GK) {
      // the first unprocessed gated cell: its pre-switch snapshot
      const int* v = visits + static_cast<size_t>(c * kNVF + 6) * Rk + t;
      #pragma unroll
      for (int f = 0; f < kSnap; ++f) {
        int word = __ldg(v + static_cast<size_t>(f) * Rk);
        if (f >= 2 && f < 6) {
          word = __float_as_int(__fadd_rn(__int_as_float(word), 0.0f));
        }
        snap_out[static_cast<size_t>(f) * Rk + t] = word;
      }
    }
  }

  const int cap = min(gated, k.GK);
  for (int q = cap + lane; q < k.GK; q += 32) {
    const size_t i = static_cast<size_t>(q) * Rk + t;
    packed[i] = make_int4(0, 0, 0, 0);
    proc[i] = 0;
  }
  if (gated <= k.GK && lane < kSnap) {
    snap_out[static_cast<size_t>(lane) * Rk + t] = 0;
  }
  if (lane == 0) {
    count_out[t] = gated;
    cap_out[t] = cap;
    if (killed) ry.alive[r] = 0;
    if (overflow_steps) {
      atomicAdd(counters + 1, static_cast<unsigned long long>(overflow_steps));
    }
  }
}

struct Dda {
  int* pos;
  float* tmax;
  float* tdelta;
  int* stp;
  float* ids;
  int* lod;
};

// raymarch.rewind_apply for slot t, in place
__global__ void rewind_kernel(int Rk, const int* __restrict__ index,
                              const int* __restrict__ count,
                              const int* __restrict__ cap,
                              const int* __restrict__ snap,
                              const uint8_t* __restrict__ rs_alive, Dda d,
                              uint8_t* __restrict__ alive,
                              unsigned long long* __restrict__ rewound,
                              unsigned long long* __restrict__ counters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counters + 2, 1ull);
  bool needs = false;
  if (t < Rk) {
    const int r = index ? __ldg(index + t) : t;
    needs = __ldg(count + t) > __ldg(cap + t) && rs_alive[r] != 0;
    if (needs) {
      const int lod_rw = __ldg(snap + 6 * Rk + t);
      // torch.ldexp: a multiply by the exact power of two
      const float scale = ldexpf(1.0f, lod_rw - d.lod[r]);
      d.pos[2 * r] = __ldg(snap + t);
      d.pos[2 * r + 1] = __ldg(snap + Rk + t);
      d.tmax[2 * r] = __int_as_float(__ldg(snap + 2 * Rk + t));
      d.tmax[2 * r + 1] = __int_as_float(__ldg(snap + 3 * Rk + t));
      d.tdelta[2 * r] = __fmul_rn(d.tdelta[2 * r], scale);
      d.tdelta[2 * r + 1] = __fmul_rn(d.tdelta[2 * r + 1], scale);
      for (int a = 0; a < 2; ++a) {
        const int s = d.stp[2 * r + a];
        d.stp[2 * r + a] = ((s > 0) - (s < 0)) * (1 << lod_rw);
      }
      d.ids[2 * r] = __int_as_float(__ldg(snap + 4 * Rk + t));
      d.ids[2 * r + 1] = __int_as_float(__ldg(snap + 5 * Rk + t));
      d.lod[r] = lod_rw;
      alive[r] = 1;
    }
  }
  const unsigned n = __popc(__ballot_sync(kAll, needs));
  if ((threadIdx.x & 31) == 0 && n) {
    atomicAdd(rewound, static_cast<unsigned long long>(n));
  }
}

}  // namespace

// visits: (C, 13, Rk) int32; index: (Rk,) int32 or null; occ: (n_tiles, 8)
// int32; win: (4,) int32 on the device or null; fdir_min .. alive: the
// raster state's (R,) fields; cam_y_ray: (R,) f32 or null for the scalar
// cam_y; has_solid: the solid bounds are set; packed (GK, Rk, 4), proc
// (GK, Rk) bool, count and cap (Rk,), snap (7, Rk) int32: written;
// counters: (3,) int64 [gate launches, overflow steps, rewind launches],
// the first two added to.
extern "C" int cpuvox_gate(
    void* visits, int C, int Rk, void* index, void* occ, int n_tiles,
    void* tile_base, void* tile_gz, void* col_base, void* grid_z, void* win,
    void* fdir_min, void* fdir_max, void* f_active, void* alive,
    void* cam_y_ray, float cam_y, float world_max_y, float eps,
    int has_solid, float solid_min_y, float solid_max_y, int GK,
    void* packed, void* proc, void* count, void* cap, void* snap,
    void* counters, void* stream) {
  if (Rk > 0 && C > 0) {
    const size_t smem = sizeof(int) * kFields * C * kStride;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const GateWorld gw{static_cast<const int*>(occ), n_tiles,
                       static_cast<const int*>(tile_base),
                       static_cast<const int*>(tile_gz),
                       static_cast<const int*>(col_base),
                       static_cast<const int*>(grid_z),
                       static_cast<const int*>(win)};
    const GateRays ry{static_cast<const float*>(fdir_min),
                      static_cast<const float*>(fdir_max),
                      static_cast<const uint8_t*>(f_active),
                      static_cast<uint8_t*>(alive),
                      static_cast<const float*>(cam_y_ray)};
    const GateConsts k{cam_y, world_max_y, eps, solid_min_y, solid_max_y,
                       has_solid, C, GK, C / 8 + 4};
    gate_kernel<<<(Rk + kRays - 1) / kRays, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(visits), Rk, static_cast<const int*>(index),
        gw, ry, k, static_cast<int4*>(packed), static_cast<uint8_t*>(proc),
        static_cast<int*>(count), static_cast<int*>(cap),
        static_cast<int*>(snap), static_cast<unsigned long long*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}

// count, cap, snap: the gate's; rs_alive: the raster state's alive after
// the rasterizer; pos .. lod: the DDA state (R, .), written in place;
// alive: the march's (R,) bool; rewound: () int64, added to; counters: the
// gate's (3,) int64, its rewind launches added to.
extern "C" int cpuvox_gate_rewind(
    int Rk, void* index, void* count, void* cap, void* snap, void* rs_alive,
    void* pos, void* tmax, void* tdelta, void* stp, void* ids, void* lod,
    void* alive, void* rewound, void* counters, void* stream) {
  if (Rk > 0) {
    const int threads = 256;
    rewind_kernel<<<(Rk + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        Rk, static_cast<const int*>(index), static_cast<const int*>(count),
        static_cast<const int*>(cap), static_cast<const int*>(snap),
        static_cast<const uint8_t*>(rs_alive),
        Dda{static_cast<int*>(pos), static_cast<float*>(tmax),
            static_cast<float*>(tdelta), static_cast<int*>(stp),
            static_cast<float*>(ids), static_cast<int*>(lod)},
        static_cast<uint8_t*>(alive),
        static_cast<unsigned long long*>(rewound),
        static_cast<unsigned long long*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
