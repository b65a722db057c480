// Kernel 3: the phase-2 raybuffer sample.
//
// Replaces cpuvox_tpu/ops/reproject_kernel.py::sample_raybuffer.  The plain
// version is cpuvox_tpu_torch.ops.reproject_kernel.sample_raybuffer_ref.
//
// out[i, j] = rb[clamp(ri[i, j], 0, R - 1), j] where mask[i, j] != 0, else -1.
//
// What bounds it on the H100: bytes.  Per output element it reads ri and
// mask (8 B, coalesced), one raybuffer texel and writes 4 B; at 1080p that is
// ~2 M elements per pass, ~40 MB of traffic in all, about 12 us at the card's
// 3.35 TB/s.  The texel column j rides the fast thread index, so a warp reads
// 32 neighbouring texels of (mostly) one raybuffer row, which is coalesced
// wherever the ray index varies slowly along j.  The TPU kernel's windowed
// select loop existed because Mosaic has no per-lane gather; here the
// gather is an ordinary load, one thread per element.

#include "common.cuh"

namespace {

__global__ void sample_raybuffer_kernel(const int* __restrict__ rb, int R,
                                        int PL, const int* __restrict__ ri,
                                        const int* __restrict__ mask, int NI,
                                        int NJ, int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= NJ || i >= NI) return;
  const size_t e = static_cast<size_t>(i) * NJ + j;
  int v = -1;
  if (mask[e] != 0) {
    const int row = min(max(ri[e], 0), R - 1);
    v = rb[static_cast<size_t>(row) * PL + j];
  }
  out[e] = v;
}

}  // namespace

extern "C" int cpuvox_sample_raybuffer(void* rb, int R, int PL, void* ri,
                                       void* mask, int NI, int NJ, void* out,
                                       void* stream) {
  if (NI > 0 && NJ > 0) {
    const int threads = 128;
    const dim3 grid((NJ + threads - 1) / threads, NI);
    sample_raybuffer_kernel<<<grid, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rb), R, PL, static_cast<const int*>(ri),
        static_cast<const int*>(mask), NI, NJ, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cpuvox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
