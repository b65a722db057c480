// The march loop's control, and the CUDA graph that loops the march on it.
//
// Replaces the condition of the JAX march's lax.while_loop
// (cpuvox_tpu/render/raymarch.py:928-930 for the dense march, :1542 and
// :1583 for the gated one, :1126-1129 for a stage of the staged march):
// `(i < max_chunks) & (count(alive & rs.alive) > threshold)`, which on the
// TPU lives inside the jitted program, so the frame never asks the host.
// Threshold 0 is the unstaged loop's `any`; a stage's threshold is the next
// stage's width.  No Pallas kernel computes it there; XLA does.  Its plain
// version is cpuvox_tpu_torch.render.raymarch.loop_control.
//
// march_loop_kernel, one block of kThreads threads:
//  - folds the rasterizer's liveness into the roll's, alive &= rs_alive
//    (the torch op it replaces), as 4-byte words where R and both pointers
//    allow it;
//  - counts the live rays: the bytes are 0 or 1, so a word's __popc is its
//    live rays; a warp sum, then one shared add a warp;
//  - advances the counter by mode: kFirst sets it to 0 (the check before
//    the first iteration), kNext adds one (after an iteration), kCheck
//    leaves it (the check before a later stage: the iterations go on
//    counting across stages, as JAX's i_total does);
//  - writes the counter to exit_out where there is one (a stage's slot of
//    the graph's exit buffer: its last write is the counter at the stage's
//    exit), and sets the WHILE node's condition, count > threshold &&
//    counter < max_chunks, with cudaGraphSetConditional;
//  - on a sampled frame of a Renderer's frame graph (timer.cuh), folds
//    the iteration's roll and rasterizer launches and then itself into the
//    timer buffer and, where it lets an iteration run, adds the live rays
//    and the stage's width (the slots the iteration marches).
// What bounds it on the H100: nothing the card does fast.  It reads 2 R
// bytes and writes R (27 KB at R = 9,088), a few nanoseconds of HBM; a
// launch is latency: one block's loads, its barriers and thread 0's
// stores.  One block because the condition is one value and a second pass
// or a grid-wide atomic would cost more than the pass itself.  No float
// math.
//
// cpuvox_march_graph_create builds the graph of a frame's march from graphs
// torch captured (render/march_graph.py): the prologue (the raster state's
// reset), each stage's body (one iteration on the stage's live-ray index:
// roll, gate glue, rasterizer, rewind, the copies back into the state's
// buffers) and the pack between two stages (the next stage's index).  The
// parent graph is
//   [prologue, a child graph]
//   -> for each stage k:
//        [march_loop_kernel: kFirst for k = 0, kCheck after; no iteration
//         of the stage runs when no more rays live than the next holds]
//        -> [WHILE conditional node k: [body k, a child graph]
//                                      -> [march_loop_kernel, kNext]]
//        -> [pack k -> k + 1, a child graph] (not after the last stage)
// with a conditional handle a WHILE node, and is instantiated once; a frame
// is one cudaGraphLaunch.  The unstaged march is the one-stage case.  A
// body holds only what a conditional body may hold (kernels, memsets,
// device-to-device copies, child graphs); torch's temporaries live in the
// captures' private pool.  Conditional nodes need CUDA 12.4 or later.
//
// cpuvox_globaltimer reads %globaltimer once (the host maps the card's
// clock onto its own with it) and cpuvox_globaltimer_steps reads it until
// it has changed n times (its update granularity).

#include <cstdint>

#include <cuda_runtime.h>

#include "timer.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kFirst = 0;
constexpr int kNext = 1;
constexpr int kCheck = 2;

__global__ void __launch_bounds__(kThreads)
    march_loop_kernel(uint8_t* alive, const uint8_t* rs_alive, int R,
                      int* counter, int max_chunks, int mode, int threshold,
                      int* exit_out, int* cond_out,
                      cudaGraphConditionalHandle handle, int set_handle,
                      int width, long long* timer) {
  __shared__ int warp_counts[kWarps];
  // thread 0's: the sampled word is waited for only at the end
  const bool timed = threadIdx.x == 0 && cpuvox::timed(timer);
  const long long start = timer != nullptr ? cpuvox::globaltimer() : 0;
  int count = 0;
  const bool words =
      R % 4 == 0 && ((reinterpret_cast<uintptr_t>(alive) |
                      reinterpret_cast<uintptr_t>(rs_alive)) & 3) == 0;
  if (words) {
    auto* a = reinterpret_cast<uint32_t*>(alive);
    const auto* b = reinterpret_cast<const uint32_t*>(rs_alive);
    for (int w = threadIdx.x; w < R / 4; w += kThreads) {
      const uint32_t v = a[w] & b[w];
      a[w] = v;
      count += __popc(v);
    }
  } else {
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const uint8_t v = alive[r] & rs_alive[r];
      alive[r] = v;
      count += v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    const int i = mode == kFirst  ? 0
                  : mode == kNext ? *counter + 1
                                  : *counter;
    *counter = i;
    if (exit_out != nullptr) *exit_out = i;
    const unsigned int go = total > threshold && i < max_chunks ? 1u : 0u;
    if (cond_out != nullptr) *cond_out = static_cast<int>(go);
    if (set_handle) cudaGraphSetConditional(handle, go);
    if (timed) {
      if (go) {
        timer[cpuvox::kLive] += total;
        timer[cpuvox::kSlots] += width;
      }
      cpuvox::fold_pending(timer, cpuvox::kRollTimer);
      cpuvox::fold_pending(timer, cpuvox::kRasterTimer);
      cpuvox::fold_launch(timer, cpuvox::kControlTimer, start,
                          cpuvox::globaltimer());
    }
  }
}

__global__ void globaltimer_kernel(long long* out) {
  *out = cpuvox::globaltimer();
}

__global__ void globaltimer_steps_kernel(long long* out, int n) {
  long long last = cpuvox::globaltimer();
  out[0] = last;
  for (int k = 1; k <= n;) {
    const long long now = cpuvox::globaltimer();
    if (now != last) {
      out[k++] = now;
      last = now;
    }
  }
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* dep,
                            cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, dep, nullptr, 1, params);
#else
  return cudaGraphAddNode(node, graph, dep, 1, params);
#endif
}

// The control kernel's launch as a node's parameters; the node copies the
// arguments when it is added, so one Control serves every node.
struct Control {
  uint8_t* alive;
  const uint8_t* rs_alive;
  int R;
  int* counter;
  int max_chunks;
  int mode = kFirst;
  int threshold = 0;
  int* exit_out = nullptr;
  int* cond_out = nullptr;
  cudaGraphConditionalHandle handle = 0;
  int set_handle = 1;
  int width = 0;
  long long* timer = nullptr;

  cudaError_t add(cudaGraphNode_t* node, cudaGraph_t graph,
                  const cudaGraphNode_t* dep) {
    void* args[] = {&alive,     &rs_alive,   &R,         &counter,
                    &max_chunks, &mode,      &threshold, &exit_out,
                    &cond_out,  &handle,     &set_handle, &width,
                    &timer};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(march_loop_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(kThreads);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    kp.extra = nullptr;
    return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &kp);
  }
};

#define RETURN_IF(err)                   \
  do {                                   \
    const cudaError_t e_ = (err);        \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

cudaError_t create(cudaGraph_t graph, cudaGraph_t prologue, int n_stages,
                   cudaGraph_t const* bodies, cudaGraph_t const* packs,
                   const int* thresholds, Control ctl, int* exits,
                   cudaGraphExec_t* exec) {
  cudaGraphNode_t prev;
  RETURN_IF(cudaGraphAddChildGraphNode(&prev, graph, nullptr, 0, prologue));
  for (int k = 0; k < n_stages; ++k) {
    RETURN_IF(cudaGraphConditionalHandleCreate(&ctl.handle, graph, 0,
                                               cudaGraphCondAssignDefault));
    ctl.threshold = thresholds[k];
    ctl.width = k == 0 ? ctl.R : thresholds[k - 1];  // the stage's rays
    ctl.exit_out = exits + k;
    ctl.mode = k == 0 ? kFirst : kCheck;
    cudaGraphNode_t check, loop, child, control;
    RETURN_IF(ctl.add(&check, graph, &prev));

    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = ctl.handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    RETURN_IF(add_conditional(&loop, graph, &check, &cp));
    cudaGraph_t loop_body = cp.conditional.phGraph_out[0];
    RETURN_IF(cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0,
                                         bodies[k]));
    ctl.mode = kNext;
    RETURN_IF(ctl.add(&control, loop_body, &child));
    prev = loop;
    if (k + 1 < n_stages) {
      cudaGraphNode_t pack;
      RETURN_IF(cudaGraphAddChildGraphNode(&pack, graph, &prev, 1, packs[k]));
      prev = pack;
    }
  }
  return cudaGraphInstantiate(exec, graph, 0);
}

}  // namespace

// One eager launch of the control kernel (no graph): mode 0 (first), 1
// (next) or 2 (check); the counter to exit_out (int32, or null) and the
// condition to cond_out ((), int32), for the comparisons with the plain
// version.
extern "C" int cpuvox_march_loop(void* alive, void* rs_alive, int R,
                                 void* counter, int max_chunks, int mode,
                                 int threshold, void* exit_out,
                                 void* cond_out, void* stream) {
  march_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(alive), static_cast<const uint8_t*>(rs_alive), R,
      static_cast<int*>(counter), max_chunks, mode, threshold,
      static_cast<int*>(exit_out), static_cast<int*>(cond_out),
      cudaGraphConditionalHandle{}, 0, R, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// %globaltimer into out (int64 (), on the device).
extern "C" int cpuvox_globaltimer(void* out, void* stream) {
  globaltimer_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// %globaltimer's first n + 1 distinct values read by one thread into out
// (int64 (n + 1,), on the device).
extern "C" int cpuvox_globaltimer_steps(void* out, int n, void* stream) {
  globaltimer_steps_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// The frame's march graph from the captured prologue, the n_stages bodies
// and the n_stages - 1 packs (cudaGraph_t each; cloned into child nodes, so
// the caller keeps them), each stage's threshold, and the exit buffer
// (int32 (n_stages,)), and the timer buffer its control kernels are given
// (int64 (kTimerWords,), timer.cuh; null: untimed), instantiated into
// *exec_out.
extern "C" int cpuvox_march_graph_create(void* prologue, int n_stages,
                                         void** bodies, void** packs,
                                         const int* thresholds, void* alive,
                                         void* rs_alive, int R, void* counter,
                                         int max_chunks, void* exits,
                                         void* timer, void** exec_out) {
  *exec_out = nullptr;
  if (n_stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  Control ctl;
  ctl.alive = static_cast<uint8_t*>(alive);
  ctl.rs_alive = static_cast<const uint8_t*>(rs_alive);
  ctl.R = R;
  ctl.counter = static_cast<int*>(counter);
  ctl.max_chunks = max_chunks;
  ctl.timer = static_cast<long long*>(timer);
  cudaGraphExec_t exec = nullptr;
  err = create(graph, static_cast<cudaGraph_t>(prologue), n_stages,
               reinterpret_cast<cudaGraph_t const*>(bodies),
               reinterpret_cast<cudaGraph_t const*>(packs), thresholds, ctl,
               static_cast<int*>(exits), &exec);
  cudaGraphDestroy(graph);  // the executable graph does not need it
  if (err == cudaSuccess) *exec_out = exec;
  return static_cast<int>(err);
}

extern "C" int cpuvox_march_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int cpuvox_march_graph_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
