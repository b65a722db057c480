// The march loop's control, and the CUDA graph that loops the march on it.
//
// Replaces the condition of the JAX march's lax.while_loop
// (cpuvox_tpu/render/raymarch.py:928-930 for the dense march, :1542 and
// :1583 for the gated one): `(i < max_chunks) & any(alive & rs.alive)`,
// which on the TPU lives inside the jitted program, so the frame never asks
// the host.  No Pallas kernel computes it there; XLA does.  Its plain
// version is cpuvox_tpu_torch.render.raymarch.loop_control.
//
// march_loop_kernel, one block of kThreads threads:
//  - folds the rasterizer's liveness into the roll's, alive &= rs_alive
//    (the torch op it replaces), as 4-byte words where R and both pointers
//    allow it;
//  - reduces "any ray alive" over the block (__syncthreads_or);
//  - counts the iteration (first = 1: sets the counter to 0, the check
//    before the first iteration) and sets the WHILE node's condition,
//    any && counter < max_chunks, with cudaGraphSetConditional.
// What bounds it on the H100: nothing the card does fast.  It reads 2 R
// bytes and writes R (27 KB at R = 9,088), a few nanoseconds of HBM; a
// launch is latency: one block's loads, its barrier and thread 0's stores.
// One block because the condition is one value and a second pass or a
// grid-wide atomic would cost more than the pass itself.  No float math.
//
// cpuvox_march_graph_create builds the graph of a frame's march from two
// graphs torch captured (render/march_graph.py): the prologue (the raster
// state's reset) and one iteration's body (roll, gate glue, rasterizer,
// rewind, the copies back into the state's buffers).  The parent graph is
//   [prologue, a child graph]
//   -> [march_loop_kernel, first = 1: no iteration runs when no ray lives]
//   -> [WHILE conditional node: [the body, a child graph]
//                               -> [march_loop_kernel, first = 0]]
// and is instantiated once; a frame is one cudaGraphLaunch.  The body holds
// only what a conditional body may hold (kernels, memsets, device-to-device
// copies, child graphs); torch's temporaries live in the capture's private
// pool.  Conditional nodes need CUDA 12.4 or later.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    march_loop_kernel(uint8_t* alive, const uint8_t* rs_alive, int R,
                      int* counter, int max_chunks, int first, int* cond_out,
                      cudaGraphConditionalHandle handle, int set_handle) {
  int any = 0;
  const bool words =
      R % 4 == 0 && ((reinterpret_cast<uintptr_t>(alive) |
                      reinterpret_cast<uintptr_t>(rs_alive)) & 3) == 0;
  if (words) {
    auto* a = reinterpret_cast<uint32_t*>(alive);
    const auto* b = reinterpret_cast<const uint32_t*>(rs_alive);
    for (int w = threadIdx.x; w < R / 4; w += kThreads) {
      const uint32_t v = a[w] & b[w];
      a[w] = v;
      any |= v != 0u;
    }
  } else {
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const uint8_t v = alive[r] & rs_alive[r];
      alive[r] = v;
      any |= v != 0;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    const int i = first ? 0 : *counter + 1;
    *counter = i;
    const unsigned int go = any && i < max_chunks ? 1u : 0u;
    if (cond_out != nullptr) *cond_out = static_cast<int>(go);
    if (set_handle) cudaGraphSetConditional(handle, go);
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

cudaError_t create(cudaGraph_t graph, cudaGraph_t prologue, cudaGraph_t body,
                   uint8_t* alive, const uint8_t* rs_alive, int R,
                   int* counter, int max_chunks, cudaGraphExec_t* exec) {
  cudaGraphNode_t pro, init, loop, child, control;
  cudaError_t err = cudaGraphAddChildGraphNode(&pro, graph, nullptr, 0,
                                               prologue);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;

  int first = 1;
  int set_handle = 1;
  int* cond_out = nullptr;
  void* args[] = {&alive, &rs_alive, &R, &counter, &max_chunks,
                  &first, &cond_out, &handle, &set_handle};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(march_loop_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(kThreads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  err = cudaGraphAddKernelNode(&init, graph, &pro, 1, &kp);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  err = add_conditional(&loop, graph, &init, &cp);
  if (err != cudaSuccess) return err;
  cudaGraph_t loop_body = cp.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0, body);
  if (err != cudaSuccess) return err;
  first = 0;  // the node copies its arguments when it is added
  err = cudaGraphAddKernelNode(&control, loop_body, &child, 1, &kp);
  if (err != cudaSuccess) return err;
  return cudaGraphInstantiate(exec, graph, 0);
}

}  // namespace

// One eager launch of the control kernel (no graph): its condition goes to
// cond_out ((), int32), for the comparisons with the plain version.
extern "C" int cpuvox_march_loop(void* alive, void* rs_alive, int R,
                                 void* counter, int max_chunks, int first,
                                 void* cond_out, void* stream) {
  march_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(alive), static_cast<const uint8_t*>(rs_alive), R,
      static_cast<int*>(counter), max_chunks, first,
      static_cast<int*>(cond_out), cudaGraphConditionalHandle{}, 0);
  return static_cast<int>(cudaGetLastError());
}

// The frame's march graph from the captured prologue and body (cudaGraph_t
// each; cloned into child nodes, so the caller keeps them), instantiated
// into *exec_out.
extern "C" int cpuvox_march_graph_create(void* prologue, void* body,
                                         void* alive, void* rs_alive, int R,
                                         void* counter, int max_chunks,
                                         void** exec_out) {
  *exec_out = nullptr;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphExec_t exec = nullptr;
  err = create(graph, static_cast<cudaGraph_t>(prologue),
               static_cast<cudaGraph_t>(body), static_cast<uint8_t*>(alive),
               static_cast<const uint8_t*>(rs_alive), R,
               static_cast<int*>(counter), max_chunks, &exec);
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
