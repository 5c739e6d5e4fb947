// Fused probSAT flip + incremental true-count update, one flip per chain:
//
//   assign[k,b,v_flip[k,b]] = new_val[k,b]
//   for o with occ_c[k,b,o] >= 0:
//     tc[k,b,occ_c[k,b,o]] += (occ_s[k,b,o] == new_val[k,b]) ? +1 : -1
//
// (repeated clause ids accumulate; v_flip 0 is the dummy variable of a
// solved chain, whose occurrence row is all -1). Updates assign and tc IN
// PLACE: the walk carries both tensors from step to step.
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/flip_update/kernel.py  flip_update_pallas
// The TPU has no per-row scatter, so the Pallas body is a dense one-hot
// compare-accumulate over the whole clause axis: O(C) work per chain.
//
// What bounds it on an H100: the launch itself. The function must move
// only about K*B*(O*9 + 1) bytes (the occurrence row, the new value, the
// counts it touches): tens to hundreds of KB at the mapper's shapes, so the
// fixed cost of a launch outweighs the memory time.
//
// Design: an O(O) scatter instead of the O(C) sweep. One warp per (k, b)
// chain: lane 0 writes the assignment byte, the 32 lanes stride over the O
// occurrences and apply atomicAdd(+-1) to the chain's true counts. Integer
// atomics are exact and their order does not matter, so the result is
// bit-identical to the plain version, repeated clause ids included. Ids
// outside [0, V1) or [0, C) are skipped (the walk never produces them).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 chains per block

__global__ void __launch_bounds__(kThreads)
flip_update_kernel(uint8_t* __restrict__ assign, int32_t* __restrict__ tc,
                   const int32_t* __restrict__ v_flip,
                   const int32_t* __restrict__ occ_c,
                   const uint8_t* __restrict__ occ_s,
                   const uint8_t* __restrict__ new_val,
                   int rows, int V1, int C, int O) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint8_t nv = new_val[row] != 0;
  if (lane == 0) {
    const int v = v_flip[row];
    if (v >= 0 && v < V1) assign[(size_t)row * V1 + v] = nv;
  }
  const int32_t* oc = occ_c + (size_t)row * O;
  const uint8_t* os = occ_s + (size_t)row * O;
  int32_t* t = tc + (size_t)row * C;
  for (int o = lane; o < O; o += 32) {
    const int c = oc[o];
    if (c >= 0 && c < C) atomicAdd(&t[c], ((os[o] != 0) == nv) ? 1 : -1);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// assign [K,B,V1] bytes 0/1 and tc [K,B,C] int32, both updated in place;
// v_flip [K,B] int32; occ_c [K,B,O] int32 (-1 = padding); occ_s [K,B,O]
// bytes 0/1; new_val [K,B] bytes 0/1. All contiguous, on the device of
// `stream`. Returns the launch's CUDA error code (0 = launched).
int flip_update(void* assign, void* tc, const void* v_flip,
                const void* occ_c, const void* occ_s, const void* new_val,
                int rows, int V1, int C, int O, void* stream) {
  if (rows <= 0) return 0;
  const int per_block = kThreads / 32;
  const int blocks = (rows + per_block - 1) / per_block;
  flip_update_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(assign), static_cast<int32_t*>(tc),
      static_cast<const int32_t*>(v_flip), static_cast<const int32_t*>(occ_c),
      static_cast<const uint8_t*>(occ_s), static_cast<const uint8_t*>(new_val),
      rows, V1, C, O);
  return cudaGetLastError();
}

}  // extern "C"
