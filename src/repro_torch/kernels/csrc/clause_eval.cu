// Per-clause true counts of a window of K CNFs under B chain assignments:
//
//   out[k,b,c] = #{ l : cvars[k,c,l] > 0  and
//                       assign[k,b,cvars[k,c,l]] == csign[k,c,l] }
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/clause_eval/kernel.py  clause_eval_window_pallas
//   src/repro/kernels/clause_eval/kernel.py  clause_eval_pallas (K = 1)
// The Pallas body stages a [block_b, V+1] assignment block in VMEM and
// gathers a [block_b, block_c, L] cube with one vectorised take.
//
// What bounds it on an H100: bytes. Every clause literal is read once
// (cvars int32 + csign byte = 5 bytes, K*C*L of them), every count written
// once (K*B*C*4 bytes); the assignments are small (K*B*(V+1) bytes). There
// is no arithmetic to speak of: one compare and add per (chain, literal).
//
// Design: one block per (formula k, tile of up to kChains chains, tile of
// kThreads*kClausesPerThread clauses). The block first copies its chains'
// assignment rows (chains*(V+1) bytes, contiguous) into shared memory, so
// the data-dependent gathers hit shared memory and not device memory. Each
// thread then owns whole clauses: it walks the clause's L literals once and
// keeps one counter per chain in registers, so a literal read from device
// memory serves every chain of the tile. With B <= kChains (the mapper's
// window batch is 24 = 3 tiles) cvars/csign are read B/kChains times, the
// later reads mostly from L2 (50 MB holds a 4x4 window's clause tables).
// Rows of one warp are L*4 bytes apart, so a warp's loads are not coalesced;
// consecutive literals of a row come from the same cache lines, which L1
// serves. A coalesced layout (literal-major tiles through shared memory) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kClausesPerThread = 4;
constexpr int kMaxSmem = 232448;   // H100: 227 KB of dynamic shared memory

__global__ void __launch_bounds__(kThreads)
clause_eval_window_kernel(const uint8_t* __restrict__ assign,
                          const int32_t* __restrict__ cvars,
                          const uint8_t* __restrict__ csign,
                          int32_t* __restrict__ out,
                          int B, int V1, int C, int L, int chains) {
  extern __shared__ uint8_t sa[];   // [chains, V1]
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * chains;
  const int nb = min(chains, B - b0);
  const uint8_t* a = assign + ((size_t)k * B + b0) * V1;
  const int n = nb * V1;
  for (int i = threadIdx.x; i < n; i += kThreads) sa[i] = a[i];
  __syncthreads();

  const int tile = kThreads * kClausesPerThread;
  const int cend = min(C, (blockIdx.x + 1) * tile);
  for (int c = blockIdx.x * tile + threadIdx.x; c < cend; c += kThreads) {
    int cnt[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) cnt[j] = 0;
    const int32_t* cv = cvars + ((size_t)k * C + c) * L;
    const uint8_t* cs = csign + ((size_t)k * C + c) * L;
    for (int l = 0; l < L; ++l) {
      const int v = cv[l];
      if (v <= 0 || v >= V1) continue;   // 0 = padding
      const uint8_t s = cs[l] != 0;
#pragma unroll
      for (int j = 0; j < kChains; ++j)
        if (j < nb) cnt[j] += (sa[j * V1 + v] != 0) == s;
    }
    int32_t* o = out + ((size_t)k * B + b0) * C + c;
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      if (j < nb) o[(size_t)j * C] = cnt[j];
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// assign [K,B,V1] bytes 0/1; cvars [K,C,L] int32 (1-based, 0 = padding);
// csign [K,C,L] bytes 0/1; out [K,B,C] int32. All contiguous, on the
// device of `stream`. Returns the launch's CUDA error code (0 = launched).
int clause_eval_window(const void* assign, const void* cvars,
                       const void* csign, void* out, int K, int B, int V1,
                       int C, int L, void* stream) {
  if (K <= 0 || B <= 0 || C <= 0) return 0;   // nothing to count
  if (V1 <= 0 || L < 0) return cudaErrorInvalidValue;
  const int chains = std::min(kChains, std::min(B, kMaxSmem / V1));
  if (chains <= 0) return cudaErrorInvalidValue;   // one row > shared memory
  const size_t smem = (size_t)chains * V1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        clause_eval_window_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tile = kThreads * kClausesPerThread;
  dim3 grid((C + tile - 1) / tile, (B + chains - 1) / chains, K);
  clause_eval_window_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(assign), static_cast<const int32_t*>(cvars),
      static_cast<const uint8_t*>(csign), static_cast<int32_t*>(out), B, V1,
      C, L, chains);
  return cudaGetLastError();
}

}  // extern "C"
