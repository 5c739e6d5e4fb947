// Per-clause true counts of a window of K CNFs under B chain assignments:
//
//   out[k,b,c] = #{ l < n(k,c) : cvars[k,c,l] > 0  and
//                                assign[k,b,cvars[k,c,l]] == csign[k,c,l] }
//
// where n(k,c) = min(clen[k,c], L) when the row lengths clen are given (the
// packer's tables: every zero of a row lies at or past its clen) and L when
// they are not (tables with zeros anywhere).
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/clause_eval/kernel.py  clause_eval_window_pallas
//   src/repro/kernels/clause_eval/kernel.py  clause_eval_pallas (K = 1)
// The Pallas body stages a [block_b, V+1] assignment block in VMEM and
// gathers a [block_b, block_c, L] cube with one vectorised take.
//
// What bounds it on an H100: bytes, and almost all of them the output. The
// mapper's windows are sparse: at sha 8x8 the [K,C,L] table has 329 M slots
// and 1.3 M literals (mean clause length 2, 14 rows a formula longer than
// 8, the longest 512), so a kernel that reads every slot moves 1.65 GB
// where the function needs the literals (sum of clen x 5 bytes), clen, the
// assignments, and K*B*C*4 bytes of counts. Read from the padded table, a
// row's first literals still cost a 32-byte sector, from rows L*4 bytes
// apart (2 KB at 8x8).
//
// Design, two launches:
// 1. planes: the assignments become bit-planes, planes[k][v][w] bit j =
//    assign[k, 32w + j, v], so one 32-bit word holds a variable's value in
//    32 chains. A thread builds one word from 32 byte loads that neighbouring
//    threads (neighbouring v) make coalesced.
// 2. eval: one block per (formula k, tile of up to 256 chains, tile of
//    clauses). The block copies its planes, (V+1) words per 32 chains, into
//    shared memory (45 KB at sha 8x8 with 256 chains), so every literal read
//    once from device memory serves all chains of the tile: its truth in 32
//    chains is one shared load and one xor. Lanes run over consecutive
//    clauses, so each chain's row out[k,b,:] is written coalesced.
//    - A row of at most kShort slots (nearly all of them) is one thread's:
//      it reads the row's slots [0, n) and nothing after them, adds the
//      literals' truth words into 4-bit bit-sliced counters (32 chains at
//      once), and writes the 32 counts of each word.
//    - A longer row (row 0 of each sha formula, of 128 or 512 literals, the
//      at-least-once rows of 16 or 64, or every row of a table without
//      clen) goes to a queue that all warps of the block take rows from, a
//      warp a row, lanes over slots: kGroup batches of 32 slots are loaded
//      before any is used, a batch with no literal is skipped, and each
//      chain's count is a popcount of a warp ballot. One thread alone would
//      stall its warp for n x B steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 8;       // chains of a block tile: 8 x 32 = 256
constexpr int kShort = 8;          // longest row that one thread takes
constexpr int kGroup = 8;          // 32-slot batches of a long row in flight
constexpr int kMaxSmem = 232448;   // H100: 227 KB of dynamic shared memory
constexpr int kTargetBlocks = 4 * 132;

__global__ void __launch_bounds__(kThreads)
planes_kernel(const uint8_t* __restrict__ assign,
              uint32_t* __restrict__ planes, int B, int V1, int W) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  const int k = blockIdx.z;
  if (v >= V1) return;
  const int b0 = w * 32;
  const int nb = min(32, B - b0);
  const uint8_t* a = assign + ((size_t)k * B + b0) * V1 + v;
  uint32_t word = 0;
  for (int i = 0; i < nb; ++i)
    word |= (uint32_t)(a[(size_t)i * V1] != 0) << i;
  planes[((size_t)k * V1 + v) * W + w] = word;
}

// the truth word of literal (v, s) in 32 chains; 0 for padding
__device__ __forceinline__ uint32_t truth(const uint32_t* sp, int v,
                                          uint8_t s, int V1, int Wt, int w) {
  if (v <= 0 || v >= V1) return 0u;
  const uint32_t p = sp[v * Wt + w];
  return s ? p : ~p;
}

// a long row's counts by one warp, lanes over slots, kGroup batches of 32
// slots loaded before any is used; a batch with no literal is skipped
__device__ void long_row(const uint32_t* sp, const int32_t* __restrict__ cv,
                         const uint8_t* __restrict__ cs, int n, int V1,
                         int Wt, int nw, int B, int b_base, size_t C,
                         int32_t* o) {
  const int lane = threadIdx.x & 31;
  int acc[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) acc[w] = 0;
  for (int g0 = 0; g0 < n; g0 += 32 * kGroup) {
    int v[kGroup];
    uint8_t s[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int l = g0 + 32 * q + lane;
      v[q] = l < n ? cv[l] : 0;
      s[q] = l < n ? cs[l] : 0;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (!__ballot_sync(0xffffffffu, v[q] > 0 && v[q] < V1)) continue;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        if (w < nw) {
          const uint32_t t = truth(sp, v[q], s[q], V1, Wt, w);
          int mine = 0;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int cnt = __popc(__ballot_sync(0xffffffffu, (t >> j) & 1u));
            if (lane == j) mine = cnt;
          }
          acc[w] += mine;
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const int b = b_base + w * 32 + lane;
    if (w < nw && b < B) o[(size_t)b * C] = acc[w];
  }
}

__global__ void __launch_bounds__(kThreads)
eval_kernel(const uint32_t* __restrict__ planes,
            const int32_t* __restrict__ cvars,
            const uint8_t* __restrict__ csign,
            const int32_t* __restrict__ clen, int32_t* __restrict__ out,
            int B, int V1, int C, int L, int W, int Wt, int tile) {
  extern __shared__ uint32_t sp[];   // [V1][Wt] planes of this chain tile
  __shared__ int queue[kThreads];    // this round's long rows
  __shared__ int queued[2];          // their count, by round parity
  const int k = blockIdx.z;
  const int w0 = blockIdx.y * Wt;
  const int nw = min(Wt, W - w0);    // words of this tile
  const uint32_t* pk = planes + (size_t)k * V1 * W + w0;
  for (int i = threadIdx.x; i < V1 * nw; i += kThreads) {
    const int v = i / nw, w = i - v * nw;
    sp[v * Wt + w] = pk[(size_t)v * W + w];
  }
  if (threadIdx.x == 0) queued[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c_begin = blockIdx.x * tile;
  const int c_end = min(C, c_begin + tile);
  const int b_base = w0 * 32;
  int32_t* ok = out + (size_t)k * B * C;
  int round = 0;
  // rounds of kThreads clauses; every thread runs the same rounds
  for (int base = c_begin; base < c_end; base += kThreads, round ^= 1) {
    const int c = base + threadIdx.x;
    const bool valid = c < c_end;
    int n = 0;
    if (valid) n = clen ? min(max(clen[(size_t)k * C + c], 0), L) : L;
    const bool is_long = valid && n > kShort;
    const size_t row = ((size_t)k * C + c) * L;

    if (valid && !is_long) {
      int v[kShort];
      uint8_t s[kShort];
#pragma unroll
      for (int l = 0; l < kShort; ++l) {
        v[l] = 0;
        s[l] = 0;
        if (l < n) {
          v[l] = cvars[row + l];
          s[l] = csign[row + l];
        }
      }
      for (int w = 0; w < nw; ++w) {
        // 4-bit counters, bit j of s_i = bit i of chain j's count (<= 8)
        uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
        for (int l = 0; l < kShort; ++l) {
          const uint32_t t = truth(sp, v[l], s[l], V1, Wt, w);
          const uint32_t c0 = s0 & t;
          s0 ^= t;
          const uint32_t c1 = s1 & c0;
          s1 ^= c0;
          const uint32_t c2 = s2 & c1;
          s2 ^= c1;
          s3 ^= c2;
        }
        const int bw = b_base + w * 32;
        int32_t* o = ok + (size_t)bw * C + c;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (bw + j < B)
            o[(size_t)j * C] = (int32_t)(((s0 >> j) & 1u) |
                                         (((s1 >> j) & 1u) << 1) |
                                         (((s2 >> j) & 1u) << 2) |
                                         (((s3 >> j) & 1u) << 3));
        }
      }
    }

    // the round's long rows go to a queue that all warps of the block
    // share, so that a warp with several long rows does not hold the rest
    const uint32_t longs = __ballot_sync(0xffffffffu, is_long);
    if (longs) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&queued[round], __popc(longs));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (is_long) queue[at + __popc(longs & ((1u << lane) - 1u))] = c;
    }
    __syncthreads();
    const int nq = queued[round];
    if (threadIdx.x == 0) queued[round ^ 1] = 0;   // last read a round ago
    for (int q = warp; q < nq; q += kWarps) {
      const int cl = queue[q];
      const int nl = clen ? min(max(clen[(size_t)k * C + cl], 0), L) : L;
      const size_t rl = ((size_t)k * C + cl) * L;
      long_row(sp, cvars + rl, csign + rl, nl, V1, Wt, nw, B, b_base, C,
               ok + cl);
    }
    __syncthreads();   // the queue is free for the next round
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// assign [K,B,V1] bytes 0/1; cvars [K,C,L] int32 (1-based, 0 = padding);
// csign [K,C,L] bytes 0/1; clen [K,C] int32 row lengths, or null to read
// whole rows; planes scratch of K*V1*ceil(B/32) words; out [K,B,C] int32.
// All contiguous, on the device of `stream`. Returns the CUDA error code of
// the launches (0 = launched).
int clause_eval_window(const void* assign, const void* cvars,
                       const void* csign, const void* clen, void* planes,
                       void* out, int K, int B, int V1, int C, int L,
                       void* stream) {
  if (K <= 0 || B <= 0 || C <= 0) return 0;   // nothing to count
  if (V1 <= 0 || L < 0) return cudaErrorInvalidValue;
  const int W = (B + 31) / 32;
  const int Wt = std::min(std::min(W, kMaxWords),
                          kMaxSmem / (V1 * (int)sizeof(uint32_t)));
  if (Wt <= 0) return cudaErrorInvalidValue;   // one plane > shared memory
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  planes_kernel<<<dim3((V1 + kThreads - 1) / kThreads, W, K), kThreads, 0,
                  s>>>(static_cast<const uint8_t*>(assign),
                       static_cast<uint32_t*>(planes), B, V1, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)V1 * Wt * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  // clauses per thread: enough blocks to fill the card, fewer plane copies
  const int ytiles = (W + Wt - 1) / Wt;
  const long long rows = (long long)K * C * ytiles;
  const int per_thread = (int)std::max(
      1LL, std::min(16LL, rows / ((long long)kThreads * kTargetBlocks)));
  const int tile = kThreads * per_thread;
  eval_kernel<<<dim3((C + tile - 1) / tile, ytiles, K), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(planes),
      static_cast<const int32_t*>(cvars), static_cast<const uint8_t*>(csign),
      static_cast<const int32_t*>(clen), static_cast<int32_t*>(out), B, V1,
      C, L, W, Wt, tile);
  return cudaGetLastError();
}

}  // extern "C"
