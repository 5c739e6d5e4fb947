// Two kernels of the probSAT walk: the per-step flip update, and the walk
// chunk that runs whole steps (pick + flip + count update) in one launch.
//
// Both replace the TPU kernel of the JAX package:
//   src/repro/kernels/flip_update/kernel.py  flip_update_pallas
// The TPU has no per-row scatter, so the Pallas body is a dense one-hot
// compare-accumulate over the whole clause axis: O(C) work per chain. The
// JAX walk runs it inside one jitted device program per chunk (a
// lax.while_loop over the pick and this flip).
//
// ---- flip_update: one flip per chain ------------------------------------
//
//   assign[k,b,v_flip[k,b]] = new_val[k,b]
//   for o with occ_c[k,b,o] >= 0:
//     tc[k,b,occ_c[k,b,o]] += (occ_s[k,b,o] == new_val[k,b]) ? +1 : -1
//
// (repeated clause ids accumulate; v_flip 0 is the dummy variable of a
// solved chain, whose occurrence row is all -1). Updates assign and tc IN
// PLACE: the walk carries both tensors from step to step.
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
//
// ---- walk_chunk: n_steps whole probSAT steps per chain -------------------
//
// The contract of walk_chunk_ref (kernels/flip_update/ref.py), bit for
// bit. Per step s = step0 + t and chain r = k*B + b, with
// word(s, r, i, stream) = word i&3 of Philox4x32-10 at counter
// (i>>2, r, s, stream) under the two-word key:
//   clause: argmax of word(s,r,c,0)>>8 over the clauses with tc == 0,
//           lowest c on ties; none unsat -> the chain is solved, v = 0;
//   var:    argmax over l of g + w, lowest l on ties, where
//           g = -logf(-logf(max((word(s,r,l,1)>>8) * 2^-24, FLT_MIN))),
//           w = vs > 0 ? (float)(-cb) * log1pf(brk) : -1e30f, and brk
//           counts the occurrences of vs whose clause it alone satisfies;
//   flip:   as flip_update (new value = !assign[v]).
//
// What bounds it on an H100: latency, not bytes or operations. A step
// must read the chain's counts (4*C bytes) and a few occurrence rows;
// spread over the chunk, the pack and state bytes come to well under a
// microsecond a step (chip_smoke.py computes the bound), but every step
// depends on the one before: the clause pick needs the whole count row,
// the variable pick the pick before it, the flip the variable. So the
// per-step cost is a chain of block-wide reductions and dependent reads.
// The per-step design before this one paid ~30 launches and a host round
// of Python for each step instead.
//
// Design: one persistent block of 256 threads per chain, for the whole
// chunk. The chain's counts (and its assignment) live in dynamic shared
// memory when 4*C + 12*L + V1 bytes fit the 227 KB a block may hold (the
// "shared" route, 47 KB at the 4x4 window); otherwise in device memory,
// updated in place (the "global" route, the same code). The pack tables
// are read through the read-only path (24 MB at 4x4, inside the L2).
// Each step: the Gumbel noise of the L literal slots first (it does not
// depend on the state); (a) a strided 16-byte scan of the counts for
// zeros, four loads in flight per thread, Philox only for the groups of
// four that hold one (the generator is counter based, so drawing nothing
// for satisfied clauses changes no value), and a block argmax of (word,
// -index) as one 64-bit key; the picked clause's literal slots in one
// coalesced read; (b) one warp per literal, its lanes over the O
// occurrences, for the break count; (c) one thread per slot for the
// weight and a block argmax over L; (d) one warp scatters +-1 over the
// flipped variable's occurrences with atomicAdd (exact in any order).
// A solved chain whose dummy variable 0 occurs in no clause leaves the
// loop early and applies the parity of its remaining steps to
// assign[..., 0], which is what toggling it every step would give.
// Floating point: __fmul_rn/__fadd_rn keep nvcc from contracting g + w*x
// into an FMA that torch does not do; logf/log1pf (never __logf) are the
// functions torch's CUDA log/log1p call; -0 is folded into +0 before the
// float is turned into an ordered key, as argmax holds them equal.
#include <cfloat>
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

// ---- walk_chunk ----------------------------------------------------------

constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
typedef unsigned long long u64;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// a float as a uint32 whose unsigned order is the float's (no NaN here)
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the key of clause c with word w: larger word first, then lower index;
// 0 stands for "no unsat clause"
__device__ __forceinline__ u64 clause_key(uint32_t w, int c) {
  return ((u64)((w >> 8) + 1u) << 32) | (0xFFFFFFFFu - (uint32_t)c);
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const u64 x = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = x > v ? x : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The block's maximum, returned to every thread. One __syncthreads; `red`
// is free again after the caller's next __syncthreads.
__device__ __forceinline__ u64 block_max(u64 v, u64* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 m = red[0];
#pragma unroll
  for (int w = 1; w < kWalkWarps; ++w) m = red[w] > m ? red[w] : m;
  return m;
}

// One block per chain r = k*B + b. kShared: the chain's counts and
// assignment live in shared memory for the chunk (loaded first, written
// back last); otherwise they are updated in place in device memory.
template <bool kShared>
__global__ void __launch_bounds__(kWalkThreads)
walk_chunk_kernel(const int32_t* __restrict__ cvars,
                  const int32_t* __restrict__ ovars,
                  const uint8_t* __restrict__ osign,
                  uint8_t* __restrict__ assign_g, int32_t* __restrict__ tc_g,
                  int B, int C, int L, int V1, int O, uint32_t key0,
                  uint32_t key1, uint32_t step0, int n_steps, float ncb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 red[kWalkWarps];
  const int row = blockIdx.x;
  const int k = row / B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // shared layout: [tc: C int32 (shared route)][vs: L int32][brk: L int32]
  // [g: L float][assign: V1 bytes (shared route)]
  int32_t* tc;
  uint8_t* assign;
  int32_t* vs_s;
  if constexpr (kShared) {
    tc = reinterpret_cast<int32_t*>(smem);
    vs_s = tc + C;
    assign = reinterpret_cast<uint8_t*>(vs_s + 3 * L);
    const int32_t* tg = tc_g + (size_t)row * C;
    for (int c = tid; c < C; c += kWalkThreads) tc[c] = tg[c];
    const uint8_t* ag = assign_g + (size_t)row * V1;
    for (int v = tid; v < V1; v += kWalkThreads) assign[v] = ag[v];
  } else {
    tc = tc_g + (size_t)row * C;
    assign = assign_g + (size_t)row * V1;
    vs_s = reinterpret_cast<int32_t*>(smem);
  }
  int32_t* brk_s = vs_s + L;
  float* g_s = reinterpret_cast<float*>(brk_s + L);
  const int32_t* cv_k = cvars + (size_t)k * C * L;
  const int32_t* ov_k = ovars + (size_t)k * V1 * O;
  const uint8_t* os_k = osign + (size_t)k * V1 * O;
  // does the dummy variable 0 occur anywhere? (never, in a packed window)
  bool v0_occurs = false;
  for (int o = tid; o < O; o += kWalkThreads) v0_occurs |= __ldg(ov_k + o) >= 0;
  v0_occurs = __syncthreads_or(v0_occurs);
  const bool vec = (C & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(tc) & 15) == 0;
  const int nq = C >> 2;

  for (int t = 0; t < n_steps; ++t) {
    const uint32_t s = step0 + (uint32_t)t;
    // the Gumbel noise of every literal slot: it does not depend on the
    // state, so it is drawn first and its latency hides under the scan
    for (int l = tid; l < L; l += kWalkThreads) {
      const uint32_t w =
          word_of(philox4x32_10(l >> 2, row, s, 1, key0, key1), l & 3);
      const float u = fmaxf(__uint2float_rn(w >> 8) * 0x1p-24f, FLT_MIN);
      g_s[l] = -logf(-logf(u));
    }
    // (a) the clause: the largest word over the unsat clauses, four
    // 16-byte loads in flight per thread
    u64 best = 0;
    if (vec) {
      const int4* tc4 = reinterpret_cast<const int4*>(tc);
      for (int q0 = tid; q0 < nq; q0 += 4 * kWalkThreads) {
        int4 x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = q0 + j * kWalkThreads;
          x[j] = q < nq ? tc4[q] : make_int4(1, 1, 1, 1);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (x[j].x && x[j].y && x[j].z && x[j].w) continue;
          const int q = q0 + j * kWalkThreads;
          const uint4 w = philox4x32_10(q, row, s, 0, key0, key1);
          const int c = q << 2;
          if (x[j].x == 0) best = max(best, clause_key(w.x, c));
          if (x[j].y == 0) best = max(best, clause_key(w.y, c + 1));
          if (x[j].z == 0) best = max(best, clause_key(w.z, c + 2));
          if (x[j].w == 0) best = max(best, clause_key(w.w, c + 3));
        }
      }
    } else {
      for (int c = tid; c < C; c += kWalkThreads)
        if (tc[c] == 0)
          best = max(best, clause_key(
              word_of(philox4x32_10(c >> 2, row, s, 0, key0, key1), c & 3),
              c));
    }
    best = block_max(best, red);
    int v_flip = 0;
    if (best == 0) {                        // solved: flip the dummy var 0
      if (!v0_occurs) {
        if (tid == 0 && ((n_steps - t) & 1)) assign[0] ^= 1;
        break;
      }
    } else {
      const int cstar = (int)(0xFFFFFFFFu - (uint32_t)best);
      const int32_t* crow = cv_k + (size_t)cstar * L;
      // the clause's literal slots, in one coalesced read
      for (int l = tid; l < L; l += kWalkThreads) {
        const int v = __ldg(crow + l);
        vs_s[l] = (v < 0 || v >= V1) ? 0 : v;   // never in a packed window
      }
      __syncthreads();
      // (b) break counts, one warp per literal (padding slots skipped:
      // their weight does not read brk)
      for (int l = warp; l < L; l += kWalkWarps) {
        const int v = vs_s[l];
        if (v <= 0) continue;
        const bool a = assign[v] != 0;
        const int32_t* orow = ov_k + (size_t)v * O;
        const uint8_t* srow = os_k + (size_t)v * O;
        int cnt = 0;
        for (int o = lane; o < O; o += 32) {
          const int c = __ldg(orow + o);
          if (c >= 0 && c < C && (__ldg(srow + o) != 0) == a && tc[c] == 1)
            ++cnt;
        }
        cnt = warp_sum(cnt);
        if (lane == 0) brk_s[l] = cnt;
      }
      __syncthreads();
      // (c) the variable: argmax of Gumbel noise + weight over the slots
      u64 bv = 0;
      for (int l = tid; l < L; l += kWalkThreads) {
        const float wt = vs_s[l] > 0
                             ? __fmul_rn(ncb, log1pf((float)brk_s[l]))
                             : -1e30f;
        float val = __fadd_rn(g_s[l], wt);
        if (val == 0.0f) val = 0.0f;        // -0 == +0 for argmax
        bv = max(bv, ((u64)ordered(val) << 32) | (0xFFFFFFFFu - (uint32_t)l));
      }
      bv = block_max(bv, red);
      v_flip = vs_s[(int)(0xFFFFFFFFu - (uint32_t)bv)];
    }
    // (d) the flip and the count update, one warp
    if (warp == 0) {
      const bool nv = assign[v_flip] == 0;
      __syncwarp();
      if (lane == 0) assign[v_flip] = nv;
      const int32_t* orow = ov_k + (size_t)v_flip * O;
      const uint8_t* srow = os_k + (size_t)v_flip * O;
      for (int o = lane; o < O; o += 32) {
        const int c = __ldg(orow + o);
        if (c >= 0 && c < C)
          atomicAdd(&tc[c], ((__ldg(srow + o) != 0) == nv) ? 1 : -1);
      }
    }
    __syncthreads();
  }
  if constexpr (kShared) {
    __syncthreads();
    int32_t* tg = tc_g + (size_t)row * C;
    for (int c = tid; c < C; c += kWalkThreads) tg[c] = tc[c];
    uint8_t* ag = assign_g + (size_t)row * V1;
    for (int v = tid; v < V1; v += kWalkThreads) ag[v] = assign[v];
  }
}

// dynamic shared bytes of a route; the layout of walk_chunk_kernel
size_t walk_chunk_smem(int C, int L, int V1, bool shared) {
  return shared ? (size_t)4 * C + (size_t)12 * L + (size_t)V1
                : (size_t)12 * L;
}

template <bool kShared>
int launch_walk_chunk(const void* cvars, const void* ovars, const void* osign,
                      void* assign, void* tc, int K, int B, int C, int L,
                      int V1, int O, unsigned key0, unsigned key1,
                      unsigned step0, int n_steps, float ncb,
                      cudaStream_t stream) {
  const size_t smem = walk_chunk_smem(C, L, V1, kShared);
  cudaError_t err = cudaFuncSetAttribute(
      walk_chunk_kernel<kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  walk_chunk_kernel<kShared><<<K * B, kWalkThreads, smem, stream>>>(
      static_cast<const int32_t*>(cvars), static_cast<const int32_t*>(ovars),
      static_cast<const uint8_t*>(osign), static_cast<uint8_t*>(assign),
      static_cast<int32_t*>(tc), B, C, L, V1, O, key0, key1, step0, n_steps,
      ncb);
  return cudaGetLastError();
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

// cvars [K,C,L] int32; ovars [K,V1,O] int32 (-1 = padding); osign [K,V1,O]
// bytes 0/1; assign [K,B,V1] bytes 0/1 and tc [K,B,C] int32, both updated
// in place. Runs steps step0 .. step0 + n_steps - 1 of every chain; ncb is
// -cb as a float; shared_route 1 keeps each chain's counts in shared
// memory (walk_chunk_smem bytes must fit), 0 in device memory. Returns
// the CUDA error code of the launch (0 = launched).
int walk_chunk(const void* cvars, const void* ovars, const void* osign,
               void* assign, void* tc, int K, int B, int C, int L, int V1,
               int O, unsigned key0, unsigned key1, unsigned step0,
               int n_steps, float ncb, int shared_route, void* stream) {
  if (K <= 0 || B <= 0 || n_steps <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shared_route
             ? launch_walk_chunk<true>(cvars, ovars, osign, assign, tc, K, B,
                                       C, L, V1, O, key0, key1, step0,
                                       n_steps, ncb, st)
             : launch_walk_chunk<false>(cvars, ovars, osign, assign, tc, K, B,
                                        C, L, V1, O, key0, key1, step0,
                                        n_steps, ncb, st);
}

}  // extern "C"
