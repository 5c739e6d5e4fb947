// Forward flash attention (GQA, causal and/or sliding window) over the
// kernel layout [B, H, S, D]:
//
//   o[b,h,i,:] = softmax_j(mask(q[b,h,i,:] . k[b,h/g,j,:] * c)) v[b,h/g,j,:]
//
// with the score scale c given at launch (1/sqrt(D) unless the caller names
// another),
// query i at absolute position q_offset + i, key j at position j, and
// the mask  j < Sk  &&  (!causal || j <= qpos)  &&  (!window || j > qpos - window).
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_pallas
//   (body _flash_kernel)
// and computes what it computes: an online softmax over the KV tiles with an
// f32 running max, sum and accumulator; a masked score is the finite
// sentinel -2^30, never -inf, so a row whose first tile is wholly masked adds
// exp(0) terms that the next tile's alpha = exp(-2^30 - m) = 0 wipes, where
// -inf would give exp(-inf - -inf) = NaN; the finalize divides by
// max(l, 1e-30). A tile whose every (q, k) pair is masked is skipped with the
// same test as the Pallas body.
//
// What bounds it on an H100: at the served shape (hymba_1_5b prefill, B=4,
// Hq=25, Hkv=5, S=2048, D=64, window 1024) the visible pairs cost ~40 GFLOP
// against ~63 MB of q/k/v/o, so operations bound it (~41 us at the bf16
// tensor-core peak); every config of the repo is on that side (D = 64 or
// 128, prompts of thousands of tokens).
//
// The dtype alone picks the kernel (the Python wrapper picks, and counts
// each route's launches):
//
// * bf16: flash_fwd_kernel_wgmma, Hopper's tensor cores fed by TMA. One
//   block of three warpgroups per (128-row q tile, q head, batch). A
//   producer warpgroup (its registers handed to the others by setmaxnreg)
//   has one thread issue the TMA loads: the Q tile once, then K and V
//   tiles of 128 keys into a 2-stage ring, each completing on its own
//   mbarrier and released by its own. The tensor maps cover the strided
//   4-d [B,S,H,D] views as they lie, in boxes of at most 64 columns under
//   the swizzle that matches a box row (128, 64 or 32 bytes; D = 128 is two
//   boxes side by side), and rows past Sq or Sk arrive as zeros. Two
//   consumer warpgroups own 64 q rows each. S = Q K^T is wgmma
//   m64n128k16 with Q and K K-major in shared memory; O += P V is wgmma
//   m64nDk16 with P from registers and V read MN-major (the transpose
//   bit). A consumer's turn issues S_i and P_{i-1} V_{i-1} back to back and
//   runs tile i's softmax while P V is in flight; the two consumers take
//   turns by named barriers, so one's softmax overlaps the other's
//   products. The softmax stays in registers (quad shuffles for the row
//   max, the row sum reduced once at the end), masks only tiles that
//   straddle an edge of a warp's rows, and spends one FFMA and one ex2 a
//   score; P goes to the A-operand layout in registers, once the product
//   that reads the previous P has completed. Blocks that see the most KV
//   tiles launch first, the q heads of one KV group adjacent, so their K/V
//   tiles are shared in L2.
//
// * f32: flash_fwd_kernel, on the CUDA cores (its 1e-4 tolerance rules out
//   TF32). Both products are FMA loops over shared memory, so the card's
//   67 TFLOP/s f32 rate caps it. One block of 256 threads per (query tile of
//   64 rows, q head, batch) stages its query tile (pre-scaled by 1/sqrt(D))
//   in shared memory once, then sweeps the KV tiles of 64 keys of KV head
//   h / group in order, staging each in shared memory. A 16 x 16 thread grid
//   owns 4 query rows x 4 keys of each score tile and 4 rows x D/16 output
//   columns; row max and row sum are reduced across the 16 threads of a row
//   with warp shuffles. Inputs take arbitrary element strides on the B, H
//   and S axes.
//
// Numbers of the bf16 kernel: the products q.k are of bf16 values in f32,
// as the Pallas body's upcast computes them, and only the order of the f32
// sums differs; the 1/sqrt(D) scale (times log2 e) multiplies the f32
// scores, not q before rounding. P is rounded to bf16 before P V (the
// Pallas body keeps it in f32) while l sums the unrounded values. Each p_j
// then carries a relative error of at most 2^-9, so the output moves by at
// most 2^-9 * sum_j p_j |v_j| / l <= 2^-9 max|v| (0.0098 at |v| <= 5, the
// range of standard-normal inputs), inside the bf16 tolerance of
// atol = rtol = 3e-2 together with the output's own bf16 rounding (2^-9
// relative). It needs 16-byte aligned bases and B/H/S strides (TMA's
// unit; the wrapper copies an operand that has not, a counted layout copy).
//
// Both take arbitrary Sq and Sk without padding (every row and key index is
// bounds-checked) and write the output with its own strides, so swapped
// [B,S,H,D] views need no copy.
#include <cuda_bf16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr int kRows = kBQ / 16; // query rows per thread
constexpr int kCols = kBK / 16; // keys per thread
constexpr int kPP = kBK + 1;    // padded pitch of the probability tile
constexpr float kNeg = -1073741824.0f;   // -2^30, the masked score

struct Strides {
  long long b, h, s;  // element strides; the D axis has stride 1
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }

template <int D>
constexpr size_t smem_bytes() {
  // Qs [kBQ][D+1], Ks [kBK][D+1], Vs [kBK][D], Ps [kBQ][kPP]
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) + size_t(kBK) * D +
          size_t(kBQ) * kPP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int group, int Sq,
                 int Sk, int causal, int window, int q_offset, float scale) {
  constexpr int QP = D + 1;       // padded pitch of the Q and K tiles
  constexpr int kDims = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBK * QP;
  float* Ps = Vs + kBK * D;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (q0 + r < Sq) val = load_f32(qb + (q0 + r) * sq.s + d) * scale;
    Qs[r * QP + d] = val;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }

  // absolute positions of the block's first and last query row (padding
  // rows included, as the Pallas block test counts them)
  const int qpos_first = q0 + q_offset;
  const int qpos_last = q0 + kBQ - 1 + q_offset;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // block-level skip: every (q, k) pair of the tile is masked
    if (causal && k0 > qpos_last) continue;
    if (window && k0 + kBK - 1 <= qpos_first - window) continue;

    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Sk) {
        kv = load_f32(kb + (k0 + r) * sk.s + d);
        vv = load_f32(vb + (k0 + r) * sv.s + d);
      }
      Ks[r * QP + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * QP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i + q_offset;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * kRows + i) * kPP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      store_f32(ob + r * so.s + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int Hq, int Hkv, int Sq,
                   int Sk, int causal, int window, int q_offset,
                   double scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so,
      Hq / Hkv, Sq, Sk, causal, window, q_offset,
      scale > 0 ? static_cast<float>(scale)
                : 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// --------------------------------------------------- bf16: TMA + wgmma
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;            // q rows per block: 2 consumer warpgroups
constexpr int kBK = 128;            // keys per KV tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
struct Cfg {
  // a tile is stored as D/64 boxes (one for D <= 64) of rows of at most 64
  // columns; a box row is the swizzle span (32, 64 or 128 bytes)
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kBoxes = D / kCols;
  // wgmma layout type and TMA swizzle of that span: 128B = 1, 64B = 2,
  // 32B = 3
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kKVBytes = kKVBox * kBoxes;     // one K or V tile
  // Q | K stages | V stages | 9 mbarriers; every tile 1024-byte aligned
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr size_t kSmem = kOffBar + 128 + 1024;  // + alignment slack
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "alignment");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d [B, H, S, D] view (coordinates innermost first) into
// shared memory; the barrier counts its bytes (rows past the end arrive
// as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s),
         "r"(h), "r"(b), "r"(bar) : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout type
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// 2^x on the special-function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// named barriers among the 256 consumer threads (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// registers that an in-flight wgmma writes are not touched across this
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// the accumulator operand lists of the wgmma shapes used below
#define WG_REGS_8 \
  "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_REGS_16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS_32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS_64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      WG_REGS_32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      WG_REGS_64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 16] += A[64 x 16] B[16 x 16]: A from registers, B MN-major in
// shared memory (read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      WG_REGS_8 "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32]: A from registers, B MN-major in
// shared memory (read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      WG_REGS_16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, B MN-major in
// shared memory (read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      WG_REGS_32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A from registers, B MN-major in
// shared memory (read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      WG_REGS_64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ o, Strides so, int Hq, int group,
                       int Sq, int Sk, int causal, int window, int q_offset,
                       int n_qt, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::kOffK, sV = base + C::kOffV;
  const uint32_t bar_q = base + C::kOffBar;
  // full_k[s], full_v[s]: the tile landed; empty_k[s], empty_v[s]: both
  // consumers are done with it
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (1 + 3 * kStages + s); };

  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int h = bh % Hq, b = bh / Hq, hk = h / group;
  const int q0 = qt * kBQ;

  const int qpos_first = q0 + q_offset, qpos_last = q0 + kBQ - 1 + q_offset;
  int t_end = (Sk + kBK - 1) / kBK;
  if (causal) t_end = min(t_end, qpos_last / kBK + 1);
  int t_begin = 0;
  if (window) {
    const int x = qpos_first - window - (kBK - 1);
    t_begin = x < 0 ? 0 : x / kBK + 1;
  }
  const int n_t = t_end - t_begin;
  bf16* ob = o + b * so.b + h * so.h;
  if (n_t <= 0) {
    // every (q, k) pair of the tile is masked: the Pallas body's zeros
    for (int e = threadIdx.x; e < kBQ * D / 2; e += kThreads) {
      const int r = e / (D / 2), col = (e % (D / 2)) * 2;
      if (q0 + r < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (q0 + r) * so.s + col) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int j = 0; j < C::kBoxes; ++j)
        tma_load(sQ + j * C::kQBox, &tm_q, bar_q, j * C::kCols, q0, h, b);
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kStages, k0 = (t_begin + i) * kBK;
        const uint32_t parity = ((i / kStages) - 1) & 1;
        if (i >= kStages) mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), C::kKVBytes);
        for (int j = 0; j < C::kBoxes; ++j)
          tma_load(sK + s * C::kKVBytes + j * C::kKVBox, &tm_k, full_k(s),
                   j * C::kCols, k0, hk, b);
        if (i >= kStages) mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), C::kKVBytes);
        for (int j = 0; j < C::kBoxes; ++j)
          tma_load(sV + s * C::kKVBytes + j * C::kKVBox, &tm_v, full_v(s),
                   j * C::kCols, k0, hk, b);
      }
    }
    return;
  }

  // consumer warpgroup c owns q rows [64c, 64c + 64) of the tile; warp w of
  // it rows 16w .. 16w + 15, of which this lane holds g and g + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kBK / 2];                 // this tile's scores, then its P
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) sc[e] = 0.f;
  uint32_t pa[kBK / 16][4];          // the previous tile's P, bf16 A fragments
  const int qlo = q0 + 64 * c + 16 * warp + q_offset;
  const int qpos_g = qlo + (lane >> 2);
  const uint32_t q_rows = sQ + 64 * c * C::kRowBytes;
  constexpr uint32_t kSBO = 8 * C::kRowBytes;   // 8-row groups

  auto issue_s = [&](int s) {         // S = Q K^T, both K-major in smem
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / C::kCols;
      const int off = (kk * 16 % C::kCols) * 2;
      wgmma_qk<kBK>(
          sc, smem_desc(q_rows + box * C::kQBox + off, 16, kSBO, C::kLayout),
          smem_desc(sK + s * C::kKVBytes + box * C::kKVBox + off, 16, kSBO,
                    C::kLayout),
          kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {        // O += P V, V MN-major in smem: 16
#pragma unroll                        // keys a step, D/64 boxes LBO apart
    for (int kc = 0; kc < kBK / 16; ++kc)
      wgmma_pv<D>(acc, pa[kc],
                  smem_desc(sV + s * C::kKVBytes + kc * 16 * C::kRowBytes,
                            C::kKVBox, kSBO, C::kLayout));
    wgmma_commit();
  };
  // tile i's softmax on sc; returns through alpha the factor that moves
  // the running sums from the previous max to this tile's
  auto softmax = [&](int i, float (&alpha)[2]) {
    // sc[4j + e]: row g (e < 2) or g + 8, key k0 + 8j + 2(lane % 4) + e % 2
    const int k0 = (t_begin + i) * kBK;
    bool whole = k0 + kBK <= Sk;
    if (causal) whole = whole && k0 + kBK - 1 <= qlo;
    if (window) whole = whole && k0 > qlo + 15 - window;
    if (!whole) {
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int kpos = k0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        const int qpos = qpos_g + ((e >> 1) & 1) * 8;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) sc[e] = kNeg;
      }
    }
    // the max runs on the unscaled scores (the scale c is positive); then
    // p = 2^(s c - m c), one FFMA and one ex2 a score. Where a row's max
    // is still the sentinel, every s c - m c is the same rounding residue
    // (|.| <= 8), so its p are equal and cancel in the finalize, as the
    // reference's exp(0) = 1 do, until a visible key's alpha = 0 wipes them.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      sc[e] = ex2(fmaf(sc[e], scale_log2, -mc[(e >> 1) & 1]));
      l[(e >> 1) & 1] += sc[e];
    }
  };
  // P in the A-fragment layout (accumulator blocks 2kc, 2kc + 1 are key
  // chunk kc), rounded to bf16; only once the P V product that reads the
  // previous P has completed
  auto to_fragments = [&]() {
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // Turn i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} back to back, then
  // runs tile i's softmax while the P V product is in flight (P_i goes to
  // its fragments once that product, which reads P_{i-1}, is done). The two
  // consumers take turns (named barriers 1 and 2), so that one's softmax
  // overlaps the other's products. n_t >= 1 here, and the first and last
  // turns are peeled, so that no wgmma sits on a conditional path.
  float alpha[2];
  mbar_wait(bar_q, 0);
  if (c == 1) named_arrive(1);
  mbar_wait(full_k(0), 0);
  named_sync(1 + c);
  fence_regs(sc);
  wgmma_fence();
  issue_s(0);
  named_arrive(2 - c);
  wgmma_wait<0>();
  fence_regs(sc);
  release(empty_k(0));
  softmax(0, alpha);
  to_fragments();
  for (int i = 1; i < n_t; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(full_k(s), (i / kStages) & 1);
    mbar_wait(full_v(sp), ((i - 1) / kStages) & 1);
    named_sync(1 + c);
    fence_regs(sc);
    fence_regs(acc);
    wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    named_arrive(2 - c);
    wgmma_wait<1>();
    fence_regs(sc);
    release(empty_k(s));
    softmax(i, alpha);
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty_v(sp));
    // O was summed up to tile i - 1: move it to tile i's max
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
    to_fragments();
  }
  const int sl = (n_t - 1) % kStages;
  mbar_wait(full_v(sl), ((n_t - 1) / kStages) & 1);
  named_sync(1 + c);
  fence_regs(acc);
  wgmma_fence();
  issue_pv(sl);
  if (c == 0) named_arrive(2);
  wgmma_wait<0>();
  fence_regs(acc);
  release(empty_v(sl));

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int row = q0 + 64 * c + 16 * warp + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= Sq) continue;
    bf16* orow = ob + (row + 8 * r) * so.s + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// cuTensorMapEncodeTiled through the runtime, so that nothing links
// against the driver library
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of a [B, H, S, D] bf16 view with element strides st (B, H,
// S), in boxes of `rows` rows x Cfg<D>::kCols columns under the matching
// swizzle. An axis of one element gets a stride past the whole view (TMA
// wants every stride a multiple of 16 bytes; that axis is never stepped).
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, const long long* st,
                     int B, int H, int S, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const long long n[3] = {B, H, S};
  long long span = 2LL * D;
  for (int i = 0; i < 3; ++i) {
    const long long end = 2LL * st[i] * n[i];
    if (n[i] > 1 && end > span) span = end;
  }
  span = (span + 15) / 16 * 16;
  cuuint64_t stride[3];   // S, H, B in bytes
  for (int i = 0; i < 3; ++i)
    stride[2 - i] = n[i] > 1 ? static_cast<cuuint64_t>(2LL * st[i]) : span;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Cfg<D>::kCols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      Cfg<D>::kLayout == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
      : Cfg<D>::kLayout == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, stride, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int Hq, int Hkv, int Sq,
                   int Sk, int causal, int window, int q_offset,
                   double scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<D>(&tq, q, st, B, Hq, Sq, kBQ);
  if (err != cudaSuccess) return err;
  if (Sk == 0) {
    tk = tv = tq;   // no KV tile is visited, so no K/V map is read
  } else {
    err = make_map<D>(&tk, k, st + 3, B, Hkv, Sk, kBK);
    if (err == cudaSuccess) err = make_map<D>(&tv, v, st + 6, B, Hkv, Sk, kBK);
    if (err != cudaSuccess) return err;
  }
  const long long n_qt = (Sq + kBQ - 1) / kBQ;
  const long long blocks = n_qt * Hq * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Strides so{st[9], st[10], st[11]};
  flash_fwd_kernel_wgmma<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), so, Hq, Hq / Hkv, Sq, Sk, causal,
      window, q_offset, static_cast<int>(n_qt),
      static_cast<float>(scale > 0 ? kLog2e * scale
                                   : kLog2e / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace wg

// 16-byte alignment of a bf16 operand: its base, and the element strides of
// its B, H and S axes wherever that axis has more than one element
bool aligned16(const void* p, const long long* st, int B, int H, int S) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const int n[3] = {B, H, S};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && st[i] % 8) return false;
  return true;
}

// D in {16, 32, 64, 128} to the kernel's template argument
template <template <int> class Launch, typename... Args>
cudaError_t by_head_dim(int D, Args... args) {
  switch (D) {
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    case 64: return Launch<64>::run(args...);
    case 128: return Launch<128>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}
template <int D>
struct SimtF32 {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch<float, D>(args...); }
};
template <int D>
struct TensorCoreBf16 {
  template <typename... Args>
  static cudaError_t run(Args... args) { return wg::launch<D>(args...); }
};

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both entry points, one per route: q [B,Hq,Sq,D], k and v [B,Hkv,Sk,D], o [B,Hq,Sq,D] on
// the device of `stream`, with Hq % Hkv == 0 and D in {16, 32, 64, 128}.
// `strides` holds 12 element strides: the B, H and S strides of q, k, v and
// o in that order (D is unit-stride). window = 0 means no window. `scale`
// multiplies the scores q.k before the softmax; 0 means 1/sqrt(D). Each
// returns the launch's CUDA error code.

// f32 operands: the SIMT kernel; any strides.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int B, int Hq, int Hkv,
                        int Sq, int Sk, int D, int causal, int window,
                        int q_offset, double scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0) return cudaErrorInvalidValue;
  return by_head_dim<SimtF32>(D, q, k, v, o, strides, B, Hq, Hkv, Sq, Sk,
                              causal, window, q_offset, scale,
                              static_cast<cudaStream_t>(stream));
}

// bf16 operands: the tensor-core kernel. Every base and every B/H/S stride
// (of an axis longer than 1) must be 16-byte aligned; anything else is
// refused with cudaErrorMisalignedAddress before launch.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int B, int Hq,
                         int Hkv, int Sq, int Sk, int D, int causal,
                         int window, int q_offset, double scale,
                         void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0) return cudaErrorInvalidValue;
  if (!aligned16(q, strides, B, Hq, Sq) ||
      !aligned16(k, strides + 3, B, Hkv, Sk) ||
      !aligned16(v, strides + 6, B, Hkv, Sk) ||
      !aligned16(o, strides + 9, B, Hq, Sq))
    return cudaErrorMisalignedAddress;
  return by_head_dim<TensorCoreBf16>(D, q, k, v, o, strides, B, Hq, Hkv, Sq,
                                     Sk, causal, window, q_offset, scale,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
