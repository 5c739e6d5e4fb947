// Forward flash attention (GQA, causal and/or sliding window) over the
// kernel layout [B, H, S, D]:
//
//   o[b,h,i,:] = softmax_j(mask(q[b,h,i,:] . k[b,h/g,j,:] / sqrt(D))) v[b,h/g,j,:]
//
// with query i at absolute position q_offset + i, key j at position j, and
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
// tensor-core peak). This first kernel computes in f32 on the CUDA cores
// (both products are FMA loops over shared memory), which caps it near the
// card's 67 TFLOP/s f32 rate and well below the tensor-core bound; wgmma
// and TMA are later work.
//
// Design: one block of 256 threads per (query tile of 64 rows, q head,
// batch). The block stages its query tile (pre-scaled by 1/sqrt(D)) in
// shared memory once, then sweeps the KV tiles of 64 keys of KV head
// h / group in order (K/V are never repeated in memory), staging each in
// shared memory as f32 (bf16 converted on load). A 16 x 16 thread grid
// owns 4 query rows x 4 keys of each score tile and 4 rows x D/16 output
// columns; row max and row sum are reduced across the 16 threads of a row
// with warp shuffles. Inputs take arbitrary element strides on the B, H
// and S axes (the D axis is unit-stride), so swapped [B,S,H,D] views need
// no copy, and every row and key index is bounds-checked, so any Sq and Sk
// work without padding.
#include <cuda_bf16.h>
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
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
                   cudaStream_t stream) {
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
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, const long long* st, int B, int Hq, int Hkv,
                       int Sq, int Sk, int causal, int window, int q_offset,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal,
                                  window, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal,
                                  window, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal,
                                  window, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk,
                                    causal, window, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Hq,Sq,D], k and v [B,Hkv,Sk,D], o [B,Hq,Sq,D], all of one dtype
// (bf16 = 1, f32 = 0) on the device of `stream`, with Hq % Hkv == 0 and
// D in {16, 32, 64, 128}. `strides` holds 12 element strides: the B, H
// and S strides of q, k, v and o in that order (D is unit-stride).
// window = 0 means no window. Returns the launch's CUDA error code.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int Hq, int Hkv, int Sq,
                    int Sk, int D, int bf16, int causal, int window,
                    int q_offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, strides, B, Hq, Hkv, Sq,
                                     Sk, causal, window, q_offset, s);
  return dispatch_d<float>(D, q, k, v, o, strides, B, Hq, Hkv, Sq, Sk,
                           causal, window, q_offset, s);
}

}  // extern "C"
