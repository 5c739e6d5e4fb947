// Mamba2 SSD chunked scan, per (batch b, head h), chunks in order:
//
//   A    = -exp(A_log[h]);  seg_l = sum_{i<=l} dt_i A   (within the chunk)
//   y_l  = sum_{m<=l} (C_l . B_m) exp(seg_l - seg_m) dt_m x_m
//        + exp(seg_l) C_l . S_prev  +  D[h] x_l
//   S    = exp(seg_last) S_prev + sum_l exp(seg_last - seg_l) dt_l x_l B_l^T
//
// with x [b,s,h,p], dt [b,s,h] (after softplus), B and C [b,s,n] (one
// group), the state S [p,n] in f32, and y in x's dtype. s is a multiple of
// the chunk (the wrapper pads with dt = 0, which leaves state and output
// unchanged).
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/ssd_scan/kernel.py  ssd_scan_pallas (body _ssd_kernel)
// which walks the chunks of one (b, h) along a sequential grid axis with
// the [P,N] state in VMEM scratch and forms the chunk's [l,l] decay and
// C.B^T matrices whole.
//
// What bounds it on an H100: at the model's shapes (hymba_1_5b: b=4,
// s=2048, h=32, p=100, n=16, chunk 256) the function moves ~106 MB (x and
// y dominate) against ~17 GFLOP of tile products, so bytes bound it
// (~32 us). This first kernel is far from that: one block per (b, h) is
// 128 blocks, about one per SM, and the products are FMA loops over shared
// memory on the CUDA cores.
//
// Design: one block of 256 threads per (h, b). The f32 state lives in
// shared memory for the whole sweep (P x (N+1) floats; 6.8 KB at hymba's
// widths, 65 KB at P = N = 128). Per chunk, thread 0 forms seg by a
// sequential prefix sum (the chunk is at most 1024 steps), then the output
// is built in row tiles of 64: the chunk's [l,l] matrices are never held
// whole (256 x 256 f32 would be 256 KB, more than a block may have).
// Instead, for each row tile the causal column tiles m0 <= l0 are visited:
// a [64,64] tile W = (C B^T) o decay o dt is formed in shared memory and
// multiplied into the row tile's [64,P] register accumulators, which start
// from the carried-state term and D x. Then the state is decayed and the
// chunk's inputs are added to it in column tiles. Rows, columns and P or N
// that do not fill a tile are bounds-checked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows per row tile, columns per column tile
constexpr int kWP = kTile + 1;     // padded pitch of the W tile
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 1024;
constexpr int kAcc = kMaxP / 4;    // output columns per thread (4 threads a row)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_floats(int P, int N, int chunk) {
  // seg, dt [chunk]; S [P][N+1]; Ct, Bt [kTile][N+1]; Xt [kTile][P]; W
  return size_t(2) * chunk + size_t(P) * (N + 1) +
         size_t(2) * kTile * (N + 1) + size_t(kTile) * P +
         size_t(kTile) * kWP;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const TB* __restrict__ Bm,
                const TB* __restrict__ Cm, const float* __restrict__ Dv,
                TX* __restrict__ y, int S, int H, int P, int N, int chunk) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* seg = smem;
  float* dtc = seg + chunk;
  float* St = dtc + chunk;          // [P][NP]
  float* Ct = St + P * NP;          // [kTile][NP]
  float* Bt = Ct + kTile * NP;      // [kTile][NP]
  float* Xt = Bt + kTile * NP;      // [kTile][P]
  float* W = Xt + kTile * P;        // [kTile][kWP]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float A = -expf(A_log[h]);
  const float Dh = Dv[h];
  // token row s of this (b, h): x and y at ((b*S + s)*H + h)*P, dt at
  // (b*S + s)*H + h, B and C at (b*S + s)*N
  const long long row0 = (long long)b * S;

  for (int i = tid; i < P * NP; i += kThreads) St[i] = 0.f;

  // thread roles: output row r = tid / 4 of a row tile, columns
  // pc + 4 j; W tile entries rows wy*4 + i, columns wx + 16 j
  const int r = tid >> 2;
  const int pc = tid & 3;
  const int wy = tid >> 4;
  const int wx = tid & 15;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < chunk; i += kThreads)
      dtc[i] = dt[(row0 + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < chunk; ++i) {
        run += dtc[i] * A;
        seg[i] = run;
      }
    }
    __syncthreads();

    for (int l0 = 0; l0 < chunk; l0 += kTile) {
      const int rows_l = min(kTile, chunk - l0);
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int rr = i / N, n = i % N;
        Ct[rr * NP + n] = rr < rows_l
            ? load_f32(Cm + (row0 + c0 + l0 + rr) * N + n) : 0.f;
      }
      __syncthreads();

      // carried-state term and skip term
      float acc[kAcc];
      const bool row_ok = r < rows_l;
      const float es = row_ok ? expf(seg[l0 + r]) : 0.f;
      const long long xrow = ((row0 + c0 + l0 + r) * H + h) * P;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int p = pc + 4 * j;
        float a = 0.f;
        if (row_ok && p < P) {
          float cs = 0.f;
          for (int n = 0; n < N; ++n) cs = fmaf(Ct[r * NP + n], St[p * NP + n], cs);
          a = es * cs + Dh * load_f32(x + xrow + p);
        }
        acc[j] = a;
      }

      for (int m0 = 0; m0 <= l0; m0 += kTile) {
        const int rows_m = min(kTile, chunk - m0);
        __syncthreads();  // the previous column tile's Bt, Xt, W are consumed
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int rr = i / N, n = i % N;
          Bt[rr * NP + n] = rr < rows_m
              ? load_f32(Bm + (row0 + c0 + m0 + rr) * N + n) : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int rr = i / P, p = i % P;
          Xt[i] = rr < rows_m
              ? load_f32(x + ((row0 + c0 + m0 + rr) * H + h) * P + p) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int wl = wy * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int wm = wx + 16 * j;
            float w = 0.f;
            if (wl < rows_l && wm < rows_m && m0 + wm <= l0 + wl) {
              float cb = 0.f;
              for (int n = 0; n < N; ++n)
                cb = fmaf(Ct[wl * NP + n], Bt[wm * NP + n], cb);
              w = cb * expf(seg[l0 + wl] - seg[m0 + wm]) * dtc[m0 + wm];
            }
            W[wl * kWP + wm] = w;
          }
        }
        __syncthreads();
        if (row_ok) {
          for (int m = 0; m < rows_m; ++m) {
            const float w = W[r * kWP + m];
#pragma unroll
            for (int j = 0; j < kAcc; ++j) {
              const int p = pc + 4 * j;
              if (p < P) acc[j] = fmaf(w, Xt[m * P + p], acc[j]);
            }
          }
        }
      }
      if (row_ok) {
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          const int p = pc + 4 * j;
          if (p < P) store_f32(y + xrow + p, acc[j]);
        }
      }
      __syncthreads();  // Ct is consumed before the next row tile loads it
    }

    // state update: decay the carried state, then add the chunk's inputs
    const float seg_last = seg[chunk - 1];
    const float decay = expf(seg_last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      St[p * NP + n] *= decay;
    }
    for (int m0 = 0; m0 < chunk; m0 += kTile) {
      const int rows_m = min(kTile, chunk - m0);
      __syncthreads();
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int rr = i / N, n = i % N;
        Bt[rr * NP + n] = rr < rows_m
            ? load_f32(Bm + (row0 + c0 + m0 + rr) * N + n) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int rr = i / P, p = i % P;
        Xt[i] = rr < rows_m
            ? load_f32(x + ((row0 + c0 + m0 + rr) * H + h) * P + p) : 0.f;
      }
      // per-row weight exp(seg_last - seg_m) dt_m, in the W tile's first row
      for (int i = tid; i < kTile; i += kThreads)
        W[i] = i < rows_m ? expf(seg_last - seg[m0 + i]) * dtc[m0 + i] : 0.f;
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e % N;
        float add = 0.f;
        for (int m = 0; m < rows_m; ++m)
          add = fmaf(W[m] * Xt[m * P + p], Bt[m * NP + n], add);
        St[p * NP + n] += add;
      }
    }
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* dt, const void* A_log,
                   const void* B, const void* C, const void* D, void* y,
                   int batch, int S, int H, int P, int N, int chunk,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, chunk) * sizeof(float);
  // the largest size any call may ask for, set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxP, kMaxN, kMaxChunk) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  ssd_scan_kernel<TX, TB><<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<const float*>(D),
      static_cast<TX*>(y), S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y [batch,S,H,P] in x's dtype (x_bf16: 1 = bf16, 0 = f32); dt [batch,S,H]
// f32; A_log, D [H] f32; B, C [batch,S,N] in one dtype (bc_bf16). All
// contiguous, on the device of `stream`; S % chunk == 0, P <= 128,
// N <= 128, chunk <= 1024. Returns the launch's CUDA error code.
int ssd_scan(const void* x, const void* dt, const void* A_log, const void* B,
             const void* C, const void* D, void* y, int batch, int S, int H,
             int P, int N, int chunk, int x_bf16, int bc_bf16, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (P > kMaxP || N <= 0 || N > kMaxN || chunk <= 0 || chunk > kMaxChunk ||
      S % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && bc_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A_log, B, C, D, y,
                                                batch, S, H, P, N, chunk, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, dt, A_log, B, C, D, y, batch, S,
                                        H, P, N, chunk, s);
  if (bc_bf16)
    return launch<float, __nv_bfloat16>(x, dt, A_log, B, C, D, y, batch, S,
                                        H, P, N, chunk, s);
  return launch<float, float>(x, dt, A_log, B, C, D, y, batch, S, H, P, N,
                              chunk, s);
}

}  // extern "C"
