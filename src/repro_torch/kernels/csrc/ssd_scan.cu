// Mamba2 SSD chunked scan:
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
// What bounds it on an H100: bytes. At hymba_1_5b's shapes (b=4, s=2048,
// h=32, p=100, n=16, chunk 256, bf16 x/B/C) the function moves ~106 MB (x
// and y dominate), ~32 us at 3.35 TB/s, against ~10 GFLOP of tile products,
// ~10 us on the tensor cores. A walk of the chunks in order, one block per
// (b, h), fills 128 of 132 SMs and puts the products on the CUDA cores.
//
// Design: SSD's chunked decomposition, chunks in parallel, three launches.
// 1. chunk_state: one block per (b, h, chunk). seg by a block scan; the
//    chunk's own state term dS = X^T (w o B), w_m = exp(seg_last - seg_m)
//    dt_m, as [p,n] f32 tiles on the tensor cores (mma.sync m16n8k16 bf16,
//    f32 accumulators) over 64-key tiles.
// 2. state_pass: S_c = exp(seg_last_c) S_{c-1} + dS_c over the 8-16 chunks
//    of each (b, h), one thread per state element, each chunk's dS replaced
//    by the state before it (6.5 MB of f32 at hymba's shape); the state
//    after the last chunk (the prefill's hand-off to decode) goes to an
//    optional f32 [b,h,p,n] output.
// 3. chunk_out: one block of 4 warps per (b, h, chunk), which computes the
//    segment sums and loads S_prev once and walks the chunk's 64-row tiles
//    in order. Each warp takes 16 rows: the carried-state term
//    exp(seg_l) C_l . S_prev first, then for each 64-key tile at or left of
//    the diagonal, in two halves of 32 keys, W = (C B^T) o exp(seg_l -
//    seg_m) o dt_m in registers (the product's accumulators become the
//    next product's A operand without a trip through shared memory) and
//    y += W X, then D x from the diagonal tile; y is rounded once.
// Blocks of neighbouring heads are launched together, so that they read
// neighbouring parts of x's rows. bf16 tiles arrive by cp.async in a ring
// of kStages tiles (rows of 100 values are 8-byte aligned, so granules of
// 8 bytes there), the next tile's copies in flight while one is used,
// zero-filled to the tile pitch; f32 tiles (and S_prev) come through
// registers, every load of a batch issued before any is stored. The tile
// counts (p and n in n8 tiles) are template arguments, so the tile loops
// unroll without branches. The outputs launch is bound by instruction
// issue and latency: all-bf16 blocks are held to 128 registers a thread
// so that four fit an SM.
// Precision: every operand reaches the tensor cores in bf16. bf16 x, B and
// C are exact there; an f32 operand (W, w o B, S_prev, and x, B, C in f32)
// is split into hi + lo bf16 terms and the products of the terms above
// 2^-16 are summed (hi.hi + hi.lo + lo.hi), so the products keep about 16
// bits of the f32 mantissa, with f32 accumulation. Tile rows are padded
// with zeros in shared memory (p to the tile count, plus 8 elements so
// that ldmatrix's eight rows fall in distinct banks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;            // output rows and keys of a tile
constexpr int kOutThreads = 128;     // chunk_out: 4 warps of 16 rows
constexpr int kStateThreads = 256;   // chunk_state: 8 warps of 16 p rows
constexpr int kPassThreads = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 1024;
constexpr int kStages = 2;             // depth of the cp.async tile ring

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
// the widths the tile loops run over: p padded to 64, 104 or 128 (n8 tiles
// of y), n to 16 or 128 (n8 tiles of the state); the repo's models have p
// 64 and 100, n 16 and 128
__host__ __device__ inline int p_cols(int P) {
  return P <= 64 ? 64 : P <= 104 ? 104 : 128;
}
__host__ __device__ inline int n_cols(int N) { return N <= 16 ? 16 : 128; }
// tile pitches in bf16 elements: a multiple of 8 that is not one of 16, so
// that ldmatrix's eight row addresses fall in distinct banks
__host__ __device__ inline int pitch_of(int v) { return round16(v) + 8; }
__host__ __device__ inline int x_pitch(int P) { return pitch_of(p_cols(P)); }
__host__ __device__ inline int n_pitch(int N) { return pitch_of(n_cols(N)); }

__host__ __device__ inline int take(int& at, int nbytes) {
  const int r = at;
  at += (nbytes + 15) & ~15;
  return r;
}

// Byte offsets into a block's dynamic shared memory. A bf16 tile that
// arrives by cp.async has kStages stages: the copies of the next tiles are
// in flight while one is used.
struct StateLayout {
  int dtc, seg, wtot, b_hi, b_lo, b_raw, x_hi, x_lo, bytes;
};
struct OutLayout {
  int dtc, seg, wtot, c_hi, c_lo, b_hi, b_lo, x_hi, x_lo, s_hi, s_lo, bytes;
};

__host__ __device__ inline StateLayout state_layout(int P, int N, int chunk,
                                                    bool split_x,
                                                    bool split_b) {
  const int bt = kRows * n_pitch(N) * 2, xt = kRows * x_pitch(P) * 2;
  StateLayout o;
  int at = 0;
  o.dtc = take(at, chunk * 4);
  o.seg = take(at, chunk * 4);
  o.wtot = take(at, 32 * 4);
  o.b_hi = take(at, bt);      // w o B of the tile in use, always split
  o.b_lo = take(at, bt);
  o.b_raw = split_b ? o.b_hi : take(at, kStages * bt);   // B as it arrives
  o.x_hi = take(at, split_x ? xt : kStages * xt);
  o.x_lo = split_x ? take(at, xt) : o.x_hi;
  o.bytes = at;
  return o;
}

__host__ __device__ inline OutLayout out_layout(int P, int N, int chunk,
                                                bool split_x, bool split_bc) {
  const int NP = n_pitch(N);
  const int bt = kRows * NP * 2, xt = kRows * x_pitch(P) * 2;
  OutLayout o;
  int at = 0;
  o.dtc = take(at, chunk * 4);
  o.seg = take(at, chunk * 4);
  o.wtot = take(at, 32 * 4);
  o.c_hi = take(at, split_bc ? bt : 2 * bt);   // two stages by cp.async
  o.c_lo = split_bc ? take(at, bt) : o.c_hi;
  o.b_hi = take(at, split_bc ? bt : kStages * bt);
  o.b_lo = split_bc ? take(at, bt) : o.b_hi;
  o.x_hi = take(at, split_x ? xt : kStages * xt);
  o.x_lo = split_x ? take(at, xt) : o.x_hi;
  // S_prev [p][n], always split, p_cols(P) rows (the tiles read)
  const int sbytes = p_cols(P) * NP * 2;
  o.s_hi = take(at, sbytes);
  o.s_lo = take(at, sbytes);
  o.bytes = at;
  return o;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as a bf16x2 register (hi) and the rounding residual (lo)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int G>
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src,
                                         bool in) {
  const uint32_t d = smem_u32(dst);
  const int n = in ? G : 0;   // 0: fill the granule with zeros
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(G), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the bytes a cp.async of a bf16 tile may move at once: the largest of 16,
// 8 and 4 that divides the source's address, its row stride and its row
// length; 0 when none does
__device__ __forceinline__ int granule(const bf16* src, long long stride,
                                       int cols) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(src) |
                               (unsigned long long)(stride * 2) |
                               (unsigned long long)(cols * 2);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

template <int G>
__device__ void stage_rows(bf16* dst, int pitch, const bf16* src,
                           long long stride, int rows, int cols) {
  constexpr int E = G / 2;            // elements of a granule
  const int per_row = pitch / E;      // a pitch is a multiple of 8
  // a warp takes `span` rows at a time when a row has few granules
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = max(1, 32 / per_row);
  const int lr = lane / per_row, g0 = lane - lr * per_row;
  if (lr >= span) return;
  for (int r = warp * span + lr; r < kRows; r += (blockDim.x >> 5) * span) {
    for (int gi = span > 1 ? g0 : lane; gi < per_row; gi += 32) {
      const int c = gi * E;
      const bool in = r < rows && c < cols;
      cp_async<G>(dst + r * pitch + c, in ? src + r * stride + c : src, in);
    }
  }
}

// rows [0, kRows) of a bf16 tile into shared memory by cp.async in
// granules of g bytes, zero past `rows` and `cols` up to `pitch`; the
// caller commits and waits
__device__ void stage_tile(int g, bf16* dst, int pitch, const bf16* src,
                           long long stride, int rows, int cols) {
  if (g == 16) stage_rows<16>(dst, pitch, src, stride, rows, cols);
  else if (g == 8) stage_rows<8>(dst, pitch, src, stride, rows, cols);
  else stage_rows<4>(dst, pitch, src, stride, rows, cols);
}

// rows [0, kRows) of a tile into shared memory as bf16 (hi, and lo when
// split), row r from src + r * stride, times scale[r] when given; rows from
// `rows` on and columns from `cols` on are zero, up to `pitch` (at most
// kMaxP + 8). A warp takes kRowsInFlight rows at a time, lanes over
// columns, and issues all of their loads before it stores any.
template <bool kSplit, typename T>
__device__ void load_tile(bf16* hi, bf16* lo, int pitch, const T* src,
                          long long stride, int rows, int cols,
                          const float* scale) {
  constexpr int kCols = (kMaxP + 8 + 31) / 32;
  constexpr int kRowsInFlight = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r0 = warp * kRowsInFlight; r0 < kRows;
       r0 += nwarps * kRowsInFlight) {
    float v[kRowsInFlight][kCols];
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int r = r0 + i;
      const T* s = src + (r < rows ? r * stride : 0);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // every load is issued (from element 0 where out of range) and
        // the value dropped after, so none waits behind a branch
        const int c = lane + 32 * j;
        const bool in = r < rows && c < cols;
        const float x = ld(in ? s + c : src);
        v[i][j] = in ? x : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const int r = r0 + i;
      const float sc = scale && r < rows ? scale[r] : 1.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        if (c < pitch) {
          const float x = v[i][j] * sc;
          const bf16 h = __float2bfloat16_rn(x);
          hi[r * pitch + c] = h;
          if (kSplit) lo[r * pitch + c] = __float2bfloat16_rn(x - __bfloat162float(h));
        }
      }
    }
  }
}

// the state S_prev [P][N] (f32, contiguous) into shared memory as bf16
// hi + lo rows of pitch `pitch`, p_cols(P) of them, zero in the padding;
// every thread has kPer loads in flight at once
__device__ void load_state(bf16* hi, bf16* lo, int pitch, const float* src,
                           int P, int N) {
  constexpr int kPer = 16;
  const int T = blockDim.x, PN = P * N;
  const int prow = p_cols(P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < prow; p += T >> 5) {
    for (int n = lane; n < pitch; n += 32) {
      if (p >= P || n >= N) {
        hi[p * pitch + n] = __float2bfloat16_rn(0.f);
        lo[p * pitch + n] = __float2bfloat16_rn(0.f);
      }
    }
  }
  for (int base = 0; base < PN; base += kPer * T) {
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * T + threadIdx.x;
      v[k] = src[i < PN ? i : 0];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * T + threadIdx.x;
      if (i < PN) {
        const int p = i / N, n = i - p * N;
        const bf16 h = __float2bfloat16_rn(v[k]);
        hi[p * pitch + n] = h;
        lo[p * pitch + n] = __float2bfloat16_rn(v[k] - __bfloat162float(h));
      }
    }
  }
}

// v[0, n) := inclusive prefix sums of v, by the whole block
__device__ void block_scan(float* v, int n, float* wtot) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int per = (n + T - 1) / T;
  const int i0 = min(n, tid * per), i1 = min(n, i0 + per);
  float run = 0.f;
  for (int i = i0; i < i1; ++i) {
    run += v[i];
    v[i] = run;
  }
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wtot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? wtot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    wtot[lane] = t;
  }
  __syncthreads();
  const float off = (x - run) + (warp ? wtot[warp - 1] : 0.f);
  for (int i = i0; i < i1; ++i) v[i] += off;
  __syncthreads();
}

// dt of rows [0, n) of a chunk into dtc, their prefix sums of dt A into seg
__device__ void chunk_seg(const float* dt, long long row0, int H, int h,
                          float A, int n, float* dtc, float* seg,
                          float* wtot) {
  // loads in flight at once: a whole chunk in one pass at 128 threads
  constexpr int kPer = kMaxChunk / kOutThreads;
  for (int i0 = 0; i0 < n; i0 += kPer * blockDim.x) {
    float d[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + k * blockDim.x + threadIdx.x;
      d[k] = dt[(row0 + (i < n ? i : 0)) * H + h];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + k * blockDim.x + threadIdx.x;
      if (i < n) {
        dtc[i] = d[k];
        seg[i] = d[k] * A;
      }
    }
  }
  __syncthreads();
  block_scan(seg, n, wtot);
}

template <typename TX, typename TB, int kNT>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A_log, const TB* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ seglast,
                   int S, int H, int P, int N, int chunk) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitB = std::is_same<TB, float>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  const StateLayout lay = state_layout(P, N, chunk, kSplitX, kSplitB);
  float* wts = reinterpret_cast<float*>(smem + lay.dtc);   // dt, then w
  float* seg = reinterpret_cast<float*>(smem + lay.seg);
  float* wtot = reinterpret_cast<float*>(smem + lay.wtot);
  bf16* bh = reinterpret_cast<bf16*>(smem + lay.b_hi);
  bf16* bl = reinterpret_cast<bf16*>(smem + lay.b_lo);
  bf16* braw = reinterpret_cast<bf16*>(smem + lay.b_raw);
  bf16* xh = reinterpret_cast<bf16*>(smem + lay.x_hi);
  bf16* xl = reinterpret_cast<bf16*>(smem + lay.x_lo);
  const int XP = x_pitch(P), NP = n_pitch(N);

  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int bhi = b * H + h;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const long long xs = (long long)H * P;   // x's row stride
  const TX* xc = x + (row0 * H + h) * P;   // the chunk's first row of x
  const TB* bc = Bm + row0 * N;
  const int ntiles = (chunk + kRows - 1) / kRows;
  // bf16 tiles whose rows allow it arrive by cp.async, kStages deep; one
  // commit group per tile, empty past the last
  int gx = 0, gb = 0;
  if constexpr (!kSplitX) gx = granule(xc, xs, P);
  if constexpr (!kSplitB) gb = granule(bc, N, N);
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int rows = min(kRows, chunk - t * kRows), stage = t % kStages;
      if constexpr (!kSplitX)
        if (gx) stage_tile(gx, xh + stage * kRows * XP, XP,
                           xc + t * kRows * xs, xs, rows, P);
      if constexpr (!kSplitB)
        if (gb) stage_tile(gb, braw + stage * kRows * NP, NP,
                           bc + t * kRows * N, N, rows, N);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  chunk_seg(dt, row0, H, h, -expf(A_log[h]), chunk, wts, seg, wtot);
  const float seg_last = seg[chunk - 1];
  for (int i = threadIdx.x; i < chunk; i += blockDim.x)
    wts[i] *= expf(seg_last - seg[i]);     // w_m = exp(seg_last - seg_m) dt_m
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int p0 = warp * 16;              // this warp's 16 rows of the state
  const bool active = p0 < round16(P);
  float acc[kNT][4];                     // kNT n8 tiles of the columns
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int m0 = t * kRows, rows = min(kRows, chunk - m0);
    const int stage = t % kStages;
    issue(t + kStages - 1);            // into the stage freed a tile ago
    cp_async_wait<kStages - 1>();      // tile t has landed
    if (!gx) load_tile<kSplitX>(xh, xl, XP, xc + m0 * xs, xs, rows, P,
                                nullptr);
    if (!gb) load_tile<true>(bh, bl, NP, bc + m0 * N, N, rows, N, wts + m0);
    __syncthreads();
    if (gb) {
      // w o B of this tile from its raw stage, split into hi + lo
      const bf16* raw = braw + stage * kRows * NP;
      for (int r = warp; r < kRows; r += kStateThreads / 32) {
        const float w = r < rows ? wts[m0 + r] : 0.f;
        for (int n = lane; n < NP; n += 32) {
          const float v = w * __bfloat162float(raw[r * NP + n]);
          const bf16 hv = __float2bfloat16_rn(v);
          bh[r * NP + n] = hv;
          bl[r * NP + n] = __float2bfloat16_rn(v - __bfloat162float(hv));
        }
      }
      __syncthreads();
    }
    const bf16* xa = xh + (gx ? stage : 0) * kRows * XP;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        // A = X^T: rows p, columns keys (transposed loads of [key][p])
        const int ak = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int ap = p0 + ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, xa + ak * XP + ap);
        if (kSplitX) ldsm_x4_t(al, xl + ak * XP + ap);
        const int bk = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          const int bn = jj * 16 + ((lane >> 4) & 1) * 8;
          uint32_t rh[4], rl[4];
          ldsm_x4_t(rh, bh + bk * NP + bn);
          ldsm_x4_t(rl, bl + bk * NP + bn);
          mma(acc[2 * jj], ah, rh[0], rh[1]);
          mma(acc[2 * jj + 1], ah, rh[2], rh[3]);
          mma(acc[2 * jj], ah, rl[0], rl[1]);
          mma(acc[2 * jj + 1], ah, rl[2], rl[3]);
          if (kSplitX) {
            mma(acc[2 * jj], al, rh[0], rh[1]);
            mma(acc[2 * jj + 1], al, rh[2], rh[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this tile's stages
  }
  if (active) {
    float* out = states + ((long long)bhi * nc + c) * P * N;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + (e >> 1) * 8;
        const int n = j * 8 + 2 * t4 + (e & 1);
        if (p < P && n < N) out[p * N + n] = acc[j][e];
      }
    }
  }
  if (threadIdx.x == 0) seglast[(long long)bhi * nc + c] = seg_last;
}

// states[bh][c] := the state before chunk c (the chunk's dS before);
// final_state[bh] := the state after the last chunk, when it is not null
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ states,
                  const float* __restrict__ seglast,
                  float* __restrict__ final_state, int nc, int PN) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.y;
  constexpr int kPer = 16;   // chunks whose loads are in flight at once
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPer) {
    float d[kPer], a[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = min(c0 + k, nc - 1);
      d[k] = states[(bh * nc + c) * PN + e];
      a[k] = seglast[bh * nc + c];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (c0 + k < nc) {
        states[(bh * nc + c0 + k) * PN + e] = s;
        s = expf(a[k]) * s + d[k];
      }
    }
  }
  if (final_state) final_state[bh * PN + e] = s;
}

// four blocks an SM where every operand is bf16 (the registers spill a
// little), three where an f32 operand is split (they would spill more)
template <typename TX, typename TB, int kTiles>
__global__ void __launch_bounds__(
    kOutThreads,
    ((std::is_same<TX, float>::value || std::is_same<TB, float>::value) ? 3
                                                                         : 4))
chunk_out_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A_log, const TB* __restrict__ Bm,
                 const TB* __restrict__ Cm, const float* __restrict__ Dv,
                 const float* __restrict__ states, TX* __restrict__ y, int S,
                 int H, int P, int N, int chunk) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitBC = std::is_same<TB, float>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  const OutLayout lay = out_layout(P, N, chunk, kSplitX, kSplitBC);
  float* dtc = reinterpret_cast<float*>(smem + lay.dtc);
  float* seg = reinterpret_cast<float*>(smem + lay.seg);
  float* wtot = reinterpret_cast<float*>(smem + lay.wtot);
  bf16* ch = reinterpret_cast<bf16*>(smem + lay.c_hi);
  bf16* cl = reinterpret_cast<bf16*>(smem + lay.c_lo);
  bf16* bh = reinterpret_cast<bf16*>(smem + lay.b_hi);
  bf16* bl = reinterpret_cast<bf16*>(smem + lay.b_lo);
  bf16* xh = reinterpret_cast<bf16*>(smem + lay.x_hi);
  bf16* xl = reinterpret_cast<bf16*>(smem + lay.x_lo);
  bf16* sh = reinterpret_cast<bf16*>(smem + lay.s_hi);
  bf16* sl = reinterpret_cast<bf16*>(smem + lay.s_lo);
  const int XP = x_pitch(P), NP = n_pitch(N);

  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int bhi = b * H + h;
  const int nrt = (chunk + kRows - 1) / kRows;   // row tiles of the chunk
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const long long xs = (long long)H * P; // x's row stride
  const TX* xc = x + (row0 * H + h) * P;
  const TB* bc = Bm + row0 * N;
  const TB* cc = Cm + row0 * N;
  // The block walks the chunk's row tiles in order and, for each, the key
  // tiles at or left of its diagonal: one sequence of key tiles, whose bf16
  // tiles arrive by cp.async kStages deep (one commit group per tile, empty
  // past the last), a row tile's C with its first key tile.
  int gx = 0, gb = 0, gc = 0;
  if constexpr (!kSplitX) gx = granule(xc, xs, P);
  if constexpr (!kSplitBC) {
    gb = granule(bc, N, N);
    gc = granule(cc, N, N);
  }
  int irt = 0, it = 0, iseq = 0;         // the next key tile to copy
  auto issue = [&]() {
    if (irt < nrt) {
      const int kend = min(chunk, (irt + 1) * kRows);
      const int krows = min(kRows, kend - it * kRows);
      const int stage = iseq % kStages;
      if constexpr (!kSplitX)
        if (gx) stage_tile(gx, xh + stage * kRows * XP, XP,
                           xc + it * kRows * xs, xs, krows, P);
      if constexpr (!kSplitBC) {
        if (gb) stage_tile(gb, bh + stage * kRows * NP, NP,
                           bc + it * kRows * N, N, krows, N);
        if (gc && it == 0)
          stage_tile(gc, ch + (irt & 1) * kRows * NP, NP,
                     cc + irt * kRows * N, N, min(kRows, chunk - irt * kRows),
                     N);
      }
      if (++it > irt) {
        ++irt;
        it = 0;
      }
      ++iseq;
    }
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) issue();

  chunk_seg(dt, row0, H, h, -expf(A_log[h]), chunk, dtc, seg, wtot);
  if (c > 0)
    load_state(sh, sl, NP, states + ((long long)bhi * nc + c) * P * N, P, N);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;              // this warp's rows of a row tile
  const int ksteps = round16(N) / 16;
  const float Dh = Dv[h];
  // A-operand addresses of this warp's 16 C rows (ldmatrix x4)
  const int arow = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = ((lane >> 4) & 1) * 8;
  int seq = 0;                           // the key tile in use

  for (int rt = 0; rt < nrt; ++rt) {
    const int l0 = rt * kRows;
    const int kend = min(chunk, l0 + kRows);   // rows and keys [0, kend)
    const bf16* ct = ch + (gc ? (rt & 1) : 0) * kRows * NP;
    // the rows of this thread's accumulator elements, and whether they exist
    const int la = l0 + r0 + g, lb = la + 8;
    const bool oka = la < kend, okb = lb < kend;
    const float sa = oka ? seg[la] : 0.f, sb = okb ? seg[lb] : 0.f;
    float acc[kTiles][4];                // kTiles n8 tiles of y's columns
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int t = 0; t <= rt; ++t, ++seq) {
      const int m0 = t * kRows, krows = min(kRows, kend - m0);
      const int stage = seq % kStages;
      issue();                           // into the stage freed a tile ago
      cp_async_wait<kStages - 1>();      // this tile (and C) has landed
      if (!gc && t == 0)
        load_tile<kSplitBC>(ch, cl, NP, cc + l0 * N, N, kend - l0, N,
                            nullptr);
      if (!gb) load_tile<kSplitBC>(bh, bl, NP, bc + m0 * N, N, krows, N,
                                   nullptr);
      if (!gx) load_tile<kSplitX>(xh, xl, XP, xc + m0 * xs, xs, krows, P,
                                  nullptr);
      __syncthreads();   // the tile, C (and, first, S_prev) are in place

      if (t == 0 && c > 0) {
        // the carried state: exp(seg_l) C_l . S_prev
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, ct + arow * NP + ks * 16 + acol);
          if (kSplitBC) ldsm_x4(al, cl + arow * NP + ks * 16 + acol);
          const int sp_ = lane & 7, sn = ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            uint32_t rh[2], rl[2];
            ldsm_x2(rh, sh + (j * 8 + sp_) * NP + sn);
            ldsm_x2(rl, sl + (j * 8 + sp_) * NP + sn);
            mma(acc[j], ah, rh[0], rh[1]);
            mma(acc[j], ah, rl[0], rl[1]);
            if (kSplitBC) mma(acc[j], al, rh[0], rh[1]);
          }
        }
        const float ea = oka ? expf(sa) : 0.f, eb = okb ? expf(sb) : 0.f;
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          acc[j][0] *= ea;
          acc[j][1] *= ea;
          acc[j][2] *= eb;
          acc[j][3] *= eb;
        }
      }

      const bf16* bt = bh + (gb ? stage : 0) * kRows * NP;
      const bf16* xt = xh + (gx ? stage : 0) * kRows * XP;
      // the tile's 64 keys in two halves of 32, to hold fewer registers:
      // C B^T for this warp's 16 rows, then W = cb o exp(seg_l - seg_m)
      // o dt_m on m <= l as A operands, then y += W X
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float cb[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, ct + arow * NP + ks * 16 + acol);
          if (kSplitBC) ldsm_x4(al, cl + arow * NP + ks * 16 + acol);
          const int bk = half * 32 + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int bn = ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t rh[4];
            ldsm_x4(rh, bt + (jj * 16 + bk) * NP + bn);
            mma(cb[2 * jj], ah, rh[0], rh[1]);
            mma(cb[2 * jj + 1], ah, rh[2], rh[3]);
            if (kSplitBC) {
              uint32_t rl[4];
              ldsm_x4(rl, bl + (jj * 16 + bk) * NP + bn);
              mma(cb[2 * jj], ah, rl[0], rl[1]);
              mma(cb[2 * jj + 1], ah, rl[2], rl[3]);
              mma(cb[2 * jj], al, rh[0], rh[1]);
              mma(cb[2 * jj + 1], al, rh[2], rh[3]);
            }
          }
        }
        uint32_t wh[2][4], wl[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + half * 32 + j * 8 + 2 * t4 + (e & 1);
            const int l = e < 2 ? la : lb;
            const bool ok = (e < 2 ? oka : okb) && m <= l;
            w[e] = ok ? cb[j][e] * expf((e < 2 ? sa : sb) - seg[m]) * dtc[m]
                      : 0.f;
          }
          // accumulator (rows g, g+8; columns 2t, 2t+1 of n8 tile j) = A
          // operand registers {0,1} (j even) or {2,3} (j odd) of k-step j/2
          split2(w[0], w[1], wh[j / 2][(j & 1) * 2], wl[j / 2][(j & 1) * 2]);
          split2(w[2], w[3], wh[j / 2][(j & 1) * 2 + 1],
                 wl[j / 2][(j & 1) * 2 + 1]);
        }
        // X [key][p] through transposed loads, 32 keys per load
        const int xk = half * 32 + (lane & 7) + (lane >> 3) * 8;
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          uint32_t rh[4];
          ldsm_x4_t(rh, xt + xk * XP + j * 8);
          mma(acc[j], wh[0], rh[0], rh[1]);
          mma(acc[j], wh[1], rh[2], rh[3]);
          mma(acc[j], wl[0], rh[0], rh[1]);
          mma(acc[j], wl[1], rh[2], rh[3]);
          if (kSplitX) {
            uint32_t rl[4];
            ldsm_x4_t(rl, xl + xk * XP + j * 8);
            mma(acc[j], wh[0], rl[0], rl[1]);
            mma(acc[j], wh[1], rl[2], rl[3]);
          }
        }
      }

      if (t == rt) {
        // y = acc + D x, rounded once. A bf16 x is exact in this diagonal
        // key tile (its rows are the row tile's rows); an f32 x is read
        // again, every load before any store.
        float xv[kTiles][4];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = j * 8 + 2 * t4 + (e & 1);
            const int r = r0 + g + (e >> 1) * 8;
            if constexpr (kSplitX) {
              const bool ok = (e < 2 ? oka : okb) && p < P;
              xv[j][e] = ld(x + (ok ? (row0 + l0 + r) * xs +
                                          (long long)h * P + p
                                    : 0));
            } else {
              xv[j][e] = __bfloat162float(xt[r * XP + p]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = j * 8 + 2 * t4 + (e & 1);
            if ((e < 2 ? oka : okb) && p < P)
              st(y + (row0 + (e < 2 ? la : lb)) * xs + (long long)h * P + p,
                 acc[j][e] + Dh * xv[j][e]);
          }
        }
      }
      __syncthreads();   // every warp is done with this tile's stages
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The tile counts are template arguments, so the tile loops unroll without
// branches: n8 tiles of y's columns (p_cols) and of the state's columns
// (n_cols). Columns past P or N are zero in shared memory and never stored.
template <typename TX, typename TB, int kNT>
cudaError_t launch_state(dim3 grid, int smem, cudaStream_t stream,
                         const void* x, const void* dt, const void* A_log,
                         const void* B, void* states, void* seglast, int S,
                         int H, int P, int N, int chunk) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitB = std::is_same<TB, float>::value;
  static const cudaError_t attr = allow_smem(
      chunk_state_kernel<TX, TB, kNT>,
      state_layout(kMaxP, kMaxN, kMaxChunk, kSplitX, kSplitB).bytes);
  if (attr != cudaSuccess) return attr;
  chunk_state_kernel<TX, TB, kNT><<<grid, kStateThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const TB*>(B),
      static_cast<float*>(states), static_cast<float*>(seglast), S, H, P, N,
      chunk);
  return cudaGetLastError();
}

template <typename TX, typename TB, int kTiles>
cudaError_t launch_out(dim3 grid, int smem, cudaStream_t stream,
                       const void* x, const void* dt, const void* A_log,
                       const void* B, const void* C, const void* D,
                       const void* states, void* y, int S, int H, int P,
                       int N, int chunk) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitBC = std::is_same<TB, float>::value;
  static const cudaError_t attr = allow_smem(
      chunk_out_kernel<TX, TB, kTiles>,
      out_layout(kMaxP, kMaxN, kMaxChunk, kSplitX, kSplitBC).bytes);
  if (attr != cudaSuccess) return attr;
  chunk_out_kernel<TX, TB, kTiles><<<grid, kOutThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<const float*>(D),
      static_cast<const float*>(states), static_cast<TX*>(y), S, H, P, N,
      chunk);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* dt, const void* A_log,
                   const void* B, const void* C, const void* D, void* y,
                   void* states, void* seglast, void* final_state,
                   int batch, int S, int H, int P, int N, int chunk,
                   cudaStream_t stream) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  constexpr bool kSplitBC = std::is_same<TB, float>::value;
  const int nc = S / chunk;
  const dim3 gs(H, nc, batch);
  const int ss = state_layout(P, N, chunk, kSplitX, kSplitBC).bytes;
  cudaError_t e =
      N <= 16 ? launch_state<TX, TB, 2>(gs, ss, stream, x, dt, A_log, B,
                                        states, seglast, S, H, P, N, chunk)
              : launch_state<TX, TB, 16>(gs, ss, stream, x, dt, A_log, B,
                                         states, seglast, S, H, P, N, chunk);
  if (e != cudaSuccess) return e;
  state_pass_kernel<<<dim3((P * N + kPassThreads - 1) / kPassThreads,
                           batch * H),
                      kPassThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(seglast),
      static_cast<float*>(final_state), nc, P * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 go(H, nc, batch);
  const int so = out_layout(P, N, chunk, kSplitX, kSplitBC).bytes;
  static_assert(kMaxP == 128 && kMaxN == 128, "the tile bins cover 128");
  return P <= 64 ? launch_out<TX, TB, 8>(go, so, stream, x, dt, A_log, B, C,
                                         D, states, y, S, H, P, N, chunk)
       : P <= 104 ? launch_out<TX, TB, 13>(go, so, stream, x, dt, A_log, B,
                                           C, D, states, y, S, H, P, N, chunk)
                  : launch_out<TX, TB, 16>(go, so, stream, x, dt, A_log, B,
                                           C, D, states, y, S, H, P, N,
                                           chunk);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y [batch,S,H,P] in x's dtype (x_bf16: 1 = bf16, 0 = f32); dt [batch,S,H]
// f32; A_log, D [H] f32; B, C [batch,S,N] in one dtype (bc_bf16); scratch:
// states [batch*H, S/chunk, P, N] f32 and seglast [batch*H, S/chunk] f32;
// final_state [batch,H,P,N] f32, the state after the last row, or null
// (nothing is written to it where S is 0: the caller fills that one). All
// contiguous, on the device of `stream`; S % chunk == 0, P <= 128,
// N <= 128, chunk <= 1024. Returns the launches' CUDA error code.
int ssd_scan(const void* x, const void* dt, const void* A_log, const void* B,
             const void* C, const void* D, void* y, void* states,
             void* seglast, void* final_state, int batch, int S, int H,
             int P, int N, int chunk, int x_bf16, int bc_bf16,
             void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (P > kMaxP || N <= 0 || N > kMaxN || chunk <= 0 || chunk > kMaxChunk ||
      S % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && bc_bf16)
    return launch<bf16, bf16>(x, dt, A_log, B, C, D, y, states, seglast,
                              final_state, batch, S, H, P, N, chunk, s);
  if (x_bf16)
    return launch<bf16, float>(x, dt, A_log, B, C, D, y, states, seglast,
                               final_state, batch, S, H, P, N, chunk, s);
  if (bc_bf16)
    return launch<float, bf16>(x, dt, A_log, B, C, D, y, states, seglast,
                               final_state, batch, S, H, P, N, chunk, s);
  return launch<float, float>(x, dt, A_log, B, C, D, y, states, seglast,
                              final_state, batch, S, H, P, N, chunk, s);
}

}  // extern "C"
