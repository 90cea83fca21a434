// Packed window scan for Hopper (sm_90a): a tensor-core GEMM with a
// fused top-`planes` window epilogue, in a float (bf16) and an int8
// domain.
//
// Replaces the Pallas kernels of qrag_tpu/ops/pallas/fused_scan.py:
//   _packed_top2_t_kernel (:398, pallas_packed_window_scan_top2_t):
//       float planes 2|3, int8 planes 2
//   _packed_top2_kernel   (:159, pallas_packed_window_scan_top2):
//       float planes 2
//   _packed_kernel        (:62,  pallas_packed_window_scan):
//       planes 1, float or int8
//   _packed_t_kernel      (:279, pallas_packed_window_scan_t):
//       planes 1, float or int8
// Their straight vs transposed split and the plane folds/batch padding
// are Mosaic layout matters with no counterpart here: each (domain,
// planes) pair is one instance of the two kernel templates below.
//
// Contract (per query b, corpus row n, window w = n / 128, lane n % 128):
//   float: g   = (alpha * dot(q_b, x_n) + col_add[b]) + row_add[n]
//          key = signfold(bits(g)) & ~127        (order-preserving int32)
//   int8:  key = clamp(dot(q8_b, x8_n), +-(2^23 - 1)) << 7
//          (the exact int32 dot; no affine terms)
//   packed = key | (127 - lane)                  (ties -> lower row)
//   out[p][b * NW + w] = (p+1)-th largest packed key of window w
// Keys are unique within a window (lane bits), so the planes are just
// the top-`planes` of 128 distinct ints.  -inf rows (row_add) stay
// ordinary keys below every finite score; INT32_MIN never occurs.
// Integer accumulation is exact, so the int8 planes equal the plain
// twin's bit for bit on every input.
//
// Design: one block owns one whole 128-row window x a tile of 16 or 64
// queries, so the (B, N) score matrix never reaches device memory and
// no reduction crosses blocks.  Products run on the tensor cores with
// WMMA 16x16x16: bf16 x bf16 -> f32 (packed_window_scan_kernel), or
// int8 x int8 -> int32, IMMA (packed_window_scan_int8_kernel).  Each
// step stages 128 bytes of every row in 16-byte segments (64 bf16 or
// 128 int8 codes); the int8 tile is stored k-step-major (all rows of
// one 16-code step contiguous) so every fragment starts 256-bit
// aligned.  The tile's scores go to shared memory, and 4 or 16 threads
// per query column reduce its 128 rows to the top-`planes` keys with a
// warp-shuffle merge.  The two domains are separate kernels: one
// template over both compiled the bf16 instance into code 17% slower
// at B = 1024 (measured A/B on the H100).
//
// What bounds it on an H100 (N = 1,250,176, d = 768):
//   bf16: at B = 1 the scan reads the 1.92 GB corpus once and computes
//     next to nothing: >= 0.57 ms at 3.35 TB/s.  At B = 1024 it does
//     2*B*N*d = 1.97 TFLOP, ~1000 FLOP/byte, far above bf16's ~295
//     FLOP/byte ridge: >= 1.99 ms at 989 dense TFLOP/s.
//   int8: at B = 1, 0.96 GB of codes: >= 0.29 ms at 3.35 TB/s.  At
//     B = 1024, 1.97 T int8 ops: >= 1.0 ms at 1,979 dense TOPS.
// This is the simple correct form (synchronous 16-byte loads,
// mma.sync-class WMMA, one window per block).  wgmma, TMA pipelines
// and persistent blocks that walk several windows are later work.
//
// The launch functions allocate nothing, run on the caller's stream,
// and return cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWindow = 128;
constexpr int kThreads = 256;          // 8 warps, 16 window rows each
constexpr int kKTile = 64;             // depth staged per step
constexpr int kLdX = kKTile + 8;       // bf16 row pitch in shared memory
constexpr int kInt32Min = -2147483647 - 1;
constexpr int kIntClamp = (1 << 23) - 1;  // |key| << 7 never overflows
constexpr int kKTile8 = 128;              // int8 codes staged per step

__device__ __forceinline__ int packed_key(float g, int row) {
  int u = __float_as_int(g);
  int mono = u < 0 ? kInt32Min - u : u;
  return (mono & ~127) | (127 - (row & 127));
}

__device__ __forceinline__ int packed_int_key(int dot, int row) {
  int v = min(max(dot, -kIntClamp), kIntClamp);
  return static_cast<int>(static_cast<unsigned>(v) << 7) | (127 - (row & 127));
}

template <int P>
__device__ __forceinline__ void insert_key(int (&top)[P], int v) {
  // top[] is descending; keys are distinct
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (v > top[i]) {
      int t = top[i];
      top[i] = v;
      v = t;
    }
  }
}

// NQF: 16-query fragments per block (1 or 4); P: planes (1..3)
template <int NQF, int P>
__global__ void __launch_bounds__(kThreads)
packed_window_scan_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ row_add,
                          const float* __restrict__ col_add, int B, int NW,
                          int d, float alpha, int* __restrict__ pk1,
                          int* __restrict__ pk2, int* __restrict__ pk3) {
  constexpr int BQ = 16 * NQF;
  constexpr int kLdS = BQ + 4;  // f32 pitch of the score tile
  constexpr int kStageBytes = (kWindow + BQ) * kLdX * 2;
  constexpr int kScoreBytes = kWindow * kLdS * 4;
  constexpr int kSmem = kStageBytes > kScoreBytes ? kStageBytes : kScoreBytes;
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sq = sx + kWindow * kLdX;
  float* ss = reinterpret_cast<float*>(smem);  // reused after the GEMM

  const int n_qtiles = (B + BQ - 1) / BQ;
  const long long tile = blockIdx.x;
  const int qt = static_cast<int>(tile % n_qtiles);
  const long long w = tile / n_qtiles;
  const int q0 = qt * BQ;
  const long long row0 = w * kWindow;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NQF];
#pragma unroll
  for (int j = 0; j < NQF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < d; k0 += kKTile) {
    // stage X (128 x 64) and Q (BQ x 64) in 16-byte segments; segments
    // past d or past B are zeros (d % 16 == 0, so segments are whole)
    constexpr int kSegs = kKTile / 8;
    for (int s = tid; s < kWindow * kSegs; s += kThreads) {
      int r = s / kSegs, c = (s % kSegs) * 8;
      uint4 v = zero;
      if (k0 + c < d)
        v = *reinterpret_cast<const uint4*>(x + (row0 + r) * d + k0 + c);
      *reinterpret_cast<uint4*>(sx + r * kLdX + c) = v;
    }
    for (int s = tid; s < BQ * kSegs; s += kThreads) {
      int r = s / kSegs, c = (s % kSegs) * 8;
      uint4 v = zero;
      if (q0 + r < B && k0 + c < d)
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<long long>(q0 + r) * d + k0 + c);
      *reinterpret_cast<uint4*>(sq + r * kLdX + c) = v;
    }
    __syncthreads();
    const int ksteps = min(kKTile, d - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sx + warp * 16 * kLdX + ks * 16, kLdX);
#pragma unroll
      for (int j = 0; j < NQF; ++j) {
        // B = Q^T: sq holds [query][k], i.e. B in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, sq + j * 16 * kLdX + ks * 16, kLdX);
        wmma::mma_sync(acc[j], a, bq, acc[j]);
      }
    }
    __syncthreads();
  }

  // scores -> shared memory: ss[row][query]
#pragma unroll
  for (int j = 0; j < NQF; ++j)
    wmma::store_matrix_sync(ss + warp * 16 * kLdS + j * 16, acc[j], kLdS,
                            wmma::mem_row_major);
  __syncthreads();

  // epilogue: TPC threads per query column, adjacent lanes of one warp
  constexpr int TPC = kThreads / BQ;  // 4 or 16
  const int col = tid / TPC;
  const int sub = tid % TPC;
  const int b = q0 + col;
  const float ca = b < B ? col_add[b] : 0.0f;
  int top[P];
#pragma unroll
  for (int i = 0; i < P; ++i) top[i] = kInt32Min;
  for (int r = sub; r < kWindow; r += TPC) {
    // (alpha*dot + col_add) + row_add in the Pallas kernel's order;
    // the _rn intrinsics keep nvcc from contracting into an FMA
    float g = __fadd_rn(__fadd_rn(__fmul_rn(alpha, ss[r * kLdS + col]), ca),
                        row_add[row0 + r]);
    insert_key<P>(top, packed_key(g, r));
  }
#pragma unroll
  for (int off = 1; off < TPC; off <<= 1) {
    int other[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      other[i] = __shfl_xor_sync(0xffffffffu, top[i], off);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (other[i] != kInt32Min) insert_key<P>(top, other[i]);
  }
  if (sub == 0 && b < B) {
    const long long o = static_cast<long long>(b) * NW + w;
    pk1[o] = top[0];
    if (P >= 2) pk2[o] = top[P >= 2 ? 1 : 0];
    if (P == 3) pk3[o] = top[P - 1];
  }
}

// The int8 domain: the same block layout and epilogue reduction over
// exact int32 dots, no affine terms.  NQF: 16-query fragments per block
// (1 or 4); P: planes (1 or 2).  Shared tiles are k-step-major:
// element (r, k) of a `rows`-row tile sits at ((k/16)*rows + r)*16 + k%16.
template <int NQF, int P>
__global__ void __launch_bounds__(kThreads)
packed_window_scan_int8_kernel(const int8_t* __restrict__ q,
                               const int8_t* __restrict__ x, int B, int NW,
                               int d, int* __restrict__ pk1,
                               int* __restrict__ pk2) {
  constexpr int BQ = 16 * NQF;
  constexpr int kLdS = BQ + 4;  // int pitch of the score tile
  constexpr int kStageBytes = (kWindow + BQ) * kKTile8;
  constexpr int kScoreBytes = kWindow * kLdS * 4;
  constexpr int kSmem = kStageBytes > kScoreBytes ? kStageBytes : kScoreBytes;
  __shared__ __align__(128) unsigned char smem[kSmem];
  signed char* sx = reinterpret_cast<signed char*>(smem);
  signed char* sq = sx + kWindow * kKTile8;
  int* ss = reinterpret_cast<int*>(smem);  // reused after the GEMM

  const int n_qtiles = (B + BQ - 1) / BQ;
  const long long tile = blockIdx.x;
  const int qt = static_cast<int>(tile % n_qtiles);
  const long long w = tile / n_qtiles;
  const int q0 = qt * BQ;
  const long long row0 = w * kWindow;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NQF];
#pragma unroll
  for (int j = 0; j < NQF; ++j) wmma::fill_fragment(acc[j], 0);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < d; k0 += kKTile8) {
    // stage 16-code segments; segment c of row r goes to step c
    constexpr int kSegs = kKTile8 / 16;
    for (int s = tid; s < kWindow * kSegs; s += kThreads) {
      int r = s / kSegs, c = s % kSegs;
      uint4 v = zero;
      if (k0 + c * 16 < d)
        v = *reinterpret_cast<const uint4*>(x + (row0 + r) * d + k0 + c * 16);
      *reinterpret_cast<uint4*>(sx + (c * kWindow + r) * 16) = v;
    }
    for (int s = tid; s < BQ * kSegs; s += kThreads) {
      int r = s / kSegs, c = s % kSegs;
      uint4 v = zero;
      if (q0 + r < B && k0 + c * 16 < d)
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<long long>(q0 + r) * d + k0 + c * 16);
      *reinterpret_cast<uint4*>(sq + (c * BQ + r) * 16) = v;
    }
    __syncthreads();
    const int ksteps = min(kKTile8, d - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, sx + (ks * kWindow + warp * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < NQF; ++j) {
        // B = Q^T: sq holds [query][k], i.e. B in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bq;
        wmma::load_matrix_sync(bq, sq + (ks * BQ + j * 16) * 16, 16);
        wmma::mma_sync(acc[j], a, bq, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NQF; ++j)
    wmma::store_matrix_sync(ss + warp * 16 * kLdS + j * 16, acc[j], kLdS,
                            wmma::mem_row_major);
  __syncthreads();

  constexpr int TPC = kThreads / BQ;  // 4 or 16
  const int col = tid / TPC;
  const int sub = tid % TPC;
  const int b = q0 + col;
  int top[P];
#pragma unroll
  for (int i = 0; i < P; ++i) top[i] = kInt32Min;
  for (int r = sub; r < kWindow; r += TPC)
    insert_key<P>(top, packed_int_key(ss[r * kLdS + col], r));
#pragma unroll
  for (int off = 1; off < TPC; off <<= 1) {
    int other[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      other[i] = __shfl_xor_sync(0xffffffffu, top[i], off);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (other[i] != kInt32Min) insert_key<P>(top, other[i]);
  }
  if (sub == 0 && b < B) {
    const long long o = static_cast<long long>(b) * NW + w;
    pk1[o] = top[0];
    if (P == 2) pk2[o] = top[P - 1];
  }
}

template <int NQF, int P>
void launch(const void* q, const void* x, const void* row_add,
            const void* col_add, int B, int NW, int d, float alpha, void* pk1,
            void* pk2, void* pk3, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(NW) * ((B + 16 * NQF - 1) / (16 * NQF));
  packed_window_scan_kernel<NQF, P><<<static_cast<unsigned>(blocks), kThreads,
                                      0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(row_add), static_cast<const float*>(col_add),
      B, NW, d, alpha, static_cast<int*>(pk1), static_cast<int*>(pk2),
      static_cast<int*>(pk3));
}

template <int NQF, int P>
void launch_int8(const void* q, const void* x, int B, int NW, int d, void* pk1,
                 void* pk2, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(NW) * ((B + 16 * NQF - 1) / (16 * NQF));
  packed_window_scan_int8_kernel<NQF, P>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(x), B, NW,
          d, static_cast<int*>(pk1), static_cast<int*>(pk2));
}

}  // namespace

// Float domain.  q (B, d) bf16, x (N, d) bf16 with N = 128 * NW and
// d % 16 == 0, row_add (N,) f32, col_add (B,) f32, planes in {1, 2, 3};
// pk1..pk3 are (B, NW) int32 outputs (those past `planes` unused).
extern "C" int qrag_packed_window_scan(const void* q, const void* x,
                                       const void* row_add,
                                       const void* col_add, int B, int NW,
                                       int d, float alpha, int planes,
                                       void* pk1, void* pk2, void* pk3,
                                       void* stream) {
  if (B < 1 || NW < 1 || d < 16 || d % 16 != 0 || planes < 1 || planes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = B > 16;
  if (planes == 1) {
    if (wide)
      launch<4, 1>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
    else
      launch<1, 1>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
  } else if (planes == 2) {
    if (wide)
      launch<4, 2>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
    else
      launch<1, 2>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
  } else {
    if (wide)
      launch<4, 3>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
    else
      launch<1, 3>(q, x, row_add, col_add, B, NW, d, alpha, pk1, pk2, pk3, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Int8 domain.  q (B, d) int8, x (N, d) int8 with N = 128 * NW and
// d % 16 == 0, planes in {1, 2}; pk1, pk2 are (B, NW) int32 outputs
// (pk2 unused when planes == 1).
extern "C" int qrag_packed_window_scan_int8(const void* q, const void* x,
                                            int B, int NW, int d, int planes,
                                            void* pk1, void* pk2,
                                            void* stream) {
  if (B < 1 || NW < 1 || d < 16 || d % 16 != 0 || planes < 1 || planes > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = B > 16;
  if (planes == 1) {
    if (wide)
      launch_int8<4, 1>(q, x, B, NW, d, pk1, pk2, s);
    else
      launch_int8<1, 1>(q, x, B, NW, d, pk1, pk2, s);
  } else {
    if (wide)
      launch_int8<4, 2>(q, x, B, NW, d, pk1, pk2, s);
    else
      launch_int8<1, 2>(q, x, B, NW, d, pk1, pk2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
