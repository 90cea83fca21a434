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
// Two arms per domain; the wrapper (ops/cuda/fused_scan.py, `_config`)
// picks one from the shapes.
//
// The wide arm (B past the wrapper's cut, d a whole number of 128-byte
// slabs: 64 bf16 values or 128 int8 codes).  What bounds the scan on an
// H100 at N = 1,250,176, d = 768, B = 1024 is operations: 2*B*N*d = 1.97
// TFLOP, >= 1.99 ms at 989 dense bf16 TFLOP/s, >= 1.0 ms at 1,979 int8
// TOPS.  A tensor-core tile stages 2*(rows + queries) bytes (bf16) for
// every 2*rows*queries FLOP, so the tile's shape decides how many bytes
// pass from L2 into shared memory: the design keeps that traffic down
// and off the multiplying warps.
//   - One block holds a 128-query x 256-row tile (two windows), the
//     most whose f32/int32 sums fit in the registers of two warpgroups;
//     queries lie on wgmma's M and corpus rows on its N
//     (m64n256k16.f32.bf16.bf16 or m64n256k32.s32.s8.s8, both operands
//     K-major in shared memory under the 128-byte swizzle).
//   - Where there are two or more query tiles, two blocks form a
//     cluster on the same 256 rows: each loads half of the corpus slab
//     and multicasts it to both, so a block stages 32 KB a slab and
//     not 48.
//   - A producer thread fills a ring of 4 stages (one 128-byte slab of
//     both operands each) by TMA (cp.async.bulk.tensor with mbarriers);
//     the two consumer warpgroups only wait, multiply and release.  TMA
//     fills rows past B or N and columns past d with zeros, so a ragged
//     last query tile or window pair costs masked stores and nothing
//     else.  The tensor maps are encoded per call in the launch
//     function (cuTensorMapEncodeTiled, looked up in the loaded libcuda:
//     nothing links against it).
//   - Inside the loop over a tile's slabs nothing but wgmma names the
//     accumulators, so ptxas lets the multiplies run on across the loop's
//     edge.
//   - The epilogue stays in registers: a thread holds, of two queries,
//     32 scores of each window; it folds them into its top-`planes`
//     keys and two shuffle rounds across its quad finish the window.
//     row_add comes with the tile (a bulk copy into a 2-slot ring of
//     its own).  Meanwhile the producer refills the ring for the next
//     tile.
//   - Blocks are persistent (one per SM); tiles go query tile fastest,
//     so the blocks of one wave share corpus rows in L2 (the 1.9 GB
//     corpus passes from device memory once; the 1.5 MB of queries
//     stay in L2).  Query tile slowest measured 5-20% slower.
// Measured at those shapes on an NVIDIA H100 80GB HBM3, 700.00 W power
// limit (chip_smoke.py): 2.8-3.3 ms for bf16 planes 1-3 beside 2.7 for
// the bare torch.matmul, 1.4-1.6 ms for int8 planes 1-2 beside 3.4 for
// the bare torch._int_mm; at B = 64, 0.65 and 0.33 ms (bytes-bound:
// 0.58 and 0.29).
//
// The general arm (B <= the cut, where the scan is bytes-bound: at B = 1
// >= 0.57 ms for the 1.92 GB bf16 corpus and >= 0.29 ms for 0.96 GB of
// codes at 3.35 TB/s; and every d % 16 == 0 the wide arm does not
// take): one block owns one whole 128-row window x a tile of 16 or 64
// queries, so no reduction crosses blocks.  Products run on the tensor
// cores with WMMA 16x16x16: bf16 x bf16 -> f32, or int8 x int8 -> int32.
// Each step stages 128 bytes of every row in 16-byte segments; the int8
// tile is stored k-step-major (all rows of one 16-code step contiguous)
// so every fragment starts 256-bit aligned.  The tile's scores go to
// shared memory, and 4 or 16 threads per query column reduce its 128
// rows to the top-`planes` keys with a warp-shuffle merge.  The two
// domains are separate kernels: one template over both compiled the
// bf16 instance into code 17% slower at B = 1024 (measured A/B on the
// H100).
//
// The launch functions allocate nothing, run on the caller's stream,
// and return cudaGetLastError() of the launch (or the error that kept
// them from launching).

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------------------ wide arm

constexpr int kWideQ = 128;     // queries a block: 64 (wgmma's M) per consumer warpgroup
constexpr int kWideRows = 256;  // corpus rows a block: two windows, wgmma's N
constexpr int kSlabBytes = 128;  // bytes of a row in one stage: one swizzle row
constexpr int kStages = 4;
constexpr int kStageA = kWideQ * kSlabBytes;     // 16 KB of queries
constexpr int kStageB = kWideRows * kSlabBytes;  // 32 KB of corpus rows
constexpr int kStageBytes = kStageA + kStageB;
constexpr int kConsumerWarps = 8;
constexpr int kWideThreads = 384;  // two consumer warpgroups and the producer's
// 1 KB of slack to align the stages (the swizzle pattern repeats every
// 1024 bytes), the ring, two row_add slots, 12 barriers
constexpr int kWideSmem = 1024 + kStages * kStageBytes + 2 * kWideRows * 4 + 16 * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One arrival at `bar` of this block and, in a cluster, at the barrier
// at the same place in every other block of it.
template <int CL>
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  if constexpr (CL == 1) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  } else {
#pragma unroll
    for (uint32_t cta = 0; cta < CL; ++cta)
      asm volatile(
          "{\n"
          ".reg .b32 remote;\n"
          "mapa.shared::cluster.u32 remote, %0, %1;\n"
          "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
          "}\n" ::"r"(bar), "r"(cta)
          : "memory");
  }
}

// Waits for the phase of parity `parity` to complete.  A wait that
// lasts two seconds is a fault in the pipeline: trap, so that the launch
// fails and does not hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (++spins == 4096)
      t0 = clock64();
    else if (spins > 4096 && clock64() - t0 > 4000000000LL)
      __trap();
  }
}

// One box of a tensor map into shared memory; its bytes count at `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same into every block of the cluster named in `mask`, at the
// same place in each, counted at the barrier at `bar` in each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread of the block (CL == 1) or of the cluster meets here.
template <int CL>
__device__ __forceinline__ void meet() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// Shared-memory matrix descriptor of a K-major operand under the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (the leading offset is unused in this mode).  A 32-byte step along K
// inside the swizzle row adds 2 to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 256) [+]= A (64 x 32 bytes of K, shared memory) * B (256 x 32
// bytes of K, shared memory): f32 sums of bf16 products, or int32 sums
// of int8 products.  The 128 accumulators of a thread are operands %0
// to %127 of the statement, the descriptors %128 and %129, and %130
// says whether D is added to (0: D = A * B).
#define QRAG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}, "
#define QRAG_ACC4(C, i) C(c[i]), C(c[(i) + 1]), C(c[(i) + 2]), C(c[(i) + 3])
#define QRAG_ACC16(C, i) \
  QRAG_ACC4(C, i), QRAG_ACC4(C, (i) + 4), QRAG_ACC4(C, (i) + 8), QRAG_ACC4(C, (i) + 12)
#define QRAG_ACC128(C)                                                        \
  QRAG_ACC16(C, 0), QRAG_ACC16(C, 16), QRAG_ACC16(C, 32), QRAG_ACC16(C, 48), \
      QRAG_ACC16(C, 64), QRAG_ACC16(C, 80), QRAG_ACC16(C, 96), QRAG_ACC16(C, 112)

__device__ __forceinline__ void wgmma_tile(float (&c)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " QRAG_D128
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : QRAG_ACC128("+f")
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tile(int (&c)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " QRAG_D128
      "%128, %129, p;\n"
      "}\n"
      : QRAG_ACC128("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)::"memory"); }

__device__ __forceinline__ int wide_key(float dot, float alpha, float ca, float ra, int lane) {
  // (alpha*dot + col_add) + row_add, as the general arm
  return packed_key(__fadd_rn(__fadd_rn(__fmul_rn(alpha, dot), ca), ra), lane);
}
__device__ __forceinline__ int wide_key(int dot, float, float, float, int lane) {
  return packed_int_key(dot, lane);
}

// insert_key as min/max pairs (keys are distinct): two instructions a
// level, one at the last.
template <int P>
__device__ __forceinline__ void fold_key(int (&top)[P], int v) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int hi = max(top[i], v);
    if (i + 1 < P) v = min(top[i], v);
    top[i] = hi;
  }
}

// Merges the descending lists of the four lanes of a quad; every lane
// ends with the quad's top P.
template <int P>
__device__ __forceinline__ void quad_merge(int (&top)[P]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    int other[P];
#pragma unroll
    for (int i = 0; i < P; ++i) other[i] = __shfl_xor_sync(0xffffffffu, top[i], off);
#pragma unroll
    for (int i = 0; i < P; ++i) fold_key<P>(top, other[i]);
  }
}

// INT8: the domain; P: planes; CL: blocks in a cluster (1 or 2), which
// take neighbouring query tiles over the same rows.  Block `rank` of a
// cluster loads rows [256 g + 256 rank / CL, + 256 / CL) of a slab for
// all of them.  Work item i of cluster c is c + i * clusters: query-tile
// group i % n_qp, row group i / n_qp.
template <bool INT8, int P, int CL>
__global__ void __launch_bounds__(kWideThreads, 1)
packed_window_scan_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_x,
                               const float* __restrict__ row_add,
                               const float* __restrict__ col_add, int B, int NW, int d,
                               float alpha, int* __restrict__ pk1, int* __restrict__ pk2,
                               int* __restrict__ pk3) {
  using acc_t = typename std::conditional<INT8, int, float>::type;
  constexpr int kSlabElems = INT8 ? 128 : 64;
  extern __shared__ unsigned char smem_wide[];
  const uint32_t raw = smem_u32(smem_wide);
  const uint32_t base = (raw + 1023u) & ~1023u;  // stage s at base + s * kStageBytes: A, then B
  const uint32_t ra_base = base + kStages * kStageBytes;  // [2][256] f32 of row_add
  const uint32_t full0 = ra_base + 2 * kWideRows * 4;     // barriers: a stage is filled,
  const uint32_t empty0 = full0 + 8 * kStages;            // a stage is free again,
  const uint32_t ra_full0 = empty0 + 8 * kStages;         // a row_add slot is filled,
  const uint32_t ra_empty0 = ra_full0 + 16;               // and free again

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  uint32_t rank = 0;
  if constexpr (CL > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int n_qp = ((B + kWideQ - 1) / kWideQ + CL - 1) / CL;
  const long long items = static_cast<long long>((NW + 1) / 2) * n_qp;
  const int clusters = gridDim.x / CL, cluster = blockIdx.x / CL;
  const int nkb = d / kSlabElems;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps * CL);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ra_full0 + 8 * i, 1);
      mbar_init(ra_empty0 + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  meet<CL>();

  if (wg == 2) {
    // the producer: one thread keeps the ring and the row_add slots full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      uint32_t it = 0, tile = 0;
      for (long long item = cluster; item < items; item += clusters, ++tile) {
        const int qt = static_cast<int>(item % n_qp) * CL + static_cast<int>(rank);
        const int row0 = static_cast<int>(item / n_qp) * kWideRows;
        if constexpr (!INT8) {
          const uint32_t slot = tile & 1;
          mbar_wait(ra_empty0 + 8 * slot, ((tile >> 1) & 1) ^ 1);
          const uint32_t bytes = 4u * min(kWideRows, NW * kWindow - row0);
          mbar_expect_tx(ra_full0 + 8 * slot, bytes);
          bulk_load(ra_base + slot * kWideRows * 4, row_add + row0, bytes, ra_full0 + 8 * slot);
        }
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const uint32_t s = it % kStages, bar = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(bar, kStageBytes);
          const uint32_t a = base + s * kStageBytes;
          tma_load(a, &map_q, kb * kSlabElems, qt * kWideQ, bar);
          if constexpr (CL == 1)
            tma_load(a + kStageA, &map_x, kb * kSlabElems, row0, bar);
          else
            tma_load_multicast(a + kStageA + rank * (kStageB / CL), &map_x, kb * kSlabElems,
                               row0 + static_cast<int>(rank) * (kWideRows / CL), bar,
                               static_cast<uint16_t>((1 << CL) - 1));
        }
      }
    }
    __syncwarp();
    // no block leaves while another of its cluster may still signal it
    if constexpr (CL > 1) meet<CL>();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    acc_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    // acc[4 j + 2 h + e] is query 16 (warp % 4) + lane / 4 + 8 h of the
    // warpgroup's 64, row 8 j + 2 (lane % 4) + e of the tile's 256
    const int qr = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c2 = 2 * (lane % 4);
    const float* ra_s = reinterpret_cast<const float*>(smem_wide + (ra_base - raw));
    uint32_t it = 0, tile = 0;
    for (long long item = cluster; item < items; item += clusters, ++tile) {
      const int qt = static_cast<int>(item % n_qp) * CL + static_cast<int>(rank);
      const int w0 = static_cast<int>(item / n_qp) * 2;
      const int b0 = qt * kWideQ + qr, b1 = b0 + 8;
      float ca0 = 0.0f, ca1 = 0.0f;
      if constexpr (!INT8) {
        if (b0 < B) ca0 = __ldg(col_add + b0);
        if (b1 < B) ca1 = __ldg(col_add + b1);
      }
      // the multiply loop: nothing but wgmma names the accumulators
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const uint32_t s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t a = base + s * kStageBytes;
        const uint64_t da = sw128_desc(a + wg * 64 * kSlabBytes);
        const uint64_t db = sw128_desc(a + kStageA);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kSlabBytes / 32; ++ks)
          wgmma_tile(acc, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the slab before this one has been read: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kb > 0 && lane == 0) mbar_arrive<CL>(empty0 + 8 * ((it - 1) % kStages));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive<CL>(empty0 + 8 * ((it - 1) % kStages));
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);

      // the epilogue, while the producer fills the ring for the next tile
      const uint32_t slot = tile & 1;
      if constexpr (!INT8) mbar_wait(ra_full0 + 8 * slot, (tile >> 1) & 1);
#pragma unroll
      for (int wi = 0; wi < 2; ++wi) {
        int top0[P], top1[P];
#pragma unroll
        for (int i = 0; i < P; ++i) top0[i] = top1[i] = kInt32Min;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * wi + jj, l0 = 8 * jj + c2;
          float2 ra = make_float2(0.0f, 0.0f);
          if constexpr (!INT8)
            ra = *reinterpret_cast<const float2*>(ra_s + slot * kWideRows + 128 * wi + l0);
          fold_key<P>(top0, wide_key(acc[4 * j], alpha, ca0, ra.x, l0));
          fold_key<P>(top0, wide_key(acc[4 * j + 1], alpha, ca0, ra.y, l0 + 1));
          fold_key<P>(top1, wide_key(acc[4 * j + 2], alpha, ca1, ra.x, l0));
          fold_key<P>(top1, wide_key(acc[4 * j + 3], alpha, ca1, ra.y, l0 + 1));
        }
        quad_merge<P>(top0);
        quad_merge<P>(top1);
        const int w = w0 + wi;
        if (lane % 4 == 0 && w < NW) {
          if (b0 < B) {
            const long long o = static_cast<long long>(b0) * NW + w;
            pk1[o] = top0[0];
            if (P >= 2) pk2[o] = top0[P >= 2 ? 1 : 0];
            if (P == 3) pk3[o] = top0[P - 1];
          }
          if (b1 < B) {
            const long long o = static_cast<long long>(b1) * NW + w;
            pk1[o] = top1[0];
            if (P >= 2) pk2[o] = top1[P >= 2 ? 1 : 0];
            if (P == 3) pk3[o] = top1[P - 1];
          }
        }
      }
      if constexpr (!INT8) {
        __syncwarp();
        if (lane == 0) mbar_arrive<1>(ra_empty0 + 8 * slot);
      }
    }
    if constexpr (CL > 1) meet<CL>();
  }
}

// cuTensorMapEncodeTiled of the libcuda that the process has loaded;
// null if it cannot be found.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a row-major (rows, d) matrix of bf16 values or int8
// codes, read in boxes of `box_rows` rows x 128 bytes under the
// 128-byte swizzle; what a box holds past the matrix reads as zeros.
int make_map(CUtensorMap* map, bool int8, const void* p, long long rows, int d, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t elem = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlabBytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(p), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool INT8, int P, int CL>
int launch_wide(const void* q, const void* x, const void* row_add, const void* col_add, int B,
                int NW, int d, float alpha, int grid, void* pk1, void* pk2, void* pk3,
                cudaStream_t stream) {
  CUtensorMap map_q, map_x;
  int err = make_map(&map_q, INT8, q, B, d, kWideQ);
  if (err == 0)
    err = make_map(&map_x, INT8, x, static_cast<long long>(NW) * kWindow, d, kWideRows / CL);
  if (err != 0) return err;
  auto kernel = packed_window_scan_wide_kernel<INT8, P, CL>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = kWideSmem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, map_q, map_x, static_cast<const float*>(row_add),
                         static_cast<const float*>(col_add), B, NW, d, alpha,
                         static_cast<int*>(pk1), static_cast<int*>(pk2), static_cast<int*>(pk3));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool INT8, int P>
int dispatch_wide(int cluster, const void* q, const void* x, const void* row_add,
                const void* col_add, int B, int NW, int d, float alpha, int grid, void* pk1,
                void* pk2, void* pk3, cudaStream_t s) {
  const int slab = INT8 ? 128 : 64;
  if (d % slab != 0 || (cluster != 1 && cluster != 2) || grid < cluster || grid % cluster != 0 ||
      NW > (1 << 24) - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 2)
    return launch_wide<INT8, P, 2>(q, x, row_add, col_add, B, NW, d, alpha, grid, pk1, pk2, pk3,
                                   s);
  return launch_wide<INT8, P, 1>(q, x, row_add, col_add, B, NW, d, alpha, grid, pk1, pk2, pk3, s);
}

}  // namespace

// Float domain.  q (B, d) bf16, x (N, d) bf16 with N = 128 * NW and
// d % 16 == 0, row_add (N,) f32, col_add (B,) f32, planes in {1, 2, 3};
// pk1..pk3 are (B, NW) int32 outputs (those past `planes` unused).
// arm 0 is the general arm; arm 1 the wide one (d % 64 == 0, operands
// 16-byte aligned), in clusters of `cluster` (1 or 2) blocks, `grid`
// blocks in all.
extern "C" int qrag_window_scan_bf16(const void* q, const void* x, const void* row_add,
                                     const void* col_add, int B, int NW, int d, float alpha,
                                     int planes, int arm, int cluster, int grid, void* pk1,
                                     void* pk2, void* pk3, void* stream) {
  if (B < 1 || NW < 1 || d < 16 || d % 16 != 0 || planes < 1 || planes > 3 || arm < 0 || arm > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arm == 1) {
    if (planes == 1)
      return dispatch_wide<false, 1>(cluster, q, x, row_add, col_add, B, NW, d, alpha, grid, pk1,
                                   pk2, pk3, s);
    if (planes == 2)
      return dispatch_wide<false, 2>(cluster, q, x, row_add, col_add, B, NW, d, alpha, grid, pk1,
                                   pk2, pk3, s);
    return dispatch_wide<false, 3>(cluster, q, x, row_add, col_add, B, NW, d, alpha, grid, pk1, pk2,
                                 pk3, s);
  }
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
// (pk2 unused when planes == 1).  arm, cluster and grid as above (the
// wide arm takes d % 128 == 0).
extern "C" int qrag_window_scan_int8(const void* q, const void* x, int B, int NW, int d,
                                     int planes, int arm, int cluster, int grid, void* pk1,
                                     void* pk2, void* stream) {
  if (B < 1 || NW < 1 || d < 16 || d % 16 != 0 || planes < 1 || planes > 2 || arm < 0 || arm > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arm == 1) {
    if (planes == 1)
      return dispatch_wide<true, 1>(cluster, q, x, nullptr, nullptr, B, NW, d, 1.0f, grid, pk1, pk2,
                                  pk2, s);
    return dispatch_wide<true, 2>(cluster, q, x, nullptr, nullptr, B, NW, d, 1.0f, grid, pk1, pk2,
                                pk2, s);
  }
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
