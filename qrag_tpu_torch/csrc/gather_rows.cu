// Row gather for Hopper (sm_90a): out[m] = corpus[clamp(idx[m], 0, N-1)].
//
// Replaces the Pallas kernels of qrag_tpu/ops/pallas/gather_rows.py:
//   _gather_kernel    (:34, gather_rows / gather_rows_2d): per-row DMAs
//   _gather_bs_kernel (:131, gather_rows_blockspec): BlockSpec form
// Their split (in-kernel async copies vs index_map-driven pipeline
// DMAs), the rows-per-block tiling and the scalar prefetch of the
// index list are Mosaic matters; here both are this one kernel.
//
// Contract: rows are copied as bytes, so any element type and any row
// width work.  Indices (int32 or int64) are clamped to [0, N-1] in the
// kernel, as the reference clamps them before its DMAs: an invalid
// candidate slot copies a real row that the caller masks later.
//
// Design: one warp per output row (8 rows per 256-thread block, a grid-
// stride loop over rows).  A row is moved in units of W bytes, W the
// widest of 16, 8, 4, 2, 1 that divides the row pitch and both base
// addresses, so an f32 or bf16 row of d = 768 moves in 16-byte vector
// copies and an odd pitch in narrower ones, with no tail.
//
// What bounds it on an H100: it computes nothing and moves each
// gathered row twice (read and write): 2 * M * d * itemsize bytes at
// 3.35 TB/s, e.g. >= 0.19 ms for 102,400 f32 rows of d = 768.  The
// random row order costs no extra bytes at 3 KB per row.  Replayed from
// a CUDA graph (no host in the way) this copy loop takes 0.0021 /
// 0.0113 / 0.219 ms for 100 / 6,400 / 102,400 such rows, against
// 0.0017 / 0.0119 / 0.219 ms for torch.index_select (NVIDIA H100 80GB
// HBM3, 700 W; ops/cuda/launch_ab.py).  A form that cut a row over
// several warps at small M and issued four loads before their stores
// measured the same (0.0021-0.0024 ms at M = 100), so the loop stays as
// it is: below a few thousand rows the device work is shorter than one
// launch from Python, and what a caller waits for is the wrapper's host
// path, which ops/cuda/_launch.py keeps short.
//
// The launch function allocates nothing, runs on the caller's stream,
// and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <int W> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };
template <> struct Unit<1> { using T = uint8_t; };

template <int W, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const unsigned char* __restrict__ corpus,
                   const Idx* __restrict__ idx, long long M, long long N,
                   long long row_bytes, unsigned char* __restrict__ out) {
  using T = typename Unit<W>::T;
  const long long units = row_bytes / W;
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long m = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                     threadIdx.x / 32;
       m < M; m += stride) {
    long long r = static_cast<long long>(idx[m]);
    r = r < 0 ? 0 : (r >= N ? N - 1 : r);
    const T* src = reinterpret_cast<const T*>(corpus + r * row_bytes);
    T* dst = reinterpret_cast<T*>(out + m * row_bytes);
    for (long long u = lane; u < units; u += 32) dst[u] = src[u];
  }
}

template <typename Idx>
int launch(const void* corpus, const void* idx, long long M, long long N,
           long long row_bytes, void* out, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(corpus) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  const long long want = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  const unsigned blocks = static_cast<unsigned>(want < 65536 ? want : 65536);
  const auto* c = static_cast<const unsigned char*>(corpus);
  const auto* i = static_cast<const Idx*>(idx);
  auto* o = static_cast<unsigned char*>(out);
  if (a % 16 == 0)
    gather_rows_kernel<16, Idx><<<blocks, kThreads, 0, s>>>(c, i, M, N, row_bytes, o);
  else if (a % 8 == 0)
    gather_rows_kernel<8, Idx><<<blocks, kThreads, 0, s>>>(c, i, M, N, row_bytes, o);
  else if (a % 4 == 0)
    gather_rows_kernel<4, Idx><<<blocks, kThreads, 0, s>>>(c, i, M, N, row_bytes, o);
  else if (a % 2 == 0)
    gather_rows_kernel<2, Idx><<<blocks, kThreads, 0, s>>>(c, i, M, N, row_bytes, o);
  else
    gather_rows_kernel<1, Idx><<<blocks, kThreads, 0, s>>>(c, i, M, N, row_bytes, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// corpus (N, row_bytes) bytes, idx (M,) int32 (idx64 == 0) or int64,
// out (M, row_bytes) bytes; M >= 1, N >= 1, row_bytes >= 1.
extern "C" int qrag_gather_rows(const void* corpus, const void* idx,
                                int idx64, long long M, long long N,
                                long long row_bytes, void* out,
                                void* stream) {
  if (M < 1 || N < 1 || row_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch<int64_t>(corpus, idx, M, N, row_bytes, out, s)
               : launch<int32_t>(corpus, idx, M, N, row_bytes, out, s);
}
