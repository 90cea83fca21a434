// Fused scan + running top-k for Hopper (sm_90a): per query the k best
// corpus rows by goodness, the (B, N) score matrix never in device
// memory.
//
// Replaces the Pallas kernel of qrag_tpu/ops/pallas/scan_topk.py:
//   _scan_topk_kernel (:74, _pallas_scan_topk_padded :150,
//                      pallas_scan_topk :205)
// Its 256-query chunks, 128-lane k padding and sequential tile grid are
// VMEM and Mosaic artefacts; what it computes is kept:
//   g[b, n] = l2 ? (2 * dot(q_b, x_n) - qsq[b]) - xsq[n] : dot(q_b, x_n)
//   (operands rounded to bf16 first in the bf16 arm; f32 sums in both)
//   top-k of g per query by (value desc, index asc), where k sentinel
//   entries (finfo(f32).min, -1) stand before the corpus, so that rows
//   masked by valid_rows (biased to finfo(f32).min there) and rows with
//   g <= finfo(f32).min never displace a sentinel: slots past the last
//   real candidate hold (finfo(f32).min, -1), the reference's answer
//   whenever its corpus fits one tile.
// The caller turns values <= finfo(f32).min / 2 into +inf / -inf.
//
// Design: two kernels.  scan_topk_partial_kernel: a block owns QT
// queries x one contiguous range of rows (a split), walks it in chunks
// of 64 rows, computes the QT x 64 dots with f32 FFMA from tiles staged
// in shared memory (32 columns per step, register tiles of TQ x TR),
// and offers every score that beats the query's current k-th entry
// (value, then index) to a per-query candidate buffer of BUF entries in
// shared memory; a buffer that could not take another chunk is sorted
// by one warp (bitonic network) and cut to k, which raises the
// threshold.  Each split leaves its sorted top-k in scratch.
// scan_topk_merge_kernel: one warp per query merges the splits' lists
// with the same buffer; a list is sorted, so its first entry that fails
// the threshold ends it.  No library sort anywhere.
//
// What bounds it on an H100 (N = 1,250,176, d = 768): at B = 1024 the
// 1.97 TFLOP of f32 products, >= 29 ms at 67 TFLOP/s (FFMA, no tensor
// cores: the package refuses TF32); the bf16 arm's operands would allow
// the tensor cores (989 TFLOP/s, >= 2.0 ms) but this simple form runs
// FFMA on them too.  At B = 1 it reads the 3.84 GB corpus once: >= 1.15
// ms at 3.35 TB/s.  Later work: wgmma for the bf16 arm, TMA pipelines.
//
// The launch function allocates nothing, runs on the caller's stream,
// and returns cudaGetLastError() of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;        // corpus rows per chunk
constexpr int kDepth = 32;       // columns staged per step
constexpr int kPitch = kDepth + 4;  // f32 row pitch of the staged tiles
constexpr float kNeg = -FLT_MAX;    // finfo(f32).min

struct Entry {
  float v;
  int i;
};

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sorts buf[0, BUF) best first with one warp (bitonic network); the
// entries from `count` on are first set to an entry worse than any
// candidate (every candidate scores above finfo(f32).min).
template <int BUF>
__device__ void warp_sort(Entry* buf, int count, int lane) {
  for (int t = count + lane; t < BUF; t += 32) buf[t] = Entry{-INFINITY, INT_MAX};
  __syncwarp();
  for (int size = 2; size <= BUF; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < BUF / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Entry a = buf[i], b = buf[j];
        const bool swap = (i & size) == 0 ? better(b.v, b.i, a.v, a.i)
                                          : better(a.v, a.i, b.v, b.i);
        if (swap) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ float stage(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16, int QT, int BUF>
__global__ void __launch_bounds__(kThreads)
scan_topk_partial_kernel(const float* __restrict__ q,
                         const float* __restrict__ qsq,
                         const float* __restrict__ x,
                         const float* __restrict__ xsq,
                         const unsigned char* __restrict__ valid, int B,
                         long long N, int d, int k, int l2,
                         long long rows_per_split, float* __restrict__ pv,
                         int* __restrict__ pi) {
  constexpr int QTH = QT < 16 ? QT : 16;  // threads along queries
  constexpr int RTH = kThreads / QTH;     // threads along rows
  constexpr int TQ = QT / QTH;            // queries per thread (contiguous)
  constexpr int TR = kRows / RTH;         // rows per thread (stride RTH)
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* buf = reinterpret_cast<Entry*>(smem);            // [QT][BUF]
  float* qs = reinterpret_cast<float*>(buf + QT * BUF);   // [QT][kPitch]
  float* xs = qs + QT * kPitch;                           // [kRows][kPitch]
  int* cnt = reinterpret_cast<int*>(xs + kRows * kPitch); // [QT]
  float* thv = reinterpret_cast<float*>(cnt + QT);        // [QT]
  int* thi = reinterpret_cast<int*>(thv + QT);            // [QT]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tq = tid / RTH, tr = tid % RTH;
  const int q0 = blockIdx.x * QT;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  for (int t = tid; t < QT; t += kThreads) {
    cnt[t] = 0;
    thv[t] = kNeg;
    thi[t] = -1;
  }

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    float acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kDepth) {
      __syncthreads();  // the previous step's reads (and compaction) done
      for (int e = tid; e < QT * kDepth; e += kThreads) {
        const int qq = e / kDepth, c = e % kDepth;
        float v = 0.0f;
        if (q0 + qq < B && k0 + c < d)
          v = q[static_cast<long long>(q0 + qq) * d + k0 + c];
        qs[qq * kPitch + c] = stage(v, BF16);
      }
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int rr = e / kDepth, c = e % kDepth;
        const long long row = r0 + rr;
        float v = 0.0f;
        if (row < r_end && k0 + c < d) v = x[row * d + k0 + c];
        xs[rr * kPitch + c] = stage(v, BF16);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kDepth; c += 4) {
        float4 a[TQ], b[TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (tq * TQ + i) * kPitch + c);
#pragma unroll
        for (int j = 0; j < TR; ++j)
          b[j] = *reinterpret_cast<const float4*>(xs + (tr + j * RTH) * kPitch + c);
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
    }
    // offer this chunk's scores to the candidate buffers
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qq = tq * TQ + i;
      const int b = q0 + qq;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const long long row = r0 + tr + j * RTH;
        if (b < B && row < r_end && (valid == nullptr || valid[row])) {
          float g = acc[i][j];
          if (l2) g = __fsub_rn(__fsub_rn(2.0f * g, qsq[b]), xsq[row]);
          const int r = static_cast<int>(row);
          if (better(g, r, thv[qq], thi[qq])) {
            const int p = atomicAdd(&cnt[qq], 1);
            buf[qq * BUF + p] = Entry{g, r};
          }
        }
      }
    }
    __syncthreads();
    // a buffer that could not take another chunk: sort, cut to k
    for (int qq = warp; qq < QT; qq += kWarps) {
      const int c = cnt[qq];
      if (c > BUF - kRows) {
        Entry* bb = buf + qq * BUF;
        warp_sort<BUF>(bb, c, lane);
        if (lane == 0) {
          cnt[qq] = k;
          thv[qq] = bb[k - 1].v;
          thi[qq] = bb[k - 1].i;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int qq = warp; qq < QT; qq += kWarps) {
    const int b = q0 + qq;
    if (b >= B) continue;
    Entry* bb = buf + qq * BUF;
    const int c = min(cnt[qq], k);
    warp_sort<BUF>(bb, cnt[qq], lane);
    const long long base = (static_cast<long long>(blockIdx.y) * B + b) * k;
    for (int t = lane; t < k; t += 32) {
      const Entry e = t < c ? bb[t] : Entry{kNeg, -1};
      pv[base + t] = e.v;
      pi[base + t] = e.i;
    }
  }
}

template <int BUF>
__global__ void __launch_bounds__(kThreads)
scan_topk_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                       int splits, int B, int k, float* __restrict__ ov,
                       int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* buf = reinterpret_cast<Entry*>(smem) + (threadIdx.x / 32) * BUF;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp; no block barrier follows
  int cnt = 0;
  float tv = kNeg;
  int ti = -1;
  for (int s = 0; s < splits; ++s) {
    const long long base = (static_cast<long long>(s) * B + b) * k;
    for (int t0 = 0; t0 < k; t0 += 32) {
      const int t = t0 + lane;
      float v = kNeg;
      int i = -1;
      if (t < k) {
        v = pv[base + t];
        i = pi[base + t];
      }
      const bool pass = i >= 0 && better(v, i, tv, ti);
      const unsigned live = __ballot_sync(0xffffffffu, t < k);
      const unsigned mask = __ballot_sync(0xffffffffu, pass);
      if (pass) buf[cnt + __popc(mask & ((1u << lane) - 1u))] = Entry{v, i};
      cnt += __popc(mask);
      __syncwarp();
      if (cnt > BUF - 32) {
        warp_sort<BUF>(buf, cnt, lane);
        cnt = k;
        tv = buf[k - 1].v;
        ti = buf[k - 1].i;
        __syncwarp();
      }
      if (mask != live) break;  // a list is sorted: the rest fails too
    }
  }
  warp_sort<BUF>(buf, cnt, lane);
  const int c = min(cnt, k);
  for (int t = lane; t < k; t += 32) {
    const Entry e = t < c ? buf[t] : Entry{kNeg, -1};
    ov[static_cast<long long>(b) * k + t] = e.v;
    oi[static_cast<long long>(b) * k + t] = e.i;
  }
}

struct Args {
  const float* q;
  const float* qsq;
  const float* x;
  const float* xsq;
  const unsigned char* valid;
  int B;
  long long N;
  int d, k, l2, splits;
  long long rows_per_split;
  float* pv;
  int* pi;
  float* ov;
  int* oi;
  cudaStream_t s;
};

template <bool BF16, int QT, int BUF>
int launch(const Args& a) {
  const size_t smem = static_cast<size_t>(QT) * BUF * sizeof(Entry) +
                      static_cast<size_t>(QT + kRows) * kPitch * sizeof(float) +
                      static_cast<size_t>(QT) * 3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_partial_kernel<BF16, QT, BUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + QT - 1) / QT, a.splits);
  scan_topk_partial_kernel<BF16, QT, BUF><<<grid, kThreads, smem, a.s>>>(
      a.q, a.qsq, a.x, a.xsq, a.valid, a.B, a.N, a.d, a.k, a.l2,
      a.rows_per_split, a.pv, a.pi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t msmem = static_cast<size_t>(kWarps) * BUF * sizeof(Entry);
  err = cudaFuncSetAttribute(scan_topk_merge_kernel<BUF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(msmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_topk_merge_kernel<BUF><<<(a.B + kWarps - 1) / kWarps, kThreads, msmem, a.s>>>(
      a.pv, a.pi, a.splits, a.B, a.k, a.ov, a.oi);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch(const Args& a, int qt, int buf) {
  if (buf == 128 && qt == 16) return launch<BF16, 16, 128>(a);
  if (buf == 128 && qt == 64) return launch<BF16, 64, 128>(a);
  if (buf == 256 && qt == 16) return launch<BF16, 16, 256>(a);
  if (buf == 256 && qt == 64) return launch<BF16, 64, 256>(a);
  if (buf == 512 && qt == 16) return launch<BF16, 16, 512>(a);
  if (buf == 1024 && qt == 16) return launch<BF16, 16, 1024>(a);
  if (buf == 2048 && qt == 8) return launch<BF16, 8, 2048>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, d) f32, qsq (B,) f32, x (N, d) f32, xsq (N,) f32, valid (N,)
// bool or null; (qt, buf) one of the instantiated tile/buffer pairs
// with k + 64 <= buf; the rows split into `splits` ranges of
// rows_per_split; pv, pi (splits, B, k) scratch; ov, oi (B, k) outputs.
extern "C" int qrag_scan_topk(const void* q, const void* qsq, const void* x,
                              const void* xsq, const void* valid, int B,
                              long long N, int d, int k, int l2, int bf16,
                              int qt, int buf, int splits,
                              long long rows_per_split, void* pv, void* pi,
                              void* ov, void* oi, void* stream) {
  if (B < 1 || N < 1 || N > INT_MAX || d < 1 || k < 1 || k > N ||
      k + kRows > buf || splits < 1 || rows_per_split < 1 ||
      rows_per_split * splits < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(qsq),
               static_cast<const float*>(x), static_cast<const float*>(xsq),
               static_cast<const unsigned char*>(valid), B, N, d, k, l2,
               splits, rows_per_split, static_cast<float*>(pv),
               static_cast<int*>(pi), static_cast<float*>(ov),
               static_cast<int*>(oi), static_cast<cudaStream_t>(stream)};
  return bf16 ? dispatch<true>(a, qt, buf) : dispatch<false>(a, qt, buf);
}
