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
// What bounds it on an H100 (N = 1,250,176, d = 768), and the arm that
// answers each bound.  Every arm is a "partial" kernel: a block owns a
// group of queries x one contiguous range of rows (a split), offers
// every score that beats the query's current k-th entry (value, then
// index) to a per-query candidate buffer in shared memory, sorts a
// buffer that could not take another chunk (bitonic network, no library
// sort) and cuts it to k, which raises the threshold, and leaves its
// sorted top-k in scratch; scan_topk_merge_kernel then merges the
// splits' lists, one block per query, level by level (the best entry
// of every list first), and stops at the first level that adds nothing.
//
//   stream (B <= 8; f32 compute up to B = 64, where it still beats the
//     tiles): the bound is bytes, the 3.84 GB corpus read once per 8
//     queries, >= 1.15 ms at 3.35 TB/s.  The queries sit in shared
//     memory for the whole block; a warp owns four rows at a time, each
//     lane reads its part of the rows with 16-byte read-only loads
//     straight into registers (eight in flight per lane, two blocks of
//     eight warps per SM), the dots finish by warp shuffles, and the
//     block meets at a barrier only once per 256 rows, to compact the
//     buffers.  Rows that are not 16-byte aligned run the same arm with
//     4-byte loads.
//   wgmma (bf16 compute, B > 8): the bound is operations, 1.97 TFLOP,
//     >= 2.0 ms at 989 TFLOP/s on the tensor cores.  64 or 128 queries
//     are rounded to bf16 once into shared memory (128-byte swizzle,
//     wgmma's B operand).  A warp reads its 16 corpus rows as f32
//     straight into the registers of wgmma's A operand, two steps of 64
//     columns ahead, and rounds them to bf16 there (the k slots of a
//     fragment are permuted so that a lane's slots are one 16-byte
//     load; the queries are stored in the same order): the corpus
//     never passes through shared memory, whose bandwidth two
//     warpgroups of m64n64k16 with both operands there had used up, and
//     the row loop has no block barrier.  Each warpgroup issues
//     m64n64k16 or m64n128k16 with f32 accumulators on its 64 rows, and
//     the epilogue runs from the accumulator registers.  The store is
//     passed over B / 64 or B / 128 times (from L2 after the first: the
//     query tiles of one row range run side by side).
//   tiled (f32 compute, B > 64): FFMA, >= 29 ms at 67 TFLOP/s (the
//     package refuses TF32).  128 queries x 128 rows per block, 8 x 8
//     outputs a thread, the depth in steps of 16 through a three-stage
//     cp.async ring, row pitch 80 bytes so that both operands load as
//     conflict-free 16-byte vectors, one barrier per step.  At this
//     tile a warp needs 64 shared-memory wavefronts per 256 FFMA, so
//     the shared-memory pipe is as busy as the FFMA issue: it runs at
//     43% of the FFMA peak.  (8 x 16 outputs a thread, which would need
//     a quarter fewer wavefronts, spill at 255 registers and run slower.)
//   general: the first form (64-row chunks staged by scalar loads, 4 x 4
//     register tiles), kept for what the arms above do not take: k too
//     large for their buffers, rows that are not 16-byte aligned past
//     the stream arm's batches, a depth past their shared memory.
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
constexpr float kNeg = -FLT_MAX;  // finfo(f32).min
constexpr int kMergeBuf = 2048;   // the merge kernel's buffer entries
constexpr int kMergeBatch = 1024; // lists it reads per step

struct Entry {
  float v;
  int i;
};

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ int sort_size(int count) {
  int n = 2;
  while (n < count) n <<= 1;
  return n;
}

__device__ __forceinline__ void exchange(Entry* buf, int t, int size, int stride) {
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

// Sorts buf[0, count) best first with one warp (bitonic network over
// the next power of two, the tail filled with entries worse than any
// candidate: every candidate scores above finfo(f32).min).
__device__ void warp_sort(Entry* buf, int count, int lane) {
  const int n = sort_size(count);
  for (int t = count + lane; t < n; t += 32) buf[t] = Entry{-INFINITY, INT_MAX};
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) exchange(buf, t, size, stride);
      __syncwarp();
    }
}

// The same with the whole block; every thread calls it with the same
// count.  Ends with a barrier.
__device__ void block_sort(Entry* buf, int count, int tid) {
  const int n = sort_size(count);
  for (int t = count + tid; t < n; t += kThreads) buf[t] = Entry{-INFINITY, INT_MAX};
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n / 2; t += kThreads) exchange(buf, t, size, stride);
      __syncthreads();
    }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The per-query candidate buffers of a block: QT buffers of BUF
// entries, their fill counts and the thresholds (the k-th entry after
// the last cut; (finfo(f32).min, -1), the k-th sentinel, before it).
struct Cand {
  Entry* buf;
  int* cnt;
  float* thv;
  int* thi;
  int BUF;

  __device__ __forceinline__ void init(int qt, int tid) {
    for (int t = tid; t < qt; t += kThreads) {
      cnt[t] = 0;
      thv[t] = kNeg;
      thi[t] = -1;
    }
  }
  __device__ __forceinline__ void offer(int qq, float g, int row) {
    if (better(g, row, thv[qq], thi[qq])) {
      const int p = atomicAdd(&cnt[qq], 1);
      buf[qq * BUF + p] = Entry{g, row};
    }
  }
  // Between two block barriers: every buffer that could not take
  // another `chunk` entries is sorted by one warp and cut to k.
  __device__ void compact(int qt, int k, int chunk, int warp, int lane) {
    for (int qq = warp; qq < qt; qq += kWarps) {
      const int c = cnt[qq];
      if (c > BUF - chunk) {
        Entry* bb = buf + qq * BUF;
        warp_sort(bb, c, lane);
        if (lane == 0) {
          cnt[qq] = k;
          thv[qq] = bb[k - 1].v;
          thi[qq] = bb[k - 1].i;
        }
        __syncwarp();
      }
    }
  }
  // After a block barrier: each query's sorted top-k to the split's
  // scratch list, sentinels past the last candidate.
  __device__ void write(int qt, int q0, int B, int k, int split, float* pv,
                        int* pi, int warp, int lane) {
    for (int qq = warp; qq < qt; qq += kWarps) {
      const int b = q0 + qq;
      if (b >= B) continue;
      Entry* bb = buf + qq * BUF;
      const int c = min(cnt[qq], k);
      warp_sort(bb, cnt[qq], lane);
      const long long base = (static_cast<long long>(split) * B + b) * k;
      for (int t = lane; t < k; t += 32) {
        const Entry e = t < c ? bb[t] : Entry{kNeg, -1};
        pv[base + t] = e.v;
        pi[base + t] = e.i;
      }
    }
  }
};

__device__ __forceinline__ float score(float dot, int l2, float qsq, float xsq) {
  // the reference's order; _rn keeps nvcc from contracting into an FMA
  return l2 ? __fsub_rn(__fsub_rn(2.0f * dot, qsq), xsq) : dot;
}

struct Args {
  const float* q;
  const float* qsq;
  const float* x;
  const float* xsq;
  const unsigned char* valid;
  int B;
  long long N;
  int d, k, l2, buf, splits;
  long long rows_per_split;
  float* pv;
  int* pi;
  float* ov;
  int* oi;
  void* gbuf;  // (blocks, 128, buf) entries of scratch for the wide wgmma arm
  cudaStream_t s;
};

// ------------------------------------------------------------- stream

constexpr int kStreamRows = 4;     // rows a warp owns at a time
constexpr int kStreamChunk = 256;  // rows of a block between two barriers

template <bool BF16, int NQ, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
scan_topk_stream_kernel(const float* __restrict__ q,
                        const float* __restrict__ qsq,
                        const float* __restrict__ x,
                        const float* __restrict__ xsq,
                        const unsigned char* __restrict__ valid, int B,
                        long long N, int d, int k, int l2, int BUF,
                        long long rows_per_split, float* __restrict__ pv,
                        int* __restrict__ pi) {
  constexpr int R = kStreamRows;
  static_assert(NQ * R <= 32, "one lane per (query, row) score");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dq = (d + 3) / 4 * 4;  // query pitch, zero padded
  Cand cand;
  cand.buf = reinterpret_cast<Entry*>(smem);                  // [NQ][BUF]
  float* qs = reinterpret_cast<float*>(cand.buf + NQ * BUF);  // [NQ][dq]
  cand.cnt = reinterpret_cast<int*>(qs + NQ * dq);
  cand.thv = reinterpret_cast<float*>(cand.cnt + NQ);
  cand.thi = reinterpret_cast<int*>(cand.thv + NQ);
  cand.BUF = BUF;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.y * NQ;
  const long long r_begin = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  for (int e = tid; e < NQ * dq; e += kThreads) {
    const int qq = e / dq, c = e % dq;
    float v = 0.0f;
    if (q0 + qq < B && c < d) v = q[static_cast<long long>(q0 + qq) * d + c];
    qs[e] = BF16 ? round_bf16(v) : v;
  }
  cand.init(NQ, tid);
  __syncthreads();

  for (long long c0 = r_begin; c0 < r_end; c0 += kStreamChunk) {
    for (int it = 0; it < kStreamChunk / (kWarps * R); ++it) {
      const long long row0 = c0 + (it * kWarps + warp) * R;
      if (row0 >= r_end) break;  // the whole warp
      const float* xr[R];
#pragma unroll
      for (int j = 0; j < R; ++j) xr[j] = x + min(row0 + j, r_end - 1) * d;
      float acc[NQ][R];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
      if (VEC == 4) {
        // two column groups per turn: 2 * R 16-byte loads in flight
        for (int c = lane * 4; c < d; c += 256) {
          float4 xv[2][R];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < R; ++j)
              xv[u][j] = c + u * 128 < d
                             ? __ldg(reinterpret_cast<const float4*>(xr[j] + c + u * 128))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (c + u * 128 >= d) continue;
#pragma unroll
            for (int j = 0; j < R; ++j)
              if (BF16)
                xv[u][j] = make_float4(round_bf16(xv[u][j].x), round_bf16(xv[u][j].y),
                                       round_bf16(xv[u][j].z), round_bf16(xv[u][j].w));
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qs + i * dq + c + u * 128);
#pragma unroll
              for (int j = 0; j < R; ++j) {
                acc[i][j] = fmaf(qv.x, xv[u][j].x, acc[i][j]);
                acc[i][j] = fmaf(qv.y, xv[u][j].y, acc[i][j]);
                acc[i][j] = fmaf(qv.z, xv[u][j].z, acc[i][j]);
                acc[i][j] = fmaf(qv.w, xv[u][j].w, acc[i][j]);
              }
            }
          }
        }
      } else {
        for (int c = lane; c < d; c += 128) {
          float xv[4][R];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < R; ++j)
              xv[u][j] = c + u * 32 < d ? __ldg(xr[j] + c + u * 32) : 0.0f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (c + u * 32 >= d) continue;
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              const float qv = qs[i * dq + c + u * 32];
#pragma unroll
              for (int j = 0; j < R; ++j)
                acc[i][j] = fmaf(qv, BF16 ? round_bf16(xv[u][j]) : xv[u][j], acc[i][j]);
            }
          }
        }
      }
      float mine = 0.0f;  // lane i * R + j keeps the dot of (query i, row j)
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float s = acc[i][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == i * R + j) mine = s;
        }
      if (lane < NQ * R) {
        const int qq = lane / R;
        const int b = q0 + qq;
        const long long row = row0 + lane % R;
        if (b < B && row < r_end && (valid == nullptr || valid[row]))
          cand.offer(qq, score(mine, l2, l2 ? qsq[b] : 0.0f, l2 ? xsq[row] : 0.0f),
                     static_cast<int>(row));
      }
    }
    __syncthreads();
    // a buffer that could not take another chunk: the block sorts it
    for (int qq = 0; qq < NQ; ++qq) {
      const int c = cand.cnt[qq];
      if (c > BUF - kStreamChunk) {  // the same for every thread
        Entry* bb = cand.buf + qq * BUF;
        block_sort(bb, c, tid);
        if (tid == 0) {
          cand.cnt[qq] = k;
          cand.thv[qq] = bb[k - 1].v;
          cand.thi[qq] = bb[k - 1].i;
        }
      }
    }
    __syncthreads();
  }
  for (int qq = 0; qq < NQ; ++qq) {
    const int b = q0 + qq;
    if (b >= B) break;
    Entry* bb = cand.buf + qq * BUF;
    const int c = cand.cnt[qq];
    block_sort(bb, c, tid);
    const long long base = (static_cast<long long>(blockIdx.x) * B + b) * k;
    for (int t = tid; t < k; t += kThreads) {
      const Entry e = t < c ? bb[t] : Entry{kNeg, -1};
      pv[base + t] = e.v;
      pi[base + t] = e.i;
    }
  }
}

size_t stream_smem(int nq, int buf, int d) {
  return static_cast<size_t>(nq) * buf * sizeof(Entry) +
         static_cast<size_t>(nq) * ((d + 3) / 4 * 4) * sizeof(float) +
         static_cast<size_t>(nq) * 3 * sizeof(int);
}

template <bool BF16, int NQ, int VEC>
int launch_stream(const Args& a) {
  const size_t smem = stream_smem(NQ, a.buf, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_stream_kernel<BF16, NQ, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.splits, (a.B + NQ - 1) / NQ);
  scan_topk_stream_kernel<BF16, NQ, VEC><<<grid, kThreads, smem, a.s>>>(
      a.q, a.qsq, a.x, a.xsq, a.valid, a.B, a.N, a.d, a.k, a.l2, a.buf,
      a.rows_per_split, a.pv, a.pi);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- tiled

constexpr int kTileQ = 128;     // queries per block
constexpr int kTileR = 128;     // rows per tile
constexpr int kTileK = 16;      // depth per step
constexpr int kTilePitch = 20;  // f32 row pitch of a stage (80 bytes)
constexpr int kTileStages = 3;
constexpr int kTileStage = (kTileQ + kTileR) * kTilePitch;  // floats
constexpr int kTileChunk = 16;  // rows offered between two compactions

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
scan_topk_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ qsq,
                       const float* __restrict__ x,
                       const float* __restrict__ xsq,
                       const unsigned char* __restrict__ valid, int B,
                       long long N, int d, int k, int l2, int BUF,
                       long long rows_per_split, float* __restrict__ pv,
                       int* __restrict__ pi) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [stages][q rows | x rows][pitch]
  Cand cand;
  cand.buf = reinterpret_cast<Entry*>(ring + kTileStages * kTileStage);
  cand.cnt = reinterpret_cast<int*>(cand.buf + kTileQ * BUF);
  cand.thv = reinterpret_cast<float*>(cand.cnt + kTileQ);
  cand.thi = reinterpret_cast<int*>(cand.thv + kTileQ);
  cand.BUF = BUF;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;  // queries ty + 16 i, rows tx + 16 j
  const int q0 = blockIdx.x * kTileQ;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  const int nk = (d + kTileK - 1) / kTileK;
  const long long tiles = (r_end - r_begin + kTileR - 1) / kTileR;
  const long long steps = tiles * nk;
  cand.init(kTileQ, tid);
  float qsq_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = q0 + ty + 16 * i;
    qsq_r[i] = (l2 && b < B) ? qsq[b] : 0.0f;
  }

  // step t stages columns [16 ks, 16 ks + 16) of tile t / nk: 1024
  // 16-byte pieces, four a thread
  auto load = [&](long long t) {
    float* stage = ring + (t % kTileStages) * kTileStage;
    const long long r0 = r_begin + (t / nk) * kTileR;
    const int k0 = static_cast<int>(t % nk) * kTileK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int piece = tid + kThreads * u;
      const int rr = piece / 4, col = k0 + (piece % 4) * 4;
      const float* src = q;
      bool full = col < d;
      if (rr < kTileQ) {
        full = full && q0 + rr < B;
        if (full) src = q + static_cast<long long>(q0 + rr) * d + col;
      } else {
        const long long row = r0 + rr - kTileQ;
        full = full && row < r_end;
        if (full) src = x + row * d + col;
      }
      cp_async16(stage + rr * kTilePitch + (piece % 4) * 4, src, full);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (steps > 1) load(1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (long long t = 0; t < steps; ++t) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // step t has landed; step t - 1's stage is free
    if (t + 2 < steps) load(t + 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* qs = ring + (t % kTileStages) * kTileStage;
    const float* xs = qs + kTileQ * kTilePitch;
#pragma unroll
    for (int c = 0; c < kTileK; c += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kTilePitch + c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(xs + (tx + 16 * j) * kTilePitch + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    if (t % nk != nk - 1) continue;
    // the tile is complete: offer it 16 rows a query at a time
    const long long r0 = r_begin + (t / nk) * kTileR;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = r0 + tx + 16 * j;
      if (row < r_end && (valid == nullptr || valid[row])) {
        const float xs_ = l2 ? xsq[row] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (q0 + ty + 16 * i < B)
            cand.offer(ty + 16 * i, score(acc[i][j], l2, qsq_r[i], xs_),
                       static_cast<int>(row));
      }
      __syncthreads();
      cand.compact(kTileQ, k, kTileChunk, warp, lane);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  __syncthreads();
  cand.write(kTileQ, q0, B, k, blockIdx.y, pv, pi, warp, lane);
}

size_t tiled_smem(int buf) {
  return static_cast<size_t>(kTileStages) * kTileStage * sizeof(float) +
         static_cast<size_t>(kTileQ) * buf * sizeof(Entry) +
         static_cast<size_t>(kTileQ) * 3 * sizeof(int);
}

int launch_tiled(const Args& a) {
  const size_t smem = tiled_smem(a.buf);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + kTileQ - 1) / kTileQ, a.splits);
  scan_topk_tiled_kernel<<<grid, kThreads, smem, a.s>>>(
      a.q, a.qsq, a.x, a.xsq, a.valid, a.B, a.N, a.d, a.k, a.l2, a.buf,
      a.rows_per_split, a.pv, a.pi);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- wgmma

constexpr int kMmaR = 128;   // rows per tile: 64 (wgmma's M) per warpgroup
constexpr int kMmaK = 64;    // depth per step: one 128-byte swizzle row of Q
constexpr int kMmaChunk = 64;  // rows offered to a query between two compactions

// Shared-memory matrix descriptor of the B operand: K-major, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the leading offset is unused
// in this mode).
__device__ __forceinline__ uint64_t mma_desc(const void* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 64, f32) = A (64 x 16 bf16, registers) * B (16 x 64 bf16,
// shared memory) [+ D]
__device__ __forceinline__ void wgmma_m64n64k16(float (&c)[32], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) = A (64 x 16 bf16, registers) * B (16 x 128 bf16,
// shared memory) [+ D]
__device__ __forceinline__ void wgmma_m64n128k16(float (&c)[64], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_issue(float (&c)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  wgmma_m64n64k16(c, a, db, accumulate);
}
__device__ __forceinline__ void wgmma_issue(float (&c)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  wgmma_m64n128k16(c, a, db, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Within 16 columns, wgmma's A fragment gives the thread with
// c = lane % 4 the k slots 2c, 2c + 1, 2c + 8 and 2c + 9.  A dot product
// does not care in which order its terms are paired, so the kernel
// lets slot t hold column kperm(t): the thread's four slots are then
// four neighbouring columns, 4c .. 4c + 3, one 16-byte load of the
// corpus row.  The queries are laid out in the same order.
__device__ __forceinline__ int kperm(int t) {
  return 4 * ((t % 8) / 2) + (t % 2) + 2 * (t / 8);
}

// QT = 64 or 128 queries a block, rounded to bf16 once into shared
// memory (wgmma's B operand).  Both warpgroups take all of them:
// warpgroup wg multiplies rows [64 wg, 64 wg + 64) of each 128-row
// tile, warp w4 of it rows 16 w4 .. 16 w4 + 15, which its lanes read as
// f32 straight into the registers of the A operand and round there, so
// the corpus never passes through shared memory and the row loop has no
// block barrier; the barriers are the epilogue's, once a tile.  With
// 128 queries the store is passed over half as often; they fill the
// shared memory, and the candidate buffers (written rarely once the
// thresholds have risen) sit in device memory, `gbuf`.
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
scan_topk_wgmma_kernel(const float* __restrict__ q,
                       const float* __restrict__ qsq,
                       const float* __restrict__ x,
                       const float* __restrict__ xsq,
                       const unsigned char* __restrict__ valid, int B,
                       long long N, int d, int k, int l2, int BUF,
                       long long rows_per_split, float* __restrict__ pv,
                       int* __restrict__ pi, Entry* __restrict__ gbuf) {
  constexpr bool WIDE = QT == 128;
  // the swizzle pattern repeats every 1024 bytes
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  const int nkb = (d + kMmaK - 1) / kMmaK;
  unsigned char* qb = smem_mma;  // [nkb][QT queries][128 bytes]
  int* words = reinterpret_cast<int*>(qb + static_cast<size_t>(nkb) * QT * 128);
  Cand cand;
  cand.cnt = words;
  cand.thv = reinterpret_cast<float*>(words + QT);
  cand.thi = words + 2 * QT;
  float* qsq_s = reinterpret_cast<float*>(words + 3 * QT);
  cand.buf = WIDE ? gbuf + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                               QT * BUF
                  : reinterpret_cast<Entry*>(words + 4 * QT);
  cand.BUF = BUF;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4;
  const int q0 = blockIdx.x * QT;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  const long long tiles = (r_end - r_begin + kMmaR - 1) / kMmaR;
  // steps go in pairs (two sets of registers): a tile takes an even
  // number of them, the last one empty where nkb is odd
  const int nkbp = (nkb + 1) / 2 * 2;
  const long long steps = tiles * nkbp;

  // 16-byte piece g of query qq in column block kb (slots 8 g .. 8 g + 7
  // of its 64) sits at piece g ^ (qq % 8) of the query's 128-byte row
  for (int e = tid; e < nkb * QT * 8; e += kThreads) {
    const int g = e % 8, qq = (e / 8) % QT, kb = e / (8 * QT);
    const int b = q0 + qq;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = kb * kMmaK + 16 * (g / 2) + kperm(8 * (g % 2) + c);
      v[c] = (b < B && col < d) ? q[static_cast<long long>(b) * d + col] : 0.0f;
    }
    *reinterpret_cast<uint4*>(qb + (static_cast<size_t>(kb) * QT + qq) * 128 +
                              ((g ^ (qq & 7)) * 16)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  for (int t = tid; t < QT; t += kThreads)
    qsq_s[t] = (l2 && q0 + t < B) ? qsq[q0 + t] : 0.0f;
  cand.init(QT, tid);
  // the queries were written through the generic proxy; wgmma reads
  // them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Step t takes columns [64 kb, 64 kb + 64) of tile t / nkbp, kb =
  // t % nkbp (nothing where kb = nkb).  A thread reads, of its rows
  // lane / 4 and lane / 4 + 8 of the warp's 16, columns 16 i + 4 c .. + 3
  // for i < 4: eight 16-byte loads, the four lanes of a row on 64
  // neighbouring bytes.
  using Regs = float4[2][4];
  const int row_in_tile = wg * 64 + w4 * 16 + lane / 4;
  auto fetch = [&](long long t, Regs& xr) {
    const long long r0 = r_begin + (t / nkbp) * kMmaR + row_in_tile;
    const int k0 = static_cast<int>(t % nkbp) * kMmaK + 4 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long row = r0 + 8 * e;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[e][i] = (t < steps && row < r_end && k0 + 16 * i < d)
                       ? __ldg(reinterpret_cast<const float4*>(x + row * d + k0 + 16 * i))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  // rounds a step's values to bf16 into the A fragments of its four
  // 16-column multiplies
  using Frag = uint32_t[4][4];
  auto round_to = [&](Frag& a, const Regs& xr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i][0] = pack_bf16(xr[0][i].x, xr[0][i].y);
      a[i][1] = pack_bf16(xr[1][i].x, xr[1][i].y);
      a[i][2] = pack_bf16(xr[0][i].z, xr[0][i].w);
      a[i][3] = pack_bf16(xr[1][i].z, xr[1][i].w);
    }
  };
  // (the empty asm statements keep a register the compiler's: wgmma
  // reads its A fragments and writes its accumulators after the
  // instruction that names them has been issued)
  auto hold = [](Frag& a) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  };

  float acc[QT / 2];
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) acc[i] = 0.0f;
  // Step t rounds its values (fetched two steps earlier) into one of
  // two sets of fragments, asks for the values of step t + 2 into the
  // registers they left, starts its wgmma and waits only for that of
  // step t - 1, whose fragments the next step overwrites.  Nothing but
  // wgmma names the accumulators inside the loop over a tile's steps,
  // so that ptxas lets a multiply run on across the loop's edge.
  auto step = [&](long long t, int kb, Regs& xr, Frag& a, Frag& before) {
    round_to(a, xr);
    fetch(t + 2, xr);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // an empty step multiplies zeros by the last column block
    const unsigned char* b0 = qb + static_cast<size_t>(min(kb, nkb - 1)) * QT * 128;
#pragma unroll
    for (int ks = 0; ks < kMmaK / 16; ++ks)
      wgmma_issue(acc, a[ks], mma_desc(b0 + ks * 32), (kb | ks) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    hold(before);  // step t - 1 has read its fragments
  };

  Regs xr0, xr1;
  Frag a0 = {}, a1 = {};
  fetch(0, xr0);
  fetch(1, xr1);
  long long t = 0;
  for (long long tile = 0; tile < tiles; ++tile) {
    for (int kb = 0; kb < nkbp; kb += 2, t += 2) {
      step(t, kb, xr0, a0, a1);
      step(t + 1, kb + 1, xr1, a1, a0);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(a0);
    hold(a1);
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    // the tile is complete: acc[4 jb + 2 h + e] is row lane / 4 + 8 h of
    // the warp's 16, query 8 jb + 2 (lane % 4) + e
    const long long r0 = r_begin + tile * kMmaR + row_in_tile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + 8 * h;
      if (row < r_end && (valid == nullptr || valid[row])) {
        const float xs_ = l2 ? xsq[row] : 0.0f;
#pragma unroll
        for (int jb = 0; jb < QT / 8; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qq = 8 * jb + 2 * (lane % 4) + e;
            if (q0 + qq < B)
              cand.offer(qq, score(acc[4 * jb + 2 * h + e], l2, qsq_s[qq], xs_),
                         static_cast<int>(row));
          }
      }
      __syncthreads();
      cand.compact(QT, k, kMmaChunk, warp, lane);
      __syncthreads();
    }
  }
  __syncthreads();
  cand.write(QT, q0, B, k, blockIdx.y, pv, pi, warp, lane);
}

size_t wgmma_smem(int qt, int buf, int d) {
  const int nkb = (d + kMmaK - 1) / kMmaK;
  return static_cast<size_t>(nkb) * qt * 128 + static_cast<size_t>(qt) * 4 * sizeof(int) +
         (qt == 64 ? static_cast<size_t>(qt) * buf * sizeof(Entry) : 0);
}

template <int QT>
int launch_wgmma(const Args& a) {
  if (QT == 128 && a.gbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wgmma_smem(QT, a.buf, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_wgmma_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + QT - 1) / QT, a.splits);
  scan_topk_wgmma_kernel<QT><<<grid, kThreads, smem, a.s>>>(
      a.q, a.qsq, a.x, a.xsq, a.valid, a.B, a.N, a.d, a.k, a.l2, a.buf,
      a.rows_per_split, a.pv, a.pi, static_cast<Entry*>(a.gbuf));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ general

constexpr int kRows = 64;           // corpus rows per chunk
constexpr int kDepth = 32;          // columns staged per step
constexpr int kPitch = kDepth + 4;  // f32 row pitch of the staged tiles

template <bool BF16, int QT>
__global__ void __launch_bounds__(kThreads)
scan_topk_general_kernel(const float* __restrict__ q,
                         const float* __restrict__ qsq,
                         const float* __restrict__ x,
                         const float* __restrict__ xsq,
                         const unsigned char* __restrict__ valid, int B,
                         long long N, int d, int k, int l2, int BUF,
                         long long rows_per_split, float* __restrict__ pv,
                         int* __restrict__ pi) {
  constexpr int QTH = QT < 16 ? QT : 16;  // threads along queries
  constexpr int RTH = kThreads / QTH;     // threads along rows
  constexpr int TQ = QT / QTH;            // queries per thread (contiguous)
  constexpr int TR = kRows / RTH;         // rows per thread (stride RTH)
  extern __shared__ __align__(16) unsigned char smem[];
  Cand cand;
  cand.buf = reinterpret_cast<Entry*>(smem);                   // [QT][BUF]
  float* qs = reinterpret_cast<float*>(cand.buf + QT * BUF);   // [QT][kPitch]
  float* xs = qs + QT * kPitch;                                // [kRows][kPitch]
  cand.cnt = reinterpret_cast<int*>(xs + kRows * kPitch);
  cand.thv = reinterpret_cast<float*>(cand.cnt + QT);
  cand.thi = reinterpret_cast<int*>(cand.thv + QT);
  cand.BUF = BUF;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tq = tid / RTH, tr = tid % RTH;
  const int q0 = blockIdx.x * QT;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  cand.init(QT, tid);

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
        qs[qq * kPitch + c] = BF16 ? round_bf16(v) : v;
      }
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int rr = e / kDepth, c = e % kDepth;
        const long long row = r0 + rr;
        float v = 0.0f;
        if (row < r_end && k0 + c < d) v = x[row * d + k0 + c];
        xs[rr * kPitch + c] = BF16 ? round_bf16(v) : v;
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
        if (b < B && row < r_end && (valid == nullptr || valid[row]))
          cand.offer(qq, score(acc[i][j], l2, l2 ? qsq[b] : 0.0f, l2 ? xsq[row] : 0.0f),
                     static_cast<int>(row));
      }
    }
    __syncthreads();
    cand.compact(QT, k, kRows, warp, lane);
  }
  __syncthreads();
  cand.write(QT, q0, B, k, blockIdx.y, pv, pi, warp, lane);
}

template <bool BF16, int QT>
int launch_general(const Args& a) {
  const size_t smem = static_cast<size_t>(QT) * a.buf * sizeof(Entry) +
                      static_cast<size_t>(QT + kRows) * kPitch * sizeof(float) +
                      static_cast<size_t>(QT) * 3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_general_kernel<BF16, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + QT - 1) / QT, a.splits);
  scan_topk_general_kernel<BF16, QT><<<grid, kThreads, smem, a.s>>>(
      a.q, a.qsq, a.x, a.xsq, a.valid, a.B, a.N, a.d, a.k, a.l2, a.buf,
      a.rows_per_split, a.pv, a.pi);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- merge

// One block per query.  The splits' lists are sorted, so the block
// reads them level by level: the best entry of every list, then the
// second best, and so on.  What beats the threshold goes to the buffer,
// which the block sorts and cuts to k once it holds 2 k entries (the
// threshold is then close to final after a level or two) and whenever
// it could not take another batch.  A level of which no entry passes
// ends the merge: every deeper entry is worse than one that failed.
__global__ void __launch_bounds__(kThreads)
scan_topk_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                       int splits, int B, int k, float* __restrict__ ov,
                       int* __restrict__ oi) {
  constexpr int PER = kMergeBatch / kThreads;
  __shared__ Entry buf[kMergeBuf];
  __shared__ int cnt;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  float tv = kNeg;
  int ti = -1;
  bool tight = false;  // the threshold is the k-th best so far
  if (tid == 0) cnt = 0;
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    int level = 0;
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      float v[PER];
      int i[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int s = s0 + u * kThreads + tid;
        v[u] = kNeg;
        i[u] = -1;
        if (s < splits) {
          const long long at = (static_cast<long long>(s) * B + b) * k + t;
          v[u] = pv[at];
          i[u] = pi[at];
        }
      }
      int passed = 0;
#pragma unroll
      for (int u = 0; u < PER; ++u)
        if (i[u] >= 0 && better(v[u], i[u], tv, ti)) {
          buf[atomicAdd(&cnt, 1)] = Entry{v[u], i[u]};
          passed = 1;
        }
      level |= __syncthreads_or(passed);
      const int c = cnt;  // the same for every thread
      if (c > kMergeBuf - kMergeBatch || (!tight && c >= 2 * k)) {
        block_sort(buf, c, tid);
        tv = buf[k - 1].v;
        ti = buf[k - 1].i;
        tight = true;
        if (tid == 0) cnt = k;
      }
      __syncthreads();
    }
    if (!level) break;
  }
  const int c = cnt;
  block_sort(buf, c, tid);
  for (int t = tid; t < k; t += kThreads) {
    const Entry e = t < min(c, k) ? buf[t] : Entry{kNeg, -1};
    ov[static_cast<long long>(b) * k + t] = e.v;
    oi[static_cast<long long>(b) * k + t] = e.i;
  }
}

enum Arm { kGeneral = 0, kStream = 1, kTiled = 2, kWgmma = 3 };

template <bool BF16>
int dispatch(const Args& a, int arm, int qt, int vec) {
  if (arm == kStream && qt == 1 && vec == 4) return launch_stream<BF16, 1, 4>(a);
  if (arm == kStream && qt == 1 && vec == 1) return launch_stream<BF16, 1, 1>(a);
  if (arm == kStream && qt == 8 && vec == 4) return launch_stream<BF16, 8, 4>(a);
  if (arm == kStream && qt == 8 && vec == 1) return launch_stream<BF16, 8, 1>(a);
  if (arm == kGeneral && qt == 8) return launch_general<BF16, 8>(a);
  if (arm == kGeneral && qt == 16) return launch_general<BF16, 16>(a);
  if (arm == kGeneral && qt == 64) return launch_general<BF16, 64>(a);
  static_assert(kTileQ == 128, "the tile the wrapper names");
  if (arm == kTiled && qt == 128 && vec == 4 && !BF16) return launch_tiled(a);
  if (arm == kWgmma && qt == 64 && vec == 4 && BF16) return launch_wgmma<64>(a);
  if (arm == kWgmma && qt == 128 && vec == 4 && BF16) return launch_wgmma<128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, d) f32, qsq (B,) f32, x (N, d) f32, xsq (N,) f32, valid (N,)
// bool or null.  (arm, qt, vec) names an instance above: arm 0 general
// (qt 8, 16 or 64; k + 64 <= buf), 1 stream (qt 1 or 8; vec 4 when
// d % 4 == 0 and q, x are 16-byte aligned, else 1; k + 256 <= buf),
// 2 tiled (f32; qt 128, vec 4; k + 16 <= buf), 3 wgmma (bf16; vec 4; qt
// 64 or 128, k + 64 <= buf; qt 128 needs gbuf, scratch
// of splits * ceil(B / 128) * 128 * buf entries of 8 bytes); buf a
// power of two.  The rows split into `splits` ranges of rows_per_split;
// pv, pi (splits, B, k) scratch; ov, oi (B, k) outputs.
extern "C" int qrag_scan_topk(const void* q, const void* qsq, const void* x,
                              const void* xsq, const void* valid, int B,
                              long long N, int d, int k, int l2, int bf16,
                              int arm, int qt, int vec, int buf, int splits,
                              long long rows_per_split, void* pv, void* pi,
                              void* ov, void* oi, void* gbuf, void* stream) {
  const int chunk = arm == kStream ? kStreamChunk
                    : arm == kTiled ? kTileChunk
                    : arm == kWgmma ? kMmaChunk
                                    : kRows;
  const bool aligned =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  if (B < 1 || N < 1 || N > INT_MAX || d < 1 || k < 1 || k > N ||
      k > kMergeBuf - kMergeBatch || buf < 2 || (buf & (buf - 1)) != 0 ||
      k + chunk > buf || splits < 1 || rows_per_split < 1 ||
      rows_per_split * splits < N || (vec != 1 && vec != 4) ||
      (vec == 4 && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(qsq),
               static_cast<const float*>(x), static_cast<const float*>(xsq),
               static_cast<const unsigned char*>(valid), B, N, d, k, l2, buf,
               splits, rows_per_split, static_cast<float*>(pv),
               static_cast<int*>(pi), static_cast<float*>(ov),
               static_cast<int*>(oi), gbuf, static_cast<cudaStream_t>(stream)};
  const int err = bf16 ? dispatch<true>(a, arm, qt, vec) : dispatch<false>(a, arm, qt, vec);
  if (err != 0) return err;
  scan_topk_merge_kernel<<<B, kThreads, 0, a.s>>>(a.pv, a.pi, splits, B, k, a.ov, a.oi);
  return static_cast<int>(cudaGetLastError());
}
