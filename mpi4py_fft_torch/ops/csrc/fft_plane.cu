// fft_plane_p (H) and fft_plane_large_p (I): unnormalized planar c2c FFT
// over the last two axes of (2, P, N1, N2) float32 data, N1 and N2 powers
// of two up to 1024, either sign, with an optional scale folded into the
// last write.  The last axis (N2) is transformed first, then the
// second-to-last (N1), as the JAX kernels order the two stages.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_plane_p :1056 through _dispatch_plane :1018
// (_kern_plane :981, planes of N1, N2 <= 256 packed T to a block) and from
// fft_plane_large_p :1167 through _dispatch_plane_large :1139
// (_kern_plane_large :1095, one full plane of N1*N2 <= 2^20 a block).
// Both entries compute the same function; the kernels are chosen by
// shape: planes whose axes are both at most 256 (every plane H's gate
// takes) go to the plane-holding kernel in one launch, every other plane
// (I's larger planes) to the row line kernel and then the column band
// kernel, two launches of one C entry.
//
// Bound on an H100: bytes, as fft_axis.cu (about 3 flops a byte a pass):
// the least the card can take is one read and one write of the volume.
//
// The plane-holding kernel (mff_fft_plane_f32, N1, N2 <= 256): each plane
// goes from device memory to shared memory once and back once, as the TPU
// kernel keeps T planes in one block's VMEM.  A CTA (512 threads, two an
// SM, 64 registers a thread) holds kHoldElems = 8192 points of each plane
// component.  A plane of at most that many points is held whole by one
// CTA, T = 8192 / (N1 N2) planes a CTA, both axes in shared memory.  A
// larger plane (up to 256 x 256, 2^16 points) is held by a cluster of
// K = N1 N2 / 8192 CTAs (2, 4 or 8; Hopper thread-block clusters,
// distributed shared memory): CTA j holds rows j R .. (j+1) R - 1
// (R = N1 / K), loads them, transforms them along the last axis, and the
// second-to-last axis is split as G splits its axis (fft_axis2.cu): after
// a cluster barrier, one radix-K decimation-in-frequency step across the
// cluster, each thread taking some points (n, c) of the R x N2 block: it
// reads x_j[n, c] from every CTA j, forms y_k = sum_j x_j W_K^(jk)
// W_N1^(nk), and writes y_k to CTA k's point (n, c), a place no other
// thread of the cluster touches, so no staging buffer is needed; a second
// cluster barrier publishes them.  Each CTA then runs the R-point
// transforms of its columns: CTA k holds output rows k + K m, which it
// writes as whole rows with the scale folded in.
//
// Both axes run in place on the same array: rows of N2 points (point p
// at p + p/16, a gap after every 16), an odd number of floats apart, so
// that a warp's 32 lines fall on 32 banks whether the lines are rows or
// columns.  Each axis is a chain of in-place decimation-in-frequency
// stages of radix 8 (then 4 or 2): a butterfly reads its 8 points,
// transforms and twiddles them and writes them back to the same places,
// so a thread holds one butterfly at a time (the stages of butterfly.cuh
// hold 16 points a thread across a barrier, and spill), and the block
// synchronises once a stage.  The twiddles are powers of w_N, from a table
// of N entries an axis (the column pass reads every K-th of N1's).  The
// stages leave frequency f at a digit-reversed place, which the store
// reads from.  Loads and stores move 16-byte
// vectors, every load of a thread issued before its first store to
// shared memory; a warp takes 8 vectors of each of 4 rows.
//
// I's larger planes (mff_fft_plane_large_f32, an axis above 256).  A
// 1024 x 1024 plane (8 MB) does not fit a CTA's shared memory (227 KB)
// nor a cluster's, so here it crosses device memory twice each way: two
// reads and two writes of the volume take at least 10.26 ms at (2, 1024,
// 1024, 1024), twice the function's bound.  The queue kernel that this design
// replaces ran both axes on A's tile (butterfly.cuh), whose stages held
// 16 points a thread at 40 registers and spilled 1936 B a thread, and
// moved one 4-byte float a thread a load: its stages took more than half
// its time, its column items read 32-byte row segments, and its L2
// hand-off between the axes cost more in waits than it saved.
// * The row line kernel (x -> y): a group of G = N2 / P threads holds one
//   row, P = 32 points a thread (the whole row below 32 points), in
//   registers.  Each thread loads 16-byte vectors of 4 adjacent points of
//   each component, every load before any arithmetic; the row runs as
//   Stockham stages (radix 8, then 16 while it divides, then the rest:
//   8 x 16 x 8 at 1024 points), each stage's
//   butterflies in registers and the exchange through the group's own
//   buffer in shared memory behind __syncwarp, with no block-wide
//   barrier; the store reads the row from the buffer in its natural order
//   as 16-byte vectors.  128 threads a block, four blocks an SM.
// * The column band kernel (in place on y): a CTA of 512 threads, two an
//   SM, holds 8192 points of each component, loaded as 16-byte vectors of
//   4 adjacent columns (single floats for two-column planes), every load
//   before the first store to shared memory: C adjacent columns of a plane
//   by its N1 rows (C = 16 at N1 = 512), or several whole planes when a
//   plane is smaller.  At N1 = 1024 a band of 16 columns (64-byte row
//   segments) is held by a cluster of two CTAs, 512 rows each, with one
//   radix-2 step across the cluster as the plane-holding kernel's
//   (below); 8 columns on one CTA ran 3.5% slower on an H100, 32 on a
//   cluster of four 6% slower, and a queue of row and band items with an
//   L2 hand-off between them 20% slower than two launches.  The columns
//   run as the plane-holding kernel's in-place radix-8
//   decimation-in-frequency stages, one butterfly a thread at a time, and
//   the store writes whole row segments from the digit-reversed places
//   with the scale folded in.
// Neither kernel holds more than one stage's butterflies a thread, so
// neither spills.  The in-place stages, the cluster step and the row
// stages are lines.cuh's, shared with D's and A64's line and band kernels.
#include <algorithm>
#include <cstdint>

#include "lines.cuh"

namespace {

using mff::at;
using mff::Block;
using mff::cluster_rank;
using mff::cluster_sync;
using mff::cluster_dif_step;
using mff::dif_pass;
using mff::Powers;
using mff::dif_pos;
using mff::log2_of;
using mff::pad;
using mff::row_stride;

// ---------------------------------------------------------------------------
// the plane-holding kernel (N1, N2 <= 256)
// ---------------------------------------------------------------------------

// Points of each plane component a CTA holds, its threads and its launch
// bound.
constexpr int kHoldElems = 8192;
constexpr int kHoldThreads = 512;
constexpr int kHoldMinBlocks = 2;

// The float4 chunk (of 4 points) that the block's chunk f stands for: a
// warp's 32 chunks are 8 adjacent chunks of each of 4 rows when a row has
// at least 8 (2^lq chunks a row) and the block at least 4 rows, else the
// chunks in order.
__device__ __forceinline__ int chunk_of(int f, int lq, int lines) {
  if (lq < 3 || lines < 4) return f;
  const int g = f >> 5, l = f & 31;
  const int qb = g & ((1 << (lq - 3)) - 1), rb = g >> (lq - 3);
  return ((rb * 4 + (l >> 3)) << lq) + qb * 8 + (l & 7);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// K = 2^lk CTAs a plane (a cluster when K > 1; then T = 1), R = 2^lr
// rows of n2 = 2^l2 points and T = 2^lt planes a CTA, T R n2 =
// kHoldElems.  tw2, tw1: the (2, n2) and (2, n1) tables of
// _tw_pack_powers(n2, sign) and (n1, sign), for the row pass, and for
// the cross step and the column pass.
template <int K>
__global__ void __launch_bounds__(kHoldThreads, kHoldMinBlocks)
fft_plane_hold_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ tw2,
                      const float* __restrict__ tw1, long long P, int n1,
                      int n2, int lt, int lr, int l2, float sign,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 1 << lr;
  const int lines = R << lt;            // rows a CTA
  const int rs = row_stride(n2);
  Block<float> blk{reinterpret_cast<float*>(smem), nullptr, lt, lr, l2, rs};
  blk.im = blk.re + lines * rs;
  const unsigned kk = K > 1 ? cluster_rank() : 0u;
  const long long area = static_cast<long long>(n1) * n2;
  const long long q0 = K > 1 ? static_cast<long long>(blockIdx.x / K)
                             : static_cast<long long>(blockIdx.x) << lt;
  const long long planes = P - q0 < (1LL << lt) ? P - q0 : (1LL << lt);
  const int valid = static_cast<int>(planes) * (R << l2);
  const long long in0 = q0 * area + (static_cast<long long>(kk) * R << l2);
  const long long vol = P * area;       // offset of the imaginary parts
  const int lq = l2 - 2;
  constexpr int kChunks = kHoldElems / 4 / kHoldThreads;

  // rows kk R .. of plane q0 (K > 1), or planes q0 .. q0 + T - 1: every
  // load before the first store
  float4 ar[kChunks], ai[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = 4 * chunk_of(threadIdx.x + i * kHoldThreads, lq, lines);
    ar[i] = ai[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < valid) {
      ar[i] = __ldg(reinterpret_cast<const float4*>(x + in0 + e));
      ai[i] = __ldg(reinterpret_cast<const float4*>(x + vol + in0 + e));
    }
  }
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = 4 * chunk_of(threadIdx.x + i * kHoldThreads, lq, lines);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = at<true>(blk, (e + c) >> l2, (e + c) & (n2 - 1));
      blk.re[s] = comp(ar[i], c);
      blk.im[s] = comp(ai[i], c);
    }
  }
  __syncthreads();

  // the last axis: each row a line
  dif_pass<true>(blk, lr + lt, l2, 0, Powers<float>{tw2, tw2 + (1 << l2)},
                 sign);

  if constexpr (K > 1) {
    // the radix-K step across the cluster, in place: point (n, col) of
    // every CTA's block, by one thread of the cluster
    cluster_sync();
    cluster_dif_step<K, kHoldThreads>(blk, l2, kHoldElems, kk, tw1, tw1 + n1,
                                      sign);
    cluster_sync();
  }

  // the second-to-last axis: each column of each plane a line of R points
  constexpr int lk = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
  dif_pass<false>(blk, l2 + lt, lr, lk,
                  Powers<float>{tw1, tw1 + (1 << (lr + lk))}, sign);

  // output row m of plane t (row kk + K m of the plane in a cluster) from
  // where the stages left it: whole rows, scaled
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = 4 * chunk_of(threadIdx.x + i * kHoldThreads, lq, lines);
    if (e >= valid) continue;
    float o[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int line = (e + c) >> l2;
      const int t = line >> lr;
      const int s = ((t << lr) + dif_pos(line & (R - 1), lr)) * rs +
                    pad(dif_pos((e + c) & (n2 - 1), l2));
      o[0][c] = blk.re[s] * scale;
      o[1][c] = blk.im[s] * scale;
    }
    const int line = e >> l2;
    const long long a =
        q0 * area + kk * static_cast<long long>(n2) +
        ((static_cast<long long>(line >> lr) * n1 +
          static_cast<long long>(K) * (line & (R - 1))) << l2) +
        (e & (n2 - 1));
    *reinterpret_cast<float4*>(y + a) =
        make_float4(o[0][0], o[0][1], o[0][2], o[0][3]);
    *reinterpret_cast<float4*>(y + vol + a) =
        make_float4(o[1][0], o[1][1], o[1][2], o[1][3]);
  }
}

// The launch of the plane-holding kernel for (n1, n2) planes, P of them:
// K, T, R and the config (a cluster dimension when K > 1); false if the
// plane is not one it takes.
struct HoldLaunch {
  void (*kern)(const float*, float*, const float*, const float*,
               long long, int, int, int, int, int, float, float);
  int K, lt, lr, l2;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

inline bool hold_launch(int n1, int n2, long long P, HoldLaunch* L) {
  if (n1 < 2 || n2 < 2 || n1 > 256 || n2 > 256 || (n1 & (n1 - 1)) ||
      (n2 & (n2 - 1)) || P <= 0)
    return false;
  const int area = n1 * n2;
  const int K = area > kHoldElems ? area / kHoldElems : 1;
  const int T = area < kHoldElems ? kHoldElems / area : 1;
  L->K = K;
  L->lt = log2_of(T);
  L->lr = log2_of(n1 / K);
  L->l2 = log2_of(n2);
  const long long grid = K > 1 ? P * K : (P + T - 1) / T;
  if (grid > 0x7fffffffLL) return false;
  switch (K) {
    case 1: L->kern = &fft_plane_hold_kernel<1>; break;
    case 2: L->kern = &fft_plane_hold_kernel<2>; break;
    case 4: L->kern = &fft_plane_hold_kernel<4>; break;
    case 8: L->kern = &fft_plane_hold_kernel<8>; break;
    default: return false;
  }
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3{static_cast<unsigned>(grid), 1u, 1u};
  L->cfg.blockDim = dim3{static_cast<unsigned>(kHoldThreads), 1u, 1u};
  L->cfg.dynamicSmemBytes = 2 * sizeof(float) * static_cast<size_t>(T) *
                            (n1 / K) * row_stride(n2);
  L->attr[0].id = cudaLaunchAttributeClusterDimension;
  L->attr[0].val.clusterDim.x = static_cast<unsigned>(K);
  L->attr[0].val.clusterDim.y = 1;
  L->attr[0].val.clusterDim.z = 1;
  L->cfg.attrs = L->attr;
  L->cfg.numAttrs = K > 1 ? 1 : 0;
  return true;
}

// ---------------------------------------------------------------------------
// I's larger planes (an axis above 256): the row line kernel, then the
// column band kernel
// ---------------------------------------------------------------------------

// The row line kernel: 128 threads a block, four blocks an SM (a thread
// may take 128 registers).
constexpr int kRowThreads = 128;
constexpr int kRowMinBlocks = 4;

// Points a thread of an N-point row holds: 32, or the whole row; the
// group of N / P threads that holds a row lies inside one warp, and runs
// the line stages of lines.cuh (radix 8, then 16 while it divides, then
// the rest: 8 x 16 x 8 at 1024 points).
__host__ __device__ constexpr int row_points(int N) {
  return N >= 32 ? 32 : N;
}

// Rows blk * (blockDim.x / G) .. of the `lines` rows of N points of x
// (planar, imaginary parts vol floats on), transformed into y.
template <int N>
__device__ __forceinline__ void row_block(const float* __restrict__ x,
                                          float* __restrict__ y,
                                          const float* __restrict__ tw,
                                          long long lines, long long vol,
                                          float sign, long long blk) {
  constexpr int P = row_points(N), G = N / P, V = mff::line_vec<float>(N);
  static_assert(G <= 32 && 32 % G == 0, "a group lies inside one warp");
  static_assert(G == 1 || (P / mff::line_radix(N, P, 0)) % V == 0,
                "first-stage butterflies in whole vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  float* br = reinterpret_cast<float*>(smem) + grp * 2 * mff::row_buf(N);
  float* bi = br + mff::row_buf(N);
  const long long line = blk * (blockDim.x / G) + grp;
  const bool live = line < lines;
  const long long a = (live ? line : 0) * N;

  // every load first: points row_own(g, s), V adjacent ones a vector
  float zr[P], zi[P];
#pragma unroll
  for (int s = 0; s < P; s += V) {
    const int p = mff::row_own<V, G>(g, s);
    if constexpr (V == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(x + a + p));
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(x + vol + a + p));
      zr[s] = u.x; zr[s + 1] = u.y; zr[s + 2] = u.z; zr[s + 3] = u.w;
      zi[s] = v.x; zi[s + 1] = v.y; zi[s + 2] = v.z; zi[s + 3] = v.w;
    } else {
      const float2 u = __ldg(reinterpret_cast<const float2*>(x + a + p));
      const float2 v =
          __ldg(reinterpret_cast<const float2*>(x + vol + a + p));
      zr[s] = u.x; zr[s + 1] = u.y;
      zi[s] = v.x; zi[s + 1] = v.y;
    }
  }
  mff::line_stages<float, N, P, 0>(zr, zi, br, bi, g, tw, tw + N, sign);
  if (!live) return;

  // the row in natural order, V adjacent points a vector
#pragma unroll
  for (int i = 0; i < N / V / G; ++i) {
    const int p = V * (g + G * i);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(y + a + p) =
          *reinterpret_cast<const float4*>(br + mff::bpad(p));
      *reinterpret_cast<float4*>(y + vol + a + p) =
          *reinterpret_cast<const float4*>(bi + mff::bpad(p));
    } else {
      *reinterpret_cast<float2*>(y + a + p) =
          *reinterpret_cast<const float2*>(br + p);
      *reinterpret_cast<float2*>(y + vol + a + p) =
          *reinterpret_cast<const float2*>(bi + p);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
fft_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ tw, long long lines,
                long long vol, float sign) {
  row_block<N>(x, y, tw, lines, vol, sign, blockIdx.x);
}

// The column band kernel: a CTA of 512 threads, two an SM (64 registers
// a thread), holds kBandElems points of each component: T = 2^lt planes
// of R = 2^lr rows by C = 2^lc columns (C = n2 when T > 1), the columns
// c0 .. c0 + C - 1 of each row.  A band of kBandCols columns of a plane
// whose rows do not fit one CTA is held by a cluster of K = C n1 /
// kBandElems CTAs, R = n1 / K rows each.
constexpr int kBandElems = mff::BandBudget<float>::kElems;
constexpr int kBandThreads = mff::BandBudget<float>::kThreads;
constexpr int kBandMinBlocks = mff::BandBudget<float>::kMinBlocks;
constexpr int kBandCols = 16;

// The band's shape for (n1, n2) planes: lt, lk (K = 2^lk), lc.
inline void band_shape(int n1, int n2, int* lt, int* lk, int* lc) {
  const int area = n1 * n2;
  const int C = area <= kBandElems ? n2
                : std::min(n2, std::max(kBandCols, kBandElems / n1));
  *lc = log2_of(C);
  *lt = area < kBandElems ? log2_of(kBandElems / area) : 0;
  *lk = C * n1 > kBandElems ? log2_of(C * n1 / kBandElems) : 0;
}

// Band blk / K of y (planar, vol floats apart), transformed along its
// columns in place, the scale folded into the store; this CTA's rows
// kk R .. of it (kk: its rank in the cluster).  kVec: C >= 4, loads and
// stores of 16-byte vectors (else of single floats).  With K > 1 the
// first radix-K step runs across the cluster, as the plane-holding
// kernel's: point (n, col) of every CTA's block by one thread of the
// cluster, y_k = sum_j x_j W_K^(jk) W_n1^(nk) written to CTA k, which
// then holds output rows kk + K m.  tw1: the (2, n1) table of
// _tw_pack_powers(n1, sign).
template <bool kVec, int K>
__device__ __forceinline__ void band_block(float* y,
                                           const float* __restrict__ tw1,
                                           long long P, int n1, int n2,
                                           int lt, int lr, int lc,
                                           float sign, float scale,
                                           long long blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc, R = 1 << lr;
  const int rs = row_stride(C);
  const int lines = R << lt;            // rows held
  Block<float> k{reinterpret_cast<float*>(smem), nullptr, lt, lr, lc, rs};
  k.im = k.re + lines * rs;
  const unsigned kk = K > 1 ? cluster_rank() : 0u;
  const long long bands = n2 >> lc;     // bands a plane (1 when T > 1)
  const long long band = blk / K;
  const long long q0 = (band / bands) << lt;
  const int c0 = static_cast<int>(band % bands) << lc;
  const long long planes = P - q0 < (1LL << lt) ? P - q0 : (1LL << lt);
  const int valid = static_cast<int>(planes) << (lr + lc);
  const long long area = static_cast<long long>(n1) * n2;
  const long long vol = P * area;
  // element e of the block: plane e >> (lr + lc), column c0 + e % C, held
  // row m = (e >> lc) % R, which is row kk R + m of the plane in the load
  // and output row kk + K m in the store
  const auto addr = [&](int e, int row) {
    return (q0 + (e >> (lr + lc))) * area +
           static_cast<long long>(row) * n2 + c0 + (e & (C - 1));
  };
  const auto in_row = [&](int e) {
    return static_cast<int>(kk) * R + ((e >> lc) & (R - 1));
  };
  if constexpr (kVec) {
    // 16-byte vectors of 4 adjacent columns, every load before the first
    // store to shared memory
    constexpr int kChunks = kBandElems / 4 / kBandThreads;
    float4 ar[kChunks], ai[kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = 4 * (static_cast<int>(threadIdx.x) + i * kBandThreads);
      ar[i] = ai[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < valid) {
        const long long a = addr(e, in_row(e));
        ar[i] = __ldcg(reinterpret_cast<const float4*>(y + a));
        ai[i] = __ldcg(reinterpret_cast<const float4*>(y + vol + a));
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = 4 * (static_cast<int>(threadIdx.x) + i * kBandThreads);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = at<true>(k, (e + c) >> lc, (e + c) & (C - 1));
        k.re[s] = comp(ar[i], c);
        k.im[s] = comp(ai[i], c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < (lines << lc); e += blockDim.x) {
      const int s = at<true>(k, e >> lc, e & (C - 1));
      const bool in = e < valid;
      k.re[s] = in ? __ldcg(y + addr(e, in_row(e))) : 0.f;
      k.im[s] = in ? __ldcg(y + vol + addr(e, in_row(e))) : 0.f;
    }
  }

  if constexpr (K > 1) {
    // the radix-K step across the cluster, in place
    cluster_sync();
    cluster_dif_step<K, kBandThreads>(k, lc, kBandElems, kk, tw1, tw1 + n1,
                                      sign);
    cluster_sync();
  } else {
    __syncthreads();
  }

  // each column of each plane (of the CTA's rows) a line of R points
  constexpr int lk = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
  dif_pass<false>(k, lc + lt, lr, lk,
                  Powers<float>{tw1, tw1 + (1 << (lr + lk))}, sign);

  // output row kk + K m of plane t from where the stages left it, scaled
  const auto held = [&](int e) {
    const int line = e >> lc;
    return (((line >> lr) << lr) + dif_pos(line & (R - 1), lr)) * rs +
           pad(e & (C - 1));
  };
  const auto out_row = [&](int e) {
    return static_cast<int>(kk) + K * ((e >> lc) & (R - 1));
  };
  if constexpr (kVec) {
    for (int e = 4 * threadIdx.x; e < valid; e += 4 * kBandThreads) {
      const int s = held(e);
      const long long a = addr(e, out_row(e));
      *reinterpret_cast<float4*>(y + a) =
          make_float4(k.re[s] * scale, k.re[s + 1] * scale,
                      k.re[s + 2] * scale, k.re[s + 3] * scale);
      *reinterpret_cast<float4*>(y + vol + a) =
          make_float4(k.im[s] * scale, k.im[s + 1] * scale,
                      k.im[s + 2] * scale, k.im[s + 3] * scale);
    }
  } else {
    for (int e = threadIdx.x; e < valid; e += blockDim.x) {
      const int s = held(e);
      y[addr(e, out_row(e))] = k.re[s] * scale;
      y[vol + addr(e, out_row(e))] = k.im[s] * scale;
    }
  }
}

template <bool kVec, int K>
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
fft_band_kernel(float* y, const float* __restrict__ tw1, long long P,
                int n1, int n2, int lt, int lr, int lc, float sign,
                float scale) {
  band_block<kVec, K>(y, tw1, P, n1, n2, lt, lr, lc, sign, scale,
                      blockIdx.x);
}

template <int N>
int launch_rows(const float* x, float* y, const float* tw, long long lines,
                long long vol, float sign, cudaStream_t stream) {
  constexpr int G = N / row_points(N);
  const long long blocks = (lines + kRowThreads / G - 1) / (kRowThreads / G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * 2 * mff::row_buf(N) * (kRowThreads / G);
  auto kern = &fft_rows_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), kRowThreads, smem, stream>>>(
      x, y, tw, lines, vol, sign);
  return cudaGetLastError();
}

}  // namespace

// The plane-holding kernel.  x, y: (2, P, n1, n2) float32, contiguous,
// distinct and 16-byte aligned, on the current device, n1, n2 powers of
// two from 2 to 256; K = max(1, n1 n2 / 8192) CTAs a plane.  tw2, tw1:
// the (2, n2) and (2, n1) tables of butterfly._tw_pack_powers(n2, sign)
// and (n1, sign).  Returns the error of a refused launch (a cluster that
// does not fit included), else cudaGetLastError() after the launch.
extern "C" int mff_fft_plane_f32(const float* x, float* y, const float* tw2,
                                 const float* tw1, long long P, int n1,
                                 int n2, int sign, float scale,
                                 void* stream) {
  HoldLaunch L;
  const auto mis = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  if (!hold_launch(n1, n2, P, &L) || (sign != 1 && sign != -1) || mis(x) ||
      mis(y))
    return cudaErrorInvalidValue;
  L.cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      L.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.cfg.dynamicSmemBytes));
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&L.cfg, L.kern, x, y, tw2, tw1, P, n1, n2, L.lt,
                         L.lr, L.l2, static_cast<float>(sign), scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The CTAs a plane of the plane-holding kernel takes for (n1, n2) planes
// into *k, and into *count the most clusters of them (K > 1,
// cudaOccupancyMaxActiveClusters) or CTAs (K = 1, the blocks an SM times
// the SMs) the device holds at once; 0 if none fits.
extern "C" int mff_fft_plane_clusters_f32(int n1, int n2, int* k,
                                          int* count) {
  HoldLaunch L;
  *k = *count = 0;
  if (!hold_launch(n1, n2, 1, &L)) return cudaErrorInvalidValue;
  *k = L.K;
  cudaError_t e = cudaFuncSetAttribute(
      L.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.cfg.dynamicSmemBytes));
  if (e != cudaSuccess) return e;
  if (L.K > 1)
    return cudaOccupancyMaxActiveClusters(
        count, reinterpret_cast<const void*>(L.kern), &L.cfg);
  int dev = 0, sms = 0, per = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, L.kern, kHoldThreads, L.cfg.dynamicSmemBytes);
  *count = per * sms;
  return e;
}

// I's larger planes (the wrapper sends planes with an axis above 256;
// any plane of two powers of two from 2 to 1024 is taken).  x, y: (2, P,
// n1, n2) float32, contiguous, distinct and 16-byte aligned, on the
// current device; tw2, tw1: the (2, n2) and (2, n1) tables of
// butterfly._tw_pack_powers(n2, sign) and (n1, sign).  Launches the row
// line kernel (x -> y), then the column band kernel (in place on y, with
// the scale).  Returns the error of a refused launch, else
// cudaGetLastError() after the second.
extern "C" int mff_fft_plane_large_f32(const float* x, float* y,
                                       const float* tw2, const float* tw1,
                                       long long P, int n1, int n2,
                                       int sign, float scale, void* stream) {
  const auto mis = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  if (P <= 0 || n1 < 2 || n2 < 2 || n1 > 1024 || n2 > 1024 ||
      (n1 & (n1 - 1)) || (n2 & (n2 - 1)) || (sign != 1 && sign != -1) ||
      mis(x) || mis(y))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vol = P * n1 * n2;
  const float sg = static_cast<float>(sign);
  int e;
  switch (n2) {
#define MFF_ROWS(n) \
  case n: e = launch_rows<n>(x, y, tw2, P * n1, vol, sg, st); break
    MFF_ROWS(2); MFF_ROWS(4); MFF_ROWS(8); MFF_ROWS(16); MFF_ROWS(32);
    MFF_ROWS(64); MFF_ROWS(128); MFF_ROWS(256); MFF_ROWS(512);
    MFF_ROWS(1024);
#undef MFF_ROWS
    default: return cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  int lt, lk, lc;
  band_shape(n1, n2, &lt, &lk, &lc);
  const int K = 1 << lk;
  const long long blocks = lt > 0 ? (P + (1LL << lt) - 1) >> lt
                                  : P * (n2 >> lc) * K;
  if (K > 2) return cudaErrorInvalidValue;
  const auto band = lc < 2    ? &fft_band_kernel<false, 1>
                    : K == 1 ? &fft_band_kernel<true, 1>
                             : &fft_band_kernel<true, 2>;
  const int lr = log2_of(n1 / K);
  return mff::launch_ex(band, blocks, kBandThreads,
                        mff::band_smem<float>((n1 / K) << lt, lc), K, st, y,
                        tw1, P, n1, n2, lt, lr, lc, sg, scale);
}
