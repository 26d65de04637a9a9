// fft_plane_p (H) and fft_plane_large_p (I): unnormalized planar c2c FFT
// over the last two axes of (2, P, N1, N2) float32 data in one launch,
// N1 and N2 powers of two up to 1024, either sign, with an optional scale
// folded into the last write.  The last axis (N2) is transformed first,
// then the second-to-last (N1), as the JAX kernels order the two stages.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_plane_p :1056 through _dispatch_plane :1018
// (_kern_plane :981, planes of N1, N2 <= 256 packed T to a block) and from
// fft_plane_large_p :1167 through _dispatch_plane_large :1139
// (_kern_plane_large :1095, one full plane of N1*N2 <= 2^20 a block).
// Both entries compute the same function; the kernel is chosen by shape:
// planes whose axes are both at most 256 (every plane H's gate takes) go
// to the plane-holding kernel, every other plane (I's larger planes) to
// the queue kernel.
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
// The queue kernel (mff_fft_plane_queue_f32, I's planes with an axis
// above 256): a persistent grid (the SMs times the blocks an SM holds)
// takes work items from a counter in device memory, in order.  A plane
// does not fit one block's shared memory (1024 x 1024 complex f32 is
// 8 MB, against 227 KB), so the two axes take two tiles each: the plane
// goes from the first axis to the second through L2 (50 MB) instead of
// HBM while a few planes are in flight.  Plane q gives first its row items
// (C2 whole rows of N2 points each, A's tile with neighbours along the
// line, from x into y), then its column items (C1 adjacent columns of N1
// points, stride N2, read from y, transformed and written back in place
// with the scale).  A row item, once written, adds one to q's counter
// (every thread fences its stores first); a column item of q waits until
// that counter holds q's row items, then reads through L2 (__ldcg).  An
// item only waits on items taken before it, by blocks that are running,
// and a row item waits on nothing: no deadlock, and a grid whose blocks
// run one after another runs the queue in order.
#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "butterfly.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = mff::Budget<float>::kTile / 16;

// counters: [0] the next item, [1 + q] the row items of plane q done.
template <int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fft_plane_kernel(const float* __restrict__ x, float* y,
                 const float* __restrict__ tw2, long long tw2_len,
                 const float* __restrict__ tw1, long long tw1_len,
                 long long P, int n1, int n2, float sign, mff::Plan plan2,
                 mff::Plan plan1, float scale, int* counters, int lc2,
                 int lc1) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* slot = reinterpret_cast<int*>(smem);
  float* tile = reinterpret_cast<float*>(smem + 16);
  const int rows = n1 >> lc2;          // row items a plane
  const int per = rows + (n2 >> lc1);  // items a plane
  const long long total = P * per;
  const long long area = static_cast<long long>(n1) * n2;
  const long long plane = P * area;    // offset of the imaginary parts
  int* next = counters;
  int* done = counters + 1;

  for (;;) {
    if (threadIdx.x == 0) slot[0] = atomicAdd(next, 1);
    __syncthreads();
    const int item = slot[0];
    __syncthreads();
    if (item >= total) break;
    const long long q = item / per;
    const int j = item - static_cast<int>(q * per);
    const long long base = q * area;
    mff::Tile<float> t;
    t.re = tile;
    if (j < rows) {
      // rows j*C2 .. of plane q: lines of n2 contiguous points, x -> y
      t.lc = lc2;
      t.cp = (1 << lc2) + 1;
      t.im = t.re + n2 * t.cp;
      const long long r0 = base + static_cast<long long>(j << lc2) * n2;
      const int count = n2 << lc2;
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx / n2;
        const int k = idx - c * n2;
        t.re[k * t.cp + c] = x[r0 + idx];
        t.im[k * t.cp + c] = x[plane + r0 + idx];
      }
      __syncthreads();
      mff::run_plan(t, n2, plan2, tw2, tw2 + tw2_len, sign);
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx / n2;
        const int k = idx - c * n2;
        y[r0 + idx] = t.re[k * t.cp + c];
        y[plane + r0 + idx] = t.im[k * t.cp + c];
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(done + q, 1);
    } else {
      // columns (j - rows)*C1 .. of plane q: lines of n1 points, stride
      // n2, read from y once q's rows are all written, and written back
      if (threadIdx.x == 0) {
        // the row items were taken before this one and wait on nothing;
        // a count that never comes is a fault: stop, do not hang
        long long spins = 0;
        while (atomicAdd(done + q, 0) < rows) {
          __nanosleep(128);
          if (++spins > (1LL << 26)) __trap();
        }
        __threadfence();
      }
      __syncthreads();
      t.lc = lc1;
      t.cp = (1 << lc1) + 1;
      t.im = t.re + n1 * t.cp;
      const long long c0 = base + (static_cast<long long>(j - rows) << lc1);
      const int count = n1 << lc1;
      const int cmask = (1 << lc1) - 1;
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx & cmask;
        const int k = idx >> lc1;
        const long long a = c0 + static_cast<long long>(k) * n2 + c;
        t.re[k * t.cp + c] = __ldcg(y + a);
        t.im[k * t.cp + c] = __ldcg(y + plane + a);
      }
      __syncthreads();
      mff::run_plan(t, n1, plan1, tw1, tw1 + tw1_len, sign);
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int c = idx & cmask;
        const int k = idx >> lc1;
        const long long a = c0 + static_cast<long long>(k) * n2 + c;
        y[a] = t.re[k * t.cp + c] * scale;
        y[plane + a] = t.im[k * t.cp + c] * scale;
      }
      __syncthreads();
    }
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// ---------------------------------------------------------------------------
// the plane-holding kernel (N1, N2 <= 256)
// ---------------------------------------------------------------------------

// Points of each plane component a CTA holds, its threads and its launch
// bound.
constexpr int kHoldElems = 8192;
constexpr int kHoldThreads = 512;
constexpr int kHoldMinBlocks = 2;

// A row's points in shared memory: point p at pad(p), a gap after every
// 16, so that the strided points of a butterfly and the permuted points
// of the store fall on distinct banks; rows are row_stride(n2) apart (odd).
__host__ __device__ __forceinline__ int pad(int p) { return p + (p >> 4); }
__host__ __device__ __forceinline__ int row_stride(int n2) {
  return (n2 + ((n2 - 1) >> 4)) | 1;
}

// Where the decimation-in-frequency stages of a 2^lw-point line (radix 8
// while it divides, then 4 or 2) leave frequency f.
__device__ __forceinline__ int dif_pos(int f, int lw) {
  int p = 0;
  for (int ll = lw; ll > 0;) {
    const int a = ll < 3 ? ll : 3;
    ll -= a;
    p |= (f & ((1 << a) - 1)) << ll;
    f >>= a;
  }
  return p;
}

// The block's lines: rows (kRows; line c = t R + n, point p at
// c rs + pad(p)) or columns (line c = t n2 + col, point n at
// (t R + n) rs + pad(col)), with T = 2^lt planes of R = 2^lr rows of
// n2 = 2^l2 points.
struct Block {
  float* re;
  float* im;
  int lt, lr, l2, rs;
};

template <bool kRows>
__device__ __forceinline__ int at(const Block& k, int c, int p) {
  if (kRows) return c * k.rs + pad(p);
  return (((c >> k.l2) << k.lr) + p) * k.rs + pad(c & ((1 << k.l2) - 1));
}

// One in-place decimation-in-frequency stage of radix R = 2^lrr over
// sub-blocks of L = 2^ll points of every line of 2^lw points: butterfly
// (line c, block, i < L/R) takes the points block L + j L/R + i, and
// writes their DFT over j, output a times w_L^(a i), back to the same
// points.  No other butterfly touches them, so a thread takes its
// butterflies one at a time, and the block synchronises once a stage.
// tw: (cos, sin)(sign 2 pi e / 2^(lw + ls)), e < 2^(lw + ls), at twr/twi.
template <int R, int lrr, bool kRows>
__device__ __forceinline__ void dif_stage(const Block& k, int lc, int lw,
                                          int ll, int ls,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi,
                                          float sign) {
  const int lq = ll - lrr;
  const int nb = 1 << (lc + lw - lrr);
#pragma unroll 1
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = b & ((1 << lc) - 1);
    const int q = b >> lc;
    const int i = q & ((1 << lq) - 1);
    const int p0 = ((q >> lq) << ll) + i;
    float vr[R], vi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = at<kRows>(k, c, p0 + (j << lq));
      vr[j] = k.re[s];
      vi[j] = k.im[s];
    }
    mff::Dft<R, float>::run(vr, vi, sign);
    if (lq > 0) {
#pragma unroll
      for (int a = 1; a < R; ++a) {
        const int e = (a * i) << (lw - ll + ls);
        const float wr = __ldg(twr + e), wi = __ldg(twi + e);
        const float yr = vr[a], yi = vi[a];
        vr[a] = yr * wr - yi * wi;
        vi[a] = yr * wi + yi * wr;
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int s = at<kRows>(k, c, p0 + (a << lq));
      k.re[s] = vr[a];
      k.im[s] = vi[a];
    }
  }
  __syncthreads();
}

// Every stage of the 2^lw-point transforms of the block's 2^lc lines;
// tw: the (2, 2^(lw + ls)) table of _tw_pack_powers(2^(lw + ls), sign),
// whose every 2^ls-th entry is a power of w_(2^lw).
template <bool kRows>
__device__ __forceinline__ void dif_pass(const Block& k, int lc, int lw,
                                         int ls,
                                         const float* __restrict__ tw,
                                         float sign) {
  const float* twi = tw + (1 << (lw + ls));
  for (int ll = lw; ll > 0;) {
    const int a = ll < 3 ? ll : 3;
    if (a == 1)
      dif_stage<2, 1, kRows>(k, lc, lw, ll, ls, tw, twi, sign);
    else if (a == 2)
      dif_stage<4, 2, kRows>(k, lc, lw, ll, ls, tw, twi, sign);
    else
      dif_stage<8, 3, kRows>(k, lc, lw, ll, ls, tw, twi, sign);
    ll -= a;
  }
}

// The cluster helpers (as fft_axis2.cu's): this CTA's rank, a barrier
// over every thread of the cluster, and the address of the same
// shared-memory object in CTA `rank`.
__device__ __forceinline__ unsigned cluster_rank() {
  return cg::this_cluster().block_rank();
}
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
template <class T>
__device__ __forceinline__ T* peer_smem(T* p, unsigned rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

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
  Block blk{reinterpret_cast<float*>(smem), nullptr, lt, lr, l2, rs};
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
  dif_pass<true>(blk, lr + lt, l2, 0, tw2, sign);

  if constexpr (K > 1) {
    // the radix-K step across the cluster, in place: point (n, col) of
    // every CTA's block, by one thread of the cluster
    cluster_sync();
#pragma unroll 1
    for (int p = static_cast<int>(kk) * kHoldThreads + threadIdx.x;
         p < kHoldElems; p += K * kHoldThreads) {
      const int n = p >> l2;
      const int s = n * rs + pad(p & (n2 - 1));
      float vr[K], vi[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        vr[j] = *peer_smem(blk.re + s, static_cast<unsigned>(j));
        vi[j] = *peer_smem(blk.im + s, static_cast<unsigned>(j));
      }
      mff::Dft<K, float>::run(vr, vi, sign);
#pragma unroll
      for (int j = 1; j < K; ++j) {     // output j times w_n1^(n j)
        const int e = n * j;
        const float wr = __ldg(tw1 + e), wi = __ldg(tw1 + n1 + e);
        const float yr = vr[j], yi = vi[j];
        vr[j] = yr * wr - yi * wi;
        vi[j] = yr * wi + yi * wr;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        *peer_smem(blk.re + s, static_cast<unsigned>(j)) = vr[j];
        *peer_smem(blk.im + s, static_cast<unsigned>(j)) = vi[j];
      }
    }
    cluster_sync();
  }

  // the second-to-last axis: each column of each plane a line of R points
  constexpr int lk = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
  dif_pass<false>(blk, l2 + lt, lr, lk, tw1, sign);

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

// The queue kernel.  x, y: (2, P, n1, n2) float32, contiguous and
// distinct, on the current device; tw2/tw1: the (2, len) tables of
// _tw_pack(n2, sign) and _tw_pack(n1, sign); plan2/plan1 their stage
// radices; counters: P + 1 ints set to 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int mff_fft_plane_queue_f32(const float* x, float* y,
                                       const float* tw2, long long tw2_len,
                                       const float* tw1, long long tw1_len,
                                       long long P, int n1, int n2,
                                       int sign, const int* plan2, int nst2,
                                       const int* plan1, int nst1,
                                       float scale, int* counters,
                                       void* stream) {
  mff::Plan p2, p1;
  if (!mff::make_plan(plan2, nst2, n2, &p2) ||
      !mff::make_plan(plan1, nst1, n1, &p1) || P <= 0 ||
      n1 < 2 || n2 < 2 || n1 > 1024 || n2 > 1024 || (n1 & (n1 - 1)) ||
      (n2 & (n2 - 1)) || (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  // C2 rows of n2 and C1 columns of n1 a tile, at most the plane's
  const int lc2 = std::min(mff::tile_log2_lines<float>(n2), log2_of(n1));
  const int lc1 = std::min(mff::tile_log2_lines<float>(n1), log2_of(n2));
  const long long per = (n1 >> lc2) + (n2 >> lc1);
  // the item counter passes the last item once a block
  if (P * per > INT_MAX / 2) return cudaErrorInvalidValue;
  const size_t cells = std::max(static_cast<size_t>(n2) * ((1 << lc2) + 1),
                                static_cast<size_t>(n1) * ((1 << lc1) + 1));
  const size_t smem = 16 + 2 * sizeof(float) * cells;
  // at most 1024 (8 + 1) cells: kMinBlocks tiles always fit an SM
  constexpr int kBlocks = mff::Budget<float>::kMinBlocks;
  auto kern = &fft_plane_kernel<kBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long grid =
      std::min<long long>(P * per, static_cast<long long>(sms) * kBlocks);
  kern<<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw2, tw2_len, tw1, tw1_len, P, n1, n2, static_cast<float>(sign),
      p2, p1, scale, counters, lc2, lc1);
  return cudaGetLastError();
}
