// Butterfly probe: A's kernel body (fft_axis.cu) on A's tile, with the
// work between one load and one store chosen by a mode, float32.
//
// Replaces the TPU kernels that split the lead-axis butterfly into its
// parts: scripts/tpu_bfly_dissect.py:77 (`mk_kernel`: body_copy,
// body_concat, body_adds) and :152 (`with_tw`: body_full, the radix plan
// of pallas_butterfly._butterfly), tpu_vpu_probe.py:57 (the butterfly
// applied `reps` times a block), tpu_lead_copy.py:119, :137 and :199 (the
// butterfly on lead blocks, on the 5-D view and on Q-wide blocks) and
// tpu_r3_profile.py:121 (the mid-axis butterfly on whole slabs).  Modes:
//   copy   load the tile, synchronise, store it;
//   moves  the radix-4 Stockham stage loop with every output slot taking
//          its input unchanged (body_concat: a fixed permutation);
//   adds   the radix-4 stages with every twiddle at 1 (body_adds, sign -1);
//   full   A's radix plan (butterfly.cuh run_plan), as fft_axis_p.
// `reps` runs the mode's stage loop that many times on the tile.  moves and
// adds take N = 4^k, as the JAX bodies assume.
//
// Bound on an H100: bytes for every mode (one read and one write of the
// volume); the modes split A's time into its load/store, its shared-memory
// data movement, its adds and its twiddles.  The tile, its layout, the
// thread count and the launch bounds are A's (butterfly.cuh), so the split
// is of A's own kernel; `lc` may give fewer lines a tile than A takes.
#include "butterfly.cuh"

namespace {

enum Mode { kCopy = 0, kMoves = 1, kAdds = 2, kFull = 3 };

// Offset of element 0 of each tile line; -1 past the last line (as in
// fft_axis.cu).
__device__ __forceinline__ void line_bases(long long* base, long long l0,
                                           long long nlines, int C, int n,
                                           long long post) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    base[c] = l < nlines ? (l / post) * n * post + l % post : -1;
  }
}

// One radix-4 Stockham stage of mff::stage's data flow at remaining length
// L, without twiddles; with kDft false, without the 4-point DFT too.
template <bool kDft, class T>
__device__ __forceinline__ void stage4(const mff::Tile<T>& t, int W, int L,
                                       int lm, T sign) {
  constexpr int R = 4, K = 4;
  const int Lq = L / R;
  const int C = 1 << t.lc;
  const int M = 1 << lm;
  const int nb = (W / R) << t.lc;
  T vr[K][R], vi[K][R];
  int dst[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    dst[k] = -1;
    if (b < nb) {
      const int c = b & (C - 1);
      const int q = b >> t.lc;
      const int lp = q >> lm;
      const int m = q & (M - 1);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int s = (((j * Lq + lp) << lm) + m) * t.cp + c;
        vr[k][j] = t.re[s];
        vi[k][j] = t.im[s];
      }
      if (kDft) mff::Dft<R, T>::run(vr[k], vi[k], sign);
      dst[k] = ((lp * R << lm) + m) * t.cp + c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (dst[k] >= 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int s = dst[k] + (j << lm) * t.cp;
        t.re[s] = vr[k][j];
        t.im[s] = vi[k][j];
      }
    }
  }
  __syncthreads();
}

template <bool kDft, class T>
__device__ __forceinline__ void radix4_loop(const mff::Tile<T>& t, int W,
                                            T sign) {
  for (int L = W, lm = 0; L > 1; L /= 4, lm += 2)
    stage4<kDft>(t, W, L, lm, sign);
}

// One instance a mode, so that each compiles as A does: the full mode's
// registers and spills are A's, not those of all four modes inlined.
template <class T, int kBlocks, int kMode>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
bfly_kernel(const T* __restrict__ x, T* __restrict__ y,
            const T* __restrict__ tw, long long tw_len,
            long long pre, int n, long long post, T sign, mff::Plan plan,
            int lc, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  long long* base = reinterpret_cast<long long*>(smem);
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(base + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  const long long plane = nlines * n;
  line_bases(base, static_cast<long long>(blockIdx.x) << lc, nlines, C, n,
             post);
  __syncthreads();

  const int total = n << lc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {        // whole lines: neighbours along the line
      c = idx / n;
      k = idx - c * n;
    } else {                // neighbours across lines (post columns)
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    T vr = 0, vi = 0;
    if (b >= 0) {
      const long long a = b + k * post;
      vr = x[a];
      vi = x[plane + a];
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  for (int r = 0; r < reps; ++r) {
    if (kMode == kMoves) radix4_loop<false>(t, n, sign);
    if (kMode == kAdds) radix4_loop<true>(t, n, sign);
    if (kMode == kFull) mff::run_plan(t, n, plan, tw, tw + tw_len, sign);
  }

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {
      c = idx / n;
      k = idx - c * n;
    } else {
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    if (b >= 0) {
      const long long a = b + k * post;
      y[a] = t.re[k * t.cp + c];
      y[plane + a] = t.im[k * t.cp + c];
    }
  }
}

bool pow4(int n) {
  while (n > 1 && n % 4 == 0) n /= 4;
  return n == 1;
}

template <int kMode>
int launch(const float* x, float* y, const float* tw, long long tw_len,
           long long pre, int n, long long post, int sign,
           const mff::Plan& p, int lc, int reps, long long blocks,
           void* stream) {
  const int C = 1 << lc;
  const int threads = (n << lc) / 16;
  const size_t smem = sizeof(long long) * C +
                      2 * sizeof(float) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<float>;
  auto kern = mff::pick_bound<float>(
      smem, &bfly_kernel<float, B::kMinBlocks, kMode>,
      &bfly_kernel<float, B::kWideMinBlocks, kMode>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, post, static_cast<float>(sign), p, lc, reps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (2, pre, n, post) float32, contiguous; y == x runs in place, as
// A does (every block loads its own lines whole before it stores them,
// and no other block touches them).  tw, plan: A's tables for n and sign
// (_tw_pack, _stage_plan).  mode 0 copy, 1 moves, 2 adds, 3 full;
// reps >= 1; lc: log2 of the lines a tile, or -1 for A's own
// (butterfly.cuh tile_log2_lines).  Returns cudaGetLastError().
extern "C" int mff_bfly_f32(const float* x, float* y, const float* tw,
                            long long tw_len, long long pre, int n,
                            long long post, int sign, const int* plan,
                            int nstages, int mode, int reps, int lc,
                            void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p) || mode < kCopy ||
      mode > kFull || reps < 1 || ((mode == kMoves || mode == kAdds) &&
                                   (n < 4 || !pow4(n))))
    return cudaErrorInvalidValue;
  const int own = mff::tile_log2_lines<float>(n);
  if (lc < 0) lc = own;
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (lc > own || nlines <= 0 || blocks > 0x7fffffffLL ||
      ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  switch (mode) {
    case kCopy: return launch<kCopy>(x, y, tw, tw_len, pre, n, post, sign, p,
                                     lc, reps, blocks, stream);
    case kMoves: return launch<kMoves>(x, y, tw, tw_len, pre, n, post, sign,
                                       p, lc, reps, blocks, stream);
    case kAdds: return launch<kAdds>(x, y, tw, tw_len, pre, n, post, sign, p,
                                     lc, reps, blocks, stream);
    default: return launch<kFull>(x, y, tw, tw_len, pre, n, post, sign, p,
                                  lc, reps, blocks, stream);
  }
}
