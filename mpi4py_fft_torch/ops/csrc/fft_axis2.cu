// fft_axis2_p / fft_axis_pair_p: unnormalized planar c2c Stockham FFT
// along an axis whose N rows arrive as two halves of h = N/2 rows each
// (rows 0..h-1 from operand a, rows h..N-1 from operand b), written as two
// output halves in natural order, for N = 2^a or 3*2^a <= 2048, either
// sign, with an optional scale folded into the last write.  Float32 only:
// the fp64 build is still to come (ROADMAP Queue 2, D64).
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_axis2_p :1358 through _dispatch2 :1280 (_kern_lead2,
// _kern_mid2, _kern_last2s :1195-1237) and from fft_axis_pair_p :1476
// through _dispatch2q :1428 (_kern_lead2q, _kern_mid2q, _kern_last2q
// :1386-1423), with their split-input core _butterfly2 :484.
//
// Each operand comes with its own base pointer, plane stride and pre
// stride; the row stride is post and the column stride 1.  So one entry
// takes two separate tensors (the quarters of the quartered schedule), the
// two halves of one contiguous tensor passed as views (no slice copy, no
// concat), and outputs written over their inputs (alias): a block reads
// its whole tile before it writes any of it, and no two blocks share a
// line.
//
// Bound on an H100: bytes, as for fft_axis.cu: one pass reads and writes
// both halves once.  Design: A's tile (butterfly.cuh) at W = N.  A block
// loads C lines, rows below h from a and the rest from b, into one
// shared-memory tile, runs every stage there and writes rows below h to
// oa and the rest to ob.  At N = 2048 the tile holds C = 4 lines (80 KB,
// two blocks an SM: the wide bound of butterfly.cuh), so a row segment is
// 16 bytes a plane: half a 32-byte sector, and the lead and mid passes
// sit further from their bound than A's at N = 1024.
#include <cstdint>

#include "butterfly.cuh"

namespace {

// One half of the axis: element (plane p, pre index i, row k, column c)
// sits at ptr[p * plane + i * pre + k * post + c].
template <class T>
struct Half {
  T* ptr;
  long long plane;
  long long pre;
};

// Line c and row k of tile element idx (the map of fft_axis.cu).
__device__ __forceinline__ void tile_index(int idx, int n, int lc,
                                           long long post, int* c, int* k) {
  if (post == 1) {        // whole lines: neighbours along the line
    *c = idx / n;
    *k = idx - *c * n;
  } else {                // neighbours across lines (post columns)
    *c = idx & ((1 << lc) - 1);
    *k = idx >> lc;
  }
}

template <int kBlocks>
__global__ void __launch_bounds__(mff::Budget<float>::kTile / 16, kBlocks)
fft_axis2_kernel(Half<const float> a, Half<const float> b, Half<float> oa,
                 Half<float> ob, const float* __restrict__ tw,
                 long long tw_len, long long pre, int n, long long post,
                 float sign, mff::Plan plan, float scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  const int h = n / 2;
  // pre index (-1 past the last line) and column of each tile line
  long long* lpre = reinterpret_cast<long long*>(smem);
  long long* lcol = lpre + C;
  mff::Tile<float> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<float*>(lcol + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  const long long l0 = static_cast<long long>(blockIdx.x) << lc;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    lpre[c] = l < nlines ? l / post : -1;
    lcol[c] = l % post;
  }
  __syncthreads();

  const int total = n << lc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long i = lpre[c];
    float vr = 0.f, vi = 0.f;
    if (i >= 0) {
      const bool lo = k < h;
      const float* p = lo ? a.ptr : b.ptr;
      const long long o = i * (lo ? a.pre : b.pre) +
                          static_cast<long long>(lo ? k : k - h) * post +
                          lcol[c];
      vr = p[o];
      vi = p[(lo ? a.plane : b.plane) + o];
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  mff::run_plan(t, n, plan, tw, tw + tw_len, sign);

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long i = lpre[c];
    if (i >= 0) {
      const bool lo = k < h;
      float* p = lo ? oa.ptr : ob.ptr;
      const long long o = i * (lo ? oa.pre : ob.pre) +
                          static_cast<long long>(lo ? k : k - h) * post +
                          lcol[c];
      p[o] = t.re[k * t.cp + c] * scale;
      p[(lo ? oa.plane : ob.plane) + o] = t.im[k * t.cp + c] * scale;
    }
  }
}

}  // namespace

// xa, xb: the input halves, ya, yb: the output halves, each viewed as
// (2, pre, n/2, post) with row stride post and column stride 1;
// strides: their (plane, pre) strides in elements, in the order xa, xb,
// ya, yb.  tw: the (2, tw_len) table of _tw_pack(n, sign).  Returns
// cudaGetLastError() after the launch.
extern "C" int mff_fft_axis2_f32(const float* xa, const float* xb, float* ya,
                                 float* yb, const long long* strides,
                                 const float* tw, long long tw_len,
                                 long long pre, int n, long long post,
                                 int sign, const int* plan, int nstages,
                                 float scale, void* stream) {
  mff::Plan p;
  if (n < 2 || n % 2 != 0 || n > 2048 ||
      !mff::make_plan(plan, nstages, n, &p))
    return cudaErrorInvalidValue;
  const int lc = mff::tile_log2_lines<float>(n);
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (nlines <= 0 || blocks > 0x7fffffffLL || ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  const Half<const float> a{xa, strides[0], strides[1]};
  const Half<const float> b{xb, strides[2], strides[3]};
  const Half<float> oa{ya, strides[4], strides[5]};
  const Half<float> ob{yb, strides[6], strides[7]};
  const int threads = (n << lc) / 16;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(float) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<float>;
  auto kern = mff::pick_bound<float>(smem, &fft_axis2_kernel<B::kMinBlocks>,
                                     &fft_axis2_kernel<B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      a, b, oa, ob, tw, tw_len, pre, n, post, static_cast<float>(sign), p,
      scale, lc);
  return cudaGetLastError();
}
