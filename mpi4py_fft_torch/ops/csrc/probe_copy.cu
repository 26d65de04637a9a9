// Copy probes: a box-by-box copy of a contiguous f32 tensor (block_copy)
// and a gather copy along one axis (move), each exact.
//
// block_copy replaces the copy kernels of the JAX package's TPU probes,
// each `o_ref[...] = x_ref[...]` under a BlockSpec and a grid:
// scripts/tpu_dma_probe.py:69, tpu_blockshape_probe.py:72 and :113,
// tpu_lead_copy.py:89 and :102, tpu_r3_profile.py:79 and :93,
// tpu_plane_test.py:96 and :110, tpu_pair_blocking_probe.py:66 and :96,
// tpu_oop3d_dissect.py:104 and tpu_slope_probe.py:74 and :88.  move
// replaces the in-kernel moves of tpu_probe_moves.py:31 (even and odd
// deinterleave, reversal, roll along one axis).
//
// Bound on an H100: bytes; nothing is computed.  The box is the unit of
// work and sets the address pattern that the probes vary: the contiguous
// run of each box row and the stride between rows.  One CTA copies whole
// boxes (a grid-stride loop over them, in the caller's grid order), its
// threads on neighbouring 16-byte vectors of a row.  The TPU's VMEM
// budgets and (8, 128) tile gates are not carried over.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 5;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2048 threads an SM

// 16 bytes, loaded and stored as one vector
struct alignas(16) Vec4 {
  float v[4];
};

// n / d for n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned div_of(const FastDiv& f, unsigned n) {
  const unsigned hi = static_cast<unsigned>(
      (static_cast<unsigned long long>(n) * f.m) >> 32);
  return (hi + n) >> f.s;
}

// The box-grid and the rows of one box.  Box b's origin is the sum over
// grid axes (slowest first) of its digit times step; a box is rows of
// `run` vectors, row r at the sum over the (up to 4) outer box axes of its
// digit times ostride.
struct CopyGeom {
  int gdims;
  long long gcount[kMaxDims];
  long long gstep[kMaxDims];
  FastDiv ext[4];             // outer box extents, slowest first
  long long ostride[4];       // their element strides
  FastDiv run;                // vectors of one row
  unsigned vecs;              // vectors of one box
  long long nboxes;
};

__device__ __forceinline__ long long row_offset(const CopyGeom& g,
                                                unsigned v) {
  const unsigned row = div_of(g.run, v);
  long long off = v - row * g.run.d;
  unsigned r = row;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    const unsigned q = div_of(g.ext[d], r);
    off += static_cast<long long>(r - q * g.ext[d].d) * g.ostride[d];
    r = q;
  }
  return off;
}

// V: Vec4 (16 bytes a thread) or float; x1/y1 null for one stream.
template <class V>
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const V* x0, V* y0, const V* x1, V* y1, CopyGeom g) {
  for (long long b = blockIdx.x; b < g.nboxes; b += gridDim.x) {
    long long origin = 0, rest = b;
    for (int d = g.gdims - 1; d >= 0; --d) {
      origin += (rest % g.gcount[d]) * g.gstep[d];
      rest /= g.gcount[d];
    }
    for (unsigned v = threadIdx.x; v < g.vecs; v += blockDim.x) {
      const long long a = origin + row_offset(g, v);
      if (x1 == nullptr) {
        y0[a] = x0[a];
      } else {
        const V p = x0[a], q = x1[a];
        y0[a] = p;
        y1[a] = q;
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Fill g from the tensor's dims, the box and the grid order; false if they
// do not describe a box grid of the tensor.  `vec`: elements a vector.
bool make_geom(const long long* dims, const long long* box, const int* order,
               int nd, int vec, CopyGeom* g) {
  if (nd < 1 || nd > kMaxDims) return false;
  long long st[kMaxDims], seen = 0;
  long long s = 1;
  for (int d = nd - 1; d >= 0; --d) {
    if (dims[d] < 1 || box[d] < 1 || dims[d] % box[d] != 0) return false;
    st[d] = s;
    s *= dims[d];
  }
  // grid axes in the caller's order, slowest first
  g->gdims = nd;
  g->nboxes = 1;
  for (int i = 0; i < nd; ++i) {
    const int d = order[i];
    if (d < 0 || d >= nd || (seen >> d) & 1) return false;
    seen |= 1ll << d;
    g->gcount[i] = dims[d] / box[d];
    g->gstep[i] = box[d] * st[d];
    g->nboxes *= g->gcount[i];
  }
  // the contiguous run: the innermost box axis that is not whole, with
  // every whole axis inside it
  int k = nd - 1;
  while (k > 0 && box[k] == dims[k]) --k;
  const long long run = box[k] * st[k];
  if (run % vec != 0) return false;
  long long rows = 1;
  for (int i = 0; i < 4; ++i) {
    const int d = k - 4 + i;              // outer axes k-4 .. k-1
    const long long e = d >= 0 ? box[d] : 1;
    g->ext[i] = make_div(static_cast<unsigned>(e));
    g->ostride[i] = d >= 0 ? st[d] / vec : 0;
    rows *= e;
  }
  const long long vecs = rows * (run / vec);
  if (vecs >= (1ll << 31) || g->nboxes > 0x7fffffffLL) return false;
  g->run = make_div(static_cast<unsigned>(run / vec));
  g->vecs = static_cast<unsigned>(vecs);
  for (int i = 0; i < nd; ++i) g->gstep[i] /= vec;
  return true;
}

template <class V>
int launch_copy(const float* x0, float* y0, const float* x1, float* y1,
                const CopyGeom& g, void* stream) {
  const long long blocks =
      g.nboxes < 1ll * kBlocksPerSm * sm_count()
          ? g.nboxes : 1ll * kBlocksPerSm * sm_count();
  const unsigned threads = g.vecs < kThreads
      ? (g.vecs + 31) / 32 * 32 : kThreads;
  auto kern = &block_copy_kernel<V>;
  kern<<<static_cast<unsigned>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const V*>(x0), reinterpret_cast<V*>(y0),
      reinterpret_cast<const V*>(x1), reinterpret_cast<V*>(y1), g);
  return cudaGetLastError();
}

// move: y[p, k, q] = x[p, src(k), q] on the (P, N, Q) view, with src
// 2k (even), 2k + 1 (odd), N - 1 - k (reverse) or (k - shift) mod N (roll)
enum MoveKind { kEven = 0, kOdd = 1, kReverse = 2, kRoll = 3 };

template <class V>
__global__ void __launch_bounds__(kThreads)
move_kernel(const V* __restrict__ x, V* __restrict__ y, unsigned total,
            FastDiv qv, FastDiv nout, unsigned n, int kind, unsigned shift) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned t = div_of(qv, i);
    const unsigned q = i - t * qv.d;
    const unsigned p = div_of(nout, t);
    const unsigned k = t - p * nout.d;
    unsigned src;
    switch (kind) {
      case kEven: src = 2 * k; break;
      case kOdd: src = 2 * k + 1; break;
      case kReverse: src = n - 1 - k; break;
      default: src = k >= shift ? k - shift : k + n - shift; break;
    }
    y[i] = x[(static_cast<long long>(p) * n + src) * qv.d + q];
  }
}

// block_copy's route: 16-byte vectors where every base is 16-byte
// aligned and a box row is a multiple of 4 floats, else single floats;
// -1 where the arguments describe no box grid of the tensors.  Fills g.
enum CopyRoute { kRefused = -1, kScalar = 0, kVector = 1 };

int pick_route(const float* x0, const float* y0, const float* x1,
               const float* y1, const long long* dims, const long long* box,
               const int* order, int nd, CopyGeom* g) {
  if ((x1 == nullptr) != (y1 == nullptr)) return kRefused;
  const bool vec = aligned16(x0) && aligned16(y0) &&
                   (x1 == nullptr || (aligned16(x1) && aligned16(y1)));
  if (vec && make_geom(dims, box, order, nd, 4, g)) return kVector;
  return make_geom(dims, box, order, nd, 1, g) ? kScalar : kRefused;
}

}  // namespace

// x0 -> y0 (and x1 -> y1 unless x1 is null): contiguous float32 tensors of
// `nd` <= 5 dims `dims`, copied in boxes of `box` elements, the boxes
// enumerated with the grid axes `order` (a permutation of 0..nd-1,
// slowest first).  y == x copies in place.
extern "C" int mff_block_copy_f32(const float* x0, float* y0,
                                  const float* x1, float* y1,
                                  const long long* dims,
                                  const long long* box, const int* order,
                                  int nd, void* stream) {
  CopyGeom g;
  switch (pick_route(x0, y0, x1, y1, dims, box, order, nd, &g)) {
    case kVector: return launch_copy<Vec4>(x0, y0, x1, y1, g, stream);
    case kScalar: return launch_copy<float>(x0, y0, x1, y1, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The route mff_block_copy_f32 takes with the same arguments: 1 vector,
// 0 scalar; -1 where it refuses them.  Nothing is launched.
extern "C" int mff_block_copy_route_f32(const float* x0, float* y0,
                                        const float* x1, float* y1,
                                        const long long* dims,
                                        const long long* box,
                                        const int* order, int nd) {
  CopyGeom g;
  return pick_route(x0, y0, x1, y1, dims, box, order, nd, &g);
}

// y (P, N', Q) from x (P, N, Q), float32, contiguous: N' = N / 2 for
// kind 0 (even) and 1 (odd), else N; kind 3 rolls by `shift` (0 <= shift
// < N).
extern "C" int mff_move_f32(const float* x, float* y, long long P,
                            long long N, long long Q, int kind,
                            long long shift, void* stream) {
  if (P < 1 || N < 1 || Q < 1 || kind < kEven || kind > kRoll ||
      (kind <= kOdd && N % 2 != 0) || shift < 0 || shift >= N)
    return cudaErrorInvalidValue;
  const long long nout = kind <= kOdd ? N / 2 : N;
  const int vec = Q % 4 == 0 && aligned16(x) && aligned16(y) ? 4 : 1;
  const long long total = P * nout * (Q / vec);
  if (total >= (1ll << 31) || N * Q >= (1ll << 31))
    return cudaErrorInvalidValue;
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = 1ll * 4 * kBlocksPerSm * sm_count();
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  const FastDiv qv = make_div(static_cast<unsigned>(Q / vec));
  const FastDiv nd = make_div(static_cast<unsigned>(nout));
  if (vec == 4) {
    auto kern = &move_kernel<Vec4>;
    kern<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const Vec4*>(x), reinterpret_cast<Vec4*>(y),
        static_cast<unsigned>(total), qv, nd, static_cast<unsigned>(N),
        kind, static_cast<unsigned>(shift));
  } else {
    auto kern = &move_kernel<float>;
    kern<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, static_cast<unsigned>(total), qv, nd,
        static_cast<unsigned>(N), kind, static_cast<unsigned>(shift));
  }
  return cudaGetLastError();
}
