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

// move: y[p, k, q] = x[p, src(k), q] on the (P, N, Q) view, k < N' (N / 2
// for even and odd, else N), src from move_src.  Bound on an H100: bytes;
// nothing is computed.  The least traffic is y written once plus every
// 32-byte sector of x that holds a gathered element read once
// (ops/probes.py move_bytes): x + y for even and odd on the last axis
// (every sector holds both parities), 2 y on another axis with rows of 32
// bytes or more, 2 x for reverse and roll.  The C entry picks one of four
// routes by shape (pick_move_route), each moving 16-byte vectors where
// the shape lets it, with kMoveUnroll loads in flight a thread before its
// first store:
//  * lines (Q = 1, both bases 16-byte aligned, even and odd), the gather
//    in registers: deinterleave the flat tensor (an even N starts every
//    line on an even index), output vector o from source vectors 2o and
//    2o + 1;
//  * lines_shared (Q = 1, aligned, reverse and roll): a CTA stages a group
//    of whole lines in shared memory and writes its outputs as vectors,
//    each element read there by the map;
//  * rows (Q > 1, Q % 4 == 0, aligned): each output row is one contiguous
//    source row, copied as vectors; the row comes from the CTA's item;
//  * scalar: a base not 16-byte aligned, rows of Q % 4 != 0 floats, or a
//    staged group above the shared-memory budget (a line of more than
//    12288 points): one float a thread.
// y may not overlap x: the entry refuses it (a reverse in place would
// race).
enum MoveKind { kEven = 0, kOdd = 1, kReverse = 2, kRoll = 3 };
enum MoveRoute {
  kMoveRefused = -1, kMoveScalar = 0, kMoveRows = 1, kMoveLines = 2,
  kMoveStaged = 3
};

constexpr int kMoveUnroll = 4;      // vectors a thread loads, then stores
constexpr unsigned kMoveItem = kThreads * kMoveUnroll;  // a CTA's step
constexpr long long kStageBytes = 16384;  // a staged group's target size
constexpr long long kStageMax = 49152;    // its limit (no opt-in needed)

// The source index along the axis of output index k < N' for a move of
// `kind` on n points (roll by 0 <= shift < n, torch.roll's sense).
__host__ __device__ __forceinline__ unsigned move_src(int kind, unsigned k,
                                                      unsigned n,
                                                      unsigned shift) {
  switch (kind) {
    case kEven: return 2 * k;
    case kOdd: return 2 * k + 1;
    case kReverse: return n - 1 - k;
    default: return k >= shift ? k - shift : k + n - shift;
  }
}

// scalar: output element i (flat) from its source element.
__global__ void __launch_bounds__(kThreads)
move_kernel(const float* __restrict__ x, float* __restrict__ y,
            unsigned total, FastDiv q, FastDiv nout, unsigned n, int kind,
            unsigned shift) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned t = div_of(q, i);
    const unsigned c = i - t * q.d;
    const unsigned p = div_of(nout, t);
    const unsigned k = t - p * nout.d;
    y[i] = x[(static_cast<long long>(p) * n + move_src(kind, k, n, shift)) *
                 q.d + c];
  }
}

// lines in registers (even and odd): `total` output vectors of the flat
// y, kMoveItem a CTA step, output vector o from vectors 2o and 2o + 1 of
// the flat x; the last `tail` (< 4) floats of y one at a time.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
move_lines_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                  unsigned total, unsigned tail) {
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const unsigned i = 4 * total + threadIdx.x;
    reinterpret_cast<float*>(y)[i] =
        reinterpret_cast<const float*>(x)[2ull * i + kKind];
  }
  for (unsigned base = blockIdx.x * kMoveItem; base < total;
       base += gridDim.x * kMoveItem) {
    float4 a[kMoveUnroll], b[kMoveUnroll];
#pragma unroll
    for (int u = 0; u < kMoveUnroll; ++u) {
      const unsigned o = base + u * kThreads + threadIdx.x;
      if (o >= total) continue;
      a[u] = __ldg(x + 2ull * o);
      b[u] = __ldg(x + 2ull * o + 1);
    }
#pragma unroll
    for (int u = 0; u < kMoveUnroll; ++u) {
      const unsigned o = base + u * kThreads + threadIdx.x;
      if (o >= total) continue;
      if constexpr (kKind == kEven)
        y[o] = make_float4(a[u].x, a[u].z, b[u].x, b[u].z);
      else
        y[o] = make_float4(a[u].y, a[u].w, b[u].y, b[u].w);
    }
  }
}

// lines_shared (reverse and roll, N' = N): a CTA moves `g` whole lines of
// n.d points at a time, g n.d a multiple of 4, so every group starts
// 16-byte aligned in x and y: the group into shared memory as vectors
// (kMoveUnroll loads a thread before it stores them), then its outputs as
// vectors, each element read there at move_src; the last group, of fewer
// lines, ends on single floats.
__global__ void __launch_bounds__(kThreads)
move_staged_kernel(const float* __restrict__ x, float* __restrict__ y,
                   unsigned lines, unsigned g, FastDiv n, int kind,
                   unsigned shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  float4* s4 = reinterpret_cast<float4*>(smem);
  for (unsigned l0 = blockIdx.x * g; l0 < lines; l0 += gridDim.x * g) {
    const unsigned m = (lines - l0 < g ? lines - l0 : g) * n.d;
    const unsigned mv = m / 4;
    const long long off = static_cast<long long>(l0) * n.d;
    const float4* xs = reinterpret_cast<const float4*>(x + off);
    for (unsigned v0 = 0; v0 < mv; v0 += kMoveItem) {
      float4 r[kMoveUnroll];
#pragma unroll
      for (int u = 0; u < kMoveUnroll; ++u) {
        const unsigned v = v0 + u * kThreads + threadIdx.x;
        if (v < mv) r[u] = __ldg(xs + v);
      }
#pragma unroll
      for (int u = 0; u < kMoveUnroll; ++u) {
        const unsigned v = v0 + u * kThreads + threadIdx.x;
        if (v < mv) s4[v] = r[u];
      }
    }
    if (threadIdx.x < m % 4)
      s[4 * mv + threadIdx.x] = x[off + 4 * mv + threadIdx.x];
    __syncthreads();
    float* ys = y + off;
    for (unsigned o = 4 * threadIdx.x; o < m; o += 4 * kThreads) {
      unsigned l = div_of(n, o);
      unsigned k = o - l * n.d;
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[c] = o + c < m ? s[l * n.d + move_src(kind, k, n.d, shift)] : 0.f;
        if (++k == n.d) {
          k = 0;
          ++l;
        }
      }
      if (o + 4 <= m) {
        reinterpret_cast<float4*>(ys)[o / 4] =
            make_float4(e[0], e[1], e[2], e[3]);
      } else {
        for (unsigned c = 0; o + c < m; ++c) ys[o + c] = e[c];
      }
    }
    __syncthreads();
  }
}

// rows (Q > 1): output row r = (p, k) of `rv` vectors from source row
// (p, move_src(k)).  A CTA moves one item at a time: kMoveItem vectors of
// one row (`chunks` items a row, per = 1) or `per` whole rows (chunks =
// 1); the item gives the row, one division, and each thread's place in an
// item (row offset and column of each of its kMoveUnroll vectors, `span`
// vectors a row of the item) is fixed for the launch.
__global__ void __launch_bounds__(kThreads)
move_rows_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                 unsigned items, unsigned rows, FastDiv chunks, unsigned per,
                 unsigned span, unsigned rv, FastDiv nout, unsigned n,
                 int kind, unsigned shift) {
  unsigned dr[kMoveUnroll], col[kMoveUnroll];
#pragma unroll
  for (int u = 0; u < kMoveUnroll; ++u) {
    const unsigned f = u * kThreads + threadIdx.x;
    dr[u] = f / span;
    col[u] = f - dr[u] * span;
  }
  for (unsigned it = blockIdx.x; it < items; it += gridDim.x) {
    const unsigned q = div_of(chunks, it);
    const unsigned row0 = q * per;
    const unsigned col0 = (it - q * chunks.d) * kMoveItem;
    float4 v[kMoveUnroll];
    long long dst[kMoveUnroll];
#pragma unroll
    for (int u = 0; u < kMoveUnroll; ++u) {
      const unsigned r = row0 + dr[u], c = col0 + col[u];
      dst[u] = -1;
      if (dr[u] >= per || r >= rows || c >= rv) continue;
      const unsigned p = div_of(nout, r);
      const unsigned k = r - p * nout.d;
      v[u] = __ldg(x + (static_cast<long long>(p) * n +
                        move_src(kind, k, n, shift)) * rv + c);
      dst[u] = static_cast<long long>(r) * rv + c;
    }
#pragma unroll
    for (int u = 0; u < kMoveUnroll; ++u)
      if (dst[u] >= 0) y[dst[u]] = v[u];
  }
}

// The move's launch: its route and each kernel's arguments.
struct MovePlan {
  int route;
  long long nout;             // N'
  long long units;            // CTA steps (vectors / kMoveItem, groups,
                              // items)
  unsigned total;             // scalar: floats; lines: output vectors
  unsigned tail;              // lines: floats after them
  unsigned g;                 // lines_shared: lines a group
  unsigned rows, per, span, rv, chunks;   // rows
};

// The route mff_move_f32 takes for these arguments, its plan in *mp;
// kMoveRefused where it refuses them.  y null: a new tensor (16-byte
// aligned, apart from x).
int pick_move_route(const float* x, const float* y, long long P,
                    long long N, long long Q, int kind, long long shift,
                    MovePlan* mp) {
  if (P < 1 || N < 1 || Q < 1 || kind < kEven || kind > kRoll ||
      (kind <= kOdd && N % 2 != 0) || shift < 0 || shift >= N)
    return kMoveRefused;
  const long long nout = kind <= kOdd ? N / 2 : N;
  const bool al = aligned16(x) && aligned16(y);
  const int vec = Q % 4 == 0 && al ? 4 : 1;
  if (P * nout * (Q / vec) >= (1ll << 31) || N * Q >= (1ll << 31))
    return kMoveRefused;
  if (y != nullptr) {
    const auto x0 = reinterpret_cast<std::uintptr_t>(x);
    const auto y0 = reinterpret_cast<std::uintptr_t>(y);
    if (x0 < y0 + 4ull * P * nout * Q && y0 < x0 + 4ull * P * N * Q)
      return kMoveRefused;
  }
  *mp = MovePlan{};
  mp->nout = nout;
  if (Q > 1 && vec == 4) {
    const long long rv = Q / 4, rows = P * nout;
    mp->rows = static_cast<unsigned>(rows);
    mp->rv = static_cast<unsigned>(rv);
    if (2 * rv >= kMoveItem) {              // items of kMoveItem vectors
      mp->per = 1;
      mp->span = kMoveItem;
      mp->chunks = static_cast<unsigned>((rv + kMoveItem - 1) / kMoveItem);
      mp->units = rows * mp->chunks;
    } else {                                // items of `per` whole rows
      mp->per = static_cast<unsigned>(kMoveItem / rv);
      mp->span = mp->rv;
      mp->chunks = 1;
      mp->units = (rows + mp->per - 1) / mp->per;
    }
    return mp->route = kMoveRows;
  }
  if (Q == 1 && al) {
    if (kind <= kOdd) {
      const long long floats = P * nout;
      mp->total = static_cast<unsigned>(floats / 4);
      mp->tail = static_cast<unsigned>(floats % 4);
      mp->units = (mp->total + kMoveItem - 1) / kMoveItem;
      return mp->route = kMoveLines;
    }
    // whole lines a group, g N a multiple of 4
    const long long ga = N % 4 == 0 ? 1 : N % 2 == 0 ? 2 : 4;
    long long g = kStageBytes / (4 * N) / ga * ga;
    if (g < ga) g = ga;
    if (4 * g * N <= kStageMax) {
      mp->g = static_cast<unsigned>(g);
      mp->units = (P + g - 1) / g;
      return mp->route = kMoveStaged;
    }
  }
  mp->total = static_cast<unsigned>(P * nout * Q);
  mp->units = (mp->total + kThreads - 1) / kThreads;
  return mp->route = kMoveScalar;
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

// y (P, N', Q) from x (P, N, Q), float32, contiguous, apart: N' = N / 2
// for kind 0 (even) and 1 (odd), else N; kind 3 rolls by `shift` (0 <=
// shift < N).
extern "C" int mff_move_f32(const float* x, float* y, long long P,
                            long long N, long long Q, int kind,
                            long long shift, void* stream) {
  MovePlan mp;
  if (y == nullptr ||
      pick_move_route(x, y, P, N, Q, kind, shift, &mp) == kMoveRefused)
    return cudaErrorInvalidValue;
  const long long cap = 1ll * 4 * kBlocksPerSm * sm_count();
  const unsigned blocks =
      static_cast<unsigned>(mp.units < cap ? (mp.units > 0 ? mp.units : 1)
                                           : cap);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(N);
  const unsigned sh = static_cast<unsigned>(shift);
  switch (mp.route) {
    case kMoveLines: {
      auto kern = kind == kEven ? &move_lines_kernel<kEven>
                                : &move_lines_kernel<kOdd>;
      kern<<<blocks, kThreads, 0, st>>>(reinterpret_cast<const float4*>(x),
                                        reinterpret_cast<float4*>(y),
                                        mp.total, mp.tail);
      break;
    }
    case kMoveStaged: {
      auto kern = &move_staged_kernel;
      kern<<<blocks, kThreads, 4ull * mp.g * N, st>>>(
          x, y, static_cast<unsigned>(P), mp.g, make_div(n), kind, sh);
      break;
    }
    case kMoveRows: {
      auto kern = &move_rows_kernel;
      kern<<<blocks, kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
          static_cast<unsigned>(mp.units), mp.rows, make_div(mp.chunks),
          mp.per, mp.span, mp.rv, make_div(static_cast<unsigned>(mp.nout)),
          n, kind, sh);
      break;
    }
    default: {
      auto kern = &move_kernel;
      kern<<<blocks, kThreads, 0, st>>>(
          x, y, mp.total, make_div(static_cast<unsigned>(Q)),
          make_div(static_cast<unsigned>(mp.nout)), n, kind, sh);
    }
  }
  return cudaGetLastError();
}

// The route mff_move_f32 takes with the same arguments (y null: a new
// tensor): 0 scalar, 1 rows, 2 lines, 3 lines_shared; -1 where it refuses
// them (y overlapping x among them).  Nothing is launched.
extern "C" int mff_move_route_f32(const float* x, const float* y,
                                  long long P, long long N, long long Q,
                                  int kind, long long shift) {
  MovePlan mp;
  return pick_move_route(x, y, P, N, Q, kind, shift, &mp);
}
