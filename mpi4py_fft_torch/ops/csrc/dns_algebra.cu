// The spectral DNS solver's algebra (examples/spectral_dns_solver.py) in
// three float64 passes a Runge-Kutta stage:
//
// * dns_curl: W_hat = i K x U_hat on the (3, n0, n1, n2h) complex128
//   spectrum;
// * dns_cross: u x w on the physical grid, in place over w;
// * dns_project_rk: the right-hand side dU = N - K (K . N) / |K|^2 -
//   nu |K|^2 U_hat from the three forwards N of u x w, and both RK4
//   updates U_next = U_hat0 + b dt dU, U_hat1 <- U_hat1 + a dt dU.
//
// Replaces no TPU kernel: the JAX package's solver
// (examples/spectral_dns_solver.py:82-113) jits the step, and XLA fuses
// these pointwise ops; the port ran them as eager PyTorch ops, each pass
// a temporary.  K is the solver's three rank-1 wavenumber vectors, read
// by each element's index (i0, i1, i2); |K|^2 and K_i / |K|^2 are formed
// from them per element, so no full-size K tensor is held.
//
// Bound on an H100: bytes.  A few flops for each 16-byte complex (three
// float64 divisions an element in the projection) against the card's 10
// flops a byte at float64.  Each pass reads its inputs and writes its
// outputs once, in 16-byte vectors (a complex128, or two float64 of the
// physical grid), neighbouring threads on neighbouring elements; the
// loads of a thread's elements go out before their arithmetic.
//
// Arithmetic: every product, sum and quotient is rounded on its own, in
// the order of the solver's eager expression (|K|^2 as (K0^2 + K1^2) +
// K2^2, the sum over i in order 0, 1, 2), so no multiply-add is
// contracted and each pass gives what the eager ops gave.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCurlPer = 2;     // spectral elements a thread in dns_curl
constexpr int kCrossPer = 2;    // 16-byte vectors a thread in dns_cross

__device__ __forceinline__ double mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ double add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ double sub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

__device__ __forceinline__ double quo(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}

// The wavenumbers of element e of one (n0, n1, n2h) spectral component:
// e = (i0 n1 + i1) n2h + i2, K_j read from the j-th rank-1 vector.
__device__ __forceinline__ void wavenumbers(unsigned e, unsigned n1,
                                            unsigned n2h, const double* K0,
                                            const double* K1,
                                            const double* K2, double k[3]) {
  const unsigned r = e / n2h;
  k[0] = __ldg(K0 + r / n1);
  k[1] = __ldg(K1 + r % n1);
  k[2] = __ldg(K2 + e % n2h);
}

// W_c = i (K_a U_b - K_b U_a) for (c, a, b) = (0, 1, 2), (1, 2, 0),
// (2, 0, 1): the solver's 1j * (K[a] * U_hat[b] - K[b] * U_hat[a]).  U, W:
// (3, m) complex128, m = n0 n1 n2h elements a component.
__global__ void __launch_bounds__(kThreads)
dns_curl_kernel(const double2* __restrict__ U, double2* __restrict__ W,
                const double* __restrict__ K0, const double* __restrict__ K1,
                const double* __restrict__ K2, unsigned n1, unsigned n2h,
                unsigned m) {
  const unsigned long long base =
      1ull * blockIdx.x * (kThreads * kCurlPer) + threadIdx.x;
  double2 u[kCurlPer][3];
#pragma unroll
  for (int j = 0; j < kCurlPer; ++j) {
    const unsigned long long e = base + 1ull * j * kThreads;
    if (e < m) {
#pragma unroll
      for (int c = 0; c < 3; ++c) u[j][c] = U[c * 1ull * m + e];
    }
  }
#pragma unroll
  for (int j = 0; j < kCurlPer; ++j) {
    const unsigned long long e = base + 1ull * j * kThreads;
    if (e >= m) continue;
    double k[3];
    wavenumbers(static_cast<unsigned>(e), n1, n2h, K0, K1, K2, k);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a = (c + 1) % 3, b = (c + 2) % 3;
      const double re = sub(mul(k[a], u[j][b].x), mul(k[b], u[j][a].x));
      const double im = sub(mul(k[a], u[j][b].y), mul(k[b], u[j][a].y));
      W[c * 1ull * m + e] = make_double2(-im, re);
    }
  }
}

// One point of u x w over w: (u1 w2 - u2 w1, u2 w0 - u0 w2, u0 w1 - u1 w0).
__device__ __forceinline__ void cross_point(double u0, double u1, double u2,
                                            double& w0, double& w1,
                                            double& w2) {
  const double c0 = sub(mul(u1, w2), mul(u2, w1));
  const double c1 = sub(mul(u2, w0), mul(u0, w2));
  const double c2 = sub(mul(u0, w1), mul(u1, w0));
  w0 = c0;
  w1 = c1;
  w2 = c2;
}

// u x w over w on n contiguous float64 points of six distinct tensors:
// kVec, every base 16-byte aligned: 16-byte vectors (a pair of points),
// kCrossPer a thread, and the last point of an odd n in thread 0; else
// single points.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dns_cross_kernel(const double* __restrict__ u0, const double* __restrict__ u1,
                 const double* __restrict__ u2, double* __restrict__ w0,
                 double* __restrict__ w1, double* __restrict__ w2,
                 long long n) {
  const long long base =
      1ll * blockIdx.x * (kThreads * kCrossPer) + threadIdx.x;
  if (!kVec) {
#pragma unroll
    for (int j = 0; j < kCrossPer; ++j) {
      const long long e = base + 1ll * j * kThreads;
      if (e < n) cross_point(u0[e], u1[e], u2[e], w0[e], w1[e], w2[e]);
    }
    return;
  }
  const long long pairs = n / 2;
  const double2* v[3] = {reinterpret_cast<const double2*>(u0),
                         reinterpret_cast<const double2*>(u1),
                         reinterpret_cast<const double2*>(u2)};
  double2* x[3] = {reinterpret_cast<double2*>(w0),
                   reinterpret_cast<double2*>(w1),
                   reinterpret_cast<double2*>(w2)};
  double2 a[kCrossPer][3], b[kCrossPer][3];
#pragma unroll
  for (int j = 0; j < kCrossPer; ++j) {
    const long long p = base + 1ll * j * kThreads;
    if (p < pairs) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[j][c] = v[c][p];
        b[j][c] = x[c][p];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCrossPer; ++j) {
    const long long p = base + 1ll * j * kThreads;
    if (p >= pairs) continue;
    cross_point(a[j][0].x, a[j][1].x, a[j][2].x, b[j][0].x, b[j][1].x,
                b[j][2].x);
    cross_point(a[j][0].y, a[j][1].y, a[j][2].y, b[j][0].y, b[j][1].y,
                b[j][2].y);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c][p] = b[j][c];
  }
  if ((n & 1) && base == 0) {
    const long long e = n - 1;
    cross_point(u0[e], u1[e], u2[e], w0[e], w1[e], w2[e]);
  }
}

// dU = N - K P - nu |K|^2 U, P = sum_i N_i K_i / K2s (K2s = |K|^2, or 1
// where |K|^2 = 0): the solver's rhs -= stack([P_hat * K_i]) after
// P_hat = sum(rhs * K_over_K2, 0), then rhs -= nu * K2 * U_hat.  Then
// U_next = U0 + bdt dU (kNext) and U1o = U1 + adt dU.  N_i: (m,); U, U0,
// U1, Un, U1o: (3, m), m = n0 n1 n2h.  Un may be U and U1o may be U1 (in
// place: each element is read before it is written, by the thread that
// writes it); U0 and U1 may be U (read once).
template <bool kNext>
__global__ void __launch_bounds__(kThreads)
dns_project_rk_kernel(const double2* __restrict__ N0,
                      const double2* __restrict__ N1,
                      const double2* __restrict__ N2, const double2* U,
                      const double2* U0, const double2* U1, double2* Un,
                      double2* U1o, const double* __restrict__ K0,
                      const double* __restrict__ K1,
                      const double* __restrict__ K2, unsigned n1,
                      unsigned n2h, unsigned m, double nu, double adt,
                      double bdt) {
  const unsigned long long e =
      1ull * blockIdx.x * kThreads + threadIdx.x;
  if (e >= m) return;
  const double2 n[3] = {N0[e], N1[e], N2[e]};
  double2 u[3], u0[3], u1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = U[c * 1ull * m + e];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (kNext) u0[c] = U0 == U ? u[c] : U0[c * 1ull * m + e];
    u1[c] = U1 == U ? u[c] : U1[c * 1ull * m + e];
  }
  double k[3];
  wavenumbers(static_cast<unsigned>(e), n1, n2h, K0, K1, K2, k);
  const double kk =
      add(add(mul(k[0], k[0]), mul(k[1], k[1])), mul(k[2], k[2]));
  const double kks = kk == 0.0 ? 1.0 : kk;
  double q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) q[c] = quo(k[c], kks);
  const double pr =
      add(add(mul(n[0].x, q[0]), mul(n[1].x, q[1])), mul(n[2].x, q[2]));
  const double pi =
      add(add(mul(n[0].y, q[0]), mul(n[1].y, q[1])), mul(n[2].y, q[2]));
  const double nk = mul(nu, kk);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double dr = sub(sub(n[c].x, mul(pr, k[c])), mul(nk, u[c].x));
    const double di = sub(sub(n[c].y, mul(pi, k[c])), mul(nk, u[c].y));
    if (kNext)
      Un[c * 1ull * m + e] = make_double2(add(u0[c].x, mul(bdt, dr)),
                                          add(u0[c].y, mul(bdt, di)));
    U1o[c * 1ull * m + e] = make_double2(add(u1[c].x, mul(adt, dr)),
                                         add(u1[c].y, mul(adt, di)));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The elements of one spectral component, or 0 where they do not fit
// the kernels' 32-bit index or a grid.
unsigned long long spectral_elements(int n0, int n1, int n2h) {
  if (n0 < 1 || n1 < 1 || n2h < 1) return 0;
  const unsigned long long m = 1ull * n0 * n1 * n2h;
  return m > 0xffffffffull ? 0 : m;
}

unsigned blocks_for(unsigned long long items, int per) {
  return static_cast<unsigned>((items + 1ull * kThreads * per - 1) /
                               (1ull * kThreads * per));
}

}  // namespace

// U, W: (3, n0, n1, n2h) complex128 as (re, im) pairs, contiguous, W not
// U; K0, K1, K2: the n0, n1 and n2h wavenumbers of the axes.  W = i K x
// U.  Returns cudaGetLastError() after the launch.
extern "C" int mff_dns_curl_f64(const double* U, double* W, const double* K0,
                                const double* K1, const double* K2, int n0,
                                int n1, int n2h, void* stream) {
  const unsigned long long m = spectral_elements(n0, n1, n2h);
  if (m == 0 || !aligned16(U) || !aligned16(W) || U == W)
    return cudaErrorInvalidValue;
  dns_curl_kernel<<<blocks_for(m, kCurlPer), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const double2*>(U), reinterpret_cast<double2*>(W), K0,
      K1, K2, static_cast<unsigned>(n1), static_cast<unsigned>(n2h),
      static_cast<unsigned>(m));
  return cudaGetLastError();
}

// u0..u2, w0..w2: n contiguous float64 points each, six distinct tensors.
// w <- u x w.  Returns cudaGetLastError() after the launch.
extern "C" int mff_dns_cross_f64(const double* u0, const double* u1,
                                 const double* u2, double* w0, double* w1,
                                 double* w2, long long n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const bool vec = aligned16(u0) && aligned16(u1) && aligned16(u2) &&
                   aligned16(w0) && aligned16(w1) && aligned16(w2);
  const unsigned long long items = vec ? n / 2 : n;
  const unsigned long long blocks =
      (items + 1ull * kThreads * kCrossPer - 1) / (1ull * kThreads * kCrossPer);
  if (blocks > 0x7fffffffull) return cudaErrorInvalidValue;
  auto kern = vec ? &dns_cross_kernel<true> : &dns_cross_kernel<false>;
  kern<<<blocks ? static_cast<unsigned>(blocks) : 1u, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(u0, u1, u2, w0, w1, w2, n);
  return cudaGetLastError();
}

// N0, N1, N2: (n0, n1, n2h) complex128; U, U0, U1, U1o and, where bdt is
// used (Un not null), Un: (3, n0, n1, n2h) complex128; all contiguous.
// K0, K1, K2 as for mff_dns_curl_f64.  Un may be U, U1o may be U1, and U0
// and U1 may be U.  U1o = U1 + adt dU and, with Un, Un = U0 + bdt dU.
// Returns cudaGetLastError() after the launch.
extern "C" int mff_dns_project_rk_f64(const double* N0, const double* N1,
                                      const double* N2, const double* U,
                                      const double* U0, const double* U1,
                                      double* Un, double* U1o,
                                      const double* K0, const double* K1,
                                      const double* K2, int n0, int n1,
                                      int n2h, double nu, double adt,
                                      double bdt, void* stream) {
  const unsigned long long m = spectral_elements(n0, n1, n2h);
  const double* p[] = {N0, N1, N2, U, U0, U1, Un, U1o};
  if (m == 0) return cudaErrorInvalidValue;
  for (const double* q : p)
    if (!aligned16(q)) return cudaErrorInvalidValue;
  auto d2 = [](const double* q) { return reinterpret_cast<const double2*>(q); };
  auto w2 = [](double* q) { return reinterpret_cast<double2*>(q); };
  auto kern = Un ? &dns_project_rk_kernel<true> : &dns_project_rk_kernel<false>;
  kern<<<blocks_for(m, 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d2(N0), d2(N1), d2(N2), d2(U), d2(U0), d2(U1), w2(Un), w2(U1o), K0, K1,
      K2, static_cast<unsigned>(n1), static_cast<unsigned>(n2h),
      static_cast<unsigned>(m), nu, adt, bdt);
  return cudaGetLastError();
}
