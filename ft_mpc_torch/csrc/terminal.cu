// Terminal-cost kernel: the polynomial terminal cost V(e) of every row of a
// bank, and where asked its gradient and its Hessian with the omega block
// shifted to be positive semidefinite, in one launch.
//
// Replaces no pallas_call: on the TPU, XLA fused `jax.vmap` of `jax.grad` /
// `jax.hessian` (ft_mpc_tpu/terminal/poly.py).  The port's plain version,
// `torch.func.vmap` of `grad` / `hessian` (ops/terminal.py:terminal_plain),
// dispatches thousands of small eager ops a call.  For row r of N, reading
// the tables of row b = r mod B (so that an (nA, B, 9) batch of candidates is
// one launch), with eo = e[6:9]:
//     V   = e'Pe + p'e + c + sum_k poly_c[k] m_k(eo)
//                          + sum_k sqrt_c[k] (s_k(eo) + app)^(1/4)
//     dV  = 2Pe + p, plus the extra terms' gradient on rows 6..8
//     H   = 2P, plus on the omega block the extra terms' Hessian H_eo
//           shifted by max(-lambda_min(H_eo), 0) on its diagonal
// where m_k(w) = prod_i w_i^poly_pow[k,i] and s_k likewise of sqrt_pow.
// Exponents outside 0..8 give a factor 0, as the plain version's one-hot of
// its power table does.  Derivatives in closed form: for f = (s + app)^(1/4),
// df = 1/4 (s+app)^(-3/4) ds and d2f = 1/4 (s+app)^(-3/4) d2s
// - 3/16 (s+app)^(-7/4) ds ds'.  lambda_min is `_eigmin_sym3`'s closed form,
// step for step, with det(B/p) by cofactors in place of an LU factorization.
//
// Bound on the H100: bytes.  A row reads its 9 errors and tables of
// 9*9 + 9 + 2 + 4*K1 + 4*K2 values and writes 1 + 9 + 81 values: 1.1 KB in
// float32 with the bank's K1 = 8, K2 = 12, 2.2 MB at B = 2048 (0.7 us at
// 3.35 TB/s), against under two thousand operations a row.  A call takes
// about 25 us at any B: one thread's chain over its 20 terms sets the time,
// which is small beside the thousands of dispatched ops it replaces.
// Design: one thread a row, THREADS rows a block.  The block's rows of P are
// staged through shared memory, and the rows of H leave through it, so that
// neighbouring threads load and store neighbouring addresses; each thread
// reads its row of P there and writes its row of H in place.
// Templated over float and double: every caller runs in its own dtype.
#include "common.cuh"

namespace {

constexpr int NE = 9;            // the terminal error
constexpr int NH = NE * NE;      // its Hessian
constexpr int OM = 6;            // where the omega block starts
constexpr int MAX_POW = 8;       // the power table holds w^0 .. w^8
constexpr int MAX_TERMS = 32;    // K1, K2 at most (ops/terminal.py:MAX_TERMS)
constexpr int THREADS = 64;      // rows a block; 64 * 81 doubles fit 48 KB
constexpr int WARP = 32;

__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float acos_(float x) { return acosf(x); }
__device__ __forceinline__ double acos_(double x) { return acos(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }

// x^a and its first two derivatives from the power table pw[p] = x^p (built
// by repeated multiplication, as `_pow_table`); an exponent outside 0..8
// selects nothing, so the factor and its derivatives are 0.
template <typename T>
__device__ __forceinline__ void factor(const T (&pw)[MAX_POW + 1], int a, T& f, T& d1,
                                       T& d2) {
  f = d1 = d2 = T(0);
#pragma unroll
  for (int q = 0; q <= MAX_POW; ++q) {
    if (a == q) {
      f = pw[q];
      if (q >= 1) d1 = T(q) * pw[q - 1];
      if (q >= 2) d2 = T(q * (q - 1)) * pw[q - 2];
    }
  }
}

// A function of the omega error w: value, gradient, Hessian's upper
// triangle (00 01 02 11 12 22).
template <typename T>
struct Jet {
  T v, g[3], h[6];
};

// The monomial prod_i w_i^pow[i] (value only, or with its derivatives).
template <typename T, bool DERIVS>
__device__ __forceinline__ Jet<T> monomial(const T (&pw)[3][MAX_POW + 1], const int* pw_idx) {
  T f[3], d[3], dd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) factor(pw[i], pw_idx[i], f[i], d[i], dd[i]);
  Jet<T> m;
  m.v = f[0] * f[1] * f[2];
  if (DERIVS) {
    m.g[0] = d[0] * f[1] * f[2];
    m.g[1] = f[0] * d[1] * f[2];
    m.g[2] = f[0] * f[1] * d[2];
    m.h[0] = dd[0] * f[1] * f[2];
    m.h[1] = d[0] * d[1] * f[2];
    m.h[2] = d[0] * f[1] * d[2];
    m.h[3] = f[0] * dd[1] * f[2];
    m.h[4] = f[0] * d[1] * d[2];
    m.h[5] = f[0] * f[1] * dd[2];
  }
  return m;
}

// `_eigmin_sym3`: the smallest eigenvalue of the symmetric 3x3 a (upper
// triangle 00 01 02 11 12 22), closed form.  Comparisons, not fmin/fmax, so
// that a NaN passes through the clamps as torch.clamp lets it.
template <typename T>
__device__ __forceinline__ T eigmin_sym3(const T (&a)[6]) {
  const T q = (a[0] + a[3] + a[5]) / T(3);
  const T b00 = a[0] - q, b11 = a[3] - q, b22 = a[5] - q;
  const T b01 = a[1], b02 = a[2], b12 = a[4];
  const T p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
                T(2) * (b01 * b01 + b02 * b02 + b12 * b12)) / T(6);
  const T p = sqrt_(p2 < T(1e-30) ? T(1e-30) : p2);
  const T c00 = b00 / p, c11 = b11 / p, c22 = b22 / p;
  const T c01 = b01 / p, c02 = b02 / p, c12 = b12 / p;
  const T det = c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02) +
                c02 * (c01 * c12 - c11 * c02);
  T r = det / T(2);
  r = r < T(-1) ? T(-1) : (r > T(1) ? T(1) : r);
  const T phi = acos_(r) / T(3);
  const T eig = q + T(2) * p * cos_(phi + T(2.0 * 3.14159265358979323846 / 3.0));
  return p2 < T(1e-24) ? q : eig;
}

template <typename T, bool DERIVS>
__global__ void __launch_bounds__(THREADS) terminal_kernel(
    const T* __restrict__ e,         // (N, 9), N = lead * B
    const T* __restrict__ P,         // (B, 9, 9)
    const T* __restrict__ pv,        // (B, 9)
    const T* __restrict__ c,         // (B,)
    const T* __restrict__ poly_c,    // (B, K1)
    const int* __restrict__ poly_pow,  // (B, K1, 3)
    const T* __restrict__ sqrt_c,    // (B, K2)
    const int* __restrict__ sqrt_pow,  // (B, K2, 3)
    const T* __restrict__ app,       // (B,)
    T* __restrict__ V_out,           // (N,)
    T* __restrict__ g_out,           // (N, 9)
    T* __restrict__ H_out,           // (N, 9, 9)
    long long N, int B, int K1, int K2) {
  __shared__ T S[THREADS * NH];
  const long long r0 = static_cast<long long>(blockIdx.x) * THREADS;
  const long long left = N - r0;
  const int n = left < THREADS ? static_cast<int>(left) : THREADS;
  const int tid = threadIdx.x;

  // the block's rows of P, a warp a row at a time: its lanes on
  // neighbouring addresses, one division a row
  for (int row = tid / WARP; row < n; row += THREADS / WARP) {
    const T* Pb = P + static_cast<size_t>((r0 + row) % B) * NH;
    for (int k = tid % WARP; k < NH; k += WARP) S[row * NH + k] = Pb[k];
  }
  __syncthreads();

  if (tid < n) {
    const long long r = r0 + tid;
    const int b = static_cast<int>(r % B);
    T* Pr = S + tid * NH;  // this row of P, then of H
    T x[NE];
#pragma unroll
    for (int i = 0; i < NE; ++i) x[i] = e[static_cast<size_t>(r) * NE + i];

    // the power tables of the omega error, by repeated multiplication
    T pw[3][MAX_POW + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pw[i][0] = T(1);
#pragma unroll
      for (int q = 1; q <= MAX_POW; ++q) pw[i][q] = pw[i][q - 1] * x[OM + i];
    }

    Jet<T> ex;
    ex.v = T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i) ex.g[i] = T(0);
#pragma unroll
    for (int i = 0; i < 6; ++i) ex.h[i] = T(0);

    const T* pc = poly_c + static_cast<size_t>(b) * K1;
    const int* pp = poly_pow + static_cast<size_t>(b) * K1 * 3;
    for (int k = 0; k < K1; ++k) {
      const int a[3] = {pp[3 * k], pp[3 * k + 1], pp[3 * k + 2]};
      const Jet<T> m = monomial<T, DERIVS>(pw, a);
      const T ck = pc[k];
      ex.v += ck * m.v;
      if (DERIVS) {
#pragma unroll
        for (int i = 0; i < 3; ++i) ex.g[i] += ck * m.g[i];
#pragma unroll
        for (int i = 0; i < 6; ++i) ex.h[i] += ck * m.h[i];
      }
    }

    const T ap = app[b];
    const T* sc = sqrt_c + static_cast<size_t>(b) * K2;
    const int* sp = sqrt_pow + static_cast<size_t>(b) * K2 * 3;
    for (int k = 0; k < K2; ++k) {
      const int a[3] = {sp[3 * k], sp[3 * k + 1], sp[3 * k + 2]};
      const Jet<T> m = monomial<T, DERIVS>(pw, a);
      const T s = m.v + ap;
      const T ck = sc[k];
      ex.v += ck * pow_(s, T(0.25));
      if (DERIVS) {
        // d f = d1 ds,  d2 f = d1 d2s + d2 ds ds'
        const T d1 = ck * (T(0.25) * pow_(s, T(-0.75)));
        const T d2 = ck * (T(0.25) * T(-0.75) * pow_(s, T(-1.75)));
#pragma unroll
        for (int i = 0; i < 3; ++i) ex.g[i] += d1 * m.g[i];
        ex.h[0] += d1 * m.h[0] + d2 * m.g[0] * m.g[0];
        ex.h[1] += d1 * m.h[1] + d2 * m.g[0] * m.g[1];
        ex.h[2] += d1 * m.h[2] + d2 * m.g[0] * m.g[2];
        ex.h[3] += d1 * m.h[3] + d2 * m.g[1] * m.g[1];
        ex.h[4] += d1 * m.h[4] + d2 * m.g[1] * m.g[2];
        ex.h[5] += d1 * m.h[5] + d2 * m.g[2] * m.g[2];
      }
    }

    // the quadratic part: (e'P) e + p'e + c, and 2Pe + p
    const T* pr = pv + static_cast<size_t>(b) * NE;
    T quad = T(0), lin = T(0);
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      T ePj = T(0);
#pragma unroll
      for (int i = 0; i < NE; ++i) ePj += x[i] * Pr[i * NE + j];
      quad += ePj * x[j];
      lin += pr[j] * x[j];
    }
    V_out[r] = quad + lin + c[b] + ex.v;

    if (DERIVS) {
      T* g = g_out + static_cast<size_t>(r) * NE;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        T Pe = T(0);
#pragma unroll
        for (int j = 0; j < NE; ++j) Pe += Pr[i * NE + j] * x[j];
        g[i] = T(2) * Pe + pr[i] + (i >= OM ? ex.g[i - OM] : T(0));
      }
      // H_eo is symmetric as computed; its PSD shift on the diagonal
      const T lmin = eigmin_sym3(ex.h);
      const T shift = -lmin < T(0) ? T(0) : -lmin;
      const int up[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
      for (int i = 0; i < NH; ++i) Pr[i] = T(2) * Pr[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Pr[(OM + i) * NE + OM + j] += ex.h[up[i][j]] + (i == j ? shift : T(0));
      }
    }
  }
  if (DERIVS) {
    __syncthreads();
    T* H = H_out + static_cast<size_t>(r0) * NH;
    for (int i = tid; i < n * NH; i += THREADS) H[i] = S[i];
  }
}

template <typename T>
int launch(const void* e, const void* P, const void* p, const void* c, const void* poly_c,
           const void* poly_pow, const void* sqrt_c, const void* sqrt_pow, const void* app,
           void* V, void* g, void* H, long long N, int B, int K1, int K2, int derivs,
           void* stream) {
  if (N <= 0) return 0;
  if (B <= 0 || N % B != 0 || K1 < 0 || K2 < 0 || K1 > MAX_TERMS || K2 > MAX_TERMS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        static_cast<const T*>(e), static_cast<const T*>(P), static_cast<const T*>(p),
        static_cast<const T*>(c), static_cast<const T*>(poly_c),
        static_cast<const int*>(poly_pow), static_cast<const T*>(sqrt_c),
        static_cast<const int*>(sqrt_pow), static_cast<const T*>(app), static_cast<T*>(V),
        static_cast<T*>(g), static_cast<T*>(H), N, B, K1, K2);
  };
  if (derivs)
    args(terminal_kernel<T, true>);
  else
    args(terminal_kernel<T, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TERMINAL_ENTRY(name, T)                                                           \
  extern "C" int name(const void* e, const void* P, const void* p, const void* c,         \
                      const void* poly_c, const void* poly_pow, const void* sqrt_c,       \
                      const void* sqrt_pow, const void* app, void* V, void* g, void* H,   \
                      long long N, int B, int K1, int K2, int derivs, void* stream) {     \
    return launch<T>(e, P, p, c, poly_c, poly_pow, sqrt_c, sqrt_pow, app, V, g, H, N, B,  \
                     K1, K2, derivs, stream);                                             \
  }

TERMINAL_ENTRY(terminal_f32, float)
TERMINAL_ENTRY(terminal_f64, double)
