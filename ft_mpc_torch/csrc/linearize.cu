// Linearization kernel: the RK4 stage map of the orbit-centre dynamics, its
// jacobians and the shooting defect, for every stage of a bank's horizon.
//
// Replaces no pallas_call: on the TPU, XLA fused `jax.jacfwd` under `jit`
// (ft_mpc_tpu/controllers/spiraling.py:_linearize).  The port's plain
// version, `torch.func.vmap(jacfwd)` (ops/linearize.py:linearize_plain),
// dispatches hundreds of small eager ops a call.  For each stage s = (b, t)
// of B scenarios and Nt stages:
//     u_gen  = u_t + rot_full_inv(q_t) u_ref_t + u_comp_b
//     f      = x_t + dt/6 (k1 + 2 k2 + 2 k3 + k4), k_i of center_dx_dt
//     A_s = df/dx_t (13x13),  B_s = df/du_t (13x6),  d_s = f - x_{t+1}
// with the plant's mass, inertia, inertia^-1 and dt read through a row
// stride that is 0 where the leaf is shared by every scenario.
//
// Bound on the H100: about equal in bytes and operations.  A stage writes
// 260 values (1040 bytes in float32) and reads its 19 inputs and x_{t+1}:
// 34.4 MB at B=2048, Nt=15, 10.3 us at 3.35 TB/s.  Forward mode needs the
// primal once and 19 tangents: 928 + 19 * 1384 = 27224 flops a stage as
// counted from this source (an FMA two), 0.84 GFLOP there, 12.5 us at 67
// TFLOP/s.  The warp computes the primal on every lane and leaves 13 lanes
// without a tangent, so it executes about 2.7x the operations counted.
// Design: one warp a stage, as jacfwd's dual numbers: lane j carries the
// primal and one tangent, the x direction j for j < 13 and the u direction
// j - 13 for j < 19 (lanes 19..31 carry a zero tangent; lane 19 stores the
// defect), so the warp runs one instruction stream with no shuffles and no
// divergence.  Each lane's column of A or B, and the defect, go to shared
// memory; the block's stages are consecutive, so their A, B and d rows are
// each one contiguous run of device memory, written by all the block's
// threads with neighbouring threads on neighbouring addresses.
// Templated over float and double: every caller runs in its own dtype.
#include "common.cuh"

namespace {

constexpr int NX = 13;
constexpr int NU = 6;
constexpr int NA = NX * NX;
constexpr int NB = NX * NU;
constexpr int WARP = 32;
constexpr int WARPS = 8;  // stages a block
constexpr int THREADS = WARPS * WARP;

template <typename T>
struct Dual {
  T v, d;  // value, tangent
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T s, Dual<T> a) {
  return {s * a.v, s * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T c) {
  return {a.v + c, a.d};
}

// The plant and scenario constants of one stage's row.
template <typename T>
struct Row {
  T ffg[NU], r[3], I[9], Iinv[9], mass;
};

// rot_matrix (ops/quaternion.py): world->body rotation of the xyzw q.
template <typename T>
__device__ __forceinline__ void rot_matrix(const Dual<T>* q, Dual<T> (&R)[9]) {
  const Dual<T> x = q[0], y = q[1], z = q[2], w = q[3];
  R[0] = x * x - y * y - z * z + w * w;
  R[1] = x * y + z * w;
  R[1] = R[1] + R[1];
  R[2] = x * z - y * w;
  R[2] = R[2] + R[2];
  R[3] = x * y - z * w;
  R[3] = R[3] + R[3];
  R[4] = -(x * x) + y * y - z * z + w * w;
  R[5] = y * z + x * w;
  R[5] = R[5] + R[5];
  R[6] = x * z + y * w;
  R[6] = R[6] + R[6];
  R[7] = y * z - x * w;
  R[7] = R[7] + R[7];
  R[8] = -(x * x) - y * y + z * z + w * w;
}

// a x b for a dual a and a constant b.
template <typename T>
__device__ __forceinline__ void cross_c(const Dual<T>* a, const T* b, Dual<T>* out) {
  out[0] = b[2] * a[1] - b[1] * a[2];
  out[1] = b[0] * a[2] - b[2] * a[0];
  out[2] = b[1] * a[0] - b[0] * a[1];
}

template <typename T>
__device__ __forceinline__ void cross(const Dual<T>* a, const Dual<T>* b, Dual<T>* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// center_dx_dt (ops/dynamics.py): [vel, dvel, domega, dq] of state c under
// the generalized command ug.
template <typename T>
__device__ __forceinline__ void center_dx_dt(const Row<T>& p, const Dual<T>* c,
                                             const Dual<T>* ug, Dual<T>* out) {
  const Dual<T>* om = c + 6;
  const Dual<T>* q = c + 9;
  Dual<T> Iw[3], gyro[3], tq[3], dom[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Iw[i] = p.I[3 * i] * om[0] + p.I[3 * i + 1] * om[1] + p.I[3 * i + 2] * om[2];
  cross(om, Iw, gyro);
#pragma unroll
  for (int i = 0; i < 3; ++i) tq[i] = ug[3 + i] + p.ffg[3 + i] - gyro[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dom[i] = p.Iinv[3 * i] * tq[0] + p.Iinv[3 * i + 1] * tq[1] + p.Iinv[3 * i + 2] * tq[2];
  Dual<T> w[3], dr[3], om_r[3], om_om_r[3];
  cross_c(dom, p.r, dr);
  cross_c(om, p.r, om_r);
  cross(om, om_r, om_om_r);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Dual<T> f = ug[i] + p.ffg[i];
    w[i] = Dual<T>{f.v / p.mass, f.d / p.mass} + dr[i] + om_om_r[i];
  }
  Dual<T> R[9];
  rot_matrix(q, R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = c[3 + i];
    out[3 + i] = R[i] * w[0] + R[3 + i] * w[1] + R[6 + i] * w[2];  // R^T w
    out[6 + i] = dom[i];
  }
  const Dual<T> x = q[0], y = q[1], z = q[2], qw = q[3];
  const Dual<T> wx = om[0], wy = om[1], wz = om[2];
  const T half = T(0.5);
  out[9] = half * (wz * y - wy * z + wx * qw);
  out[10] = half * (-(wz * x) + wx * z + wy * qw);
  out[11] = half * (wy * x - wx * y + wz * qw);
  out[12] = half * (-(wx * x) - wy * y - wz * z);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) linearize_kernel(
    const T* __restrict__ X,        // (B, Nt+1, 13)
    const T* __restrict__ U,        // (B, Nt, 6)
    const T* __restrict__ u_ref,    // (>= Nt, 6), shared
    const T* __restrict__ ffg,      // (B, 6)
    const T* __restrict__ rr,       // (B, 3)
    const T* __restrict__ u_comp,   // (B, 6)
    const T* __restrict__ mass,     // row stride sm
    const T* __restrict__ inertia,  // (3, 3), row stride si
    const T* __restrict__ inertia_inv,  // (3, 3), row stride sii
    const T* __restrict__ dt,       // row stride sd
    T* __restrict__ A_out,          // (B, Nt, 13, 13)
    T* __restrict__ B_out,          // (B, Nt, 13, 6)
    T* __restrict__ d_out,          // (B, Nt, 13)
    int sm, int si, int sii, int sd, int B, int Nt) {
  __shared__ T stA[WARPS * NA];
  __shared__ T stB[WARPS * NB];
  __shared__ T stD[WARPS * NX];
  const long long S = static_cast<long long>(B) * Nt;
  const long long s0 = static_cast<long long>(blockIdx.x) * WARPS;
  const int wid = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const long long s = s0 + wid;

  if (s < S) {
    const int b = static_cast<int>(s / Nt);
    const int t = static_cast<int>(s - static_cast<long long>(b) * Nt);
    Row<T> p;
#pragma unroll
    for (int k = 0; k < NU; ++k) p.ffg[k] = ffg[b * NU + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) p.r[k] = rr[b * 3 + k];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      p.I[k] = inertia[static_cast<size_t>(b) * si + k];
      p.Iinv[k] = inertia_inv[static_cast<size_t>(b) * sii + k];
    }
    p.mass = mass[static_cast<size_t>(b) * sm];
    const T h = dt[static_cast<size_t>(b) * sd];

    const T* xt = X + (static_cast<size_t>(b) * (Nt + 1) + t) * NX;
    Dual<T> x[NX], u[NU], ug[NU];
#pragma unroll
    for (int k = 0; k < NX; ++k) x[k] = {xt[k], T(lane == k)};
#pragma unroll
    for (int k = 0; k < NU; ++k) u[k] = {U[static_cast<size_t>(s) * NU + k], T(lane == NX + k)};

    // u_gen = u + rot_full_inv(q) u_ref_t + u_comp; the torque rows of
    // rot_full_inv are the identity's
    {
      const T* ur = u_ref + static_cast<size_t>(t) * NU;
      Dual<T> R[9];
      rot_matrix(x + 9, R);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const Dual<T> u_r = ur[0] * R[i] + ur[1] * R[3 + i] + ur[2] * R[6 + i];
        ug[i] = u[i] + u_r + u_comp[b * NU + i];
        ug[3 + i] = u[3 + i] + ur[3 + i] + u_comp[b * NU + 3 + i];
      }
    }

    // RK4 (ops/dynamics.py:rk4): sum = ((k1 + 2 k2) + 2 k3) + k4
    const T h2 = h / T(2), h6 = h / T(6), two = T(2);
    Dual<T> k[NX], xs[NX], sum[NX];
    center_dx_dt(p, x, ug, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sum[i] = k[i];
      xs[i] = x[i] + h2 * k[i];
    }
    center_dx_dt(p, xs, ug, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sum[i] = sum[i] + two * k[i];
      xs[i] = x[i] + h2 * k[i];
    }
    center_dx_dt(p, xs, ug, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sum[i] = sum[i] + two * k[i];
      xs[i] = x[i] + h * k[i];
    }
    center_dx_dt(p, xs, ug, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) sum[i] = x[i] + h6 * (sum[i] + k[i]);

    if (lane < NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) stA[wid * NA + i * NX + lane] = sum[i].d;
    } else if (lane < NX + NU) {
#pragma unroll
      for (int i = 0; i < NX; ++i) stB[wid * NB + i * NU + (lane - NX)] = sum[i].d;
    } else if (lane == NX + NU) {
      const T* xn = xt + NX;
#pragma unroll
      for (int i = 0; i < NX; ++i) stD[wid * NX + i] = sum[i].v - xn[i];
    }
  }
  __syncthreads();

  // the block's stages s0 .. s0 + n - 1 are consecutive rows of each output
  const long long left = S - s0;
  const int n = left < WARPS ? static_cast<int>(left) : WARPS;
  T* A = A_out + static_cast<size_t>(s0) * NA;
  T* Bo = B_out + static_cast<size_t>(s0) * NB;
  T* d = d_out + static_cast<size_t>(s0) * NX;
  for (int i = threadIdx.x; i < n * NA; i += THREADS) A[i] = stA[i];
  for (int i = threadIdx.x; i < n * NB; i += THREADS) Bo[i] = stB[i];
  for (int i = threadIdx.x; i < n * NX; i += THREADS) d[i] = stD[i];
}

template <typename T>
int launch(const void* X, const void* U, const void* u_ref, const void* ffg,
           const void* r, const void* u_comp, const void* mass, const void* inertia,
           const void* inertia_inv, const void* dt, void* A, void* Bm, void* d,
           int sm, int si, int sii, int sd, int B, int Nt, void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  const long long blocks = (static_cast<long long>(B) * Nt + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  linearize_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U), static_cast<const T*>(u_ref),
      static_cast<const T*>(ffg), static_cast<const T*>(r), static_cast<const T*>(u_comp),
      static_cast<const T*>(mass), static_cast<const T*>(inertia),
      static_cast<const T*>(inertia_inv), static_cast<const T*>(dt), static_cast<T*>(A),
      static_cast<T*>(Bm), static_cast<T*>(d), sm, si, sii, sd, B, Nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LINEARIZE_ENTRY(name, T)                                                        \
  extern "C" int name(const void* X, const void* U, const void* u_ref, const void* ffg, \
                      const void* r, const void* u_comp, const void* mass,              \
                      const void* inertia, const void* inertia_inv, const void* dt,     \
                      void* A, void* Bm, void* d, int sm, int si, int sii, int sd,      \
                      int B, int Nt, void* stream) {                                    \
    return launch<T>(X, U, u_ref, ffg, r, u_comp, mass, inertia, inertia_inv, dt, A,    \
                     Bm, d, sm, si, sii, sd, B, Nt, stream);                            \
  }

LINEARIZE_ENTRY(linearize_f32, float)
LINEARIZE_ENTRY(linearize_f64, double)
