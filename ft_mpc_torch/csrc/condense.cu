// Condensing kernel: prediction matrices of the condensed MPC QP.
//
// Replaces ft_mpc_tpu/solvers/lanes_condense.py:_condense_kernel (wrapper
// condense_lanes).  For each scenario b and stage t = 0..Nt-1:
//     S_t   = A_t S_{t-1},  then  S_t[:, 6t:6t+6] += B_t
//     phi_t = A_t phi_{t-1} + d_t
// with S_{-1} = 0, phi_{-1} = 0; S_t is (13, 6 Nt), all float32.
//
// Bound on the H100: device-memory bytes.  The kernel writes S_all,
// B * Nt * 13 * 6Nt floats (144 MB at B=2048, Nt=15), against ~0.9 GFLOP
// of FMAs: ~43 us of HBM traffic at 3.35 TB/s versus ~14 us of fp32 math.
// Design: one block per scenario; the 13 x 6Nt carry lives in shared
// memory, double-buffered across stages, so it never round-trips through
// HBM (the TPU kernel kept it in VMEM for the same reason).  Threads cover
// the 13 * 6Nt entries in row-major order, so every S_t store is
// coalesced along the 6Nt column axis and HBM sees each output byte once.
#include "common.cuh"

namespace {

constexpr int NX = 13;
constexpr int NU = 6;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) condense_kernel(
    const float* __restrict__ A,    // (B, Nt, 13, 13)
    const float* __restrict__ Bm,   // (B, Nt, 13, 6)
    const float* __restrict__ d,    // (B, Nt, 13)
    float* __restrict__ S_out,      // (B, Nt, 13, 6Nt)
    float* __restrict__ phi_out,    // (B, Nt, 13)
    int Nt) {
  extern __shared__ float smem[];
  const int n = Nt * NU;
  const int sz = NX * n;
  float* Sa = smem;          // carry, buffer 0
  float* Sb = Sa + sz;       // carry, buffer 1
  float* As = Sb + sz;       // A_t
  float* Bs = As + NX * NX;  // B_t
  float* pa = Bs + NX * NU;  // phi carry, buffer 0
  float* pb = pa + NX;       // phi carry, buffer 1
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < sz; i += blockDim.x) Sa[i] = 0.f;
  if (tid < NX) pa[tid] = 0.f;
  float* Sp = Sa;
  float* Sn = Sb;
  float* pp = pa;
  float* pn = pb;

  for (int t = 0; t < Nt; ++t) {
    const size_t st = static_cast<size_t>(b) * Nt + t;
    for (int i = tid; i < NX * NX; i += blockDim.x) As[i] = A[st * NX * NX + i];
    for (int i = tid; i < NX * NU; i += blockDim.x) Bs[i] = Bm[st * NX * NU + i];
    __syncthreads();  // A_t/B_t loaded; previous stage's carry complete

    const int c0 = t * NU;
    for (int idx = tid; idx < sz; idx += blockDim.x) {
      const int i = idx / n;
      const int c = idx - i * n;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += As[i * NX + k] * Sp[k * n + c];
      if (c >= c0 && c < c0 + NU) acc += Bs[i * NU + (c - c0)];
      Sn[idx] = acc;
      S_out[st * sz + idx] = acc;
    }
    if (tid < NX) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += As[tid * NX + k] * pp[k];
      acc += d[st * NX + tid];
      pn[tid] = acc;
      phi_out[st * NX + tid] = acc;
    }
    __syncthreads();  // carry written before the next stage reads it
    float* tmp = Sp; Sp = Sn; Sn = tmp;
    tmp = pp; pp = pn; pn = tmp;
  }
}

}  // namespace

extern "C" int condense_f32(const void* A, const void* Bm, const void* d,
                            void* S_out, void* phi_out, int B, int Nt,
                            void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  const int n = Nt * NU;
  const size_t smem = sizeof(float) * (2 * NX * n + NX * NX + NX * NU + 2 * NX);
  cudaError_t err = ftmpc_allow_smem(condense_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  condense_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(d), static_cast<float*>(S_out),
      static_cast<float*>(phi_out), Nt);
  return static_cast<int>(cudaGetLastError());
}
