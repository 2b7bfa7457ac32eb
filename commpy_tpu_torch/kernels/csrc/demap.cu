// K6: the joint soft demapper (exact LLR and max-log) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the demapper to XLA
// (commpy_tpu/ops/modem.py:258-259, two jax.nn.logsumexp over the masked
// [..., n_sym, bps, m] log-weights).  The port's plain version
// (commpy_tpu_torch/ops/modem.py:_demodulate_joint) writes and re-reads
// several [..., n_sym, bps, m] float32 intermediates in ~20 launches; this
// kernel keeps all of them in registers.
//
// One thread a symbol.  It reads the symbol as 8 bytes (complex64 as
// float2), forms the m log-weights
//     logw[c] = -((yr - cr)^2 + (yi - ci)^2) / nv
// in registers, and for each output bit p takes the log-sum-exp (or, with
// MAXLOG, the maximum) over the points whose label bit bps-1-p is 1 and
// over those where it is 0, and writes the bps float32 LLRs, one minus the
// other (one 16-byte store a thread at 16-QAM).  The constellation rides in
// the kernel's parameters (m float2 of constant bank), the noise variance
// as a value or as a pointer read with stride 0 or 1.  Nothing else touches
// device memory, and a call is one launch.
//
// What bounds it on an H100: a 16-QAM symbol moves 24 bytes (8 in, 16
// out) and needs 64 exp and 8 log on the special-function units (16 a clock
// an SM) beside ~300 other float operations.  For the 5.5M symbols of a BCC
// benchmark step that is 0.04 ms of bytes at 3.35 TB/s against 0.095 ms of
// exp and log: it is bound by operations.  So the design spends no
// instruction on data movement beyond one load and one store a thread, and
// keeps m, bps and the mode compile-time so that every loop, the sum tree's
// included, unrolls into straight-line code (a tree left as a loop indexed
// its array at run time, in predicated moves, and ran 2.3x slower).
//
// Numerics, bit for bit with the plain version on the card:
// * distances and division as the plain path orders them: __fsub_rn,
//   __fmul_rn, __fadd_rn, a negation and __fdiv_rn (true division; PyTorch
//   multiplies by a reciprocal only for a host scalar divisor, which the
//   plain path avoids), and the file is built with -fmad=false;
// * torch.logsumexp: the maximum of the half (a NaN wins, as in amax), a
//   maximum of +-inf replaced by 0, expf(x - max), the sum, logf(sum) +
//   max; then one - zero;
// * the sum in the order of torch.sum's CUDA reduction over a last axis of
//   m <= 64 elements (ATen/native/cuda/Reduce.cuh: block_width min(m, 32)
//   lanes, one element a lane, a lane's two elements added first at m =
//   64, then warp shuffles at offsets halving from block_width / 2 to 1):
//   the tree adds element k and k + o for o = m/2, m/4, ..., 1.  The
//   plain path's masked terms are exp(-inf) = +0; here they are -0.0, the
//   exact identity of addition (the compiler drops those adds), and every
//   kept term is >= +0 or NaN, so every partial sum is the plain one's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int M>
struct Points {
  float re[M];
  float im[M];
};

// torch.amax's combine (MaxNanFunctor: a NaN wins) in one instruction.
// Where it may differ, max(-0, +0), cannot arise: a half's log-weights are
// -d / nv with d >= +0, so its zeros all have the sign of -nv.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One level of the sum tree, e[k] += e[k + O] for k < O, then the next:
// with O a template parameter every level unrolls into straight-line adds.
template <int O, int M>
__device__ __forceinline__ void sum_tree(float (&e)[M]) {
#pragma unroll
  for (int k = 0; k < O; ++k) e[k] = e[k] + e[k + O];
  if constexpr (O > 1) sum_tree<O / 2>(e);
}

template <int BPS>
__device__ __forceinline__ void store_llrs(float* __restrict__ llr,
                                           int64_t i, const float (&v)[BPS]) {
  if constexpr (BPS % 4 == 0) {
    float4* o = reinterpret_cast<float4*>(llr + i * BPS);
#pragma unroll
    for (int q = 0; q < BPS / 4; ++q)
      o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (BPS % 2 == 0) {
    float2* o = reinterpret_cast<float2*>(llr + i * BPS);
#pragma unroll
    for (int q = 0; q < BPS / 2; ++q) o[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < BPS; ++q) llr[i * BPS + q] = v[q];
  }
}

template <int M, int BPS, bool MAXLOG>
__global__ void __launch_bounds__(kThreads) demap_joint_kernel(
    const float2* __restrict__ y, float* __restrict__ llr, int64_t n,
    const Points<M> pts, float nv_value, const float* __restrict__ nv,
    int64_t nv_stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 s = y[i];
  const float v = nv ? nv[i * nv_stride] : nv_value;
  float logw[M];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const float dr = __fsub_rn(s.x, pts.re[c]);
    const float di = __fsub_rn(s.y, pts.im[c]);
    logw[c] = __fdiv_rn(-__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)), v);
  }
  float out[BPS];
#pragma unroll
  for (int p = 0; p < BPS; ++p) {
    const int bit = BPS - 1 - p;
    float half[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < M; ++c)
        if (((c >> bit) & 1) == h) mx = max_nan(mx, logw[c]);
      if constexpr (MAXLOG) {
        half[h] = mx;
      } else {
        if (fabsf(mx) == INFINITY) mx = 0.f;
        float e[M];
#pragma unroll
        for (int c = 0; c < M; ++c)
          e[c] = ((c >> bit) & 1) == h ? expf(__fsub_rn(logw[c], mx)) : -0.f;
        sum_tree<M / 2>(e);
        half[h] = __fadd_rn(logf(e[0]), mx);
      }
    }
    out[p] = __fsub_rn(half[1], half[0]);
  }
  store_llrs<BPS>(llr, i, out);
}

template <int M, int BPS>
int launch(const void* y, void* llr, int64_t n, int maxlog,
           const float* points, float nv_value, const float* nv,
           int64_t nv_stride, cudaStream_t stream) {
  Points<M> pts;
  for (int c = 0; c < M; ++c) {
    pts.re[c] = points[2 * c];
    pts.im[c] = points[2 * c + 1];
  }
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const float2* yy = static_cast<const float2*>(y);
  float* out = static_cast<float*>(llr);
  if (maxlog)
    demap_joint_kernel<M, BPS, true><<<grid, kThreads, 0, stream>>>(
        yy, out, n, pts, nv_value, nv, nv_stride);
  else
    demap_joint_kernel<M, BPS, false><<<grid, kThreads, 0, stream>>>(
        yy, out, n, pts, nv_value, nv, nv_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: n complex64 symbols (contiguous); llr: n * log2(m) float32; points: the
// m constellation points on the host, interleaved (re, im) float32; nv: a
// device pointer read at i * nv_stride (stride 0: one value), or null for
// nv_value.  Returns the CUDA error of the launch (0 on success).
extern "C" int demap_joint_launch(const void* y, void* llr, long long n,
                                  int m, int maxlog, const float* points,
                                  float nv_value, const float* nv,
                                  long long nv_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 2: return launch<2, 1>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
    case 4: return launch<4, 2>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
    case 8: return launch<8, 3>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
    case 16: return launch<16, 4>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
    case 32: return launch<32, 5>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
    case 64: return launch<64, 6>(y, llr, n, maxlog, points, nv_value, nv, nv_stride, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
