// Fused BCJR pass (forward recursion, backward recursion, APP) for Hopper
// (sm_90a).
//
// K3 bcjr_kernel replaces commpy_tpu/kernels/bcjr.py bcjr_appdiff_pallas
//    (its body _bcjr_kernel): one constituent MAP pass of the turbo loop
//    over [T, R] lanes, batch last.  A lane is a frame (whole-frame
//    decoding) or a window of one (warmup-windowed and NII decoding).
//
// The Python wrapper (kernels/bcjr.py) checks shapes and types, builds the
// w-streams and the state tables, and holds the plain PyTorch version this
// kernel must match bit for bit.
//
// Layouts (row-major, contiguous):
//   w1, w2, li [T, R]  float32 or bfloat16 (io_bf16): (sy+pa)/nv, (sy-pa)/nv
//                      and the prior
//   valid      [T, R]  uint8, masked variant: 0 leaves both recursions as
//                      they were at that step
//   first      [R]     uint8, masked variant: 1 starts alpha exactly in
//                      state 0, 0 from a uniform 0 metric
//   a0, bT     [S, R]  float32, boundary variant: start alpha, final beta
//   e          [T, R]  io type: app1 - app0, the u=1 prior included
//   af, bf     [S, R]  float32, boundary variant: final alpha, and the beta
//                      after the backward pass's last step (t = 0)
//   hist       [T, S, R] float32 scratch: the pre-update alpha of each step
//
// Branch metric into state s under input u: sign[u][s] * w_{which[u][s]},
// plus li for u = 1.  Forward: cand_u = alpha[inv_nst[u][s]] + g_u[s],
// alpha' = lse2(cand_0, cand_1).  Backward: cand_u[s] = (beta + g_u)[nst[u]
// [s]], beta' = lse2(cand_0, cand_1), e[t] = reduce(al + cand_1) -
// reduce(al + cand_0), the state reduction halving contiguously (s pairs
// with s + S/2 first).  No per-step normalisation.
//
// What bounds it on an H100: at the NII bench shape (T=128, R=12288, S=4,
// f32) the function reads 19.3 MB of streams and carries and writes 6.7 MB
// of e and carries (7.8 us at 3.35 TB/s), and its exact log-sum-exps need
// ~44M exp and log1p on the special-function units (16 per SM per clock:
// ~11 us): microseconds either way.  The real limit of this design is
// the dependency chain: each of a lane's 2T steps needs the previous step's
// metrics, so the card is filled with lanes, not steps, and a step costs
// the latency of its loads and of its log-sum-exp chain.  The design does
// the simple thing first: one thread per lane, lanes adjacent in r so that
// every [T, R] load and store is coalesced; 32 lanes a block, so even
// R = 4096 spreads over 128 blocks; the S state metrics in registers
// (templated on S = 2, 4, 8, 16); the state permutations, which are data
// (the trellis tables), read through the thread's own column of shared
// memory (no barrier: no thread reads another's column); the alpha
// history in device memory (16.8 MB at T=256, R=4096; 25 MB at the NII
// shape; both under the 50 MB L2).  The time it takes is recorded in
// PERF.md.
//
// Numerics: compiled with -fmad=false, so every add and multiply rounds on
// its own, in the plain version's order; lse2 is fmaxf, fabsf, expf and
// log1pf as PyTorch's maximum, abs, exp and log1p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threads (lanes) per block
constexpr int kMaxStates = 16;
constexpr float kNeg = -1e30f;

enum { kExact = 0, kMaxLog = 1, kLinear = 2 };
enum { kPlain = 0, kMasked = 1, kBoundary = 2 };

struct Tables {
  unsigned char inv[2][kMaxStates];  // inv[u][s]: the state entering s on u
  unsigned char nst[2][kMaxStates];  // nst[u][s]: the state s leaves to on u
  unsigned int which[2];             // bit s: the branch into s reads w2
  unsigned int neg[2];               // bit s: ... and is negated
};

template <int MODE>
__device__ __forceinline__ float lse2(float x, float y) {
  const float m = fmaxf(x, y);
  if (MODE == kMaxLog) return m;
  const float d = fabsf(x - y);
  if (MODE == kLinear) return m + fmaxf(0.6931472f - 0.25f * d, 0.0f);
  return m + log1pf(expf(-d));
}

__device__ __forceinline__ float load(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// sign[u][s] * w_{which[u][s]}: a select and a negation, both exact
__device__ __forceinline__ float metric(const Tables& tb, int u, int s,
                                        float x1, float x2) {
  const float w = (tb.which[u] >> s) & 1u ? x2 : x1;
  return (tb.neg[u] >> s) & 1u ? -w : w;
}

template <int S, int MODE, int VARIANT>
__global__ void __launch_bounds__(kLanes)
bcjr_kernel(const void* __restrict__ w1, const void* __restrict__ w2,
            const void* __restrict__ li, const uint8_t* __restrict__ valid,
            const uint8_t* __restrict__ first, const float* __restrict__ a0,
            const float* __restrict__ bT, void* __restrict__ e,
            float* __restrict__ af, float* __restrict__ bf,
            float* __restrict__ hist, int T, int R, int io_bf16,
            Tables tb) {
  // col[k][lane]: this lane's metrics, re-read through a table index
  __shared__ float col[2 * S][kLanes];
  const int lane = threadIdx.x;
  const int r = blockIdx.x * kLanes + lane;
  if (r >= R) return;  // no barrier follows, so idle lanes may leave
  const bool bf16 = io_bf16 != 0;

  float a[S];
  if (VARIANT == kBoundary) {
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a0[(size_t)s * R + r];
  } else {
    const bool exact = VARIANT == kPlain || first[r] != 0;
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = (s > 0 && exact) ? kNeg : 0.0f;
  }

  // ---- forward: store the pre-update metrics, then step ----
  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)t * R + r;
    const float x1 = load(w1, row, bf16);
    const float x2 = load(w2, row, bf16);
    const float l = load(li, row, bf16);
    float* h = hist + (size_t)t * S * R + r;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      h[(size_t)s * R] = a[s];
      col[s][lane] = a[s];
    }
    float na[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float g0 = metric(tb, 0, s, x1, x2);
      const float g1 = metric(tb, 1, s, x1, x2) + l;
      na[s] = lse2<MODE>(col[tb.inv[0][s]][lane] + g0,
                         col[tb.inv[1][s]][lane] + g1);
    }
    if (VARIANT != kMasked || valid[row] != 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] = na[s];
    }
  }
  if (VARIANT == kBoundary) {
#pragma unroll
    for (int s = 0; s < S; ++s) af[(size_t)s * R + r] = a[s];
  }

  // ---- backward: emit e[t] from the stored alpha, then step ----
  float b[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b[s] = VARIANT == kBoundary ? bT[(size_t)s * R + r] : 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = (size_t)t * R + r;
    const float x1 = load(w1, row, bf16);
    const float x2 = load(w2, row, bf16);
    const float l = load(li, row, bf16);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      col[s][lane] = b[s] + metric(tb, 0, s, x1, x2);
      col[S + s][lane] = b[s] + (metric(tb, 1, s, x1, x2) + l);
    }
    const float* h = hist + (size_t)t * S * R + r;
    float nb[S], p0[S], p1[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float c0 = col[tb.nst[0][s]][lane];
      const float c1 = col[S + tb.nst[1][s]][lane];
      nb[s] = lse2<MODE>(c0, c1);
      const float al = h[(size_t)s * R];
      p0[s] = al + c0;
      p1[s] = al + c1;
    }
#pragma unroll
    for (int half = S / 2; half >= 1; half /= 2) {
#pragma unroll
      for (int s = 0; s < half; ++s) {
        p0[s] = lse2<MODE>(p0[s], p0[s + half]);
        p1[s] = lse2<MODE>(p1[s], p1[s + half]);
      }
    }
    store(e, row, p1[0] - p0[0], bf16);
    if (VARIANT != kMasked || valid[row] != 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) b[s] = nb[s];
    }
  }
  if (VARIANT == kBoundary) {
#pragma unroll
    for (int s = 0; s < S; ++s) bf[(size_t)s * R + r] = b[s];
  }
}

template <int S, int MODE>
cudaError_t launch_mode(int variant, dim3 grid, cudaStream_t stream,
                        const void* w1, const void* w2, const void* li,
                        const uint8_t* valid, const uint8_t* first,
                        const float* a0, const float* bT, void* e, float* af,
                        float* bf, float* hist, int T, int R, int io_bf16,
                        const Tables& tb) {
  switch (variant) {
    case kPlain:
      bcjr_kernel<S, MODE, kPlain><<<grid, kLanes, 0, stream>>>(
          w1, w2, li, valid, first, a0, bT, e, af, bf, hist, T, R, io_bf16,
          tb);
      break;
    case kMasked:
      bcjr_kernel<S, MODE, kMasked><<<grid, kLanes, 0, stream>>>(
          w1, w2, li, valid, first, a0, bT, e, af, bf, hist, T, R, io_bf16,
          tb);
      break;
    case kBoundary:
      bcjr_kernel<S, MODE, kBoundary><<<grid, kLanes, 0, stream>>>(
          w1, w2, li, valid, first, a0, bT, e, af, bf, hist, T, R, io_bf16,
          tb);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_states(int mode, int variant, dim3 grid,
                          cudaStream_t stream, const void* w1, const void* w2,
                          const void* li, const uint8_t* valid,
                          const uint8_t* first, const float* a0,
                          const float* bT, void* e, float* af, float* bf,
                          float* hist, int T, int R, int io_bf16,
                          const Tables& tb) {
  switch (mode) {
    case kExact:
      return launch_mode<S, kExact>(variant, grid, stream, w1, w2, li, valid,
                                    first, a0, bT, e, af, bf, hist, T, R,
                                    io_bf16, tb);
    case kMaxLog:
      return launch_mode<S, kMaxLog>(variant, grid, stream, w1, w2, li, valid,
                                     first, a0, bT, e, af, bf, hist, T, R,
                                     io_bf16, tb);
    case kLinear:
      return launch_mode<S, kLinear>(variant, grid, stream, w1, w2, li, valid,
                                     first, a0, bT, e, af, bf, hist, T, R,
                                     io_bf16, tb);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// inv and nst are [2][S] host arrays (input-major); which and neg hold one
// bit per destination state for each input.
extern "C" int bcjr_launch(const void* w1, const void* w2, const void* li,
                           const uint8_t* valid, const uint8_t* first,
                           const float* a0, const float* bT, void* e,
                           float* af, float* bf, float* hist, int T, int R,
                           int S, int mode, int variant, int io_bf16,
                           const int* inv, const int* nst, unsigned which0,
                           unsigned which1, unsigned neg0, unsigned neg1,
                           void* stream) {
  if (S < 2 || S > kMaxStates || (S & (S - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  Tables tb = {};
  for (int u = 0; u < 2; ++u) {
    for (int s = 0; s < S; ++s) {
      tb.inv[u][s] = (unsigned char)inv[u * S + s];
      tb.nst[u][s] = (unsigned char)nst[u * S + s];
    }
  }
  tb.which[0] = which0;
  tb.which[1] = which1;
  tb.neg[0] = neg0;
  tb.neg[1] = neg1;
  const dim3 grid((R + kLanes - 1) / kLanes);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (S) {
    case 2:
      err = launch_states<2>(mode, variant, grid, st, w1, w2, li, valid,
                             first, a0, bT, e, af, bf, hist, T, R, io_bf16,
                             tb);
      break;
    case 4:
      err = launch_states<4>(mode, variant, grid, st, w1, w2, li, valid,
                             first, a0, bT, e, af, bf, hist, T, R, io_bf16,
                             tb);
      break;
    case 8:
      err = launch_states<8>(mode, variant, grid, st, w1, w2, li, valid,
                             first, a0, bT, e, af, bf, hist, T, R, io_bf16,
                             tb);
      break;
    default:
      err = launch_states<16>(mode, variant, grid, st, w1, w2, li, valid,
                              first, a0, bT, e, af, bf, hist, T, R, io_bf16,
                              tb);
      break;
  }
  return (int)err;
}
