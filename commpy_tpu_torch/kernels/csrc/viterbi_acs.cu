// Viterbi forward pass (ACS) and sliding-window traceback for Hopper (sm_90a).
//
// K1 acs_forward_kernel replaces commpy_tpu/kernels/viterbi_acs.py
//    acs_forward_pallas (its bodies _acs_kernel / _acs_kernel_fused).
// K2 traceback_kernel replaces commpy_tpu/kernels/viterbi_acs.py
//    traceback_pallas (_traceback_kernel).
//
// Both take binary-input, shift-structured trellises only: the j-th
// predecessor of state s is ((s & (S/2-1)) << 1) | j and the input bit that
// enters s is its MSB.  The Python wrappers (kernels/viterbi_acs.py) check
// shapes and types and hold the plain PyTorch versions these kernels must
// match bit for bit.
//
// Layouts (row-major, contiguous):
//   r      [B, T, n]  float32 received words (soft LLRs clipped, padded)
//   C      [2, S, n]  float32 branch vectors, bm(j, s) = r_t . C[j, s]
//   hconst [2, S]     float32 per-branch constant of the hard metric, or null
//   dec    [B, T, G]  int32, G = ceil(S/32): bit s%32 of word s/32 is 1 iff
//                     state s took branch 1 at step t
//   best   [B, T]     int32 first-index argmin state after step t
//   bits   [B, T]     int8 decoded bit of each position (caller slices to L)
//
// What bounds them on an H100: at the 802.11 MCS-4 shape (B=2048, T=1205,
// S=64, n=2) K1 must move ~49 MB (r in, decisions and best states out) and
// K2 ~32 MB, i.e. 15 us and 10 us at 3.35 TB/s.  The real limit is the
// dependency chain: each of K1's T steps needs the previous step's path
// metrics, so one block walks one frame through all T steps and the card is
// filled with frames, not with steps.  This first version is written for
// exactness; the time it takes is recorded in PERF.md.
//
// Numerics: the file is compiled with -fmad=false so every add and multiply
// rounds on its own, in the same order as the plain version.  Path metrics
// start at 0 for state 0 and 3.0e37 elsewhere (the XLA core's inf after
// nan_to_num) and are renormalised by the per-step minimum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;         // widest codeword K1 takes
constexpr int kChunk = 32;       // received steps staged in shared memory
constexpr float kUnreached = 3.0e37f;
constexpr size_t kMaxStagedBytes = 200 * 1024;  // K2 staging limit per frame

// One block walks F = max(1, 32/S) frames through all T steps with one
// thread per (frame, state).  Path metrics live in shared memory, double
// buffered by step parity.  A thread stores its UN-renormalised metric v
// and the next step subtracts the step minimum m when it reads it, which
// gives exactly the plain version's ((v - m) + bm) while needing only one
// barrier per step.
__global__ void __launch_bounds__(1024)
acs_forward_kernel(const float* __restrict__ r, const float* __restrict__ C,
                   const float* __restrict__ hconst, int32_t* __restrict__ dec,
                   int32_t* __restrict__ best, int B, int T, int n, int S,
                   int G) {
  extern __shared__ float smem[];
  const int nth = blockDim.x;  // F * S, a multiple of 32
  const int F = nth / S;
  const int nwarps = nth >> 5;
  const int tid = threadIdx.x;
  const int f = tid / S;
  const int s = tid - f * S;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x * F + f;

  float* pm = smem;                                  // [2][nth]
  float* part_v = pm + 2 * nth;                      // [2][nwarps]
  int* part_i = reinterpret_cast<int*>(part_v + 2 * nwarps);  // [2][nwarps]
  float* rs = reinterpret_cast<float*>(part_i + 2 * nwarps);  // [F][kChunk][n]

  float c0[kMaxN], c1[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    c0[i] = i < n ? C[s * n + i] : 0.f;
    c1[i] = i < n ? C[(S + s) * n + i] : 0.f;
  }
  const bool hard = hconst != nullptr;
  const float h0 = hard ? hconst[s] : 0.f;
  const float h1 = hard ? hconst[S + s] : 0.f;
  const int p0 = (s & (S / 2 - 1)) << 1;
  const int p1 = p0 | 1;
  const int width = S < 32 ? S : 32;  // lanes that hold one frame
  const unsigned frame_bits = S < 32 ? ((1u << S) - 1u) : 0xffffffffu;

  pm[tid] = s == 0 ? 0.f : kUnreached;
  float m = 0.f;  // minimum of the previous step

  for (int t = 0; t < T; ++t) {
    const int tc = t % kChunk;
    if (tc == 0) {
      // every read of the previous chunk happened before the last barrier
      const int steps = min(kChunk, T - t);
      for (int idx = tid; idx < F * steps * n; idx += nth) {
        const int ff = idx / (steps * n);
        const int rem = idx - ff * steps * n;
        const int bb = blockIdx.x * F + ff;
        rs[ff * kChunk * n + rem] =
            bb < B ? r[((size_t)bb * T + t) * n + rem] : 0.f;
      }
      __syncthreads();
    }
    const float* rt = rs + (f * kChunk + tc) * n;
    float bm0 = rt[0] * c0[0];
    float bm1 = rt[0] * c1[0];
#pragma unroll
    for (int i = 1; i < kMaxN; ++i) {
      if (i < n) {
        bm0 = bm0 + rt[i] * c0[i];
        bm1 = bm1 + rt[i] * c1[i];
      }
    }
    if (hard) {
      bm0 = bm0 + h0;
      bm1 = bm1 + h1;
    }
    const float* prev = pm + (t & 1) * nth + f * S;
    const float cand0 = (prev[p0] - m) + bm0;
    const float cand1 = (prev[p1] - m) + bm1;
    const bool take = cand1 < cand0;  // ties keep branch 0
    const float v = take ? cand1 : cand0;
    pm[((t + 1) & 1) * nth + tid] = v;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);

    // (value, state) minimum over the frame; equal values keep the lower
    // state, as a first-index argmin does
    float mv = v;
    int mi = s;
    for (int off = width >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, mv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (ov < mv || (ov == mv && oi < mi)) {
        mv = ov;
        mi = oi;
      }
    }
    if (nwarps > 1) {
      float* pv = part_v + (t & 1) * nwarps;
      int* pi = part_i + (t & 1) * nwarps;
      if (lane == 0) {
        pv[warp] = mv;
        pi[warp] = mi;
      }
      __syncthreads();
      mv = pv[0];
      mi = pi[0];
      for (int w = 1; w < nwarps; ++w) {
        if (pv[w] < mv) {  // warps in state order: strict < keeps the first
          mv = pv[w];
          mi = pi[w];
        }
      }
    } else {
      __syncthreads();
    }
    m = mv;

    if (b < B) {
      const size_t row = (size_t)b * T + t;
      if (S >= 32) {
        if (lane == 0) dec[row * G + warp] = (int32_t)ballot;
      } else if (s == 0) {
        dec[row] = (int32_t)((ballot >> (f * S)) & frame_bits);
      }
      if (s == 0) best[row] = mi;
    }
  }
}

// One block per frame; the frame's packed decisions are staged in shared
// memory (T*G*4 bytes: 9.6 KB at T=1205, S=64) when they fit.  Thread p
// decodes position p: the window that finalises it ends at
// w = min(p + tb_depth - 2, T - 1) (the reference schedule,
// ops/viterbi.py:29-38 of the JAX package), walks w - p steps back from
// best[w] and emits the MSB of the state it reaches.
__global__ void traceback_kernel(const int32_t* __restrict__ dec,
                                 const int32_t* __restrict__ best,
                                 int8_t* __restrict__ out, int T, int G, int S,
                                 int msb, int tb_depth, int staged) {
  extern __shared__ int32_t sdec[];
  const int b = blockIdx.x;
  const int32_t* d = dec + (size_t)b * T * G;
  if (staged) {
    for (int i = threadIdx.x; i < T * G; i += blockDim.x) sdec[i] = d[i];
    __syncthreads();
    d = sdec;
  }
  const int half = S / 2 - 1;
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const int w = min(p + tb_depth - 2, T - 1);
    int cur = best[(size_t)b * T + w];
    for (int t = w; t > p; --t) {
      const unsigned word = (unsigned)d[t * G + (cur >> 5)];
      const int j = (int)((word >> (cur & 31)) & 1u);
      cur = ((cur & half) << 1) | j;
    }
    out[(size_t)b * T + p] = (int8_t)(cur >> msb);
  }
}

}  // namespace

extern "C" int acs_forward_launch(const float* r, const float* C,
                                  const float* hconst, int32_t* dec,
                                  int32_t* best, int B, int T, int n, int S,
                                  int G, void* stream) {
  const int nth = S < 32 ? 32 : S;
  const int F = nth / S;
  const int nwarps = nth / 32;
  const size_t smem = sizeof(float) * (2 * nth + 2 * nwarps) +
                      sizeof(int) * 2 * nwarps +
                      sizeof(float) * F * kChunk * n;
  const int grid = (B + F - 1) / F;
  acs_forward_kernel<<<grid, nth, smem, (cudaStream_t)stream>>>(
      r, C, hconst, dec, best, B, T, n, S, G);
  return (int)cudaGetLastError();
}

extern "C" int traceback_launch(const int32_t* dec, const int32_t* best,
                                int8_t* out, int B, int T, int G, int S,
                                int tb_depth, void* stream) {
  int msb = 0;  // log2(S) - 1
  while ((2 << msb) < S) ++msb;
  const size_t bytes = (size_t)T * G * sizeof(int32_t);
  const int staged = bytes <= kMaxStagedBytes;
  if (staged && bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  traceback_kernel<<<B, 256, staged ? bytes : 0, (cudaStream_t)stream>>>(
      dec, best, out, T, G, S, msb, tb_depth, staged);
  return (int)cudaGetLastError();
}
