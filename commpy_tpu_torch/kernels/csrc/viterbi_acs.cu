// Viterbi forward pass (ACS) and sliding-window traceback for Hopper (sm_90a).
//
// K1 replaces commpy_tpu/kernels/viterbi_acs.py acs_forward_pallas (its
//    bodies _acs_kernel / _acs_kernel_fused) with two layouts, picked by
//    the launch plan kernels/viterbi_acs.py:acs_plan:
//      acs_warp_kernel   S <= 64: a warp walks 64/S frames (one at S = 64);
//      acs_forward_kernel S >= 128: a block of S threads walks one frame.
// K2 traceback_kernel replaces commpy_tpu/kernels/viterbi_acs.py
//    traceback_pallas (_traceback_kernel): a warp a frame, a lane four
//    positions side by side, a back-step one 4-byte read issued five steps
//    ahead and three integer instructions.
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
// K2 ~32 MB, i.e. 15 us and 10 us at 3.35 TB/s, and K1 does ~5 float
// operations a state-step, 25 us at the FMA peak's instruction rate.  The
// real limit is the dependency chain: each of K1's T steps needs the
// previous step's path metrics, so the card is filled with frames, not
// with steps, and a step must cost few instructions and no block barrier.
//
// acs_warp_kernel: lane l of a frame's S/2 lanes owns butterfly l, which
// reads predecessors 2l and 2l+1 and writes states l and l + S/2, so a
// step is two add-compare-selects from the same two old metrics; four
// shuffles hand the new metrics on.  The step minimum is a redux.sync
// (or a shuffle tree below 32 lanes) over the order-preserving 32-bit key
// of the float; no index is formed on the chain: lane 0 puts step t's
// decision ballots and the ballots of (metric == minimum) in a 32-step
// ring in shared memory, and at the end of each chunk lane t%32 turns
// step t's ballots into the
// packed decision words and the first-index best state (lower states
// first, as torch.argmin breaks ties), and the warp stores 32 rows at
// once.  r is staged a chunk ahead with cp.async into warp-private shared
// memory.  No block barrier: the warps of a block are independent.
//
// Numerics: the file is compiled with -fmad=false so every add and multiply
// rounds on its own, in the same order as the plain version.  Path metrics
// start at 0 for state 0 and 3.0e37 elsewhere (the XLA core's inf after
// nan_to_num) and are renormalised by the per-step minimum: each kernel
// keeps the UN-renormalised metric v and forms ((v - m) + bm) from the
// previous step's minimum m, exactly the plain version's
// ((pm - amin) + bm).  No metric is ever -0.0 (x - x is +0.0, and a sum
// is -0.0 only when both terms are), so the key's -0.0 < +0.0 order never
// decides a minimum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;         // widest codeword K1 takes
constexpr int kChunk = 32;       // received steps staged in shared memory
constexpr float kUnreached = 3.0e37f;

// One block walks F = max(1, 32/S) frames through all T steps with one
// thread per (frame, state); the plan's block layout launches it for
// S >= 128 only (F = 1).  Path metrics live in shared memory, double
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpBlockMax = 128;  // threads of an acs_warp_kernel block

// Order-preserving 32-bit key of a float (unsigned order = float order,
// -0.0 below +0.0) and its inverse.
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float(k ^ (~(unsigned)((int)k >> 31) | 0x80000000u));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Bring the received words of steps t0 .. t0+31 (or to T) of the warp's
// frames b0 .. b0+F-1 into dst [F][32*N + 1] (padded: the frames' reads
// of one step fall in different banks), one cp.async group.
template <int N>
__device__ __forceinline__ void stage_chunk(float* dst, const float* r,
                                            int b0, int F, int B, int T,
                                            int t0, int lane) {
  const int cnt = min(kChunk, T - t0) * N;
  for (int f = 0; f < F && b0 + f < B; ++f) {
    const float* src = r + ((size_t)(b0 + f) * T + t0) * N;
    for (int e = lane; e < cnt; e += 32) {
      cp_async4(dst + f * (kChunk * N + 1) + e, src + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Floats of one warp's shared memory: the ballot ring [32] of uint4 (a
// step's decision and equality ballots, lo and hi), then two slots of
// staged r [2][F][32*n + 1], rounded up to 16 bytes.
__host__ __device__ constexpr int warp_smem_floats(int S, int n) {
  return 4 * kChunk + (2 * (64 / S) * (kChunk * n + 1) + 3) / 4 * 4;
}

// A warp walks F = 64/S frames through all T steps (S <= 64); lane l of
// frame g (lanes g*W .. g*W+W-1, W = S/2) owns butterfly l: predecessors
// 2l and 2l+1, new states l ("lo") and l + W ("hi").
template <int N, bool HARD>
__global__ void __launch_bounds__(kWarpBlockMax)
acs_warp_kernel(const float* __restrict__ r, const float* __restrict__ C,
                const float* __restrict__ hconst, int32_t* __restrict__ dec,
                int32_t* __restrict__ best, int B, int T, int S) {
  extern __shared__ float smem[];
  constexpr int kStride = kChunk * N + 1;
  const int lane = threadIdx.x & 31;
  const int W = S >> 1;
  const int F = 32 / W;
  const int g = lane / W;
  const int l = lane & (W - 1);
  const int b0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * F;
  if (b0 >= B) return;  // the whole warp
  float* wsm = smem + (threadIdx.x >> 5) * warp_smem_floats(S, N);
  uint4* ring = reinterpret_cast<uint4*>(wsm);
  float* rs = wsm + 4 * kChunk;

  float c0l[N], c1l[N], c0h[N], c1h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c0l[i] = C[l * N + i];
    c1l[i] = C[(S + l) * N + i];
    c0h[i] = C[(W + l) * N + i];
    c1h[i] = C[(S + W + l) * N + i];
  }
  float h0l = 0.f, h1l = 0.f, h0h = 0.f, h1h = 0.f;
  if (HARD) {
    h0l = hconst[l];
    h1l = hconst[S + l];
    h0h = hconst[W + l];
    h1h = hconst[S + W + l];
  }
  // predecessor 2l is lo of lane 2l (2l < W) or hi of lane 2l - W; 2l+1
  // likewise (at W = 1 the two differ: lo and hi of the frame's lane)
  const int src_a = g * W + ((2 * l) & (W - 1));
  const int src_b = g * W + ((2 * l + 1) & (W - 1));
  const bool a_hi = 2 * l >= W;
  const bool b_hi = 2 * l + 1 >= W;
  const unsigned gmask = W == 32 ? kFull : (1u << W) - 1u;

  float vlo = l == 0 ? 0.f : kUnreached;
  float vhi = kUnreached;
  float m = 0.f;  // minimum of the previous step

  stage_chunk<N>(rs, r, b0, F, B, T, 0, lane);
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int buf = (t0 / kChunk) & 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();  // the chunk landed, and every read of the other slot ended
    if (t0 + kChunk < T) {
      stage_chunk<N>(rs + (buf ^ 1) * F * kStride, r, b0, F, B, T,
                     t0 + kChunk, lane);
    }
    const float* rf = rs + buf * F * kStride + g * kStride;
    const int steps = min(kChunk, T - t0);
    for (int tc = 0; tc < steps; ++tc) {
      float rr[N];
#pragma unroll
      for (int i = 0; i < N; ++i) rr[i] = rf[tc * N + i];
      const float alo = __shfl_sync(kFull, vlo, src_a);
      const float ahi = __shfl_sync(kFull, vhi, src_a);
      const float blo = __shfl_sync(kFull, vlo, src_b);
      const float bhi = __shfl_sync(kFull, vhi, src_b);
      const float x0 = (a_hi ? ahi : alo) - m;
      const float x1 = (b_hi ? bhi : blo) - m;
      float m0l = rr[0] * c0l[0], m1l = rr[0] * c1l[0];
      float m0h = rr[0] * c0h[0], m1h = rr[0] * c1h[0];
#pragma unroll
      for (int i = 1; i < N; ++i) {
        m0l = m0l + rr[i] * c0l[i];
        m1l = m1l + rr[i] * c1l[i];
        m0h = m0h + rr[i] * c0h[i];
        m1h = m1h + rr[i] * c1h[i];
      }
      if (HARD) {
        m0l = m0l + h0l;
        m1l = m1l + h1l;
        m0h = m0h + h0h;
        m1h = m1h + h1h;
      }
      const float k0l = x0 + m0l, k1l = x1 + m1l;
      const float k0h = x0 + m0h, k1h = x1 + m1h;
      const bool tl = k1l < k0l;  // ties keep branch 0
      const bool th = k1h < k0h;
      vlo = tl ? k1l : k0l;
      vhi = th ? k1h : k0h;
      const unsigned bl = __ballot_sync(kFull, tl);
      const unsigned bh = __ballot_sync(kFull, th);
      unsigned key = min(float_key(vlo), float_key(vhi));
      if (W == 32) {
        key = __reduce_min_sync(kFull, key);
      } else {
        for (int off = W >> 1; off > 0; off >>= 1) {
          key = min(key, __shfl_xor_sync(kFull, key, off));
        }
      }
      m = key_float(key);
      // float equality: a -0.0/+0.0 tie is the tie torch.argmin sees
      const unsigned el = __ballot_sync(kFull, vlo == m);
      const unsigned eh = __ballot_sync(kFull, vhi == m);
      if (lane == 0) ring[tc] = make_uint4(bl, bh, el, eh);
    }
    __syncwarp();
    if (lane < steps) {  // lane writes step t0 + lane of every frame
      const uint4 q = ring[lane];
      const unsigned d_lo = q.x, d_hi = q.y, e_lo = q.z, e_hi = q.w;
      const int t = t0 + lane;
      for (int f = 0; f < F && b0 + f < B; ++f) {
        const int sh = f * W;
        const unsigned lo = (d_lo >> sh) & gmask;
        const unsigned hi = (d_hi >> sh) & gmask;
        const unsigned qlo = (e_lo >> sh) & gmask;
        const unsigned qhi = (e_hi >> sh) & gmask;
        const size_t row = (size_t)(b0 + f) * T + t;
        if (W == 32) {
          reinterpret_cast<int2*>(dec)[row] = make_int2((int)lo, (int)hi);
        } else {
          dec[row] = (int32_t)(lo | hi << W);
        }
        best[row] = qlo ? __ffs(qlo) - 1 : W + __ffs(qhi) - 1;
      }
    }
  }
}

size_t warp_smem_bytes(int S, int n) {
  return sizeof(float) * warp_smem_floats(S, n);
}

template <int N, bool HARD>
int launch_warp(const float* r, const float* C, const float* hconst,
                int32_t* dec, int32_t* best, int B, int T, int S, int grid,
                int threads, size_t smem, cudaStream_t stream) {
  auto* kernel = acs_warp_kernel<N, HARD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(r, C, hconst, dec, best, B, T, S);
  return (int)cudaGetLastError();
}

template <int N>
int launch_warp_hard(const float* r, const float* C, const float* hconst,
                     int32_t* dec, int32_t* best, int B, int T, int S,
                     int grid, int threads, size_t smem,
                     cudaStream_t stream) {
  return hconst != nullptr
             ? launch_warp<N, true>(r, C, hconst, dec, best, B, T, S, grid,
                                    threads, smem, stream)
             : launch_warp<N, false>(r, C, hconst, dec, best, B, T, S, grid,
                                     threads, smem, stream);
}

// K2, the sliding-window traceback.  Lane l of a warp decodes positions
// p0 + l, p0 + 32 + l, p0 + 64 + l and p0 + 96 + l of its frame side by
// side, 128 at a time: the window that finalises p ends at
// w = min(p + D - 2, T - 1) (the reference schedule, ops/viterbi.py:29-38
// of the JAX package) and the bit is the MSB of the state the walk back
// from best[w] reaches at p.
//
// What bounds it: the full walks are 33.3 k back-steps a frame at the
// MCS-4 shape, each a shared-memory read and a few integer instructions
// on the SM's 64 int32 lanes; the bytes (decisions and best states in,
// bits out) take 9.6 us at 3.35 TB/s.  So a back-step is made one 4-byte
// read and three integer instructions, and a lane keeps four independent
// walks in flight:
//   * the state is kept as an unmasked shift register r (its low log2(S)
//     bits are the state; unsigned, as a walk shifts it past 32 bits):
//     r' = (r << 1) | bit, the shift on the FMA pipe, and the wrapped
//     32-bit shift reads bit r & 31 of the word;
//   * the word of a row that holds the state's bit is picked by the
//     state's bits 5 and up, which are r's bits 0 and up five steps
//     earlier: each read is issued five steps ahead of its use, off the
//     dependency chain;
//   * rows are staged G + 1 words apart (odd), so the 32 lanes' reads of
//     32 consecutive rows fall in distinct banks;
//   * the walk stops log2(S) - 1 steps early: the MSB of the state at p
//     is bit log2(S) - 1 - e of the state e steps above it, exactly.
// Walking only until a new window's path meets the previous window's
// (exact too, and ~1/13 of the back-steps at MCS-4) was built and measured
// slower: a warp steps as long as its slowest lane, and the test and store
// of the merge cost more than the steps it saved (PERF.md).
//
// Each warp stages its frame's decisions in shared memory in kTbChunks
// cp.async groups, issued three ahead of the rows its positions need, so
// the walks start while the rest of the frame arrives; best states are
// read from device memory two groups of positions ahead.  Frames past
// shared memory read their decisions from device memory.
constexpr int kTbLanes = 32;
constexpr int kTbMaxFrames = 8;  // frames (warps) of a block
constexpr int kTbChunks = 8;     // cp.async groups of a frame's decisions
constexpr int kTbAhead = 5;      // back-steps a read is issued ahead
constexpr int kTbIlp = 4;        // positions a lane walks side by side

__device__ __forceinline__ void tb_wait_chunks(int pending) {
  switch (pending < 7 ? pending : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Rows [k*chunk, (k+1)*chunk) of the frame's decisions into shared memory
// (row stride rowp), one cp.async group.
__device__ __forceinline__ void tb_stage_chunk(int32_t* sd, const int32_t* dg,
                                               int k, int chunk, int T,
                                               int G, int lg, int rowp,
                                               int lane) {
  const int e0 = min(k * chunk, T) * G;
  const int e1 = min((k + 1) * chunk, T) * G;
  for (int e = e0 + lane; e < e1; e += 32) {
    cp_async4(reinterpret_cast<float*>(sd + (e >> lg) * rowp + (e & (G - 1))),
              reinterpret_cast<const float*>(dg + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Walk K chains n back-steps each, chain k from time t[k] and the shift
// register r[k] of its state there, side by side; leaves in r[k] the
// register of the state at t[k] - n.  The word for a step at time u is
// d[u * row + (state >> 5)], read kTbAhead steps early.  CLAMP: the reads
// ahead may fall below row 0 (only in a frame's first kTbAhead positions)
// and read row 0 instead, a word never used.  MASK (S < 32): the bit's
// index is r & smask.  ROW: the row stride when it is known at compile
// time (1 or 3), else 0 and `row_`.
template <int K, bool CLAMP, bool MASK, int ROW>
__device__ __forceinline__ void tb_walk(const int32_t* __restrict__ d,
                                        int row_, int gmask, int smask,
                                        int (&t)[K], int n,
                                        unsigned (&r)[K]) {
  const int row = ROW ? ROW : row_;
  auto read = [&](int u, int idx) {
    return (unsigned)d[(CLAMP ? max(u, 0) : u) * row + idx];
  };
  unsigned q[K][kTbAhead];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < kTbAhead; ++a) {
      q[k][a] = read(t[k] - a, (r[k] >> (5 - a)) & gmask);
    }
  }
  auto step = [&](int k, int a) {
    const int idx = (int)(r[k] & gmask);
    const int sh = (int)(MASK ? (r[k] & smask) : (r[k] & 31u));
    r[k] = (r[k] << 1) | ((q[k][a] >> sh) & 1u);
    q[k][a] = read(t[k] - kTbAhead, idx);
    --t[k];
  };
  for (; n >= kTbAhead; n -= kTbAhead) {
#pragma unroll
    for (int a = 0; a < kTbAhead; ++a) {
#pragma unroll
      for (int k = 0; k < K; ++k) step(k, a);
    }
  }
#pragma unroll
  for (int a = 0; a < kTbAhead - 1; ++a) {
    if (n > a) {
#pragma unroll
      for (int k = 0; k < K; ++k) step(k, a);
    }
  }
}

template <bool STAGED, bool MASK, int ROW>
__global__ void __launch_bounds__(kTbLanes * kTbMaxFrames)
traceback_kernel(const int32_t* __restrict__ dec,
                 const int32_t* __restrict__ best, int8_t* __restrict__ out,
                 int B, int T, int G, int S, int msb, int D, int rowp,
                 int frame_bytes) {
  extern __shared__ __align__(16) unsigned char tb_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int32_t* dg = dec + (size_t)b * T * G;
  const int32_t* bg = best + (size_t)b * T;
  int32_t* sd =
      reinterpret_cast<int32_t*>(tb_smem + (size_t)warp * frame_bytes);
  const int chunk = (T + kTbChunks - 1) / kTbChunks;
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  int issued = 0;
  if (STAGED) {
    for (; issued < 3; ++issued) {
      tb_stage_chunk(sd, dg, issued, chunk, T, G, lg, rowp, lane);
    }
  }
  const int32_t* d = STAGED ? sd : dg;
  const int row = STAGED ? rowp : G;
  const int gmask = G - 1;
  const int smask = S - 1;
  int8_t* o = out + (size_t)b * T;
  // best states of the next two groups of positions: their loads from
  // device memory are two groups' walks ahead of their use
  constexpr int kGroup = kTbLanes * kTbIlp;
  unsigned nb[kTbIlp], nb2[kTbIlp];
#pragma unroll
  for (int i = 0; i < kTbIlp; ++i) {
    nb[i] = (unsigned)__ldg(bg + min(lane + kTbLanes * i + D - 2, T - 1));
    nb2[i] = (unsigned)__ldg(
        bg + min(lane + kTbLanes * i + kGroup + D - 2, T - 1));
  }
  for (int p0 = 0; p0 < T; p0 += kGroup) {
    if (STAGED) {
      const int need = min(p0 + kGroup - 1 + D - 2, T - 1) / chunk;
      for (; issued < min(need + 3, kTbChunks); ++issued) {
        tb_stage_chunk(sd, dg, issued, chunk, T, G, lg, rowp, lane);
      }
      tb_wait_chunks(issued - 1 - need);
      __syncwarp();
    }
    int p[kTbIlp], t[kTbIlp], e[kTbIlp], n[kTbIlp];
    unsigned r[kTbIlp];
#pragma unroll
    for (int i = 0; i < kTbIlp; ++i) {
      p[i] = p0 + kTbLanes * i + lane;
      t[i] = min(p[i] + D - 2, T - 1);
      e[i] = min(t[i] - p[i], msb);  // steps left unwalked at the bottom
      n[i] = max(t[i] - p[i] - e[i], 0);
      r[i] = nb[i];
      nb[i] = nb2[i];
      nb2[i] = (unsigned)__ldg(bg + min(p[i] + 2 * kGroup + D - 2, T - 1));
    }
    // the positions' walks side by side, where they are equally long (all
    // but the last windows of a frame), else one by one
    bool same = true;
#pragma unroll
    for (int i = 1; i < kTbIlp; ++i) same = same && n[i] == n[0];
    if (same) {
      if (p0) {
        tb_walk<kTbIlp, false, MASK, ROW>(d, row, gmask, smask, t, n[0], r);
      } else {
        tb_walk<kTbIlp, true, MASK, ROW>(d, row, gmask, smask, t, n[0], r);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTbIlp; ++i) {
        int ti[1] = {t[i]};
        unsigned ri[1] = {r[i]};
        tb_walk<1, true, MASK, ROW>(d, row, gmask, smask, ti, n[i], ri);
        r[i] = ri[0];
      }
    }
#pragma unroll
    for (int i = 0; i < kTbIlp; ++i) {
      if (p[i] < T) o[p[i]] = (int8_t)((r[i] >> (msb - e[i])) & 1u);
    }
  }
}

template <bool STAGED, bool MASK, int ROW>
int launch_traceback(const int32_t* dec, const int32_t* best, int8_t* out,
                     int B, int T, int G, int S, int msb, int D, int rowp,
                     int frame_bytes, int threads, int grid, size_t smem,
                     cudaStream_t stream) {
  auto* kernel = traceback_kernel<STAGED, MASK, ROW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    }
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(dec, best, out, B, T, G, S, msb, D,
                                          rowp, frame_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan (kernels/viterbi_acs.py:acs_plan) gives the layout
// (0: acs_warp_kernel, 1: acs_forward_kernel), threads, grid and shared
// memory bytes; a plan that does not fit the layout is refused.
extern "C" int acs_forward_launch(const float* r, const float* C,
                                  const float* hconst, int32_t* dec,
                                  int32_t* best, int B, int T, int n, int S,
                                  int G, int layout, int threads, int grid,
                                  int smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  if (n < 1 || n > kMaxN || S < 2 || (S & (S - 1)) || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (layout == 0) {
    const int wpb = threads / 32;
    if (S > 64 || threads % 32 || threads > kWarpBlockMax || wpb < 1 ||
        smem != wpb * warp_smem_bytes(S, n) ||
        (size_t)grid * wpb * (64 / S) < (size_t)B) {
      return (int)cudaErrorInvalidValue;
    }
    using Launch = int (*)(const float*, const float*, const float*,
                           int32_t*, int32_t*, int, int, int, int, int,
                           size_t, cudaStream_t);
    static const Launch by_n[kMaxN] = {
        launch_warp_hard<1>, launch_warp_hard<2>, launch_warp_hard<3>,
        launch_warp_hard<4>, launch_warp_hard<5>, launch_warp_hard<6>,
        launch_warp_hard<7>, launch_warp_hard<8>};
    return by_n[n - 1](r, C, hconst, dec, best, B, T, S, grid, threads, smem,
                       st);
  }
  const int nth = S < 32 ? 32 : S;
  const int F = nth / S;
  const int nwarps = nth / 32;
  const size_t need = sizeof(float) * (2 * nth + 2 * nwarps) +
                      sizeof(int) * 2 * nwarps +
                      sizeof(float) * F * kChunk * n;
  if (layout != 1 || threads != nth || smem != need ||
      (size_t)grid * F < (size_t)B) {
    return (int)cudaErrorInvalidValue;
  }
  acs_forward_kernel<<<grid, nth, smem, st>>>(r, C, hconst, dec, best, B, T,
                                              n, S, G);
  return (int)cudaGetLastError();
}

// The launch plan (kernels/viterbi_acs.py:traceback_plan) gives the depth
// D = min(tb_depth, T + 1), the row of staged decisions, whether they are
// staged, threads, grid and shared memory bytes; a plan that does not fit
// the kernel is refused.
extern "C" int traceback_launch(const int32_t* dec, const int32_t* best,
                                int8_t* out, int B, int T, int G, int S,
                                int D, int rowp, int staged, int threads,
                                int grid, int smem_bytes, void* stream) {
  int msb = 0;  // log2(S) - 1
  while ((2 << msb) < S) ++msb;
  const int F = threads / kTbLanes;
  if (S < 2 || (S & (S - 1)) || S > 1024 || G != (S + 31) / 32 || T < 1 ||
      D < 2 || D > T + 1 || rowp != (G == 1 ? 1 : G + 1) ||
      threads % kTbLanes || F < 1 || F > kTbMaxFrames ||
      (size_t)grid * F < (size_t)B) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t frame =
      staged ? (((size_t)4 * T * rowp + 15) & ~(size_t)15) : 0;
  if ((size_t)smem_bytes != F * frame) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const int32_t*, const int32_t*, int8_t*, int, int,
                         int, int, int, int, int, int, int, int, size_t,
                         cudaStream_t);
  // the row strides of S <= 32 (1, either placement) and of S = 64 staged
  // (3) are compile-time constants; the others are not
  const Launch launch =
      G == 1 ? (S < 32 ? (staged ? launch_traceback<true, true, 1>
                                 : launch_traceback<false, true, 1>)
                       : (staged ? launch_traceback<true, false, 1>
                                 : launch_traceback<false, false, 1>))
      : staged ? (G == 2 ? launch_traceback<true, false, 3>
                         : launch_traceback<true, false, 0>)
               : launch_traceback<false, false, 0>;
  return launch(
      dec, best, out, B, T, G, S, msb, D, rowp, (int)frame, threads, grid,
      (size_t)smem_bytes, (cudaStream_t)stream);
}
