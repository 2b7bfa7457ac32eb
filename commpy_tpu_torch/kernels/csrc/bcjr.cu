// Fused BCJR pass (forward recursion, backward recursion, APP) for Hopper
// (sm_90a).
//
// K3 bcjr_kernel replaces commpy_tpu/kernels/bcjr.py bcjr_appdiff_pallas
//    (its body _bcjr_kernel): one constituent MAP pass of the turbo loop
//    over [T, R] lanes, batch last.  A lane is a frame (whole-frame
//    decoding) or a window of one (warmup-windowed and NII decoding).
//
// The Python wrapper (kernels/bcjr.py) checks shapes and types, builds the
// w-streams and the state tables, plans the launch (bcjr_plan: where the
// history lives) and holds the plain PyTorch version this kernel must
// match bit for bit.
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
//   hist       [T, R, S] float32 scratch in device memory, when the plan
//                      does not keep the history in shared memory
//
// Branch metric into state s under input u: sign[u][s] * w_{which[u][s]},
// plus li for u = 1.  Forward: cand_u = alpha[inv_nst[u][s]] + g_u[s],
// alpha' = lse2(cand_0, cand_1).  Backward: cand_u[s] = (beta + g_u)[nst[u]
// [s]], beta' = lse2(cand_0, cand_1), e[t] = reduce(al + cand_1) -
// reduce(al + cand_0), al the alpha before step t and beta the beta after
// the backward steps past t, the state reduction halving contiguously (s
// pairs with s + S/2 first).  No per-step normalisation, unless the
// renormalisation period N (renorm) is set: then the forward recursion
// subtracts each lane's maximum state metric after step t whenever
// (t + 1) % N == 0, and the backward one after step t whenever
// (T - t) % N == 0, valid step or not.  The schedule is fixed by the
// absolute step, so the meet-in-the-middle split does not move it, and a
// stored pre-step metric after such a step is the renormalised one.
//
// What bounds it on an H100: at the NII bench shape (T=128, R=12288, S=4,
// f32) the function reads 19.3 MB of streams and carries and writes 6.7 MB
// of e and carries (7.8 us at 3.35 TB/s), and its exact log-sum-exps need
// ~44M exp and log1p on the special-function units (16 per SM per clock:
// 10.5 us): bound by operations, at microseconds.  What limits a kernel is
// the dependency chain: each step of a recursion needs the previous one's
// metrics, so a step costs the latency of its log-sum-exps, and the card
// can only be filled with lanes (R) and states.  The design:
//   * forward and backward at once, meeting in the middle: in the first
//     half the forward threads run steps 0 .. T/2-1 storing each pre-step
//     alpha, and the backward threads run steps T-1 .. T/2 storing each
//     pre-step beta; after one barrier each goes on through the other
//     half, emitting e[t] from the other's stored metrics.  A lane's chain
//     falls from 2T steps to T;
//   * a thread per state: each direction of a lane is a group of S
//     threads in one warp, thread s holding alpha[s] or beta[s].  The
//     state permutations, which are data (the trellis tables), are warp
//     shuffles, and e's two state reductions share one pass: the lower
//     half of a group reduces app0 and the upper half app1.  A step's
//     chain is one log-sum-exp in the first half and 1 + log2(S) in the
//     second, and a lane has 2S threads to fill the card with;
//   * stream prefetch: each thread loads w1, w2, li (and valid) 4 steps
//     ahead (2 where S >= 8) into a register ring, and in the second half
//     the other direction's stored metric of its state too, so no step
//     waits on a load;
//   * 32 lanes a block (64 S threads); the history, [T, S] floats a lane,
//     in shared memory when it fits and the blocks it leaves an SM still
//     hold the grid at once, else in device memory ([T, R, S] scratch);
//     bcjr_plan chooses and the kernel is templated on it;
//   * lanes adjacent in r, states adjacent within a lane, so every load
//     and store of a warp is one or a few contiguous runs.
// That state form fills the card where lanes are few.  Where the 2R
// threads of a thread per lane and direction fill it alone (the LTE cell:
// T=128, R=49152, S=8), extra threads cost instructions and hide no
// latency, and the state form spends them on shuffles and on the APP's
// reduction run in all S threads of a group (40 lse2 a lane-step against
// the 30 the algorithm needs).  So K3 has a second form, which
// bcjr_plan picks from the shapes:
//   * the lane form, bcjr_kernel_lanes: a thread per lane and direction
//     holding all S metrics in registers.  A step is S independent lse2
//     chains in one thread, and e's two reductions run once (2(S-1)
//     lse2, halving as the plain version does).  Registers cannot be
//     indexed at run time, so the state maps are the shift register's,
//     fixed at compile time (the states entering d are 2 (d mod S/2) and
//     that + 1; s leaves to s/2 and s/2 + S/2), and which input takes
//     each of the two is data, like the branch's w stream and sign: masks
//     of the tables, so each choice is one bit-select instruction.  The
//     wrapper checks that property of the tables, and a trellis without
//     it runs the state form;
//   * the same meeting in the middle, variants, modes, renormalisation
//     schedule and order of operations, and the same history layout and
//     placement rule; a thread stores and loads its S metrics of a step
//     as S/4 vector accesses and prefetches one step ahead, its S chains
//     hiding the rest.
// The times both take are recorded in PERF.md.
//
// Numerics: compiled with -fmad=false, so every add and multiply rounds on
// its own, in the plain version's order; lse2 is fmaxf, fabsf, expf and
// log1pf as PyTorch's maximum, abs, exp and log1p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // lanes per block
constexpr int kMaxStates = 16;
constexpr float kNeg = -1e30f;

enum { kExact = 0, kMaxLog = 1, kLinear = 2 };
enum { kPlain = 0, kMasked = 1, kBoundary = 2 };

enum { kState = 0, kLane = 1 };

struct Tables {
  unsigned char inv[2][kMaxStates];  // inv[u][s]: the state entering s on u
  unsigned char nst[2][kMaxStates];  // nst[u][s]: the state s leaves to on u
  unsigned int which[2];             // bit s: the branch into s reads w2
  unsigned int neg[2];               // bit s: ... and is negated
};

// The lane form's tables, for a shift-register trellis (the states
// entering d are 2 (d mod S/2) and that + 1; s leaves to s/2 and s/2 +
// S/2): masks of all ones or none, and signs, so that each choice is one
// instruction
struct LaneTables {
  unsigned int wmask[2][kMaxStates];  // ones: the branch into d reads w2
  float sign[2][kMaxStates];          // -1: ... and is negated, else 1
  unsigned int pmask[kMaxStates];  // ones: input 0 enters d from 2 (d mod
                                   // S/2) + 1
  unsigned int smask[kMaxStates];  // ones: input 0 leaves s to s/2 + S/2
};

struct Args {
  const void* w1;
  const void* w2;
  const void* li;
  const uint8_t* valid;
  const uint8_t* first;
  const float* a0;
  const float* bT;
  void* e;
  float* af;
  float* bf;
  float* hist;
  int T, R, io_bf16, renorm;
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

// One step's inputs, fetched kAhead<S> steps before it runs; `hv` holds the
// other direction's stored metric of this thread's state in the second
// half.
struct Item {
  float x1, x2, l, hv;
  bool ok;
};

// steps of prefetch: 4, or 2 where S >= 8 threads a lane leave a thread
// fewer registers (the 512- and 1024-thread blocks)
template <int S>
constexpr int kAhead = S >= 8 ? 2 : 4;
constexpr unsigned kFull = 0xffffffffu;

// Runs body(i, item) for i = 0 .. n-1, fetch(i) having been issued P
// steps earlier into a register ring.
template <int P, typename Fetch, typename Body>
__device__ __forceinline__ void pipelined(int n, Fetch fetch, Body body) {
  decltype(fetch(0)) ring[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < n) ring[j] = fetch(j);
  }
  for (int i = 0; i < n; i += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (i + j < n) {
        const auto cur = ring[j];
        if (i + j + P < n) ring[j] = fetch(i + j + P);
        body(i + j, cur);
      }
    }
  }
}

// t[s] of a per-state table row, for a run-time s, without indexing
template <int S>
__device__ __forceinline__ int pick(const unsigned char (&t)[kMaxStates],
                                    int s) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) v = k == s ? t[k] : v;
  return v;
}

// reduce_s(p1) - reduce_s(p0) over the S threads of a group (thread s
// holding p0[s], p1[s]), halving contiguously as the plain version does:
// the first level pairs p0[s] with p0[s + S/2] in the lower half of the
// group and p1[s - S/2] with p1[s] in the upper half, after which both
// halves reduce alike.  Valid in the group's thread 0.
template <int S, int MODE>
__device__ __forceinline__ float appdiff(float p0, float p1, int s) {
  constexpr int h = S / 2;
  const bool lower = s < h;
  const float got = __shfl_xor_sync(kFull, lower ? p1 : p0, h);
  float v = lse2<MODE>(lower ? p0 : got, lower ? got : p1);
#pragma unroll
  for (int o = h / 2; o >= 1; o /= 2) {
    v = lse2<MODE>(v, __shfl_xor_sync(kFull, v, o));
  }
  return __shfl_xor_sync(kFull, v, h) - v;
}

// Each lane's maximum over its S state metrics, in every thread of the
// group: log2(S) butterfly steps whose xor offsets, below S, stay inside
// the S-aligned group (two lanes share a warp at S = 16).  fmaxf is exact,
// so the order does not matter.
template <int S>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = S / 2; o >= 1; o /= 2) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// A block holds kLanes lanes: for each, S forward threads (one a state)
// and S backward threads.  Thread (lane, s) of a direction is number
// lane * S + s of it, so a warp holds 32 / S whole lanes.
template <int S, int MODE, int VARIANT, bool SHARED>
__global__ void __launch_bounds__(2 * kLanes * S)
    bcjr_kernel(Args g, Tables tb) {
  // the history, when SHARED: [T][kLanes][S], a thread's own slot a step
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const bool fwd = tid < kLanes * S;
  const int d = fwd ? tid : tid - kLanes * S;  // index within the direction
  const int lane = d / S;
  const int s = d % S;
  const int base = (tid & 31) - s;  // warp lane of the group's state 0
  const int r = blockIdx.x * kLanes + lane;
  const bool live = r < g.R;
  const int T = g.T, R = g.R;
  const int h = T / 2;  // the forward half: steps 0 .. h-1
  const bool bf16 = g.io_bf16 != 0;
  float* hp = SHARED ? smem + d : g.hist + (size_t)r * S + s;
  const size_t h_t = SHARED ? (size_t)kLanes * S : (size_t)R * S;
  // this state's table entries and branch bits
  const int inv0 = base + pick<S>(tb.inv[0], s);
  const int inv1 = base + pick<S>(tb.inv[1], s);
  const int nst0 = base + pick<S>(tb.nst[0], s);
  const int nst1 = base + pick<S>(tb.nst[1], s);
  const bool w2_0 = (tb.which[0] >> s) & 1u, w2_1 = (tb.which[1] >> s) & 1u;
  const bool ng_0 = (tb.neg[0] >> s) & 1u, ng_1 = (tb.neg[1] >> s) & 1u;

  auto fetch_at = [&](int t) {
    Item it;
    const size_t row = (size_t)t * R + r;
    it.x1 = live ? load(g.w1, row, bf16) : 0.f;
    it.x2 = live ? load(g.w2, row, bf16) : 0.f;
    it.l = live ? load(g.li, row, bf16) : 0.f;
    it.ok = VARIANT != kMasked || (live && g.valid[row] != 0);
    it.hv = 0.f;
    return it;
  };
  auto fetch_hist_at = [&](int t) {
    Item it = fetch_at(t);
    if (live) it.hv = hp[t * h_t];
    return it;
  };
  // g0, g1: the branch metrics into this state under u = 0, 1
  auto branch0 = [&](const Item& x) {
    const float w = w2_0 ? x.x2 : x.x1;
    return ng_0 ? -w : w;
  };
  auto branch1 = [&](const Item& x) {
    const float w = w2_1 ? x.x2 : x.x1;
    return (ng_1 ? -w : w) + x.l;
  };
  // alpha <- lse2(alpha[inv0] + g0, alpha[inv1] + g1) where ok
  auto alpha_step = [&](float& a, float g0, float g1, bool ok) {
    const float na = lse2<MODE>(__shfl_sync(kFull, a, inv0) + g0,
                                __shfl_sync(kFull, a, inv1) + g1);
    if (ok) a = na;
  };
  // the renormalisation after a step that ends a period of N: `since`
  // counts the direction's steps since the last one, through both halves
  // (the forward direction's steps are t + 1 = 1 .. T, the backward's
  // T - t = 1 .. T), the same in every thread of a warp, dead lanes and
  // invalid steps included, so the shuffles converge
  const int N = g.renorm;
  int since = 0;
  auto renorm = [&](float& v) {
    if (N > 0 && ++since == N) {
      since = 0;
      v = v - group_max<S>(v);
    }
  };

  // m: alpha[s] in the forward threads, beta[s] in the backward ones
  float m;
  if (fwd) {
    if (VARIANT == kBoundary) {
      m = live ? g.a0[(size_t)s * R + r] : 0.f;
    } else {
      const bool exact = VARIANT == kPlain || (live && g.first[r] != 0);
      m = (s > 0 && exact) ? kNeg : 0.0f;
    }
  } else {
    m = VARIANT == kBoundary && live ? g.bT[(size_t)s * R + r] : 0.0f;
  }

  // ---- first half: store each pre-step metric, then step ----
  if (fwd) {
    pipelined<kAhead<S>>(h, fetch_at, [&](int t, const Item& x) {
      if (live) hp[t * h_t] = m;
      alpha_step(m, branch0(x), branch1(x), x.ok);
      renorm(m);
    });
  } else {
    pipelined<kAhead<S>>(T - h, [&](int i) { return fetch_at(T - 1 - i); },
              [&](int i, const Item& x) {
                if (live) hp[(T - 1 - i) * h_t] = m;
                // cand_u = (beta + g_u)[nst[u][s]]
                const float c0 = __shfl_sync(kFull, m + branch0(x), nst0);
                const float c1 = __shfl_sync(kFull, m + branch1(x), nst1);
                const float nb = lse2<MODE>(c0, c1);
                if (x.ok) m = nb;
                renorm(m);
              });
  }
  __syncthreads();  // every stored metric of the first half is in place

  // ---- second half: emit e[t] from the other direction's metrics ----
  if (fwd) {
    pipelined<kAhead<S>>(T - h, [&](int i) { return fetch_hist_at(h + i); },
              [&](int i, const Item& x) {
                const int t = h + i;
                const float g0 = branch0(x), g1 = branch1(x);
                const float c0 = __shfl_sync(kFull, x.hv + g0, nst0);
                const float c1 = __shfl_sync(kFull, x.hv + g1, nst1);
                const float e = appdiff<S, MODE>(m + c0, m + c1, s);
                if (live && s == 0) store(g.e, (size_t)t * R + r, e, bf16);
                alpha_step(m, g0, g1, x.ok);
                renorm(m);
              });
    if (VARIANT == kBoundary && live) g.af[(size_t)s * R + r] = m;
  } else {
    pipelined<kAhead<S>>(h, [&](int i) { return fetch_hist_at(h - 1 - i); },
              [&](int i, const Item& x) {
                const int t = h - 1 - i;
                const float c0 = __shfl_sync(kFull, m + branch0(x), nst0);
                const float c1 = __shfl_sync(kFull, m + branch1(x), nst1);
                const float e = appdiff<S, MODE>(x.hv + c0, x.hv + c1, s);
                if (live && s == 0) store(g.e, (size_t)t * R + r, e, bf16);
                const float nb = lse2<MODE>(c0, c1);
                if (x.ok) m = nb;
                renorm(m);
              });
    if (VARIANT == kBoundary && live) g.bf[(size_t)s * R + r] = m;
  }
}

// ---- the lane form: a thread per lane and direction --------------------

// m ? b : a, bit for bit, for a mask m of all ones or none: one LOP3
__device__ __forceinline__ float bitsel(float a, float b, unsigned m) {
  const unsigned ua = __float_as_uint(a);
  return __uint_as_float(ua ^ ((ua ^ __float_as_uint(b)) & m));
}

// A thread's S metrics of one step to and from its history row (S
// contiguous floats, 8- or 16-byte aligned): S/4 vector accesses
template <int S>
__device__ __forceinline__ void put_row(float* p, const float (&v)[S]) {
  if constexpr (S == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < S; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  }
}

template <int S>
__device__ __forceinline__ void get_row(const float* p, float (&v)[S]) {
  if constexpr (S == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < S; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + k);
      v[k] = x.x;
      v[k + 1] = x.y;
      v[k + 2] = x.z;
      v[k + 3] = x.w;
    }
  }
}

// One step's inputs in the lane form, fetched a step before it runs; `hv`
// holds the other direction's stored metrics in the second half.
template <int S>
struct LaneItem {
  float x1, x2, l;
  bool ok;
  float hv[S];
};

// A block holds kLanes lanes: thread `lane` runs the lane's forward
// recursion and thread kLanes + lane its backward one, each holding all S
// metrics of its direction in registers, so a step is S independent lse2
// chains in one thread and its state reductions run once.  The state maps
// are the shift register's, fixed at compile time; which input takes each
// of a state's two neighbours, and each branch's w stream and sign, are
// the tables' masks.  The history is [T][kLanes][S] in shared memory when
// g.hist is null, else [T][R][S] in device memory: a thread's row of a
// step is S contiguous floats.  At most 80 registers a thread up to S = 8,
// so that 12 blocks fit an SM.
template <int S, int MODE, int VARIANT>
__global__ void __launch_bounds__(2 * kLanes, S <= 8 ? 12 : 1)
    bcjr_kernel_lanes(Args g, LaneTables tb) {
  extern __shared__ float smem[];
  constexpr int H = S / 2;
  const bool fwd = threadIdx.x < kLanes;
  const int lane = threadIdx.x % kLanes;
  const int r = blockIdx.x * kLanes + lane;
  const bool live = r < g.R;
  const int T = g.T, R = g.R;
  const int h = T / 2;  // the forward half: steps 0 .. h-1
  const bool bf16 = g.io_bf16 != 0;
  const bool shared = g.hist == nullptr;
  // this lane's history row of step t: hist + (t * L + at) * S
  float* const hbase = shared ? smem : g.hist;
  const size_t L = shared ? kLanes : R;
  const size_t at = shared ? lane : r;
  auto hrow = [&](int t) { return hbase + ((size_t)t * L + at) * S; };

  auto fetch_at = [&](int t, bool hist) {
    LaneItem<S> it;
    const size_t i = (size_t)t * R + r;
    it.x1 = live ? load(g.w1, i, bf16) : 0.f;
    it.x2 = live ? load(g.w2, i, bf16) : 0.f;
    it.l = live ? load(g.li, i, bf16) : 0.f;
    it.ok = VARIANT != kMasked || (live && g.valid[i] != 0);
    if (hist && live) {
      get_row<S>(hrow(t), it.hv);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) it.hv[s] = 0.f;
    }
    return it;
  };
  // g0[d], g1[d]: the branch metrics into state d under input 0 and 1
  // (a product with 1 or -1 is exact: the plain version's w or -w)
  auto branches = [&](const LaneItem<S>& x, float (&g0)[S], float (&g1)[S]) {
#pragma unroll
    for (int d = 0; d < S; ++d) {
      g0[d] = bitsel(x.x1, x.x2, tb.wmask[0][d]) * tb.sign[0][d];
      g1[d] = bitsel(x.x1, x.x2, tb.wmask[1][d]) * tb.sign[1][d] + x.l;
    }
  };
  // a <- lse2(a[inv[0][d]] + g0[d], a[inv[1][d]] + g1[d]) where ok
  auto alpha_step = [&](float (&a)[S], const float (&g0)[S],
                        const float (&g1)[S], bool ok) {
    float na[S];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const int p = 2 * (d % H);
      const unsigned sw = tb.pmask[d];
      na[d] = lse2<MODE>(bitsel(a[p], a[p + 1], sw) + g0[d],
                         bitsel(a[p + 1], a[p], sw) + g1[d]);
    }
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (ok) a[d] = na[d];
    }
  };
  // c0[s], c1[s]: (v + g_u)[nst[u][s]], state s's candidates under u
  auto cands = [&](const float (&v)[S], const float (&g0)[S],
                   const float (&g1)[S], float (&c0)[S], float (&c1)[S]) {
    float q0[S], q1[S];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      q0[d] = v[d] + g0[d];
      q1[d] = v[d] + g1[d];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = s / 2;
      const unsigned sw = tb.smask[s];
      c0[s] = bitsel(q0[n], q0[n + H], sw);
      c1[s] = bitsel(q1[n + H], q1[n], sw);
    }
  };
  // reduce_s(al + c1) - reduce_s(al + c0), halving as the plain version
  auto app = [&](const float (&al)[S], const float (&c0)[S],
                 const float (&c1)[S]) {
    float p0[S], p1[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      p0[s] = al[s] + c0[s];
      p1[s] = al[s] + c1[s];
    }
#pragma unroll
    for (int o = H; o >= 1; o /= 2) {
#pragma unroll
      for (int i = 0; i < o; ++i) {
        p0[i] = lse2<MODE>(p0[i], p0[i + o]);
        p1[i] = lse2<MODE>(p1[i], p1[i + o]);
      }
    }
    return p1[0] - p0[0];
  };
  auto beta_step = [&](float (&b)[S], const float (&c0)[S],
                       const float (&c1)[S], bool ok) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float nb = lse2<MODE>(c0[s], c1[s]);
      if (ok) b[s] = nb;
    }
  };
  // the renormalisation after a step that ends a period of N, on the
  // state form's schedule
  const int N = g.renorm;
  int since = 0;
  auto renorm = [&](float (&v)[S]) {
    if (N > 0 && ++since == N) {
      since = 0;
      float mx = v[0];
#pragma unroll
      for (int s = 1; s < S; ++s) mx = fmaxf(mx, v[s]);
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = v[s] - mx;
    }
  };

  // m: alpha in the forward thread, beta in the backward one
  float m[S];
  const bool exact =
      VARIANT == kPlain || (VARIANT == kMasked && live && g.first[r] != 0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (fwd) {
      if (VARIANT == kBoundary) {
        m[s] = live ? g.a0[(size_t)s * R + r] : 0.f;
      } else {
        m[s] = (s > 0 && exact) ? kNeg : 0.0f;
      }
    } else {
      m[s] = VARIANT == kBoundary && live ? g.bT[(size_t)s * R + r] : 0.0f;
    }
  }

  // ---- first half: store each pre-step metric, then step ----
  if (fwd) {
    pipelined<1>(h, [&](int t) { return fetch_at(t, false); },
                 [&](int t, const LaneItem<S>& x) {
                   if (live) put_row<S>(hrow(t), m);
                   float g0[S], g1[S];
                   branches(x, g0, g1);
                   alpha_step(m, g0, g1, x.ok);
                   renorm(m);
                 });
  } else {
    pipelined<1>(T - h, [&](int i) { return fetch_at(T - 1 - i, false); },
                 [&](int i, const LaneItem<S>& x) {
                   if (live) put_row<S>(hrow(T - 1 - i), m);
                   float g0[S], g1[S], c0[S], c1[S];
                   branches(x, g0, g1);
                   cands(m, g0, g1, c0, c1);
                   beta_step(m, c0, c1, x.ok);
                   renorm(m);
                 });
  }
  __syncthreads();  // every stored metric of the first half is in place

  // ---- second half: emit e[t] from the other direction's metrics ----
  if (fwd) {
    pipelined<1>(T - h, [&](int i) { return fetch_at(h + i, true); },
                 [&](int i, const LaneItem<S>& x) {
                   float g0[S], g1[S], c0[S], c1[S];
                   branches(x, g0, g1);
                   cands(x.hv, g0, g1, c0, c1);
                   const float e = app(m, c0, c1);
                   if (live) store(g.e, (size_t)(h + i) * R + r, e, bf16);
                   alpha_step(m, g0, g1, x.ok);
                   renorm(m);
                 });
    if (VARIANT == kBoundary && live) {
#pragma unroll
      for (int s = 0; s < S; ++s) g.af[(size_t)s * R + r] = m[s];
    }
  } else {
    pipelined<1>(h, [&](int i) { return fetch_at(h - 1 - i, true); },
                 [&](int i, const LaneItem<S>& x) {
                   float g0[S], g1[S], c0[S], c1[S];
                   branches(x, g0, g1);
                   cands(m, g0, g1, c0, c1);
                   const float e = app(x.hv, c0, c1);
                   if (live) {
                     store(g.e, (size_t)(h - 1 - i) * R + r, e, bf16);
                   }
                   beta_step(m, c0, c1, x.ok);
                   renorm(m);
                 });
    if (VARIANT == kBoundary && live) {
#pragma unroll
      for (int s = 0; s < S; ++s) g.bf[(size_t)s * R + r] = m[s];
    }
  }
}

template <typename Tab>
cudaError_t launch(void (*kernel)(Args, Tab), int threads, const Args& a,
                   const Tab& tb, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.R + kLanes - 1) / kLanes);
  kernel<<<grid, threads, smem_bytes, stream>>>(a, tb);
  return cudaGetLastError();
}

template <int S, int MODE, int VARIANT>
cudaError_t launch_one(int form, int shared_hist, const Args& a,
                       const Tables& tb, const LaneTables& lt,
                       int smem_bytes, cudaStream_t stream) {
  if (form == kLane) {
    return launch(bcjr_kernel_lanes<S, MODE, VARIANT>, 2 * kLanes, a, lt,
                  smem_bytes, stream);
  }
  if (shared_hist) {
    return launch(bcjr_kernel<S, MODE, VARIANT, true>, 2 * kLanes * S, a,
                  tb, smem_bytes, stream);
  }
  return launch(bcjr_kernel<S, MODE, VARIANT, false>, 2 * kLanes * S, a, tb,
                smem_bytes, stream);
}

template <int S, int MODE>
cudaError_t launch_variant(int variant, int form, int shared_hist,
                           const Args& a, const Tables& tb,
                           const LaneTables& lt, int smem_bytes,
                           cudaStream_t stream) {
  switch (variant) {
    case kPlain:
      return launch_one<S, MODE, kPlain>(form, shared_hist, a, tb, lt,
                                         smem_bytes, stream);
    case kMasked:
      return launch_one<S, MODE, kMasked>(form, shared_hist, a, tb, lt,
                                          smem_bytes, stream);
    case kBoundary:
      return launch_one<S, MODE, kBoundary>(form, shared_hist, a, tb, lt,
                                            smem_bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int S>
cudaError_t launch_states(int mode, int variant, int form, int shared_hist,
                          const Args& a, const Tables& tb,
                          const LaneTables& lt, int smem_bytes,
                          cudaStream_t stream) {
  switch (mode) {
    case kExact:
      return launch_variant<S, kExact>(variant, form, shared_hist, a, tb,
                                       lt, smem_bytes, stream);
    case kMaxLog:
      return launch_variant<S, kMaxLog>(variant, form, shared_hist, a, tb,
                                        lt, smem_bytes, stream);
    case kLinear:
      return launch_variant<S, kLinear>(variant, form, shared_hist, a, tb,
                                        lt, smem_bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// inv and nst are [2][S] host arrays (input-major); which and neg hold one
// bit per destination state for each input, pred (per destination) and
// succ (per source) the lane form's choice of neighbour (LaneTables);
// renorm is the renormalisation period (0: none).  form, shared_hist and
// smem_bytes come from the launch plan (kernels/bcjr.py:bcjr_plan); hist
// is null when the history lives in shared memory.
extern "C" int bcjr_launch(const void* w1, const void* w2, const void* li,
                           const uint8_t* valid, const uint8_t* first,
                           const float* a0, const float* bT, void* e,
                           float* af, float* bf, float* hist, int T, int R,
                           int S, int mode, int variant, int renorm,
                           int io_bf16, int form, int shared_hist,
                           int smem_bytes, const int* inv, const int* nst,
                           unsigned which0, unsigned which1, unsigned neg0,
                           unsigned neg1, unsigned pred, unsigned succ,
                           void* stream) {
  if (S < 2 || S > kMaxStates || (S & (S - 1)) || T < 1 || R < 1 ||
      renorm < 0 || form < kState || form > kLane ||
      (!shared_hist && hist == nullptr) ||
      smem_bytes < (shared_hist ? (int)sizeof(float) * T * S * kLanes : 0)) {
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
  LaneTables lt = {};
  for (int u = 0; u < 2; ++u) {
    const unsigned w = u ? which1 : which0, n = u ? neg1 : neg0;
    for (int s = 0; s < S; ++s) {
      lt.wmask[u][s] = (w >> s) & 1u ? ~0u : 0u;
      lt.sign[u][s] = (n >> s) & 1u ? -1.0f : 1.0f;
    }
  }
  for (int s = 0; s < S; ++s) {
    lt.pmask[s] = (pred >> s) & 1u ? ~0u : 0u;
    lt.smask[s] = (succ >> s) & 1u ? ~0u : 0u;
  }
  const Args a{w1, w2, li, valid, first, a0, bT, e, af, bf,
               shared_hist ? nullptr : hist, T, R, io_bf16, renorm};
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 2:
      return (int)launch_states<2>(mode, variant, form, shared_hist, a,
                                   tb, lt, smem_bytes, st);
    case 4:
      return (int)launch_states<4>(mode, variant, form, shared_hist, a,
                                   tb, lt, smem_bytes, st);
    case 8:
      return (int)launch_states<8>(mode, variant, form, shared_hist, a,
                                   tb, lt, smem_bytes, st);
    default:
      return (int)launch_states<16>(mode, variant, form, shared_hist, a,
                                    tb, lt, smem_bytes, st);
  }
}
