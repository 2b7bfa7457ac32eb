// K8: K-best MIMO detection (search and max-log LLRs) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package searches in plain XLA, sorts and
// gathers (commpy_tpu/ops/mimo.py:_beam_search_batched).  The port's plain
// version (commpy_tpu_torch/ops/mimo.py:_beam_search_batched and
// _max_log_llrs_batched) sorts all C m candidates of every vector at every
// level with a stable sort and gathers the K survivors' state, each stage a
// pass over [B, K m] tensors in device memory: ~150 launches and a 49 ms
// pass at the benchmark's 368,640 4x4 16-QAM vectors.  This kernel takes
// the triangularised vector (r, yt, from the plain _chol_qr_batched) and
// runs the whole search and the LLRs in one launch; no candidate, metric or
// survivor leaves registers or shared memory between levels.
//
// Lanes: a vector takes P lanes (K rounded up to a power of two, the
// wrapper's plan, kernels/kbest.py:kbest_plan), a warp
// 32 / P vectors; lane rank c holds the survivor of rank c: its residual
// rows (dr, di), its metric dt and its symbol indices (4 bits a level).
// At each level a lane forms the M children of its survivor in registers
// (candidate j * C + c, metric dt + |d - r_ii s_j|^2 + prior term), sorts
// them by (metric, j) with an odd-even merge network and keeps the sorted
// list in its own column of shared memory.  The vector's K new survivors are then
// chosen in K rounds: a butterfly of warp shuffles over the P lanes finds
// the least head (metric, j * 32 + c), lane q of round q keeps it, and the
// lane whose head it was reads its next entry from its column.  Equal
// metrics go to the lower (j, c), which is the plain stable sort's order of
// j * C + c.  The new survivor fetches its parent's residuals and symbols
// from lane c by shuffle and applies the plain residual update.  The first
// level has one parent, the root, whose children every lane forms: each
// candidate's rank is counted (M compares) and the candidate of rank r
// passes to lane r through shared memory, with no sort and no rounds.  Each lane then takes one output
// bit at a time (P bits at a time a vector), runs over the vector's leaves
// by shuffle for the two minima, and writes its LLR; or the best leaf's
// symbols are written.  Vectors past the batch in the last warp search the
// batch's last vector, take part in every shuffle and write nothing.
//
// Numerics, bit for bit with the plain version on the card (the file is
// built with -fmad=false; every operation rounds as PyTorch's eager
// elementwise kernel of the same operation):
// * inc = (d - r_ii * s)^2 summed over re and im: __fmul_rn, __fsub_rn,
//   the squares and their __fadd_rn in the plain order; the candidate
//   metric __fadd_rn(dt, inc) (the root's dt is +0.0, as the plain zeros);
// * the prior term, -N0 * sum_b sgn_b La_b: the plain multiplies La_b by
//   the float32 +-1 (exactly a negation or nothing), adds over b in order,
//   then multiplies by the host scalar -N0 (a float32 operand); here the
//   same adds of +-La_b and __fmul_rn(acc, -N0), added to inc;
// * the residual updates d_i + -(r_ic s_r - r_ic' s_i) and
//   d_i' + -(r_ic s_i + r_ic' s_r) in the plain order; the row of the level
//   itself is never read again and is not updated;
// * the LLR -(n0 - n1) / (2 N0): PyTorch's CUDA division of a tensor by a
//   host scalar multiplies by the float32 reciprocal (div_true_kernel_cuda,
//   BUnaryFunctor), which the wrapper computes on the host as float32
//   1 / (2 N0); here __fmul_rn(-(n0 - n1), inv); +-inf where every leaf
//   agrees on a bit;
// * the clip as torch.clamp's CUDA kernel: a NaN stays, else
//   min(max(x, lo), hi).
// Candidate metrics are never -0.0 (inc >= +0 is a sum of squares, and an
// RN sum is -0 only of two -0), so comparing floats with < and == orders
// them as the radix sort does.  NaN inputs are not matched.
//
// What bounds it: at 4x4 16-QAM, K = 16, a vector's pass is ~11,000 float
// operations (portbench/bounds_kbest.py) against 288 bytes read and written,
// so the card's issue rate bounds it, not its memory.  The design spends
// no instruction on device memory between levels, sorts a lane's 16
// children in 63 compare-exchanges, and picks the 16 survivors of a level
// in 16 rounds of four shuffle stages, with one shared-memory load for the
// lane that won a round.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kNone = 0x7fffffff;  // key of a head that holds no candidate

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

template <int M>
struct Points {
  float re[M];
  float im[M];
};

// (am, ak) before (bm, bk) in the order (metric, key)
__device__ __forceinline__ bool before(float am, int ak, float bm, int bk) {
  return am < bm || (am == bm && ak < bk);
}

// Put entries a and b of the list in (metric, j) order.
template <int M>
__device__ __forceinline__ void order(float (&m)[M], int (&j)[M], int a,
                                      int b) {
  const float ma = m[a], mb = m[b];
  const int ja = j[a], jb = j[b];
  const bool s = before(mb, jb, ma, ja);
  m[a] = s ? mb : ma;
  m[b] = s ? ma : mb;
  j[a] = s ? jb : ja;
  j[b] = s ? ja : jb;
}

// One stage of Batcher's odd-even merge sort (runs of R merged at distance
// D), then the next: the indices are template constants, so the whole
// network (63 compare-exchanges at M = 16) unrolls into straight-line code
// on registers.
template <int M, int R, int D>
__device__ __forceinline__ void oddeven(float (&m)[M], int (&j)[M]) {
#pragma unroll
  for (int b = D % R; b + D < M; b += 2 * D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i + b + D < M && (i + b) / (2 * R) == (i + b + D) / (2 * R))
        order<M>(m, j, i + b, i + b + D);
    }
  }
  if constexpr (D > 1)
    oddeven<M, R, D / 2>(m, j);
  else if constexpr (2 * R < M)
    oddeven<M, 2 * R, 2 * R>(m, j);
}

template <int NT, int M>
__global__ void __launch_bounds__(kThreads) kbest_kernel(
    const float2* __restrict__ r, const float2* __restrict__ yt,
    const float* __restrict__ la, float2* __restrict__ sym_out,
    float* __restrict__ llr_out, long long B, int K, int P,
    const Points<M> pts, float neg_n0, float inv_2n0, int clip_on,
    float clip_lo, float clip_hi) {
  constexpr int BPS = log2i(M);
  constexpr int NB = NT * BPS;
  __shared__ float2 lists[kWarps][M][32];  // a lane's sorted children
  __shared__ float s_re[M], s_im[M];
  if (threadIdx.x == 0) {  // one thread: the indices stay constants
#pragma unroll
    for (int q = 0; q < M; ++q) {
      s_re[q] = pts.re[q];
      s_im[q] = pts.im[q];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rnk = lane & (P - 1), base = lane - rnk;
  long long v = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                    (32 / P) + lane / P;
  const bool live = v < B;
  if (!live) v = B - 1;
  const float2* rv = r + v * NT * NT;
  const float* lv = la ? la + v * NB : nullptr;
  float2* col = &lists[warp][0][lane];

  float dr[NT], di[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float2 t = yt[v * NT + i];
    dr[i] = t.x;
    di[i] = t.y;
  }
  float dt = 0.f;
  int sym = 0;
  int C = 1;  // survivors of the level before
#pragma unroll
  for (int lvl = 0; lvl < NT; ++lvl) {
    const int coor = NT - 1 - lvl;
    const float rii = rv[coor * NT + coor].x;
    float l[BPS];
#pragma unroll
    for (int p = 0; p < BPS; ++p) l[p] = lv ? lv[coor * BPS + p] : 0.f;
    float cm[M];
    int cj[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float er = __fsub_rn(dr[coor], __fmul_rn(rii, pts.re[j]));
      const float ei = __fsub_rn(di[coor], __fmul_rn(rii, pts.im[j]));
      float inc = __fadd_rn(__fmul_rn(er, er), __fmul_rn(ei, ei));
      if (lv) {
        // sgn_b = 1 - 2 bit_b(j), bit 0 the most significant
        float acc = (j >> (BPS - 1)) & 1 ? -l[0] : l[0];
#pragma unroll
        for (int p = 1; p < BPS; ++p)
          acc = __fadd_rn(acc, (j >> (BPS - 1 - p)) & 1 ? -l[p] : l[p]);
        inc = __fadd_rn(inc, __fmul_rn(acc, neg_n0));
      }
      cm[j] = __fadd_rn(dt, inc);
      cj[j] = j;
    }
    const int keep = min(C * M, K);
    int j = 0;
    if (lvl == 0) {
      // one parent, the root, whose children every lane has: a lane ranks
      // its candidates rnk, rnk + P, ... among the M and puts each that
      // survives in the column of its rank
      for (int jj = rnk; jj < M; jj += P) {
        float mj = cm[0];
#pragma unroll
        for (int i = 1; i < M; ++i) mj = jj == i ? cm[i] : mj;
        int rank = 0;
#pragma unroll
        for (int i = 0; i < M; ++i) rank += before(cm[i], i, mj, jj);
        if (rank < keep)
          lists[warp][0][base + rank] = make_float2(mj, __int_as_float(jj));
      }
      __syncwarp();
      if (rnk < keep) {  // no lane has put a candidate past rank keep
        const float2 e = col[0];
        dt = e.x;
        j = __float_as_int(e.y);
      }
    } else {
      oddeven<M, 1, 1>(cm, cj);
#pragma unroll
      for (int q = 0; q < M; ++q)
        col[q * 32] = make_float2(cm[q], __int_as_float(cj[q]));
      float hm = rnk < C ? cm[0] : INFINITY;
      int hk = rnk < C ? (cj[0] << 5 | rnk) : kNone;
      int h = 0;
      float nm = 0.f;
      int nk = 0;
      for (int q = 0; q < keep; ++q) {
        float bm = hm;
        int bk = hk;
        for (int o = P >> 1; o; o >>= 1) {
          const float om = __shfl_xor_sync(kFull, bm, o);
          const int ok = __shfl_xor_sync(kFull, bk, o);
          if (before(om, ok, bm, bk)) {
            bm = om;
            bk = ok;
          }
        }
        if (rnk == q) {
          nm = bm;
          nk = bk;
        }
        if (hk == bk) {  // this lane's head won: its next child
          if (++h < M) {
            const float2 e = col[h * 32];
            hm = e.x;
            hk = __float_as_int(e.y) << 5 | rnk;
          } else {
            hm = INFINITY;
            hk = kNone;
          }
        }
      }
      const int src = base + (rnk < keep ? (nk & 31) : 0);
#pragma unroll
      for (int i = 0; i < coor; ++i) {
        dr[i] = __shfl_sync(kFull, dr[i], src);
        di[i] = __shfl_sync(kFull, di[i], src);
      }
      sym = __shfl_sync(kFull, sym, src);
      dt = nm;
      j = nk >> 5;
    }
    if (rnk >= keep) j = 0;  // no survivor of this rank
    sym |= j << (4 * coor);
    const float sr = s_re[j], si = s_im[j];
#pragma unroll
    for (int i = 0; i < coor; ++i) {
      const float2 ric = rv[i * NT + coor];
      dr[i] = __fadd_rn(dr[i], -__fsub_rn(__fmul_rn(ric.x, sr),
                                          __fmul_rn(ric.y, si)));
      di[i] = __fadd_rn(di[i], -__fadd_rn(__fmul_rn(ric.x, si),
                                          __fmul_rn(ric.y, sr)));
    }
    C = keep;
  }

  if (llr_out) {
    for (int b0 = 0; b0 < NB; b0 += P) {
      const int b = min(b0 + rnk, NB - 1);
      const int t = b / BPS, p = b - t * BPS;
      const int shift = 4 * t + BPS - 1 - p;
      float n0 = INFINITY, n1 = INFINITY;
      for (int s = 0; s < P; ++s) {
        const float lm = __shfl_sync(kFull, dt, base + s);
        const int ls = __shfl_sync(kFull, sym, base + s);
        if (s < C) {
          if ((ls >> shift) & 1)
            n1 = fminf(n1, lm);
          else
            n0 = fminf(n0, lm);
        }
      }
      if (live && b0 + rnk < NB) {
        float x = __fmul_rn(-__fsub_rn(n0, n1), inv_2n0);
        if (clip_on && !isnan(x)) x = fminf(fmaxf(x, clip_lo), clip_hi);
        llr_out[v * NB + b] = x;
      }
    }
  } else {
    const int s0 = __shfl_sync(kFull, sym, base);
    if (live) {
      for (int t = rnk; t < NT; t += P) {
        const int jt = (s0 >> (4 * t)) & 15;
        sym_out[v * NT + t] = make_float2(s_re[jt], s_im[jt]);
      }
    }
  }
}

template <int NT, int M>
int launch(const void* r, const void* yt, const void* la, void* sym,
           void* llr, long long B, int K, int P, const float* points,
           float neg_n0, float inv_2n0, int clip_on, float clip_lo,
           float clip_hi, cudaStream_t st) {
  Points<M> pts;
  for (int c = 0; c < M; ++c) {
    pts.re[c] = points[2 * c];
    pts.im[c] = points[2 * c + 1];
  }
  const long long warps = (B + 32 / P - 1) / (32 / P);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  kbest_kernel<NT, M><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float2*>(r), static_cast<const float2*>(yt),
      static_cast<const float*>(la), static_cast<float2*>(sym),
      static_cast<float*>(llr), B, K, P, pts, neg_n0, inv_2n0, clip_on,
      clip_lo, clip_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r: B x nt x nt complex64 (upper triangular, row-major), yt: B x nt
// complex64, la: B x nt log2(m) float32 priors or null; exactly one of sym
// (B x nt complex64, the best leaf's symbols) and llr (B x nt log2(m)
// float32) non-null.  P: the lanes a vector takes, a power of two from K to
// 32.  points: the m constellation points on the host,
// interleaved (re, im) float32.  neg_n0 = -N0 (the priors' scale), inv_2n0
// = float32 1 / (2 N0); the clip applies where clip_on.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int kbest_launch(const void* r, const void* yt, const void* la,
                            void* sym, void* llr, long long B, int nt, int m,
                            int K, int P, const float* points,
                            float neg_n0, float inv_2n0, int clip_on,
                            float clip_lo, float clip_hi, void* stream) {
  if (B < 1 || B > 0x7fffffffLL || K < 1 || P < K || P > 32 ||
      (P & (P - 1)) || (!sym) == (!llr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KBEST_CASE(NT, M)                                                  \
  if (nt == NT && m == M)                                                  \
    return launch<NT, M>(r, yt, la, sym, llr, B, K, P, points, neg_n0,     \
                         inv_2n0, clip_on, clip_lo, clip_hi, st);
  KBEST_CASE(2, 4)
  KBEST_CASE(2, 16)
  KBEST_CASE(4, 4)
  KBEST_CASE(4, 16)
#undef KBEST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
