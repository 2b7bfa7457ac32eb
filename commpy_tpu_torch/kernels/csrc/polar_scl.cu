// K7: CRC-aided successive-cancellation list decoding of polar codes
// (min-sum f, the approximate path metric) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes polar codes in plain XLA
// (commpy_tpu/ops/polar.py).  The port's plain version
// (commpy_tpu_torch/ops/polar.py:make_polar_scl_decoder_unrolled) issues a
// few small operations a tree node and a stable sort a leaf, ~21,500
// launches a decode of the (1024, 512 + CRC11) code, and leaves the card
// idle most of the time.  This kernel decodes a whole frame, all L paths,
// in one warp and one launch.
//
// One warp a frame (a block of 32 threads).  The list has PP path slots
// (L rounded up to a power of two; slots past L are carried but never
// chosen).  Shared memory holds, for every slot, the LLRs of the tree
// levels 0 .. n-1-vtop (level l in rows 2^l .. 2^(l+1) - 1, the slot
// innermost: Lb[(2^l + i) * PP + slot]), the partial sums of levels 5 ..
// n-1 as bits (bit (2^l + i) * PP + slot of Cw), and a prune's 2L
// candidates.  The top vtop levels (up to 3) are not stored: a stage that
// reads one recomputes it from the channel LLRs in device memory (f or g
// at each level down, as the stored levels are made), so a frame takes
// 5.2 KB at N = 1024, L = 8, vtop = 3, and an SM holds 32 frames.  vtop
// is smaller where an all-frozen subtree of the walk is that high (its
// leaves are made in place at its own level).
//
// Lanes: lane x works for path x % PP, so a lane keeps its path's state in
// registers: the path metric, the CRC syndrome of its info bits, its last
// decision, its payload bits (PP words a lane, 32 a path), its partial
// sums of levels 0 .. 4 (31 bits), and two slot maps (levels 0..n-1 ->
// slot) saying in which slot its LLRs and partial sums of each higher
// level are.  Paths are never copied in shared memory: a
// prune copies the survivor's registers from its parent's lanes (warp
// shuffles), maps included, and a path writes only its own slot.  That is
// safe because all paths walk the tree together: a level is rewritten by
// every path at once, and a level read through the map is one no path has
// rewritten since the map was copied.
//
// The walk goes over units, a plan made on the host from the frozen mask
// (kernels/polar_scl.py:polar_units): each maximal all-frozen subtree and
// each info leaf, in leaf order.  A unit starting at leaf lo refreshes the
// LLRs from level t = ntz(lo) (n at lo = 0) down to its own level: g at
// level t from level t + 1, then f below.  The g stage also computes and
// stores the partial sums of level t, the left sibling's, which the
// previous unit completed:
//     s_i = b ^ XOR over levels lv in [lmin, t) with bit lv of i clear of
//           C[lv][i mod 2^lv]
// where lmin is the previous unit's level and b its decision (0 after a
// frozen subtree, whose own partial sums are all 0).  An all-frozen subtree
// of width W then takes its leaf LLRs level-parallel in place (each level
// maps rows (a; b) to (f(a, b); a + b), g with the decisions known to be
// 0), and each path adds the W penalties max(-l, 0) in leaf order.  An info
// leaf ranks the 2L candidates bit * L + parent by metric, ties to the
// lower candidate index (the plain version's stable sort), and keeps the L
// first in rank order.  At the end a path failing the CRC gets 1e20 added
// to its metric and the least metric wins, ties to the lower slot.
//
// Numerics, bit for bit with the plain version: f = sign(a) sign(b)
// min(|a|, |b|) (the sign by the XOR of the sign bits; only the sign of a
// zero can differ, and no later value depends on it), g = b + a or b - a
// (the plain b + (1 - 2 s) a rounds the same), float32 metrics summed leaf
// by leaf in the plain order, 1e30 for slots not yet branched.  The file is
// built with -fmad=false.
//
// What bounds it: the walk is a chain of dependent stages (~1,440 at the
// cell's (1024, 523) code) and one prune an info leaf, each a few
// shared-memory or shuffle latencies; the arithmetic (~L N log2 N node
// values) and the bytes (the LLRs once, the payload once) are small.  A
// frame alone takes ~2.3M cycles (g stages about half, prunes a quarter,
// f stages a fifth); 32 frames an SM overlap to ~3.3 ms for 4096 frames
// on an H100, by then bound by the instructions issued.  So the design
// keeps shared memory small, for the frames an SM holds to hide one
// another's latency, keeps what it can in registers, and takes the unit
// descriptors one ahead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPmInactive = 1e30f;  // metric of slots not yet branched
constexpr float kCrcFail = 1e20f;     // added to CRC-failing paths

__device__ __forceinline__ float f_minsum(float a, float b) {
  const float m = fminf(fabsf(a), fabsf(b));
  return __int_as_float(((__float_as_int(a) ^ __float_as_int(b)) &
                         0x80000000) | __float_as_int(m));
}

__device__ __forceinline__ float g_op(float a, float b, int s) {
  return s ? __fsub_rn(b, a) : __fadd_rn(b, a);
}

// slot maps: 3 bits a level (slots 0 .. 7), levels 0 .. 9 in 30 bits
__device__ __forceinline__ int nib(unsigned map, int level) {
  return static_cast<int>((map >> (3 * level)) & 7u);
}

__device__ __forceinline__ unsigned set_nib(unsigned map, int level,
                                            int slot) {
  return (map & ~(7u << (3 * level))) |
         (static_cast<unsigned>(slot) << (3 * level));
}

constexpr int kLow = 5;  // partial sums of levels 0 .. 4 in a register

// The partial sum of row r (level l, element i: r = 2^l + i) of slot sl.
template <int PP>
__device__ __forceinline__ int cbit(const unsigned* Cw, int r, int sl) {
  const int k = r * PP + sl;
  return static_cast<int>((Cw[k >> 5] >> (k & 31)) & 1u);
}

// The LLR of element k of level lv = n - D on the way to leaf lo,
// recomputed from the 2^D channel LLRs under it: at each level L from n - 1
// down, f where the node is a left child (bit L of lo clear) and g with the
// path's partial sums of level L (cget) where it is a right child; the same
// operations in the same order as the stored levels'.
template <int D, typename CGet>
__device__ __forceinline__ float top_llr(const float* ch, int n, int lo,
                                         int lv, int k, CGet cget) {
  constexpr int M = 1 << D;
  const int w = 1 << lv;
  float x[M];
#pragma unroll
  for (int q = 0; q < M; ++q) x[q] = __ldg(ch + k + q * w);
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int L = n - 1 - s;
    const bool right = (lo >> L) & 1;
#pragma unroll
    for (int q = 0; q < (M >> (s + 1)); ++q) {
      const float a = x[q], b = x[q + (M >> (s + 1))];
      x[q] = right ? g_op(a, b, cget(L, k + q * w)) : f_minsum(a, b);
    }
  }
  return x[0];
}

// units: lo | level << 11 | info << 15 | info ordinal << 16
template <int PP>
__global__ void __launch_bounds__(32, 32)
polar_scl_kernel(const float* __restrict__ llr, int8_t* __restrict__ out,
                 int N, int n, int P, int K, const int* __restrict__ units,
                 int n_units, const unsigned* __restrict__ crc_rows,
                 int vtop) {  // vtop: the top levels recomputed, 0 .. 3
  constexpr int LOG = PP == 1 ? 0 : PP == 2 ? 1 : PP == 4 ? 2 : 3;
  constexpr int WPL = PP;  // payload words a lane: 32 a path
  extern __shared__ float smem[];
  // the 2L candidates of a prune and the survivors' candidates, then the
  // LLR rows 1 .. R-1 (R = N / 2^vtop) and the partial-sum bits of rows
  // 1 .. N-1 (those of rows below 32 live in clow)
  const int R = N >> vtop;
  float* cs = smem;
  int* sel = reinterpret_cast<int*>(smem + 16);
  float* Lb = smem + 24;
  unsigned* Cw = reinterpret_cast<unsigned*>(Lb + R * PP);
  const int lane = threadIdx.x;
  const int p = lane & (PP - 1);
  const int grp = lane >> LOG;
  const float* ch = llr + static_cast<size_t>(blockIdx.x) * N;

  float pm = p == 0 ? 0.f : kPmInactive;
  unsigned syn = 0u;
  int lastbit = 0;
  int prev_level = 0;
  unsigned lmap = 0u, cmap = 0u;
  unsigned clow = 0u;  // this path's partial sums of rows 1 .. 31
  for (int l = 0; l < n; ++l) {
    lmap = set_nib(lmap, l, p);
    cmap = set_nib(cmap, l, p);
  }
  unsigned words[WPL];
#pragma unroll
  for (int r = 0; r < WPL; ++r) words[r] = 0u;
  float lam = 0.f;  // the leaf LLR of this lane's path

  // the partial sum of this path's level lv, element k
  auto cget = [&](int lv, int k) -> int {
    const int r = (1 << lv) + k;
    return lv < kLow ? static_cast<int>((clow >> r) & 1u)
                     : cbit<PP>(Cw, r, nib(cmap, lv));
  };

  // the rows (a; b) = level l + 1, elements i and i + 2^l, of slot sl:
  // the channel at level n, and the top vtop levels recomputed from it
  auto src = [&](int l, int i, int sl, int lo, float& a, float& b) {
    const int h = 1 << l;
    const int depth = n - l - 1;  // levels between the row and the channel
    if (depth == 0) {
      a = __ldg(ch + i);
      b = __ldg(ch + i + h);
    } else if (depth <= vtop) {
      switch (depth) {
        case 1:
          a = top_llr<1>(ch, n, lo, l + 1, i, cget);
          b = top_llr<1>(ch, n, lo, l + 1, i + h, cget);
          break;
        case 2:
          a = top_llr<2>(ch, n, lo, l + 1, i, cget);
          b = top_llr<2>(ch, n, lo, l + 1, i + h, cget);
          break;
        default:
          a = top_llr<3>(ch, n, lo, l + 1, i, cget);
          b = top_llr<3>(ch, n, lo, l + 1, i + h, cget);
      }
    } else {
      a = Lb[(2 * h + i) * PP + sl];
      b = Lb[(3 * h + i) * PP + sl];
    }
  };

  int d = n_units > 0 ? __ldg(units) : 0;
  for (int u = 0; u < n_units; ++u) {
    const int lo = d & 2047;
    const int lev = (d >> 11) & 15;
    const int info = (d >> 15) & 1;
    const int j = d >> 16;
    d = u + 1 < n_units ? __ldg(units + u + 1) : 0;  // the next, ahead
    const unsigned hrow = (info && crc_rows) ? __ldg(crc_rows + j) : 0u;
    int t = n;
    if (lo) {
      // g at level t from level t + 1, with the partial sums of level t
      t = __ffs(lo) - 1;
      const int h = 1 << t;
      const int sl = nib(lmap, t + 1);
      if (t < kLow) {
        // the partial sums of level t in registers, every element
        unsigned bits = 0u;
        for (int i = 0; i < h; ++i) {
          unsigned s = static_cast<unsigned>(lastbit);
#pragma unroll
          for (int lv = 0; lv < kLow; ++lv) {
            if (lv >= prev_level && lv < t && !((i >> lv) & 1)) {
              s ^= (clow >> ((1 << lv) + (i & ((1 << lv) - 1)))) & 1u;
            }
          }
          bits |= s << i;
        }
        clow = (clow & ~(((1u << h) - 1u) << h)) | (bits << h);
      }
      const int count = PP << t;
      for (int e0 = 0; e0 < count; e0 += 32) {
        const int e = count < 32 ? (lane & (count - 1)) : e0 + lane;
        const int i = e >> LOG;
        int s;
        if (t < kLow) {
          s = static_cast<int>((clow >> (h + i)) & 1u);
        } else {
          s = lastbit;
#pragma unroll
          for (int lv = 0; lv < 10; ++lv) {
            if (lv >= prev_level && lv < t && !((i >> lv) & 1)) {
              s ^= cget(lv, i & ((1 << lv) - 1));
            }
          }
          // the 32 bits of this pass: rows h + i of the PP slots
          const unsigned bal = __ballot_sync(kFull, s);
          if (lane == 0) Cw[(h * PP + e0) >> 5] = bal;
        }
        if (t < n - vtop) {  // the top vtop levels are not stored
          float a, b;
          src(t, i, sl, lo, a, b);
          const float v = g_op(a, b, s);
          if (t == 0) {
            lam = v;
          } else {
            Lb[(h + i) * PP + p] = v;
          }
        }
      }
      if (t >= kLow) cmap = set_nib(cmap, t, p);
      lmap = set_nib(lmap, t, p);
      __syncwarp();
    }
    // f from level l + 1 down to the unit's level (below the top vtop
    // levels, which are not stored)
    for (int l = min(t, n - vtop) - 1; l >= lev; --l) {
      const int h = 1 << l;
      const int count = PP << l;
      for (int e0 = 0; e0 < count; e0 += 32) {
        const int e = count < 32 ? (lane & (count - 1)) : e0 + lane;
        const int i = e >> LOG;
        float a, b;
        src(l, i, p, lo, a, b);
        const float v = f_minsum(a, b);
        if (l == 0) {
          lam = v;
        } else {
          Lb[(h + i) * PP + p] = v;
        }
      }
      lmap = set_nib(lmap, l, p);
      __syncwarp();
    }

    if (!info && lev > 0) {
      // an all-frozen subtree: its leaf LLRs level-parallel, in place
      const int W = 1 << lev;
      float* x = Lb + W * PP;
      for (int s = 0; s < lev; ++s) {
        const int hb = W >> (s + 1);
        const int count = PP * (W >> 1);
        for (int e0 = 0; e0 < count; e0 += 32) {
          const int e = e0 + lane;
          if (e < count) {
            const int k = e >> LOG;
            const int i0 = ((k / hb) * 2 * hb) + (k & (hb - 1));
            const float a = x[i0 * PP + p];
            const float b = x[(i0 + hb) * PP + p];
            x[i0 * PP + p] = f_minsum(a, b);
            x[(i0 + hb) * PP + p] = __fadd_rn(b, a);
          }
        }
        __syncwarp();
      }
      for (int w = 0; w < W; ++w) {
        pm = __fadd_rn(pm, fmaxf(-x[w * PP + p], 0.f));
      }
      lastbit = 0;
      __syncwarp();
    } else if (!info) {
      pm = __fadd_rn(pm, fmaxf(-lam, 0.f));
      lastbit = 0;
    } else {
      // an info leaf: lane c < 2P is candidate c = bit * P + parent, the
      // lane of parent c % P where P fills the slots
      const bool valid = lane < 2 * P;
      float lq = lam, pq = pm;
      if (P != PP) {
        const int cq = valid ? (lane < P ? lane : lane - P) : 0;
        lq = __shfl_sync(kFull, lam, cq);
        pq = __shfl_sync(kFull, pm, cq);
      }
      const float cand = __fadd_rn(pq, fmaxf(lane >= P ? lq : -lq, 0.f));
      if (valid) cs[lane] = cand;
      __syncwarp();
      int rank = 0;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float4 v = reinterpret_cast<const float4*>(cs)[k4];
        const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = 4 * k4 + m;
          rank += (k < 2 * P) &&
                  ((vk[m] < cand) || (vk[m] == cand && k < lane));
        }
      }
      if (valid && rank < P) sel[rank] = lane;
      __syncwarp();
      const bool real = p < P;
      const int mine = real ? sel[p] : lane;
      const int q = real ? (mine < P ? mine : mine - P) : p;
      const int nb = real ? (mine >= P) : 0;
      if (real) pm = cs[mine];
      syn = __shfl_sync(kFull, syn, q) ^ (nb ? hrow : 0u);
      clow = __shfl_sync(kFull, clow, q);
      lmap = __shfl_sync(kFull, lmap, q);
      cmap = __shfl_sync(kFull, cmap, q);
      const int from = (grp << LOG) | q;
#pragma unroll
      for (int r = 0; r < WPL; ++r) {
        words[r] = __shfl_sync(kFull, words[r], from);
      }
      if (nb && j < K && grp == (j >> 5) / WPL) {
        const int reg = (j >> 5) % WPL;
#pragma unroll
        for (int r = 0; r < WPL; ++r) {
          if (r == reg) words[r] |= 1u << (j & 31);
        }
      }
      lastbit = nb;
    }
    prev_level = lev;
  }

  // CRC-aided selection: the least metric, failing paths 1e20 behind
  const float score = (crc_rows && syn != 0u) ? __fadd_rn(pm, kCrcFail) : pm;
  float best = __shfl_sync(kFull, score, 0);
  int win = 0;
#pragma unroll
  for (int r = 1; r < 8; ++r) {
    const float v = __shfl_sync(kFull, score, r & (PP - 1));
    if (r < P && v < best) {
      best = v;
      win = r;
    }
  }
  int8_t* o = out + static_cast<size_t>(blockIdx.x) * K;
  const int nw = (K + 31) >> 5;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    if (m < nw) {
      const unsigned word =
          __shfl_sync(kFull, words[m % WPL], ((m / WPL) << LOG) | win);
      const int jj = (m << 5) + lane;
      if (jj < K) o[jj] = static_cast<int8_t>((word >> lane) & 1u);
    }
  }
}

template <int PP>
int launch(const float* llr, int8_t* out, long long B, int N, int n, int P,
           int K, const int* units, int n_units, const unsigned* crc_rows,
           int vtop, cudaStream_t st) {
  const int R = N >> vtop;
  const size_t smem = 96 + static_cast<size_t>(4) * R * PP +
                      static_cast<size_t>(4) * ((N * PP + 31) / 32);
  polar_scl_kernel<PP><<<static_cast<unsigned>(B), 32, smem, st>>>(
      llr, out, N, n, P, K, units, n_units, crc_rows, vtop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int polar_scl_launch(const void* llr, void* out, long long B,
                                int N, int P, int K, const void* units,
                                int n_units, const void* crc_rows, int vtop,
                                void* stream) {
  int n = 0;
  while ((1 << n) < N) ++n;
  if ((1 << n) != N || n < 1 || n > 10 || P < 1 || P > 8 || K < 0 ||
      B < 1 || B > 0x7fffffffLL || vtop < 0 || vtop > 3 ||
      vtop >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int PP = P == 1 ? 1 : P == 2 ? 2 : P <= 4 ? 4 : 8;
  const float* l = static_cast<const float*>(llr);
  int8_t* o = static_cast<int8_t*>(out);
  const int* u = static_cast<const int*>(units);
  const unsigned* c = static_cast<const unsigned*>(crc_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (PP) {
    case 1: return launch<1>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    case 2: return launch<2>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    case 4: return launch<4>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    default: return launch<8>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
  }
}
