// K7: CRC-aided successive-cancellation list decoding of polar codes
// (min-sum f, the approximate path metric) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes polar codes in plain XLA
// (commpy_tpu/ops/polar.py).  The port's plain version
// (commpy_tpu_torch/ops/polar.py:make_polar_scl_decoder_unrolled) issues a
// few small operations a tree node and a stable sort a leaf, ~21,500
// launches a decode of the (1024, 512 + CRC11) code, and leaves the card
// idle most of the time.  This kernel decodes a batch in one launch.
//
// Lanes: the list has PP path slots (L rounded up to a power of two; slots
// past L are carried but never chosen), and a warp (a block of 32 threads)
// decodes G = 32 / PP frames, one lane a path: lane = frame-in-warp * PP +
// slot.  Every frame follows the same walk (it depends on the code alone),
// so the control flow is uniform across the warp and only the data
// differs.  A lane keeps its path's state in registers: the path metric,
// the CRC syndrome of its info bits, its last decision, its payload bits
// (WPL words: ceil(K / 32) rounded up to a power of two), its partial sums
// of levels 0 .. 4 (31 bits, clow), and two slot maps (levels 0..n-1 ->
// slot) saying in which slot its LLRs and partial sums of each higher
// level are.  Paths are never copied in shared memory: a prune copies the
// survivor's registers from its parent's lane (warp shuffles within the
// frame's PP lanes), maps included, and a path writes only its own
// column.  That is safe because all paths walk the tree together: a level
// is rewritten by every path at once, and a level read through the map is
// one no path has rewritten since the map was copied.
//
// Shared memory is one array of 32 columns, column = lane: the LLRs of the
// tree levels 0 .. n-1-vtop (level l in rows 2^l .. 2^(l+1) - 1:
// Lb[(2^l + i) * 32 + column]), the partial sums of levels 5 .. n-1 as
// words of 32 elements (row 2^l + i of a column in bit i % 32 of word
// Cq[((2^l + i) / 32) * 32 + column]), and each frame's 2L candidates and
// L survivors.  A stage's iterations and a word's loads are conflict-free
// (one row, 32 columns); a lane reading another slot of its frame reads
// another column of the same row.  The top vtop levels (up to 3) are not
// stored: a stage that reads one recomputes it from the channel LLRs in
// device memory (f or g at each level down, as the stored levels are
// made), four elements at a time from float4 loads, every load issued
// before the arithmetic; so a frame takes 5.2 KB at N = 1024, L = 8, vtop
// = 3, a warp of four frames 20.9 KB.  vtop is smaller where an all-frozen
// subtree of the walk is that high (its leaves are made in place at its
// own level).
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
// frozen subtree, whose own partial sums are all 0).  The sums are made 32
// elements at a time: for lv < 5 the term depends on i mod 32 alone and is
// one masked, replicated word of clow; for lv >= 5 it is one word of Cq or
// none for the whole word of 32 elements.  An all-frozen subtree of width
// W then takes its leaf LLRs level-parallel in place (each level maps rows
// (a; b) to (f(a, b); a + b), g with the decisions known to be 0), and each
// path adds the W penalties max(-l, 0) in leaf order.  An info leaf: each
// lane forms its path's two candidates, bit * L + parent, the frame's 2L
// candidates are ranked by metric, ties to the lower candidate index (the
// plain version's stable sort), and the L first in rank order survive.  At
// the end a path failing the CRC gets 1e20 added to its metric and the
// least metric of each frame wins, ties to the lower slot.  Frames past
// the batch in the last warp decode the batch's last frame, take part in
// every shuffle, and write nothing.
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
// values) and the bytes (the LLRs once, the payload once) are small.  With
// one frame a warp (and a lane a path modulo PP), every per-path scalar
// step and every stage below level 2 was issued four times at L = 8; with
// one lane a path each is issued once for four frames, and a level-l stage
// is 2^l iterations a lane.  The batch of 4096 frames is then 1024 warps,
// under 8 an SM, so the kernel runs close to one warp's walk, and a warp
// alone issues one dependent instruction after another.  The design keeps
// that walk short: partial sums a word at a time; the level-0 stages (half
// the units) without the general stage's loop; the ranking and the
// payload insert free of branches (a branch on a register array's index
// would put it in local memory); the top levels' loads issued together;
// the descriptors and CRC rows read one unit ahead.  What remains is about
// a quarter prunes (ranking 2L candidates, copying a path's registers),
// a fifth the recomputed top levels, and the stages of levels 1 .. 5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPmInactive = 1e30f;  // metric of slots not yet branched
constexpr float kCrcFail = 1e20f;     // added to CRC-failing paths
constexpr int kLow = 5;  // partial sums of levels 0 .. 4 in a register

// Over the 32 elements i of a word: bit i set where bit lv of i is clear,
// and the factor that repeats a 2^lv-bit word across 32 bits.
__constant__ unsigned kClear[kLow] = {0x55555555u, 0x33333333u, 0x0f0f0f0fu,
                                      0x00ff00ffu, 0x0000ffffu};
__constant__ unsigned kRepeat[kLow] = {0xffffffffu, 0x55555555u, 0x11111111u,
                                       0x01010101u, 0x00010001u};

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

// The pair (a; b) of a stage at level lv - 1 for the four elements k .. k +
// 3 of each (k a multiple of 4, lv >= 3): a = elements k .., b = elements
// k + 2^(lv-1) .. of level lv = n - D, each as top_llr, from float4 loads
// of the channel.  cword(L, k) gives the partial sums of level L, elements
// k .. k + 3, in bits 0 .. 3.  Every load is issued before the arithmetic.
template <int D, typename CWord>
__device__ __forceinline__ void top_pair4(const float* ch, int n, int lo,
                                          int lv, int k, CWord cword,
                                          float4& A, float4& B) {
  constexpr int M = 2 << D;  // a's 2^D channel values, then b's
  constexpr int C = (1 << D) - 1;  // the partial-sum words of a, of b
  const int w = 1 << lv;
  const int hb = w >> 1;
  float x0[M], x1[M], x2[M], x3[M];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int e = k + (q >> D) * hb + (q & ((1 << D) - 1)) * w;
    const float4 v = __ldg(reinterpret_cast<const float4*>(ch + e));
    x0[q] = v.x;
    x1[q] = v.y;
    x2[q] = v.z;
    x3[q] = v.w;
  }
  unsigned c[2 * C > 0 ? 2 * C : 1];
#pragma unroll
  for (int s = 0, o = 0; s < D; o += (1 << D) >> (s + 1), ++s) {
    const int L = n - 1 - s;
    if ((lo >> L) & 1) {
#pragma unroll
      for (int q = 0; q < ((1 << D) >> (s + 1)); ++q) {
        c[o + q] = cword(L, k + q * w);
        c[C + o + q] = cword(L, k + hb + q * w);
      }
    }
  }
#pragma unroll
  for (int s = 0, o = 0; s < D; o += (1 << D) >> (s + 1), ++s) {
    const int L = n - 1 - s;
    const int half = (1 << D) >> (s + 1);
#pragma unroll
    for (int q = 0; q < 2 * half; ++q) {
      const int i = (q / half) * (1 << D) + q % half;  // a's, then b's
      const int j = i + half;
      if ((lo >> L) & 1) {
        const unsigned cc = c[(q / half) * C + o + q % half];
        x0[i] = g_op(x0[i], x0[j], cc & 1u);
        x1[i] = g_op(x1[i], x1[j], cc & 2u);
        x2[i] = g_op(x2[i], x2[j], cc & 4u);
        x3[i] = g_op(x3[i], x3[j], cc & 8u);
      } else {
        x0[i] = f_minsum(x0[i], x0[j]);
        x1[i] = f_minsum(x1[i], x1[j]);
        x2[i] = f_minsum(x2[i], x2[j]);
        x3[i] = f_minsum(x3[i], x3[j]);
      }
    }
  }
  constexpr int Q = 1 << D;
  A = make_float4(x0[0], x1[0], x2[0], x3[0]);
  B = make_float4(x0[Q], x1[Q], x2[Q], x3[Q]);
}

// units: lo | level << 11 | info << 15 | info ordinal << 16.  At least 8
// warps an SM: a batch of 4096 frames at L = 8 in one wave, with the
// registers of the top levels' four-element groups.
template <int PP, int WPL>
__global__ void __launch_bounds__(32, 8)
polar_scl_kernel(const float* __restrict__ llr, int8_t* __restrict__ out,
                 long long B, int N, int n, int P, int K,
                 const int* __restrict__ units, int n_units,
                 const unsigned* __restrict__ crc_rows,
                 int vtop) {  // vtop: the top levels recomputed, 0 .. 3
  constexpr int LOG = PP == 1 ? 0 : PP == 2 ? 1 : PP == 4 ? 2 : 3;
  constexpr int G = 32 / PP;  // frames a warp
  extern __shared__ float smem[];
  // each frame's 2L candidates and L survivors, then the LLR rows 1 .. R-1
  // (R = N / 2^vtop) and the partial-sum words of rows 32 .. N-1 (those of
  // rows below 32 live in clow), 32 columns each
  const int R = N >> vtop;
  const int lane = threadIdx.x;
  const int p = lane & (PP - 1);
  const int fr = lane >> LOG;
  const int base = fr << LOG;  // the frame's first column
  float* cs = smem + fr * 2 * PP;
  int* sel = reinterpret_cast<int*>(smem + 64) + base;
  float* Lb = smem + 96;
  unsigned* Cq = reinterpret_cast<unsigned*>(Lb + R * 32);
  const long long frame = static_cast<long long>(blockIdx.x) * G + fr;
  const bool live = frame < B;
  const float* ch = llr + static_cast<size_t>(live ? frame : B - 1) * N;

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
    if (lv < kLow) return static_cast<int>((clow >> r) & 1u);
    return static_cast<int>(
        (Cq[(r >> 5) * 32 + base + nib(cmap, lv)] >> (r & 31)) & 1u);
  };

  // the partial sums of this path's level lv (>= 2), elements k .. k + 3
  // (k a multiple of 4), in bits 0 .. 3
  auto cword = [&](int lv, int k) -> unsigned {
    const int r = (1 << lv) + k;
    if (lv < kLow) return (clow >> r) & 15u;
    return (Cq[(r >> 5) * 32 + base + nib(cmap, lv)] >> (r & 31)) & 15u;
  };

  // body(i, a, b) for the elements i0 .. i0 + cnt - 1 of a stage at level
  // l, with (a; b) = level l + 1, elements i and i + 2^l, of column col:
  // the channel at level n, the top vtop levels recomputed from it, the
  // rest from shared memory
  auto stage = [&](int l, int i0, int cnt, int col, int lo, auto&& body) {
    const int h = 1 << l;
    const int depth = n - l - 1;  // levels between the row and the channel
    if (depth > vtop) {
      const float* A = Lb + 2 * h * 32 + col;
      const float* Bv = Lb + 3 * h * 32 + col;
#pragma unroll 4
      for (int i = i0; i < i0 + cnt; ++i) body(i, A[i * 32], Bv[i * 32]);
    } else if (depth == 0) {
#pragma unroll 4
      for (int i = i0; i < i0 + cnt; ++i)
        body(i, __ldg(ch + i), __ldg(ch + i + h));
    } else if (h >= 4) {
      // four elements at a time (i0 and cnt are multiples of 4 here)
      for (int i = i0; i < i0 + cnt; i += 4) {
        float4 a, b;
        if (depth == 1) {
          top_pair4<1>(ch, n, lo, l + 1, i, cword, a, b);
        } else if (depth == 2) {
          top_pair4<2>(ch, n, lo, l + 1, i, cword, a, b);
        } else {
          top_pair4<3>(ch, n, lo, l + 1, i, cword, a, b);
        }
        body(i, a.x, b.x);
        body(i + 1, a.y, b.y);
        body(i + 2, a.z, b.z);
        body(i + 3, a.w, b.w);
      }
    } else if (depth == 1) {  // levels 0 and 1 recomputed: N <= 32
      for (int i = i0; i < i0 + cnt; ++i)
        body(i, top_llr<1>(ch, n, lo, l + 1, i, cget),
             top_llr<1>(ch, n, lo, l + 1, i + h, cget));
    } else if (depth == 2) {
      for (int i = i0; i < i0 + cnt; ++i)
        body(i, top_llr<2>(ch, n, lo, l + 1, i, cget),
             top_llr<2>(ch, n, lo, l + 1, i + h, cget));
    } else {
      for (int i = i0; i < i0 + cnt; ++i)
        body(i, top_llr<3>(ch, n, lo, l + 1, i, cget),
             top_llr<3>(ch, n, lo, l + 1, i + h, cget));
    }
  };

  // a unit's CRC row (0 for a frozen unit or without a CRC)
  auto crc_row = [&](int du) -> unsigned {
    return ((du >> 15) & 1) && crc_rows ? __ldg(crc_rows + (du >> 16)) : 0u;
  };
  int d = n_units > 0 ? __ldg(units) : 0;
  unsigned hnext = crc_row(d);
  for (int u = 0; u < n_units; ++u) {
    const int lo = d & 2047;
    const int lev = (d >> 11) & 15;
    const int info = (d >> 15) & 1;
    const int j = d >> 16;
    const unsigned hrow = hnext;
    d = u + 1 < n_units ? __ldg(units + u + 1) : 0;  // the next, ahead
    int t = n;
    if ((lo & 1) && n - 1 > vtop) {
      // g at level 0 from the stored level 1 (half the units): the partial
      // sum of row 1 is the last decision
      t = 0;
      const int sl = base + nib(lmap, 1);
      clow = (clow & ~2u) | (static_cast<unsigned>(lastbit) << 1);
      lam = g_op(Lb[2 * 32 + sl], Lb[3 * 32 + sl], lastbit);
      lmap = set_nib(lmap, 0, p);
      __syncwarp();
    } else if (lo) {
      // g at level t from level t + 1, with the partial sums of level t
      t = __ffs(lo) - 1;
      const int h = 1 << t;
      const int sl = base + nib(lmap, t + 1);
      const bool stored = t < n - vtop;  // the top vtop levels are not
      // the sums' terms of b and of the levels below 5, element i in bit
      // i % 32
      unsigned low = lastbit ? kFull : 0u;
#pragma unroll
      for (int lv = 0; lv < kLow; ++lv) {
        if (lv >= prev_level && lv < t) {
          const unsigned c = (clow >> (1 << lv)) & ((1u << (1 << lv)) - 1u);
          low ^= (c * kRepeat[lv]) & kClear[lv];
        }
      }
      if (t < kLow) {
        clow = (clow & ~(((1u << h) - 1u) << h)) |
               ((low & ((1u << h) - 1u)) << h);
        if (stored) {
          stage(t, 0, h, sl, lo, [&](int i, float a, float b) {
            const float v = g_op(a, b, (low >> i) & 1u);
            if (t == 0) {
              lam = v;
            } else {
              Lb[(h + i) * 32 + lane] = v;
            }
          });
        }
      } else {
        const int lmin = max(prev_level, kLow);
        for (int w = 0; w < (h >> 5); ++w) {
          unsigned s = low;
          for (int lv = lmin; lv < t; ++lv) {
            const int m = lv - kLow;
            if (!((w >> m) & 1)) {
              const int r = (1 << m) + (w & ((1 << m) - 1));
              s ^= Cq[r * 32 + base + nib(cmap, lv)];
            }
          }
          Cq[((h >> 5) + w) * 32 + lane] = s;
          if (stored) {
            stage(t, w << 5, 32, sl, lo, [&](int i, float a, float b) {
              Lb[(h + i) * 32 + lane] = g_op(a, b, (s >> (i & 31)) & 1u);
            });
          }
        }
        cmap = set_nib(cmap, t, p);
      }
      lmap = set_nib(lmap, t, p);
      __syncwarp();
    }
    // f from level l + 1 down to the unit's level (below the top vtop
    // levels, which are not stored)
    for (int l = min(t, n - vtop) - 1; l >= lev; --l) {
      const int h = 1 << l;
      if (l == 0 && n - 1 > vtop) {  // the leaf from the stored level 1
        lam = f_minsum(Lb[2 * 32 + lane], Lb[3 * 32 + lane]);
      } else {
        stage(l, 0, h, lane, lo, [&](int i, float a, float b) {
          const float v = f_minsum(a, b);
          if (l == 0) {
            lam = v;
          } else {
            Lb[(h + i) * 32 + lane] = v;
          }
        });
      }
      lmap = set_nib(lmap, l, p);
      __syncwarp();
    }

    if (!info && lev > 0) {
      // an all-frozen subtree: its leaf LLRs level-parallel, in place
      const int W = 1 << lev;
      float* x = Lb + W * 32 + lane;
      for (int s = 0; s < lev; ++s) {
        const int sh = lev - 1 - s;  // hb = 2^sh
        const int hb = 1 << sh;
#pragma unroll 4
        for (int k = 0; k < (W >> 1); ++k) {
          const int i0 = ((k >> sh) << (sh + 1)) + (k & (hb - 1));
          const float a = x[i0 * 32];
          const float b = x[(i0 + hb) * 32];
          x[i0 * 32] = f_minsum(a, b);
          x[(i0 + hb) * 32] = __fadd_rn(b, a);
        }
      }
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        pm = __fadd_rn(pm, fmaxf(-x[w * 32], 0.f));
      }
      lastbit = 0;
      __syncwarp();
    } else if (!info) {
      pm = __fadd_rn(pm, fmaxf(-lam, 0.f));
      lastbit = 0;
    } else {
      // an info leaf: this path's candidates c0 = p (bit 0) and c1 = P + p
      // (bit 1), ranked among the frame's 2P
      const bool real = p < P;
      const float c0 = __fadd_rn(pm, fmaxf(-lam, 0.f));
      const float c1 = __fadd_rn(pm, fmaxf(lam, 0.f));
      // slots past L fill the candidates 2L .. 2PP - 1 with +inf, which
      // ranks behind every candidate
      cs[real ? p : PP + p] = real ? c0 : __int_as_float(0x7f800000);
      cs[P + p] = real ? c1 : __int_as_float(0x7f800000);
      __syncwarp();
      float v[2 * PP];
      if constexpr (PP == 1) {
        const float2 q2 = *reinterpret_cast<const float2*>(cs);
        v[0] = q2.x;
        v[1] = q2.y;
      } else {
#pragma unroll
        for (int k4 = 0; k4 < PP / 2; ++k4) {
          const float4 q4 = reinterpret_cast<const float4*>(cs)[k4];
          v[4 * k4] = q4.x;
          v[4 * k4 + 1] = q4.y;
          v[4 * k4 + 2] = q4.z;
          v[4 * k4 + 3] = q4.w;
        }
      }
      // four partial counts a candidate, bitwise: no branches
      int r0[4] = {0, 0, 0, 0}, r1[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 2 * PP; ++k) {
        r0[k & 3] += (v[k] < c0) | ((v[k] == c0) & (k < p));
        r1[k & 3] += (v[k] < c1) | ((v[k] == c1) & (k < P + p));
      }
      const int rank0 = (r0[0] + r0[1]) + (r0[2] + r0[3]);
      const int rank1 = (r1[0] + r1[1]) + (r1[2] + r1[3]);
      if (real) {
        if (rank0 < P) sel[rank0] = p;
        if (rank1 < P) sel[rank1] = P + p;
      }
      __syncwarp();
      const int mine = real ? sel[p] : p;  // slots past L keep their own
      const int q = real && mine >= P ? mine - P : mine;
      const int nb = real && mine >= P;
      if (real) pm = cs[mine];
      syn = __shfl_sync(kFull, syn, q, PP) ^ (nb ? hrow : 0u);
      clow = __shfl_sync(kFull, clow, q, PP);
      lmap = __shfl_sync(kFull, lmap, q, PP);
      cmap = __shfl_sync(kFull, cmap, q, PP);
#pragma unroll
      for (int r = 0; r < WPL; ++r) {
        words[r] = __shfl_sync(kFull, words[r], q, PP);
      }
      // branch-free, so the words stay in registers
      const unsigned bit = (nb && j < K) ? 1u << (j & 31) : 0u;
#pragma unroll
      for (int r = 0; r < WPL; ++r) words[r] |= r == (j >> 5) ? bit : 0u;
      lastbit = nb;
    }
    prev_level = lev;
    hnext = crc_row(d);  // the next unit's, its descriptor here by now
  }

  // CRC-aided selection: each frame's least metric, failing paths 1e20
  // behind, ties to the lower slot
  const float score = (crc_rows && syn != 0u) ? __fadd_rn(pm, kCrcFail) : pm;
  float best = __shfl_sync(kFull, score, 0, PP);
  int win = 0;
#pragma unroll
  for (int r = 1; r < PP; ++r) {
    const float v = __shfl_sync(kFull, score, r, PP);
    if (r < P && v < best) {
      best = v;
      win = r;
    }
  }
  int8_t* o = out + static_cast<size_t>(live ? frame : 0) * K;
  const int nw = (K + 31) >> 5;
#pragma unroll
  for (int m = 0; m < WPL; ++m) {
    if (m < nw) {
      const unsigned word = __shfl_sync(kFull, words[m], win, PP);
      if (live) {
        for (int k = p; k < 32 && (m << 5) + k < K; k += PP) {
          o[(m << 5) + k] = static_cast<int8_t>((word >> k) & 1u);
        }
      }
    }
  }
}

template <int PP, int WPL>
int launch(const float* llr, int8_t* out, long long B, int N, int n, int P,
           int K, const int* units, int n_units, const unsigned* crc_rows,
           int vtop, cudaStream_t st) {
  constexpr int G = 32 / PP;
  const int R = N >> vtop;
  // G frames of the plan's bytes (kernels/polar_scl.py:polar_scl_plan)
  const size_t smem = G * (96 + static_cast<size_t>(4) * R * PP +
                           static_cast<size_t>(4) * ((N * PP + 31) / 32));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        polar_scl_kernel<PP, WPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long warps = (B + G - 1) / G;
  polar_scl_kernel<PP, WPL><<<static_cast<unsigned>(warps), 32, smem, st>>>(
      llr, out, B, N, n, P, K, units, n_units, crc_rows, vtop);
  return static_cast<int>(cudaGetLastError());
}

// the payload words a lane holds: ceil(K / 32) rounded up to a power of two
template <int PP>
int launch_words(const float* llr, int8_t* out, long long B, int N, int n,
                 int P, int K, const int* units, int n_units,
                 const unsigned* crc_rows, int vtop, cudaStream_t st) {
  const int nw = (K + 31) >> 5;
  if (nw <= 1)
    return launch<PP, 1>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                         vtop, st);
  if (nw <= 2)
    return launch<PP, 2>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                         vtop, st);
  if (nw <= 4)
    return launch<PP, 4>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                         vtop, st);
  if (nw <= 8)
    return launch<PP, 8>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                         vtop, st);
  if (nw <= 16)
    return launch<PP, 16>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                          vtop, st);
  return launch<PP, 32>(llr, out, B, N, n, P, K, units, n_units, crc_rows,
                        vtop, st);
}

}  // namespace

extern "C" int polar_scl_launch(const void* llr, void* out, long long B,
                                int N, int P, int K, const void* units,
                                int n_units, const void* crc_rows, int vtop,
                                void* stream) {
  int n = 0;
  while ((1 << n) < N) ++n;
  if ((1 << n) != N || n < 1 || n > 10 || P < 1 || P > 8 || K < 1 ||
      K > N || B < 1 || B > 0x7fffffffLL || vtop < 0 || vtop > 3 ||
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
    case 1:
      return launch_words<1>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    case 2:
      return launch_words<2>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    case 4:
      return launch_words<4>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
    default:
      return launch_words<8>(l, o, B, N, n, P, K, u, n_units, c, vtop, st);
  }
}
