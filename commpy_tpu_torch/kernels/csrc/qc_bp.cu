// QC-LDPC belief propagation for Hopper (sm_90a): resident and streamed.
//
// K4 qc_bp_resident_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas (its body _qc_bp_kernel, check update _make_cn_update).
// K5 qc_bp_streamed_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas_streamed (its body _qc_bp_streamed_kernel).
//
// Both loop over a frame until its syndrome passes or n_iters sweeps, so
// a converged frame is never touched again.  The Python wrappers
// (kernels/qc_bp.py) check shapes and budgets, plan both launches, and hold
// the plain PyTorch versions these kernels must match bit for bit (MSA)
// on the card.
//
// K4 keeps each frame's totals and all nnz*Z check-to-variable (c2v)
// messages in dynamic shared memory, laid out c2v[e*Z + z] (edges being
// the nonzero blocks in row-major order), with the graph's packed tables
// beside them, one frame a block.  Its launch plan (kernels/qc_bp.py:
// resident_plan) gives the block's threads:
//   * flooding: a thread per check (i, z) while the frame's Mb*Z checks
//     fit the block (every 802.11n code and WiMAX 1440), else each thread
//     loops over several; then a thread per variable position (looping)
//     for the totals, ((llr + c1) + c2) ... over each column's blocks in
//     row-major order, the LLRs read from device memory;
//   * layered: a thread per circulant position z of a check block row
//     (looping past the block's threads); rows whose columns differ need
//     only the barrier that ends them (thread z alone touches its check's
//     positions), a row with a repeated column keeps a barrier after its
//     reads and one before each repeated block;
//   * a row's messages in registers: the row loop is unrolled to a
//     compile-time bound KMAX (8, 16 or 32) and left at the row's K, so no
//     array is indexed at run time; at KMAX = 8 a flooding thread keeps
//     its check's positions from sweep to sweep, and below KMAX = 32 a
//     layered thread the old messages and totals it read for the row's
//     updates;
//   * the flooding syndrome folded into the next sweep's check phase: a
//     check reads the totals of all its positions for its v2c messages,
//     so it also forms its parity from their sign bits, and it writes its
//     new messages at once; one __syncthreads_or then both publishes the
//     messages and tells whether any check failed.  A frame whose checks
//     all pass stops there with its totals untouched (the messages it
//     wrote are never read).  The first sweep's parity is the
//     raw LLRs', its v2c llr + 0.0, the totals of zero messages.  The
//     layered syndrome needs the totals after the last row, so it stays a
//     pass of its own, each thread stopping at its first failing check.
//   Packed tables (int32): edge[e] = (ej*Z) << 11 | repeated << 10 | es,
//   row[i] = e0 | K << 16 | has_repeat << 31 (both as K5's), col[j] =
//   q0 | D << 16 and cedge[q0 + d] = (e*Z) << 11 | es of the d-th edge of
//   column j.  Check (i, z) reads variable ej*Z + (z + es) % Z of each edge
//   e of row i; its message returns to that position.
//
// K5 (layered only) keeps a frame's totals in shared memory and its
// messages in a store in device memory (float32 or bfloat16), laid out
// c2v[e*Zp + z] with Zp = Z rounded up to 8, so that a check block row's
// messages are one contiguous, 16-byte aligned run of K*Zp values.  Design:
//   * persistent grid: `grid` blocks (frames in flight: as many as the SMs
//     hold at once by shared memory and registers, the wrapper's launch
//     plan), block b decoding frames b, b + grid, ...; the store holds one
//     frame per block, not all B;
//   * a two-slot ring in shared memory: while row i computes, cp.async
//     brings row i+1's messages (16 bytes a copy, every thread of the
//     block) into the other slot, and a register brings its keep bits;
//     the first sweep reads no message (all zero) and issues no copy;
//   * a row's messages, positions and totals in registers: the row loop
//     is unrolled to a compile-time bound KMAX (8, 16 or 32) and left at
//     the row's K, so no array is indexed at run time and a short row
//     costs its own length (KMAX = 32 re-reads old messages from the ring
//     and totals from shared memory rather than hold them);
//   * one barrier per row: thread z alone reads and writes the positions
//     (ej*Z + (z + es) % Z) of its check in a row whose columns differ, so
//     a row needs only the barrier that ends it (and lands the ring).  A
//     row with a repeated column keeps a barrier after its reads and one
//     before each repeated block: the order of its updates is semantics;
//   * packed tables: edge[e] = (ej*Z) << 11 | repeated << 10 | es (in
//     shared memory), row[i] = e0 | K << 16 | has_repeat << 31, and
//     keep[i*Z + z], bit k clear where pos_masks removes edge e0+k at
//     check position z (DVB-S2's accumulator wrap), or null.
//
// What bounds them on an H100 (chip_smoke.py works both out from its
// inputs): K4 at the 802.11n (1944, 972) bench shape (B=512, MSA, 15
// iterations, no frame converging) moves ~8 MB (LLRs in, decisions and
// posteriors out, 2.4 us at 3.35 TB/s) and does ~15 float operations per
// edge per iteration, none a fused multiply-add, ~0.8 G in all, ~24 us at
// the 33.5 T instructions/s behind the 67 TFLOP/s FMA peak: bound by
// operations.  Its sweeps are chains of dependent shared-memory reads
// between barriers, so K4 is held by latency: one flooding frame of 972
// checks fills an SM's registers (~60 a check held across the syndrome's
// barrier).  K5 at the DVB-S2-class 16200 shape (B=512, layered 8) moves
// ~75 MB and does ~3.9 G operations: 0.1155 ms, bound by operations too.
// Its message store is scratch of the design, read and written once a
// sweep: 2.06 GB a decode in float32 (1.03 GB in bfloat16), 0.616 ms
// (0.308) at 3.35 TB/s if all of it went to device memory.  The stores of
// the frames in flight (252 KB a frame in float32, 126 KB in bfloat16;
// 66.5 MB and 33.3 MB at two frames a SM) fit the 50 MB L2 in bfloat16
// and not in float32; the L2's own rate is not measured here, so no bound
// is claimed for a store it holds.  Its times are recorded in PERF.md.
//
// Numerics: every add, subtract and multiply is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which the compiler never
// contracts into a fused multiply-add, in the plain version's order.
// MSA's sign product keeps the sign of a zero v2c message
// (jnp.sign(-0.0) == -0.0) and is formed as the product (pre_s * suf_s),
// the XOR of the other edges' sign bits with a zero magnitude when any
// other edge is zero, then multiplied by max(scale * min - offset, 0).
// SPA uses tanhf and log1pf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;      // empty leave-one-out minimum
constexpr float kLlrMax = 500.f;   // clip of SPA messages
constexpr float kMaskedV2c = 1e30f;  // v2c of a masked edge position

__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int wrap(int z, int Z) {
  return z >= Z ? z - Z : (z < 0 ? z + Z : z);
}

// Position of edge word `ed` at check position z.
__device__ __forceinline__ int edge_pos(int ed, int z, int Z) {
  return (ed >> 11) + wrap(z + (ed & 1023), Z);
}

// Leave-one-out check update of a check's K <= KMAX messages in registers
// (MSA or SPA, in the plain version's order of operations), in place: the
// loops unrolled to KMAX and left at K.
template <int KMAX>
__device__ __forceinline__ void cn_update_row(float (&v)[KMAX], int K,
                                              bool spa, float scale,
                                              float offset) {
  if (spa) {
    float suf[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      v[k] = tanhf(__fmul_rn(v[k], 0.5f));
    }
    float acc = 1.f;
#pragma unroll
    for (int k = KMAX - 1; k >= 0; --k) {
      if (k >= K) continue;
      suf[k] = acc;
      acc = __fmul_rn(acc, v[k]);
    }
    acc = 1.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      float p = __fmul_rn(acc, suf[k]);
      acc = __fmul_rn(acc, v[k]);
      p = fminf(fmaxf(p, -1.f), 1.f);
      const float m = __fsub_rn(log1pf(p), log1pf(-p));
      v[k] = fminf(fmaxf(m, -kLlrMax), kLlrMax);
    }
    return;
  }
  float min1 = kBig, min2 = kBig;
  int idx1 = -1, zeros = 0;
  unsigned neg = 0u;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    const float a = fabsf(v[k]);
    if (a < min1) {
      min2 = min1;
      min1 = a;
      idx1 = k;
    } else if (a < min2) {
      min2 = a;
    }
    zeros += v[k] == 0.f;
    neg ^= signbit(v[k]) ? 1u : 0u;
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    const float lm = k == idx1 ? min2 : min1;
    const float mag = fmaxf(__fsub_rn(__fmul_rn(scale, lm), offset), 0.f);
    const bool self_zero = v[k] == 0.f;
    const unsigned b = neg ^ (signbit(v[k]) ? 1u : 0u);
    const bool other_zero = zeros - (self_zero ? 1 : 0) > 0;
    const float s = other_zero ? (b ? -0.f : 0.f) : (b ? -1.f : 1.f);
    v[k] = __fmul_rn(s, mag);
  }
}

// ---------------------------------------------------------------------------
// K4: the resident kernel
// ---------------------------------------------------------------------------

// Threads a K4 block may have (kernels/qc_bp.py:resident_max_threads).
constexpr int k4_max_threads(int kmax, bool layered) {
  return layered || kmax > 16 ? 512 : 1024;
}

struct ResidentGraph {
  const int* edge;   // [E] (ej*Z) << 11 | repeated << 10 | es
  const int* row;    // [Mb] e0 | K << 16 | has_repeat << 31
  const int* col;    // [Nb] q0 | D << 16
  const int* cedge;  // [E] (e*Z) << 11 | es, each column's edges in turn
  int Z, Nb, Mb, E;
};

// p / Z for p * Z < 2^32, from zinv = ceil(2^32 / Z)
__device__ __forceinline__ int div_z(int p, unsigned long long zinv) {
  return (int)(((unsigned long long)p * zinv) >> 32);
}

// Position of edge word `ed` at check position z (z + es < 2Z).
__device__ __forceinline__ int k4_pos(int ed, int z, int Z) {
  const int u = z + (ed & 1023);
  return (ed >> 11) + (u >= Z ? u - Z : u);
}

// Parity of check (row `info`, position z) on the signs of the totals.
__device__ __forceinline__ int check_parity(const float* tot,
                                            const int* s_edge, int info,
                                            int z, int Z) {
  const int e0 = info & 0xffff;
  const int K = (info >> 16) & 0x7fff;
  unsigned bits = 0u;
  for (int k = 0; k < K; ++k) {
    bits ^= __float_as_uint(tot[k4_pos(s_edge[e0 + k], z, Z)]);
  }
  return (int)(bits >> 31);
}

// MSA check update of K <= KMAX messages in registers, in place: the
// same values as cn_update_row's MSA, in fewer instructions.  The two
// smallest magnitudes by min/max (|v| is never -0.0), the first
// minimum's index by the strict compare; each output is the magnitude
// max(scale * min - offset, 0), or +0.0 where another message is zero,
// with the sign bit of the other messages' sign product (a zero keeps
// its own sign, as jnp.sign(-0.0) does) set by XOR: exactly the plain
// version's (pre_s * suf_s) * mag, since that magnitude is finite.
template <int KMAX>
__device__ __forceinline__ void msa_update_k4(float (&v)[KMAX], int K,
                                              float scale, float offset) {
  float min1 = kBig, min2 = kBig;
  int idx1 = -1, zeros = 0;
  unsigned neg = 0u;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    const float a = fabsf(v[k]);
    if (a < min1) idx1 = k;
    min2 = fminf(min2, fmaxf(min1, a));
    min1 = fminf(min1, a);
    zeros += v[k] == 0.f;
    neg ^= __float_as_uint(v[k]);
  }
  const float mag1 = fmaxf(__fsub_rn(__fmul_rn(scale, min1), offset), 0.f);
  const float mag2 = fmaxf(__fsub_rn(__fmul_rn(scale, min2), offset), 0.f);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    const bool other_zero = zeros - (v[k] == 0.f ? 1 : 0) > 0;
    const float mag = other_zero ? 0.f : (k == idx1 ? mag2 : mag1);
    const unsigned sign = (neg ^ __float_as_uint(v[k])) & 0x80000000u;
    v[k] = __uint_as_float(__float_as_uint(mag) ^ sign);
  }
}

template <int KMAX, bool SPA>
__device__ __forceinline__ void cn_update_k4(float (&v)[KMAX], int K,
                                             float scale, float offset) {
  if constexpr (SPA) {
    cn_update_row<KMAX>(v, K, true, scale, offset);
  } else {
    msa_update_k4<KMAX>(v, K, scale, offset);
  }
}

// The v2c messages of check (row `info`, position z) from the totals as
// they stand (llr + 0.0 in the first sweep, the totals of zero messages)
// into v; returns the XOR of the totals' bits (its sign bit: the parity).
template <int KMAX>
__device__ __forceinline__ unsigned check_read(const float* tot,
                                               const float* c2v,
                                               const int* s_edge, int info,
                                               int z, int Z, bool first,
                                               float (&v)[KMAX]) {
  const int e0 = info & 0xffff;
  const int K = (info >> 16) & 0x7fff;
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float t = tot[k4_pos(s_edge[e0 + k], z, Z)];
    bits ^= __float_as_uint(t);
    if (first) t = __fadd_rn(t, 0.f);
    v[k] = __fsub_rn(t, c2v[(e0 + k) * Z + z]);
  }
  return bits;
}

// One check block row of the layered sweep, messages updated in place:
// every v2c from the totals as they stand, the check update, then the
// row's total updates, tot = tot + (new - old).  Ends with a barrier.
// Below KMAX = 32 the old messages and totals read stay in registers, so
// the updates load nothing a store could precede; KMAX = 32 reads them
// again after the check update.
template <int KMAX, bool SPA>
__device__ __forceinline__ void resident_row(float* tot, float* c2v,
                                             const int* s_edge, int info,
                                             int Z, int t, int tpf,
                                             float scale, float offset) {
  constexpr bool kHold = KMAX <= 16;
  const int e0 = info & 0xffff;
  const int K = (info >> 16) & 0x7fff;
  if (info >= 0) {  // columns differ: thread z alone touches its positions
    for (int z = t; z < Z; z += tpf) {
      float v[KMAX], ho[kHold ? KMAX : 1], ht[kHold ? KMAX : 1];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        const float tv = tot[k4_pos(s_edge[e0 + k], z, Z)];
        const float o = c2v[(e0 + k) * Z + z];
        if constexpr (kHold) {
          ht[k] = tv;
          ho[k] = o;
        }
        v[k] = __fsub_rn(tv, o);
      }
      cn_update_k4<KMAX, SPA>(v, K, scale, offset);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        const int pos = k4_pos(s_edge[e0 + k], z, Z);
        float* msg = c2v + (e0 + k) * Z + z;
        if constexpr (kHold) {
          *msg = v[k];
          tot[pos] = __fadd_rn(ht[k], __fsub_rn(v[k], ho[k]));
        } else {
          const float o = *msg;
          const float tv = tot[pos];
          *msg = v[k];
          tot[pos] = __fadd_rn(tv, __fsub_rn(v[k], o));
        }
      }
    }
    __syncthreads();
    return;
  }
  // a repeated column: the plan gives a thread per position (Z <= tpf)
  const bool mine = t < Z;
  float v[KMAX];
  if (mine) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      v[k] = __fsub_rn(tot[k4_pos(s_edge[e0 + k], t, Z)],
                       c2v[(e0 + k) * Z + t]);
    }
    cn_update_k4<KMAX, SPA>(v, K, scale, offset);
  }
  __syncthreads();  // every read of this row's totals is done
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;  // K is the block's: every thread leaves together
    if ((s_edge[e0 + k] >> 10) & 1) __syncthreads();
    if (mine) {
      const int pos = k4_pos(s_edge[e0 + k], t, Z);
      float* msg = c2v + (e0 + k) * Z + t;
      const float o = *msg;
      *msg = v[k];
      tot[pos] = __fadd_rn(tot[pos], __fsub_rn(v[k], o));
    }
  }
  __syncthreads();
}

// The frame's layered syndrome: true where a check fails; a thread stops
// at its first failing check.
__device__ __forceinline__ int layered_bad(const float* tot,
                                           const int* s_edge,
                                           const int* s_row, int Mb, int Z,
                                           int t, int tpf) {
  int bad = 0;
  for (int z = t; z < Z && !bad; z += tpf) {
    for (int i = 0; i < Mb && !bad; ++i) {
      bad = check_parity(tot, s_edge, s_row[i], z, Z);
    }
  }
  return bad;
}

// Block b decodes frame b.  Shared memory: the frame's totals [n] and
// messages [E*Z] (floats), then the tables edge [E], row [Mb], col [Nb]
// and cedge [E].  One instantiation a row bound, schedule and check
// update, so each holds only the registers its own loop needs: flooding
// blocks of up to 1024 threads (64 registers a thread; 512 at KMAX = 32),
// layered of up to 512 (128 registers for the row's held values).
template <int KMAX, bool LAYERED, bool SPA>
__global__ void __launch_bounds__(k4_max_threads(KMAX, LAYERED), 1)
qc_bp_resident_kernel(const float* __restrict__ llr, int8_t* __restrict__ dec,
                      float* __restrict__ out, ResidentGraph g, int n_iters,
                      float scale, float offset,
                      unsigned long long* __restrict__ sweeps) {
  extern __shared__ __align__(16) float smem_f[];
  const int Z = g.Z;
  const int n = g.Nb * Z;
  const int EZ = g.E * Z;
  const int nchk = g.Mb * Z;
  const int t = threadIdx.x;
  const int tpf = blockDim.x;
  const size_t b = blockIdx.x;
  float* tot = smem_f;
  float* c2v = tot + n;
  int* s_edge = reinterpret_cast<int*>(c2v + EZ);
  int* s_row = s_edge + g.E;
  int* s_col = s_row + g.Mb;
  int* s_cedge = s_col + g.Nb;
  for (int i = t; i < g.E; i += tpf) {
    s_edge[i] = g.edge[i];
    s_cedge[i] = g.cedge[i];
  }
  for (int i = t; i < g.Mb; i += tpf) s_row[i] = g.row[i];
  for (int i = t; i < g.Nb; i += tpf) s_col[i] = g.col[i];
  const float* x = llr + b * n;
  for (int p = t; p < n; p += tpf) tot[p] = x[p];
  for (int p = t; p < EZ; p += tpf) c2v[p] = 0.f;
  __syncthreads();
  const unsigned long long zinv = ((1ull << 32) + Z - 1) / Z;
  int it = 0;  // the sweeps that updated the frame's messages, at the end
  if constexpr (LAYERED) {
    bool bad = __syncthreads_or(layered_bad(tot, s_edge, s_row, g.Mb, Z, t,
                                            tpf)) != 0;
    for (; it < n_iters && bad; ++it) {
      for (int i = 0; i < g.Mb; ++i) {
        resident_row<KMAX, SPA>(tot, c2v, s_edge, s_row[i], Z, t, tpf, scale,
                                offset);
      }
      bad = __syncthreads_or(layered_bad(tot, s_edge, s_row, g.Mb, Z, t,
                                         tpf)) != 0;
    }
  } else {
    const bool single = nchk <= tpf;  // a thread per check
    // a thread's own check (i0, z0): its row, messages and (at KMAX = 8,
    // where the registers allow) positions
    constexpr bool kPos = KMAX == 8;
    const int i0 = div_z(t, zinv);
    const int z0 = t - i0 * Z;
    const int info0 = single && t < nchk ? s_row[i0] : 0;
    const int e00 = info0 & 0xffff;
    const int K0 = (info0 >> 16) & 0x7fff;
    const int m0 = e00 * Z + z0;  // c2v of its first edge
    int pos0[kPos ? KMAX : 1];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (!kPos || k >= K0) break;
      pos0[kPos ? k : 0] = k4_pos(s_edge[e00 + k], z0, Z);
    }
    for (; it < n_iters; ++it) {
      // Each check reads its positions' totals (the raw LLRs' first) for
      // its v2c messages and its parity, and writes its new messages; once
      // every check passes the frame is done, its totals (the output)
      // untouched and the messages it wrote never read.  So one barrier
      // decides and publishes the messages.
      unsigned bits = 0u;
      if (single) {
        float v[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K0) break;
          float tv = tot[kPos ? pos0[kPos ? k : 0]
                              : k4_pos(s_edge[e00 + k], z0, Z)];
          bits ^= __float_as_uint(tv);
          if (it == 0) tv = __fadd_rn(tv, 0.f);
          v[k] = __fsub_rn(tv, c2v[m0 + k * Z]);
        }
        cn_update_k4<KMAX, SPA>(v, K0, scale, offset);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K0) break;
          c2v[m0 + k * Z] = v[k];
        }
      } else {
        for (int c = t; c < nchk; c += tpf) {
          const int i = div_z(c, zinv);
          const int z = c - i * Z;
          const int info = s_row[i];
          const int e0 = info & 0xffff;
          const int K = (info >> 16) & 0x7fff;
          float v[KMAX];
          bits |= check_read<KMAX>(tot, c2v, s_edge, info, z, Z, it == 0,
                                   v) & 0x80000000u;
          cn_update_k4<KMAX, SPA>(v, K, scale, offset);
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (k >= K) break;
            c2v[(e0 + k) * Z + z] = v[k];
          }
        }
      }
      if (!__syncthreads_or(bits >> 31)) break;
      for (int p = t; p < n; p += tpf) {
        const int j = div_z(p, zinv);
        const int z = p - j * Z;
        const int info = s_col[j];
        const int q0 = info & 0xffff;
        const int D = info >> 16;
        float a = __ldg(x + p);
        for (int q = 0; q < D; ++q) {
          const int ce = s_cedge[q0 + q];
          const int u = z - (ce & 1023);
          a = __fadd_rn(a, c2v[(ce >> 11) + (u < 0 ? u + Z : u)]);
        }
        tot[p] = a;
      }
      __syncthreads();
    }
  }
  for (int p = t; p < n; p += tpf) {
    const float a = tot[p];
    out[b * n + p] = a;
    dec[b * n + p] = signbit(a) ? 1 : 0;
  }
  if (sweeps != nullptr && t == 0) atomicAdd(sweeps, (unsigned long long)it);
}

// ---------------------------------------------------------------------------
// K5: the streamed layered kernel
// ---------------------------------------------------------------------------

constexpr int kStreamedThreads = 512;  // Z <= 512: a thread per position

struct StreamGraph {
  const int* edge;       // [E] (ej*Z) << 11 | repeated << 10 | es
  const int* row;        // [Mb] e0 | K << 16 | has_repeat << 31
  const unsigned* keep;  // [Mb*Z] keep bits of check (i, z), or null
  int Z, Zp, Nb, Mb, E, kmax;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread of the block copies 16-byte pieces of row `info`'s
// messages (K*Zp values from c2v + e0*Zp) into a ring slot.
template <typename T>
__device__ __forceinline__ void prefetch_row(T* slot, const T* c2v, int info,
                                             int Zp) {
  const int e0 = info & 0xffff;
  const int K = (info >> 16) & 0x7fff;
  const int pieces = K * Zp * (int)sizeof(T) / 16;
  const char* src = reinterpret_cast<const char*>(c2v + (size_t)e0 * Zp);
  char* dst = reinterpret_cast<char*>(slot);
  for (int c = threadIdx.x; c < pieces; c += blockDim.x) {
    cp_async16(dst + 16 * c, src + 16 * c);
  }
  cp_async_commit();
}

// The frame's syndrome on signbit(tot), true in every thread when a check
// fails; a thread stops at its first failing check.
__device__ bool streamed_syndrome_bad(const float* tot, const int* s_edge,
                                      const StreamGraph& g) {
  const int z = threadIdx.x;
  int bad = 0;
  if (z < g.Z) {
    for (int i = 0; i < g.Mb && !bad; ++i) {
      const int info = __ldg(g.row + i);
      const int e0 = info & 0xffff;
      const int K = (info >> 16) & 0x7fff;
      const unsigned km = g.keep != nullptr ? __ldg(g.keep + i * g.Z + z)
                                            : ~0u;
      int par = 0;
      for (int k = 0; k < K; ++k) {
        const int d = signbit(tot[edge_pos(s_edge[e0 + k], z, g.Z)]) ? 1 : 0;
        par ^= d & (int)((km >> k) & 1u);
      }
      bad = par;
    }
  }
  return __syncthreads_or(bad) != 0;
}

// One check block row: thread z < Z owns check (i, z).  `slot` holds the
// row's old messages (unread in the first sweep).  Ends before the row's
// closing barrier.
template <typename T, int KMAX>
__device__ __forceinline__ void streamed_row(float* tot, const T* slot,
                                             T* c2v, const int* s_edge,
                                             int info, unsigned km,
                                             const StreamGraph& g, bool first,
                                             bool spa, float scale,
                                             float offset, bool has_keep) {
  // KMAX = 32 holds only v and pos, and re-reads old messages and totals
  constexpr bool kHold = KMAX <= 16;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int Z = g.Z, Zp = g.Zp;
  const int z = threadIdx.x;
  const int e0 = info & 0xffff;
  const int K = (info >> 16) & 0x7fff;
  const bool repeat_row = info < 0;
  float v[KMAX], old[kHold ? KMAX : 1], tv[kHold ? KMAX : 1];
  int pos[KMAX];
  if (z < Z) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      pos[k] = edge_pos(s_edge[e0 + k], z, Z);
      const float o = first ? 0.f : load_msg(slot + k * Zp + z);
      const float t = tot[pos[k]];
      float x = __fsub_rn(t, o);
      if (has_keep && !((km >> k) & 1u)) x = kMaskedV2c;
      if constexpr (kHold) {
        old[k] = o;
        tv[k] = t;
      }
      v[k] = x;
    }
    cn_update_row<KMAX>(v, K, spa, scale, offset);
    T* dst = c2v + (size_t)e0 * Zp + z;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      float m = v[k];
      if (has_keep) m = __fmul_rn(m, (km >> k) & 1u ? 1.f : 0.f);
      if (kBf16) m = __bfloat162float(__float2bfloat16_rn(m));
      v[k] = m;
      store_msg(dst + k * Zp, m);
    }
  }
  if (!repeat_row) {
    // thread z alone touches its positions in this row: no barrier
    if (z < Z) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        float o, t;
        if constexpr (kHold) {
          o = old[k];
          t = tv[k];
        } else {
          o = first ? 0.f : load_msg(slot + k * Zp + z);
          t = tot[pos[k]];
        }
        tot[pos[k]] = __fadd_rn(t, __fsub_rn(v[k], o));
      }
    }
    return;
  }
  __syncthreads();  // every read of this row's totals is done
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;  // K is the block's: every thread leaves together
    if ((s_edge[e0 + k] >> 10) & 1) __syncthreads();
    if (z < Z) {
      float o;
      if constexpr (kHold) {
        o = old[k];
      } else {
        o = first ? 0.f : load_msg(slot + k * Zp + z);
      }
      tot[pos[k]] = __fadd_rn(tot[pos[k]], __fsub_rn(v[k], o));
    }
  }
}

// Shared memory: totals [n, padded to 4], ring [2][kmax*Zp] of T, edge
// table [E].  Block b decodes frames b, b + gridDim.x, ... with the
// message store's b-th [E*Zp] slice.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kStreamedThreads)
qc_bp_streamed_kernel(const float* __restrict__ llr, int8_t* __restrict__ dec,
                      float* __restrict__ out, T* __restrict__ store,
                      StreamGraph g, int B, int n_iters, int spa, float scale,
                      float offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = g.Nb * g.Z;
  const int n4 = (n + 3) & ~3;
  const int ring_len = g.kmax * g.Zp;
  float* s_tot = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(s_tot + n4);
  int* s_edge = reinterpret_cast<int*>(ring + 2 * ring_len);
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) s_edge[e] = g.edge[e];
  T* c2v = store + (size_t)blockIdx.x * g.E * g.Zp;
  const bool has_keep = g.keep != nullptr;
  const int z = threadIdx.x;
  for (int f = blockIdx.x; f < B; f += gridDim.x) {
    const size_t base = (size_t)f * n;
#pragma unroll 8
    for (int p = threadIdx.x; p < n; p += blockDim.x) s_tot[p] = llr[base + p];
    __syncthreads();
    bool active = streamed_syndrome_bad(s_tot, s_edge, g);
    unsigned km = has_keep && z < g.Z ? __ldg(g.keep + z) : ~0u;
    int cnt = 0;  // rows of this frame so far: the ring slot is cnt & 1
    for (int it = 0; it < n_iters && active; ++it) {
      for (int i = 0; i < g.Mb; ++i, ++cnt) {
        const int ni = i + 1 < g.Mb ? i + 1 : 0;
        const int nit = i + 1 < g.Mb ? it : it + 1;
        const bool pre = nit >= 1 && nit < n_iters;
        T* next_slot = ring + ((cnt + 1) & 1) * ring_len;
        if (pre && g.Mb > 1) {
          prefetch_row(next_slot, c2v, __ldg(g.row + ni), g.Zp);
        }
        const unsigned km_next =
            has_keep && z < g.Z ? __ldg(g.keep + ni * g.Z + z) : ~0u;
        streamed_row<T, KMAX>(s_tot, ring + (cnt & 1) * ring_len, c2v,
                              s_edge, __ldg(g.row + i), km, g, it == 0,
                              spa != 0, scale, offset, has_keep);
        if (pre && g.Mb == 1) {  // the next row is this one: after its stores
          __syncthreads();
          prefetch_row(next_slot, c2v, __ldg(g.row + ni), g.Zp);
        }
        cp_async_wait_all();
        __syncthreads();
        km = km_next;
      }
      active = streamed_syndrome_bad(s_tot, s_edge, g);
    }
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float t = s_tot[p];
      out[base + p] = t;
      dec[base + p] = signbit(t) ? 1 : 0;
    }
    __syncthreads();  // the totals are read out before the next frame
  }
}

template <typename K>
int launch_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, int KMAX>
int launch_streamed(const float* llr, int8_t* dec, float* out, T* store,
                    const StreamGraph& g, int B, int grid, int threads,
                    size_t bytes, int n_iters, int spa, float scale,
                    float offset, cudaStream_t stream) {
  auto* kernel = qc_bp_streamed_kernel<T, KMAX>;
  const int rc = launch_smem(kernel, bytes);
  if (rc) return rc;
  kernel<<<grid, threads, bytes, stream>>>(llr, dec, out, store, g, B,
                                           n_iters, spa, scale, offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_streamed_kmax(int kmax_t, const float* llr, int8_t* dec,
                         float* out, T* store, const StreamGraph& g, int B,
                         int grid, int threads, size_t bytes, int n_iters,
                         int spa, float scale, float offset,
                         cudaStream_t stream) {
  switch (kmax_t) {
    case 8:
      return launch_streamed<T, 8>(llr, dec, out, store, g, B, grid, threads,
                                   bytes, n_iters, spa, scale, offset,
                                   stream);
    case 16:
      return launch_streamed<T, 16>(llr, dec, out, store, g, B, grid,
                                    threads, bytes, n_iters, spa, scale,
                                    offset, stream);
    case 32:
      return launch_streamed<T, 32>(llr, dec, out, store, g, B, grid,
                                    threads, bytes, n_iters, spa, scale,
                                    offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

struct ResidentArgs {
  const float* llr;
  int8_t* dec;
  float* out;
  ResidentGraph g;
  int B, threads, n_iters;
  size_t bytes;
  float scale, offset;
  unsigned long long* sweeps;
  cudaStream_t stream;
};

template <int KMAX, bool LAYERED, bool SPA>
int launch_resident(const ResidentArgs& a) {
  auto* kernel = qc_bp_resident_kernel<KMAX, LAYERED, SPA>;
  const int rc = launch_smem(kernel, a.bytes);
  if (rc) return rc;
  kernel<<<a.B, a.threads, a.bytes, a.stream>>>(a.llr, a.dec, a.out, a.g,
                                               a.n_iters, a.scale, a.offset,
                                               a.sweeps);
  return (int)cudaGetLastError();
}

template <int KMAX>
int launch_resident_kmax(const ResidentArgs& a, int spa, int layered) {
  if (layered) {
    return spa ? launch_resident<KMAX, true, true>(a)
               : launch_resident<KMAX, true, false>(a);
  }
  return spa ? launch_resident<KMAX, false, true>(a)
             : launch_resident<KMAX, false, false>(a);
}

}  // namespace

// The launch plan (kernels/qc_bp.py:resident_plan) gives kmax_t (the
// compile-time row bound), the block's threads (whole warps) and the
// shared memory bytes; a plan that does not hold the code is refused.
// Block b decodes frame b.  With `sweeps` set, each block adds to it the
// sweeps that updated its frame's messages: 0 for a frame whose
// decisions pass every check at the start, else up to n_iters.
extern "C" int qc_bp_resident_launch(
    const float* llr, int8_t* dec, float* out, const int* edge,
    const int* row, const int* col, const int* cedge, int Z, int Nb, int Mb,
    int E, int kmax, int kmax_t, int B, int threads, int smem_bytes,
    int n_iters, int spa, int layered, float scale, float offset,
    unsigned long long* sweeps, void* stream) {
  const size_t need =
      sizeof(float) * ((size_t)Nb * Z + (size_t)E * Z) +
      sizeof(int) * ((size_t)2 * E + Mb + Nb);
  if (Z < 1 || Z > 1024 || kmax > kmax_t || threads < 32 || threads % 32 ||
      threads > k4_max_threads(kmax_t, layered != 0) ||
      (size_t)smem_bytes != need) {
    return (int)cudaErrorInvalidValue;
  }
  const ResidentGraph g{edge, row, col, cedge, Z, Nb, Mb, E};
  const ResidentArgs a{llr,    dec,    out,   g, B, threads, n_iters,
                       (size_t)smem_bytes, scale, offset, sweeps,
                       (cudaStream_t)stream};
  switch (kmax_t) {
    case 8: return launch_resident_kmax<8>(a, spa, layered);
    case 16: return launch_resident_kmax<16>(a, spa, layered);
    case 32: return launch_resident_kmax<32>(a, spa, layered);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch plan (kernels/qc_bp.py:streamed_plan) gives Zp, kmax_t (the
// compile-time row bound), grid, threads and the shared memory bytes; the
// store holds grid * E * Zp messages.
extern "C" int qc_bp_streamed_launch(
    const float* llr, int8_t* dec, float* out, void* store, const int* edge,
    const int* row, const unsigned* keep, int Z, int Zp, int Nb, int Mb,
    int E, int kmax, int kmax_t, int B, int grid, int threads, int smem_bytes,
    int n_iters, int spa, int bf16, float scale, float offset, void* stream) {
  if (Z > kStreamedThreads || threads > kStreamedThreads || threads < Z ||
      Zp % 8 != 0 || Zp < Z || kmax > kmax_t || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const StreamGraph g{edge, row, keep, Z, Zp, Nb, Mb, E, kmax};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    return launch_streamed_kmax<__nv_bfloat16>(
        kmax_t, llr, dec, out, static_cast<__nv_bfloat16*>(store), g, B, grid,
        threads, (size_t)smem_bytes, n_iters, spa, scale, offset, st);
  }
  return launch_streamed_kmax<float>(
      kmax_t, llr, dec, out, static_cast<float*>(store), g, B, grid, threads,
      (size_t)smem_bytes, n_iters, spa, scale, offset, st);
}
