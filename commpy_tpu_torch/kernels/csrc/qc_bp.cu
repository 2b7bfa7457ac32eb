// QC-LDPC belief propagation for Hopper (sm_90a): resident and streamed.
//
// K4 qc_bp_resident_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas (its body _qc_bp_kernel, check update _make_cn_update).
// K5 qc_bp_streamed_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas_streamed (its body _qc_bp_streamed_kernel).
//
// Both loop over a frame until its syndrome passes or n_iters sweeps, so
// a converged frame is never touched again.  The Python wrappers
// (kernels/qc_bp.py) check shapes and budgets, plan K5's launch, and hold
// the plain PyTorch versions these kernels must match bit for bit (MSA)
// on the card.
//
// K4: one block decodes one frame, holding its channel LLRs, totals and
// all nnz*Z check-to-variable (c2v) messages in dynamic shared memory; a
// thread per check (flooding) or per circulant position (layered), rows
// of at most 32 blocks in local arrays.  Its graph is passed as int
// tables, so nothing is compiled per code:
//   ej, es     [E]      block column and shift (mod Z) of edge e, edges being
//                       the nonzero blocks in row-major order
//   row_start  [Mb+1]   first edge of each check block row
//   col_start  [Nb+1], col_edges [E]: each column's edges, row-major order
// Check (i, z) reads variable ej*Z + (z + es) % Z of each edge e of row i;
// its message returns to that position.
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
// operations.  K5 at the DVB-S2-class 16200 shape (B=512, layered 8) moves
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

constexpr int kMaxRow = 32;        // widest check block row
constexpr float kBig = 3e38f;      // empty leave-one-out minimum
constexpr float kLlrMax = 500.f;   // clip of SPA messages
constexpr float kMaskedV2c = 1e30f;  // v2c of a masked edge position

struct Graph {
  const int* ej;
  const int* es;
  const int* row_start;
  const int* col_start;
  const int* col_edges;
  const uint8_t* keep;
  int Z, Nb, Mb, E;
};

__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Leave-one-out check update of one check's K incoming messages, in place.
__device__ void cn_update(float* v, int K, bool spa, float scale,
                          float offset) {
  if (spa) {
    float t[kMaxRow], suf[kMaxRow];
    for (int k = 0; k < K; ++k) t[k] = tanhf(__fmul_rn(v[k], 0.5f));
    float acc = 1.f;
    for (int k = K - 1; k >= 0; --k) {
      suf[k] = acc;
      acc = __fmul_rn(acc, t[k]);
    }
    acc = 1.f;
    for (int k = 0; k < K; ++k) {
      float p = __fmul_rn(acc, suf[k]);
      acc = __fmul_rn(acc, t[k]);
      p = fminf(fmaxf(p, -1.f), 1.f);
      const float m = __fsub_rn(log1pf(p), log1pf(-p));
      v[k] = fminf(fmaxf(m, -kLlrMax), kLlrMax);
    }
    return;
  }
  // MSA: the minimum over the other edges is min2 at the first minimum's
  // index and min1 elsewhere, which is exactly min(prefix, suffix)
  float min1 = kBig, min2 = kBig;
  int idx1 = -1, zeros = 0;
  unsigned neg = 0u;
  for (int k = 0; k < K; ++k) {
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
  for (int k = 0; k < K; ++k) {
    const float lm = k == idx1 ? min2 : min1;
    const float mag = fmaxf(__fsub_rn(__fmul_rn(scale, lm), offset), 0.f);
    const bool self_zero = v[k] == 0.f;
    const unsigned b = neg ^ (signbit(v[k]) ? 1u : 0u);
    const bool other_zero = zeros - (self_zero ? 1 : 0) > 0;
    const float s = other_zero ? (b ? -0.f : 0.f) : (b ? -1.f : 1.f);
    v[k] = __fmul_rn(s, mag);
  }
}

__device__ __forceinline__ int wrap(int z, int Z) {
  return z >= Z ? z - Z : (z < 0 ? z + Z : z);
}

// True (in every thread) when any check of the frame fails on the
// decisions signbit(tot).
__device__ bool syndrome_bad(const float* tot, const Graph& g) {
  int bad = 0;
  for (int c = threadIdx.x; c < g.Mb * g.Z; c += blockDim.x) {
    const int i = c / g.Z;
    const int z = c - i * g.Z;
    int par = 0;
    for (int e = g.row_start[i]; e < g.row_start[i + 1]; ++e) {
      int d = signbit(tot[g.ej[e] * g.Z + wrap(z + g.es[e], g.Z)]) ? 1 : 0;
      if (g.keep != nullptr && !g.keep[e * g.Z + z]) d = 0;
      par ^= d;
    }
    bad |= par;
  }
  return __syncthreads_or(bad) != 0;
}

// One check block row of the layered sweep: thread z owns check (i, z).
// Every v2c is taken from the totals as they stand; after the check update
// the row's total updates land one block after another, with a barrier
// before a block whose column the row has already touched.  T is the
// message store's type; bf16 rounds each new message before it counts.
template <typename T>
__device__ void layered_row(float* tot, T* c2v, const Graph& g, int i,
                            bool first, bool spa, float scale, float offset,
                            bool bf16) {
  const int Z = g.Z;
  const int z = threadIdx.x;
  const int e0 = g.row_start[i];
  const int K = g.row_start[i + 1] - e0;
  float v[kMaxRow], old[kMaxRow];
  if (z < Z) {
    for (int k = 0; k < K; ++k) {
      const int e = e0 + k;
      const float o = first ? 0.f : load_msg(c2v + (size_t)e * Z + z);
      float x = __fsub_rn(tot[g.ej[e] * Z + wrap(z + g.es[e], Z)], o);
      if (g.keep != nullptr && !g.keep[e * Z + z]) x = kMaskedV2c;
      old[k] = o;
      v[k] = x;
    }
    cn_update(v, K, spa, scale, offset);
    for (int k = 0; k < K; ++k) {
      const int e = e0 + k;
      float m = v[k];
      if (g.keep != nullptr) m = __fmul_rn(m, g.keep[e * Z + z] ? 1.f : 0.f);
      if (bf16) m = __bfloat162float(__float2bfloat16_rn(m));
      v[k] = m;
      store_msg(c2v + (size_t)e * Z + z, m);
    }
  }
  __syncthreads();  // every read of this row's totals is done
  for (int k = 0; k < K; ++k) {
    const int j = g.ej[e0 + k];
    bool repeat = false;
    for (int q = 0; q < k; ++q) repeat |= g.ej[e0 + q] == j;
    if (repeat) __syncthreads();
    if (z < Z) {
      const int p = j * Z + wrap(z + g.es[e0 + k], Z);
      tot[p] = __fadd_rn(tot[p], __fsub_rn(v[k], old[k]));
    }
  }
  __syncthreads();
}

// Flooding totals ((llr + c1) + c2) ... over each column's blocks in
// row-major order, then a barrier.
__device__ void flooding_totals(float* tot, const float* llr,
                                const float* c2v, const Graph& g) {
  const int Z = g.Z;
  for (int p = threadIdx.x; p < g.Nb * Z; p += blockDim.x) {
    const int j = p / Z;
    const int z = p - j * Z;
    float t = llr[p];
    for (int q = g.col_start[j]; q < g.col_start[j + 1]; ++q) {
      const int e = g.col_edges[q];
      t = __fadd_rn(t, c2v[e * Z + wrap(z - g.es[e], Z)]);
    }
    tot[p] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
qc_bp_resident_kernel(const float* __restrict__ llr, int8_t* __restrict__ dec,
                      float* __restrict__ out, Graph g, int n_iters, int spa,
                      int layered, float scale, float offset) {
  extern __shared__ float smem[];
  const int Z = g.Z;
  const int n = g.Nb * Z;
  const int EZ = g.E * Z;
  float* s_llr = smem;       // [n]
  float* s_tot = smem + n;   // [n]
  float* s_c2v = smem + 2 * n;  // [E*Z]
  const size_t base = (size_t)blockIdx.x * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float x = llr[base + p];
    s_llr[p] = x;
    s_tot[p] = x;
  }
  for (int p = threadIdx.x; p < EZ; p += blockDim.x) s_c2v[p] = 0.f;
  __syncthreads();
  bool active = syndrome_bad(s_tot, g);
  for (int it = 0; it < n_iters && active; ++it) {
    if (layered) {
      for (int i = 0; i < g.Mb; ++i)
        layered_row<float>(s_tot, s_c2v, g, i, false, spa, scale, offset,
                           false);
    } else {
      // the Pallas body recomputes the totals from the messages at the
      // start of every sweep; later sweeps find the previous sweep's, but
      // the first turns a -0.0 LLR into llr + 0.0 = +0.0
      if (it == 0) flooding_totals(s_tot, s_llr, s_c2v, g);
      // check update: every v2c from the totals of the previous sweep
      for (int c = threadIdx.x; c < g.Mb * Z; c += blockDim.x) {
        const int i = c / Z;
        const int z = c - i * Z;
        const int e0 = g.row_start[i];
        const int K = g.row_start[i + 1] - e0;
        float v[kMaxRow];
        for (int k = 0; k < K; ++k) {
          const int e = e0 + k;
          v[k] = __fsub_rn(s_tot[g.ej[e] * Z + wrap(z + g.es[e], Z)],
                           s_c2v[e * Z + z]);
        }
        cn_update(v, K, spa, scale, offset);
        for (int k = 0; k < K; ++k) s_c2v[(e0 + k) * Z + z] = v[k];
      }
      __syncthreads();
      flooding_totals(s_tot, s_llr, s_c2v, g);
    }
    active = syndrome_bad(s_tot, g);
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float t = s_tot[p];
    out[base + p] = t;
    dec[base + p] = signbit(t) ? 1 : 0;
  }
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

__device__ __forceinline__ int edge_pos(int ed, int z, int Z) {
  return (ed >> 11) + wrap(z + (ed & 1023), Z);
}

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

// cn_update over a row of K <= KMAX messages in registers: the same
// operations in the same order, the loops unrolled to KMAX and left at K.
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

int round_up_warp(int x) { return (x + 31) / 32 * 32; }

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

}  // namespace

extern "C" int qc_bp_resident_launch(
    const float* llr, int8_t* dec, float* out, const int* ej, const int* es,
    const int* row_start, const int* col_start, const int* col_edges,
    const uint8_t* keep, int Z, int Nb, int Mb, int E, int B, int n_iters,
    int spa, int layered, float scale, float offset, void* stream) {
  const Graph g{ej, es, row_start, col_start, col_edges, keep, Z, Nb, Mb, E};
  const size_t bytes = sizeof(float) * ((size_t)2 * Nb * Z + (size_t)E * Z);
  int threads = round_up_warp(Z);
  if (threads < 256) threads = 256;
  const int rc = launch_smem(qc_bp_resident_kernel, bytes);
  if (rc) return rc;
  qc_bp_resident_kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      llr, dec, out, g, n_iters, spa, layered, scale, offset);
  return (int)cudaGetLastError();
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
