// QC-LDPC belief propagation for Hopper (sm_90a): resident and streamed.
//
// K4 qc_bp_resident_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas (its body _qc_bp_kernel, check update _make_cn_update).
// K5 qc_bp_streamed_kernel replaces commpy_tpu/kernels/qc_bp.py
//    qc_bp_pallas_streamed (its body _qc_bp_streamed_kernel).
//
// One block decodes one frame.  K4 holds the frame's channel LLRs, totals
// and all nnz*Z check-to-variable (c2v) messages in dynamic shared memory
// and runs the flooding or the layered schedule.  K5 holds only the totals
// there and streams each check block row's messages through a frame-major
// store in device memory (float32 or bfloat16), layered only.  Both loop
// until the frame's syndrome passes or n_iters sweeps, so a converged
// frame is never touched again.  The Python wrappers (kernels/qc_bp.py)
// check shapes and budgets and hold the plain PyTorch versions these
// kernels must match bit for bit (MSA) on the card.
//
// The graph is passed as int tables, so nothing is compiled per code:
//   ej, es     [E]      block column and shift (mod Z) of edge e, edges being
//                       the nonzero blocks in row-major order
//   row_start  [Mb+1]   first edge of each check block row
//   col_start  [Nb+1], col_edges [E]: each column's edges, row-major order
//   keep       [E*Z]    uint8, 0 where a block lacks the edge at check
//                       position z (DVB-S2's accumulator wrap), or null
// Check (i, z) reads variable ej*Z + (z + es) % Z of each edge e of row i;
// its message returns to that position.  The message of (e, z) sits at
// c2v[e*Z + z].
//
// What bounds them on an H100 (chip_smoke.py works both out from its
// inputs): K4 at the 802.11n (1944, 972) bench shape (B=512, MSA, 15
// iterations, no frame converging) moves ~8 MB (LLRs in, decisions and
// posteriors out, 2.4 us at 3.35 TB/s) and does ~15 float operations per
// edge per iteration, none a fused multiply-add, ~0.8 G in all, ~24 us at
// the 33.5 T instructions/s behind the 67 TFLOP/s FMA peak: bound by
// operations.  K5 at the DVB-S2-class 16200 shape (B=512, layered 8) moves
// ~75 MB and does ~3.9 G operations, ~0.12 ms: bound by operations too.
// Its message store is scratch, not an input or output: this design reads
// and writes it once per iteration, ~2 GB in float32 (~0.6 ms; bfloat16
// halves it), because it runs all B frames at once and at B=512 their
// stores (129 MB) exceed the 50 MB L2; 132 frames at a time would fit it.
// This first version is written for exactness: a thread per check
// (flooding) or per circulant position (layered), rows of at most 32
// blocks held in local arrays, no asynchronous copies.  Its times are
// recorded in PERF.md.
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

template <typename T>
__global__ void __launch_bounds__(1024)
qc_bp_streamed_kernel(const float* __restrict__ llr, int8_t* __restrict__ dec,
                      float* __restrict__ out, T* __restrict__ store, Graph g,
                      int n_iters, int spa, float scale, float offset,
                      int bf16) {
  extern __shared__ float s_tot[];  // [n]
  const int n = g.Nb * g.Z;
  const size_t base = (size_t)blockIdx.x * n;
  T* c2v = store + (size_t)blockIdx.x * g.E * g.Z;
  for (int p = threadIdx.x; p < n; p += blockDim.x) s_tot[p] = llr[base + p];
  __syncthreads();
  bool active = syndrome_bad(s_tot, g);
  for (int it = 0; it < n_iters && active; ++it) {
    for (int i = 0; i < g.Mb; ++i)
      layered_row<T>(s_tot, c2v, g, i, it == 0, spa, scale, offset, bf16);
    active = syndrome_bad(s_tot, g);
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float t = s_tot[p];
    out[base + p] = t;
    dec[base + p] = signbit(t) ? 1 : 0;
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

extern "C" int qc_bp_streamed_launch(
    const float* llr, int8_t* dec, float* out, void* store, const int* ej,
    const int* es, const int* row_start, const int* col_start,
    const int* col_edges, const uint8_t* keep, int Z, int Nb, int Mb, int E,
    int B, int n_iters, int spa, int bf16, float scale, float offset,
    void* stream) {
  const Graph g{ej, es, row_start, col_start, col_edges, keep, Z, Nb, Mb, E};
  const size_t bytes = sizeof(float) * (size_t)Nb * Z;
  const int threads = round_up_warp(Z);
  int rc;
  if (bf16) {
    auto* kernel = qc_bp_streamed_kernel<__nv_bfloat16>;
    rc = launch_smem(kernel, bytes);
    if (rc) return rc;
    kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
        llr, dec, out, static_cast<__nv_bfloat16*>(store), g, n_iters, spa,
        scale, offset, 1);
  } else {
    auto* kernel = qc_bp_streamed_kernel<float>;
    rc = launch_smem(kernel, bytes);
    if (rc) return rc;
    kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
        llr, dec, out, static_cast<float*>(store), g, n_iters, spa, scale,
        offset, 0);
  }
  return (int)cudaGetLastError();
}
