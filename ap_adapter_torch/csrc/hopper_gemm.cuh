// A Hopper GEMM for the fused blocks' projections, C = epilogue(A @ W^T)
// with A [M, K] row-major and W [N, K] (torch Linear layout), both bf16,
// fp32 accumulation; and the LayerNorm row pass that feeds it.
//
//   * ln_rows_kernel: y = LN(x) rounded to bf16, one warp a row, fp32
//     two-pass statistics from registers. Each row's statistics are
//     computed once, where the first port's WMMA GEMM recomputed them in
//     every block of a row (12-30 times for K1's QKV GEMM). The rounding
//     point is the JAX kernel's: the normalised row, (x - mean) * rstd * w
//     + b in fp32, rounded to bf16 before the product. The weights are not folded (that would move the rounding and
//     cancel badly where a row's mean is large against its spread).
//   * hgemm_kernel<BN, EPI>: one CTA a 64 x BN output tile (and one k-slice
//     of it under split-K): one producer warp (its first lane issues the
//     TMA loads: A's 64 x 64 box and W's BN x 64 box, 128-byte swizzle)
//     into a ring of 2-4 stages (as the plan says) guarded by full/empty
//     mbarriers, and one consumer warpgroup running wgmma m64nBNk16 from
//     both shared tiles, one k-block's group kept in flight while the next
//     one's loads land.
//     Epilogues from the accumulator registers, no fp32 tile in shared
//     memory: bf16 store (HG_STORE, up to four weight sets by grid z, the
//     QKV projections in one launch), bias + residual (HG_BIAS_RESID), and
//     GEGLU (HG_GEGLU: value rows [n0, n0 + 64) and gate rows [N + n0, ...)
//     of W into two accumulators; out = (a + b1) * gelu_erf(g + b1')).
//   * HG_CTX: the bf16 store over rows gathered from a batched context
//     (the K/V projections of K4, K8 and K11c, launch_ctx_kv): sets 2p and
//     2p + 1 (K and V of one key set) read A through the 3-D tensor map of
//     pair p, {K, n_p, B} at the set's first context row with the context's
//     batch stride; grid y is B x 64-row tiles, and TMA zero-fills a box
//     past n_p, so no row of the other key set is read and nothing is
//     copied. Output [B, n_p, N] contiguous, rows past n_p not stored.
//   * HG_STORE_F32: the fp32 store ([M, N], the backward kernels' gxn).
//   * WT (a template flag): W stored [K, N] as it lies, a Linear weight
//     [out, in] read backwards (A . W, the product a backward takes with a
//     frozen weight: g . Wo, gy1 . W1). W's TMA box is 64 k-rows x 64
//     columns of W (BN / 64 of them a stage), which wgmma reads MN-major
//     (wgmma_ss_n64_tb, as resnet.cu's convs read the HWIO weight); the
//     two n64 products of a 128-wide tile leave the accumulators in the
//     m64n128 order, so the epilogues are unchanged. K may run across up
//     to four weights of kw rows each (the producer takes W map kc / kw at
//     row kc % kw): K7's gxn = [dq | dk | dv] . [Wq; Wk; Wv] is one launch
//     with K = 3C.
//   * HG_GEGLU_BWD (K9's three products of a 64 x 64 tile of gy1): two A
//     operands, xn and g ([M, K] each, K = C), and three W boxes a stage:
//     W1's value and gate rows [n0, n0 + 64) and [N + n0, ...) K-major, as
//     HG_GEGLU loads them, and W2 [K, N] MN-major; three accumulators,
//     a = xn . W1_a^T, gate = xn . W1_g^T and gh = g . W2, and an epilogue
//     that writes gy1 [M, 2N] = [gh * gelu(gate + b1g) | gh * (a + b1a) *
//     gelu'(gate + b1g)] in bf16 from the registers (gh never leaves them
//     in fp32, as in the TPU kernel, pallas_fused_ff.py:155-162).
//   * Split-K where the output tiles are few or the k-loop long (the
//     wrapper's plan, ops/hopper_gemm.py::gemm_plan):
//     the ksplit CTAs of one output tile form a thread-block cluster along
//     x, each runs an equal share of the k-blocks; then each writes its
//     accumulators to its own shared memory (the drained ring) in register
//     order, and after a cluster barrier rank r sums the column groups
//     [r * U / ks, (r + 1) * U / ks) of the U = BN / 8 over all ranks, in
//     rank order (deterministic, no atomics), and applies the epilogue.
//     One launch either way; the bias + residual stays in it.
//
// Ragged M: A's boxes past row M are zero-filled by TMA and rows >= M are
// not stored. Requires K % 64 == 0, N % BN == 0 (checked by launch_hgemm).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

#include <functional>
#include <mutex>
#include <unordered_map>

namespace {

constexpr int HG_BM = 64;           // output rows of a CTA: the consumer warpgroup's m64
constexpr int HG_BK = 64;           // k per stage: one 128-byte swizzle row of bf16
constexpr int HG_THREADS = 160;     // consumer warpgroup (warps 0-3) + producer warp (warp 4)
constexpr int HG_MIN_STAGES = 2;    // the consumer releases a stage one k-block late
constexpr int HG_MAX_STAGES = 4;
constexpr int HG_MAX_SPLIT = 8;     // portable cluster size
constexpr int HG_A_BYTES = HG_BM * 128;

enum HgEpilogue { HG_STORE = 0, HG_BIAS_RESID = 1, HG_GEGLU = 2, HG_CTX = 3, HG_STORE_F32 = 4, HG_GEGLU_BWD = 5 };

struct HgArgs {
  CUtensorMap a;          // A [M, K]; HG_CTX: pair 0's context rows {K, n_0, B}
  CUtensorMap a_ip;       // HG_CTX: pair 1's context rows {K, n_1, B}; HG_GEGLU_BWD: g [M, K]
  CUtensorMap w[4];       // per grid-z set: W [N, K] (GEGLU: [2N, K]); WT: W [kw, N] per k-range;
                          // HG_GEGLU_BWD: W1 [2N, K], then W2 [K, N]
  bf16* c[4];             // per set: C [M, N] (HG_CTX: [B, n_p, N]; HG_GEGLU_BWD: [M, 2N])
  float* cf;              // HG_STORE_F32: C [M, N]
  const bf16* bias;       // BIAS_RESID: [N]; GEGLU, GEGLU_BWD: [2N]
  const bf16* resid;      // BIAS_RESID: [M, N]
  int M, N, K;            // HG_CTX: M = B x ctx_tiles x 64
  int kw;                 // WT: k rows of each W map
  int ksplit;             // CTAs of a cluster, splitting the k-blocks
  int stages;
  int ctx_n[2];           // HG_CTX: rows a batch entry of each pair
  int ctx_tiles;          // HG_CTX: 64-row tiles a batch entry (of the longer pair)
};

// nw: W boxes (accumulators) a stage, 1 (GEGLU: 2, GEGLU_BWD: 3, with a
// second A box)
__host__ __device__ inline int hg_stage_bytes(int bn, int nw) {
  return (nw == 3 ? 2 : 1) * HG_A_BYTES + bn * 128 * nw;
}

// the ring, or the split-K partials where they are larger ([BN / 2 x nw] x 128 fp32)
__host__ __device__ inline int hg_ring_bytes(int bn, int nw, int stages, int ksplit) {
  const int ring = stages * hg_stage_bytes(bn, nw);
  const int part = ksplit > 1 ? bn / 2 * nw * 128 * 4 : 0;
  return ring > part ? ring : part;
}

// dynamic shared memory of a launch: ring, 2 x HG_MAX_STAGES mbarriers, 1024 of alignment slack
__host__ __device__ inline int hg_smem_bytes(int bn, int nw, int stages, int ksplit) {
  return hg_ring_bytes(bn, nw, stages, ksplit) + 2 * HG_MAX_STAGES * 8 + 1024;
}

__host__ __device__ constexpr int hg_nw(int epi) { return epi == HG_GEGLU ? 2 : epi == HG_GEGLU_BWD ? 3 : 1; }

__device__ __forceinline__ float gelu_erf(float g) { return 0.5f * g * (1.f + erff(g * 0.70710678118654752f)); }

// the epilogue of two neighbouring columns (col, col + 1) of one output
// row (v: the accumulator; g, h: GEGLU's gate, GEGLU_BWD's gate and gh);
// rows at or past `lim` are not stored
template <int EPI>
__device__ __forceinline__ void hg_store_pair(const HgArgs& g, int set, int row, int lim, int col, float v0,
                                              float v1, float g0, float g1, float h0 = 0.f, float h1 = 0.f) {
  if (row >= lim) return;
  const size_t off = (size_t)row * g.N + col;
  if (EPI == HG_STORE_F32) {
    *reinterpret_cast<float2*>(g.cf + off) = make_float2(v0, v1);
    return;
  }
  if (EPI == HG_GEGLU_BWD) {
    // gy1 = [gh * gelu(gate) | gh * a * gelu'(gate)], gelu'(gate) = Phi(gate) + gate * phi(gate): the
    // first port's GEGLU backward epilogue, operation for operation
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.N + col));
    const float a[2] = {v0 + ba.x, v1 + ba.y}, gate[2] = {g0 + bg.x, g1 + bg.y}, gh[2] = {h0, h1};
    float da[2], dg[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cdf = 0.5f * (1.f + erff(gate[e] * 0.70710678118654752f));
      const float pdf = expf(-0.5f * gate[e] * gate[e]) * 0.3989422804014327f;
      da[e] = gh[e] * gate[e] * cdf;
      dg[e] = gh[e] * a[e] * (cdf + gate[e] * pdf);
    }
    bf16* out = g.c[set] + (size_t)row * 2 * g.N + col;
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(da[0], da[1]);
    *reinterpret_cast<uint32_t*>(out + g.N) = pack_bf16(dg[0], dg[1]);
    return;
  }
  if (EPI == HG_BIAS_RESID) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.resid + off));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    v0 += r.x + b.x;
    v1 += r.y + b.y;
  } else if (EPI == HG_GEGLU) {
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.N + col));
    v0 = (v0 + ba.x) * gelu_erf(g0 + bg.x);
    v1 = (v1 + ba.y) * gelu_erf(g1 + bg.y);
  }
  *reinterpret_cast<uint32_t*>(g.c[set] + off) = pack_bf16(v0, v1);
}

// grid ((N / BN) * ksplit, ceil(M / 64), sets), HG_THREADS threads, clusters
// of (ksplit, 1, 1). Thread t < 128: consumer, accumulator element e at row
// 16 * (t / 32) + (t % 32) / 4 + 8 * ((e / 2) % 2), column 8 * (e / 4) +
// 2 * (t % 4) + e % 2 of the tile (wgmma's m64nN layout).
template <int BN, int EPI, bool WT = false>
__global__ void __launch_bounds__(HG_THREADS, 1) hgemm_kernel(const __grid_constant__ HgArgs g) {
  constexpr bool DUAL = EPI == HG_GEGLU || EPI == HG_GEGLU_BWD;   // a second accumulator (the gate)
  constexpr bool TRIPLE = EPI == HG_GEGLU_BWD;                     // a third (gh), over a second A
  constexpr int NW = hg_nw(EPI);
  constexpr int NACC = BN / 2;
  constexpr int A_BYTES = (TRIPLE ? 2 : 1) * HG_A_BYTES;            // the A boxes of a stage
  constexpr int STAGE = A_BYTES + BN * 128 * NW;
  constexpr int WBOX = 64 * 128;                                   // WT: one 64 k-row x 64 column box of W
  static_assert(!(WT && DUAL), "the GEGLU epilogues read W1 K-major");
  static_assert(!TRIPLE || BN == 64, "the GEGLU backward takes 64-wide tiles");
  extern __shared__ unsigned char hg_smem_raw[];
  const uint32_t raw = smem_u32(hg_smem_raw);
  unsigned char* smem = hg_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int ks = g.ksplit, stages = g.stages;
  const uint32_t bars = base + hg_ring_bytes(BN, NW, stages, ks);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)(blockIdx.x % ks);        // == the cluster rank: clusters span ks consecutive x
  const int n0 = (int)(blockIdx.x / ks) * BN, set = blockIdx.z;
  const int nkb = g.K / HG_BK;
  const int kb0 = rank * nkb / ks, nk = (rank + 1) * nkb / ks - kb0;
  int m0 = blockIdx.y * HG_BM;        // A's first row (HG_CTX: within batch entry cb)
  int row0 = m0, lim = g.M;           // the output row of tile row 0; one past the tile's last output row
  int cb = 0;
  if constexpr (EPI == HG_CTX) {
    const int n = g.ctx_n[set >> 1];
    cb = blockIdx.y / g.ctx_tiles;
    m0 = (blockIdx.y % g.ctx_tiles) * HG_BM;
    if (m0 >= n) return;              // past the shorter pair's rows: the whole cluster (same y, z) leaves
    row0 = cb * n + m0;
    lim = cb * n + n;
  }

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (HG_MAX_STAGES + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NACC];
  float acc2[NACC];                             // used only by GEGLU and GEGLU_BWD
  float acc3[NACC];                             // used only by GEGLU_BWD
  if (warp == 4) {
    if (lane == 0) {
      const CUtensorMap* wmap = &g.w[set];
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(bars + 8 * (HG_MAX_STAGES + s), ((i / stages) - 1) & 1);
        const uint32_t full = bars + 8 * s, sa = base + s * STAGE;
        mbar_expect_tx(full, STAGE);
        const int kc = (kb0 + i) * HG_BK;
        if constexpr (EPI == HG_CTX) tma_load_3d(sa, (set >> 1) ? &g.a_ip : &g.a, kc, m0, cb, full);
        else tma_load_2d(sa, &g.a, kc, m0, full);
        if constexpr (WT) {
          const int wi = kc / g.kw;             // the weight this k-block lies in, at its row kc % kw
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load_2d(sa + A_BYTES + j * WBOX, &g.w[wi], n0 + 64 * j, kc - wi * g.kw, full);
        } else {
          tma_load_2d(sa + A_BYTES, wmap, kc, n0, full);
        }
        if (DUAL) tma_load_2d(sa + A_BYTES + BN * 128, wmap, kc, g.N + n0, full);
        if (TRIPLE) {
          tma_load_2d(sa + HG_A_BYTES, &g.a_ip, kc, m0, full);
          tma_load_2d(sa + A_BYTES + 2 * BN * 128, &g.w[1], n0, kc, full);
        }
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      acc[e] = 0.f;
      if (DUAL) acc2[e] = 0.f;
      if (TRIPLE) acc3[e] = 0.f;
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8 * s, (i / stages) & 1);
      uint32_t sa = base + s * STAGE;
      asm volatile("" : "+r"(sa));
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        reg_fence(acc[e]);
        if (DUAL) reg_fence(acc2[e]);
        if (TRIPLE) reg_fence(acc3[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk) {
        const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
        if constexpr (WT) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            wgmma_ss_n64_tb(acc + 32 * j, da, sw128_desc(sa + A_BYTES + j * WBOX + kk * 16 * 128, WBOX, 1024));
        } else {
          const uint64_t db = sw128_desc(sa + A_BYTES + kk * 32, 16, 1024);
          if constexpr (BN == 128) wgmma_ss_n128(acc, da, db);
          else wgmma_ss_n64(acc, da, db);
        }
        if constexpr (DUAL) wgmma_ss_n64(acc2, da, sw128_desc(sa + A_BYTES + BN * 128 + kk * 32, 16, 1024));
        if constexpr (TRIPLE)
          wgmma_ss_n64_tb(acc3, sw128_desc(sa + HG_A_BYTES + kk * 32, 16, 1024),
                          sw128_desc(sa + A_BYTES + 2 * BN * 128 + kk * 16 * 128, WBOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                          // k-block i - 1's products are done: free its stage
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        reg_fence(acc[e]);
        if (DUAL) reg_fence(acc2[e]);
        if (TRIPLE) reg_fence(acc3[e]);
      }
      if (i > 0) mbar_arrive(bars + 8 * (HG_MAX_STAGES + (i - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      reg_fence(acc[e]);
      if (DUAL) reg_fence(acc2[e]);
      if (TRIPLE) reg_fence(acc3[e]);
    }
  }

  const int quad = lane & 3;
  const int r0 = row0 + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  if (ks == 1) {
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        hg_store_pair<EPI>(g, set, r0, lim, col, acc[4 * j], acc[4 * j + 1], DUAL ? acc2[4 * j] : 0.f,
                           DUAL ? acc2[4 * j + 1] : 0.f, TRIPLE ? acc3[4 * j] : 0.f, TRIPLE ? acc3[4 * j + 1] : 0.f);
        hg_store_pair<EPI>(g, set, r1, lim, col, acc[4 * j + 2], acc[4 * j + 3], DUAL ? acc2[4 * j + 2] : 0.f,
                           DUAL ? acc2[4 * j + 3] : 0.f, TRIPLE ? acc3[4 * j + 2] : 0.f,
                           TRIPLE ? acc3[4 * j + 3] : 0.f);
      }
    }
    return;
  }

  // split-K: the partials through distributed shared memory, summed in rank order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  float* part = reinterpret_cast<float*>(smem);         // [NACC x NW][128 consumer threads]
  if (warp < 4) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      part[e * 128 + tid] = acc[e];
      if (DUAL) part[(NACC + e) * 128 + tid] = acc2[e];
      if (TRIPLE) part[(2 * NACC + e) * 128 + tid] = acc3[e];
    }
  }
  cluster.sync();
  if (warp < 4) {
    const int u0 = rank * (BN / 8) / ks, u1 = (rank + 1) * (BN / 8) / ks;
    for (int j = u0; j < u1; ++j) {
      float v[4] = {0.f, 0.f, 0.f, 0.f}, gt[4] = {0.f, 0.f, 0.f, 0.f}, gh[4] = {0.f, 0.f, 0.f, 0.f};
      for (int rr = 0; rr < ks; ++rr) {
        const float* rp = cluster.map_shared_rank(part, rr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] += rp[(4 * j + e) * 128 + tid];
          if (DUAL) gt[e] += rp[(NACC + 4 * j + e) * 128 + tid];
          if (TRIPLE) gh[e] += rp[(2 * NACC + 4 * j + e) * 128 + tid];
        }
      }
      const int col = n0 + 8 * j + 2 * quad;
      hg_store_pair<EPI>(g, set, r0, lim, col, v[0], v[1], gt[0], gt[1], gh[0], gh[1]);
      hg_store_pair<EPI>(g, set, r1, lim, col, v[2], v[3], gt[2], gt[3], gh[2], gh[3]);
    }
  }
  cluster.sync();                                       // no CTA leaves while another reads its partials
}

template <int BN, int EPI, bool WT = false>
int launch_hgemm_t(const HgArgs& g, int sets, cudaStream_t st) {
  const int smem = hg_smem_bytes(BN, hg_nw(EPI), g.stages, g.ksplit);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e =
        cudaFuncSetAttribute(hgemm_kernel<BN, EPI, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.N / BN * g.ksplit), (unsigned)((g.M + HG_BM - 1) / HG_BM), (unsigned)sets);
  cfg.blockDim = dim3(HG_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, hgemm_kernel<BN, EPI, WT>, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// make_map_2d (batch == 0) or make_map_3d (bf16 rows of `batch` entries
// `bstride` elements apart), remembered: a tensor map is a pure function of
// (address, rows, cols, box rows, element size, batch, batch stride); the
// key also carries the operand's layout (mn: W [K, N] read MN-major, rows
// = K), so that a square weight read both ways keeps one entry each, and
// the weights' (and, through the caching allocator, most activations')
// recur call after call. Saves the host an encode per operand per call;
// bounded at 4096 entries.
int cached_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int esize, int batch,
               long long bstride, bool mn = false) {
  struct Key {
    const void* p;
    int rows, cols, box, esize, batch;
    long long bstride;
    bool mn;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && cols == o.cols && box == o.box && esize == o.esize &&
             batch == o.batch && bstride == o.bstride && mn == o.mn;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^ ((size_t)k.rows * 0x9E3779B97F4A7C15ull) ^ ((size_t)k.cols << 24) ^
             (size_t)k.box ^ ((size_t)k.esize << 12) ^ ((size_t)k.batch << 40) ^
             ((size_t)k.bstride * 0xC2B2AE3D27D4EB4Full) ^ ((size_t)k.mn << 63);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{ptr, rows, cols, box_rows, esize, batch, bstride, mn};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const int e = batch ? make_map_3d(map, ptr, rows, cols, batch, bstride, box_rows)
                      : make_map_2d(map, ptr, rows, cols, box_rows, esize);
  if (e) return e;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

int cached_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int esize = 2) {
  return cached_map(map, ptr, rows, cols, box_rows, esize, 0, 0);
}

// a bf16 weight W [K, N] read MN-major: boxes of 64 k-rows x 64 columns
int cached_map_kn(CUtensorMap* map, const void* ptr, int K, int N) {
  return cached_map(map, ptr, K, N, HG_BK, 2, 0, 0, true);
}

// a plan the kernel runs: 64- or 128-wide tiles dividing N, K % 64, a
// split of 1-8 CTAs with at least one k-block and one 8-column group each,
// 2-4 stages
bool hg_plan_ok(int N, int K, int bn, int ksplit, int stages) {
  return K > 0 && K % HG_BK == 0 && (bn == 64 || bn == 128) && N > 0 && N % bn == 0 && ksplit >= 1 &&
         ksplit <= HG_MAX_SPLIT && ksplit <= K / HG_BK && ksplit <= bn / 8 && stages >= HG_MIN_STAGES &&
         stages <= HG_MAX_STAGES;
}

// fills g's maps and sizes, checks the plan (bn, ksplit, stages; the
// wrapper's ops/hopper_gemm.py::gemm_plan) and launches:
// C[set] = epi(A @ W[set]^T) for set < sets.
int launch_hgemm(HgArgs& g, const void* a, const void* const* w, int sets, int M, int N, int K, int bn, int ksplit,
                 int stages, int epi, cudaStream_t st) {
  if (M <= 0 || sets < 1 || sets > 4 || !hg_plan_ok(N, K, bn, ksplit, stages) || (epi == HG_GEGLU && bn != 64))
    return (int)cudaErrorInvalidValue;
  g.M = M;
  g.N = N;
  g.K = K;
  g.ksplit = ksplit;
  g.stages = stages;
  int e = cached_map_2d(&g.a, a, M, K, HG_BM);
  for (int s = 0; s < sets && !e; ++s) e = cached_map_2d(&g.w[s], w[s], epi == HG_GEGLU ? 2 * N : N, K, bn);
  if (e) return e;
  if (epi == HG_STORE)
    return bn == 128 ? launch_hgemm_t<128, HG_STORE>(g, sets, st) : launch_hgemm_t<64, HG_STORE>(g, sets, st);
  if (epi == HG_BIAS_RESID)
    return bn == 128 ? launch_hgemm_t<128, HG_BIAS_RESID>(g, sets, st) : launch_hgemm_t<64, HG_BIAS_RESID>(g, sets, st);
  if (epi == HG_GEGLU) return launch_hgemm_t<64, HG_GEGLU>(g, sets, st);
  return (int)cudaErrorInvalidValue;
}

// C = A @ [W_0; ...; W_{nw-1}] with each W_i [K / nw, N] as it lies (MN-major
// boxes), A [M, K]; epi HG_STORE (bf16 g.c[0]) or HG_STORE_F32 (fp32 g.cf).
// The W_i split K evenly, each a whole number of k-blocks.
int launch_hgemm_kn(HgArgs& g, const void* a, const void* const* w, int nw, int M, int N, int K, int bn, int ksplit,
                    int stages, int epi, cudaStream_t st) {
  if (M <= 0 || nw < 1 || nw > 4 || K % nw || (K / nw) % HG_BK || !hg_plan_ok(N, K, bn, ksplit, stages) ||
      (epi != HG_STORE && epi != HG_STORE_F32))
    return (int)cudaErrorInvalidValue;
  g.M = M;
  g.N = N;
  g.K = K;
  g.kw = K / nw;
  g.ksplit = ksplit;
  g.stages = stages;
  int e = cached_map_2d(&g.a, a, M, K, HG_BM);
  for (int i = 0; i < nw && !e; ++i) e = cached_map_kn(&g.w[i], w[i], g.kw, N);
  if (e) return e;
  if (epi == HG_STORE)
    return bn == 128 ? launch_hgemm_t<128, HG_STORE, true>(g, 1, st) : launch_hgemm_t<64, HG_STORE, true>(g, 1, st);
  return bn == 128 ? launch_hgemm_t<128, HG_STORE_F32, true>(g, 1, st)
                   : launch_hgemm_t<64, HG_STORE_F32, true>(g, 1, st);
}

// gy1 [M, 2N] (bf16) = the GEGLU backward of one 64 x 64 tile of its value
// and gate columns: xn, gm [M, K]; w1 [2N, K] (Linear layout), b1 [2N]; w2
// [K, N] (read MN-major). 64-wide tiles, (ksplit, stages) from the plan.
int launch_hgemm_geglu_bwd(const void* xn, const void* gm, const void* w1, const void* b1, const void* w2, void* gy1,
                           int M, int N, int K, int ksplit, int stages, cudaStream_t st) {
  if (M <= 0 || !hg_plan_ok(N, K, 64, ksplit, stages)) return (int)cudaErrorInvalidValue;
  HgArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  g.ksplit = ksplit;
  g.stages = stages;
  g.c[0] = static_cast<bf16*>(gy1);
  g.bias = static_cast<const bf16*>(b1);
  int e = cached_map_2d(&g.a, xn, M, K, HG_BM);
  if (!e) e = cached_map_2d(&g.a_ip, gm, M, K, HG_BM);
  if (!e) e = cached_map_2d(&g.w[0], w1, 2 * N, K, 64);
  if (!e) e = cached_map_kn(&g.w[1], w2, K, N);
  if (e) return e;
  return launch_hgemm_t<64, HG_GEGLU_BWD>(g, 1, st);
}

// The context K/V projections of a cross-attention site in one launch
// (hgemm_kernel, HG_CTX; K4, K8 and K11c): out
// 0/1 = ctx[:, :n_text] . w[0/1]^T and, with n_ip > 0, out 2/3 =
// ctx[:, n_text:n_text + n_ip] . w[2/3]^T, for ctx [B, Sk_total, Dc] and
// weights [C, Dc]; each out [B, n, C] contiguous. The plan (bn, ksplit,
// stages) is the wrapper's (gemm_plan over B x ceil(max(n_text, n_ip) / 64)
// row tiles of 64 and 2 or 4 sets).
int launch_ctx_kv(const void* ctx, int B, int Sk_total, int Dc, int n_text, int n_ip, const void* const* w,
                  bf16* const* out, int C, int bn, int ksplit, int stages, cudaStream_t st) {
  if (B < 1 || n_text < 1 || n_ip < 0 || n_text + n_ip > Sk_total || !hg_plan_ok(C, Dc, bn, ksplit, stages))
    return (int)cudaErrorInvalidValue;
  HgArgs g = {};
  const int sets = n_ip > 0 ? 4 : 2;
  g.ctx_n[0] = n_text;
  g.ctx_n[1] = n_ip;
  g.ctx_tiles = ((n_text > n_ip ? n_text : n_ip) + HG_BM - 1) / HG_BM;
  g.M = B * g.ctx_tiles * HG_BM;
  g.N = C;
  g.K = Dc;
  g.ksplit = ksplit;
  g.stages = stages;
  const long long bstride = (long long)Sk_total * Dc;
  int e = cached_map(&g.a, ctx, n_text, Dc, HG_BM, 2, B, bstride);
  if (!e && n_ip > 0) e = cached_map(&g.a_ip, (const bf16*)ctx + (size_t)n_text * Dc, n_ip, Dc, HG_BM, 2, B, bstride);
  for (int s = 0; s < sets && !e; ++s) {
    e = cached_map_2d(&g.w[s], w[s], C, Dc, bn);
    g.c[s] = out[s];
  }
  if (e) return e;
  return bn == 128 ? launch_hgemm_t<128, HG_CTX>(g, sets, st) : launch_hgemm_t<64, HG_CTX>(g, sets, st);
}

constexpr int LN_ROWS = 8;          // rows (warps) a block
constexpr int LN_MAX_CHUNKS = 8;    // 16-byte chunks a lane holds: C <= 8 * 8 * 32 = 2048

// y[m] = bf16((x[m] - mean) * rstd * w + b), one warp a row, the row in registers
__global__ void __launch_bounds__(32 * LN_ROWS) ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                                              const bf16* __restrict__ b, bf16* __restrict__ y, int M,
                                                              int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + warp;
  if (row >= M) return;
  const int nch = C / 8;
  const bf16* xr = x + (size_t)row * C;
  float v[LN_MAX_CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + 8 * c);
      const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(u2[e]);
        v[i][2 * e] = f.x;
        v[i][2 * e + 1] = f.y;
        s += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i)
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        var += d * d;
      }
    }
  const float rstd = rsqrtf(warp_sum(var) / C + eps);
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      const uint4 wv = *reinterpret_cast<const uint4*>(w + 8 * c);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + 8 * c);
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wv);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
      uint4 o;
      uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 wf = __bfloat1622float2(w2[e]);
        const float2 bf = __bfloat1622float2(b2[e]);
        o32[e] = pack_bf16((v[i][2 * e] - mean) * rstd * wf.x + bf.x, (v[i][2 * e + 1] - mean) * rstd * wf.y + bf.y);
      }
      *reinterpret_cast<uint4*>(y + (size_t)row * C + 8 * c) = o;
    }
  }
}

int launch_ln_rows(const void* x, const void* w, const void* b, void* y, int M, int C, float eps, cudaStream_t st) {
  if (C % 64 || C > LN_MAX_CHUNKS * 8 * 32) return (int)cudaErrorInvalidValue;
  ln_rows_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>((const bf16*)x, (const bf16*)w,
                                                                      (const bf16*)b, (bf16*)y, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace
