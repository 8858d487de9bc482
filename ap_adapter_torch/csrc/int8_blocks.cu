// Hopper (sm_90a) kernels of the int8 (W8A8) serving configuration
// (UNetConfig.use_int8): the three fused transformer-block ops with their
// q/out projections and GEGLU products in int8.
//
// Replaces the TPU Pallas kernels
//   K11a ap_adapter_tpu/ops/pallas_int8.py::fused_ln_geglu_ff_int8 (:118)
//   K11b ap_adapter_tpu/ops/pallas_int8.py::fused_ln_self_attention_int8 (:259)
//   K11c ap_adapter_tpu/ops/pallas_int8.py::fused_ln_cross_attention_int8 (:410)
//
// Quantization is the TPU kernels' _quant_rows (pallas_int8.py:80) and
// quantize_weight (:63): an activation row v -> int8 q = round(v * (1 / s))
// with s = max(amax, 1e-8) * (1/127), rounding half to even
// (__float2int_rn) and the products unfused (__fmul_rn), so it rounds where
// the TPU kernel and the plain version do; weights in Linear layout [N, K]
// with per-output-channel scales. A product dequantizes as
// acc * s_row * s_col, unfused as in the plain version. Every quantized
// activation comes from fp32: the LayerNorm value, the attention output and
// the GEGLU product (a bf16 round trip first would move values across int8
// rounding boundaries).
//
// The routines, all on the Hopper building blocks:
//   * ln_quant_rows_kernel<BF16_ROWS>: one warp a row, the row in
//     registers, fp32 two-pass statistics; from the one fp32 LayerNorm value
//     of each element it writes the int8 row and fp32 scale of the q or W1
//     projection and, for K11b, the bf16 row its K/V GEMM reads;
//   * quant_rows_kernel: fp32 rows (attention output, GEGLU product) to int8
//     and scales, one warp a row, 16-byte loads;
//   * i8gemm_kernel<BN, EPI> (below): hopper_gemm.cuh's structure for s8:
//     one CTA a 64 x BN output tile, a producer warp issuing TMA loads of
//     A8 [M, K] and W8 [N, K] (both K-major, as wgmma's 8-bit form
//     requires, and both already lie that way) in 128-byte k-blocks (128
//     int8 values, the 128-byte swizzle's row) into a ring of 2-4 stages,
//     one consumer warpgroup running wgmma m64nBNk32 s32.s8.s8, exact int32
//     sums. Where the output tiles are fewer than the SMs the k-blocks are
//     split over a thread-block cluster and the int32 partials combined,
//     exactly and in rank order, through distributed shared memory
//     (ops/hopper_gemm.py::gemm_plan, int8=True). K need only be a multiple
//     of 64: a last half block is zero-filled by TMA in both operands.
//     Epilogues: * alpha into bf16 (I8_STORE), + bias + residual into bf16
//     (I8_BIAS_RESID), and GEGLU (I8_GEGLU, as hgemm_kernel's HG_GEGLU: the
//     value rows [n0, n0 + 64) and the gate rows [N + n0, ...) of W1 in
//     each stage, two int32 accumulators; [a | g] = acc * s_row * s_col +
//     b1, y = a * g * 0.5 * (1 + erf(g / sqrt 2)) in fp32, stored as fp32);
//   * hgemm_kernel (hopper_gemm.cuh): K11b's K/V GEMM over the bf16
//     LayerNorm rows, and K11c's context K/V projections (launch_ctx_kv,
//     HG_CTX, which K4 and K8 share: the text and adapter rows of the
//     context through one 3-D tensor map each, four weight sets in one
//     launch, no copy);
//   * reg_attention_kernel<d, BIAS, ONE_SET, float> (reg_attention.cuh):
//     one or two key sets (the text keys with the fp32 T5 bias, then the
//     adapter keys), softmax scale 1 (q arrives pre-scaled by 1/sqrt(d)),
//     the output stored in fp32 for the quantization that follows.
//
//   K11a = LN+quant rows -> int8 W1 GEMM + GEGLU (fp32 y) -> quant rows ->
//          int8 W2 GEMM + bias + residual                   (4 device kernels)
//   K11b = LN+quant rows (+ bf16 rows) -> int8 q GEMM -> K/V GEMM ->
//          attention (fp32) -> quant rows -> int8 out GEMM + bias + residual (6)
//   K11c = context K/V GEMM -> LN+quant rows -> int8 q GEMM -> two-set
//          attention (fp32) -> quant rows -> int8 out GEMM + bias + residual (6)
// What is not int8, as on the TPU: the K/V projections and the QK/PV
// products stay bf16 (the TPU package measured those shapes losing under
// int8, and softmax probabilities do not fit an int8 grid).
//
// What bounds these on an H100: at the UNet's widths the products are small
// (K <= 2560, N <= 5120) and the activations make round trips through
// device memory (int8 rows, their scales, the fp32 attention output and
// GEGLU product), so each launch runs at launch and per-CTA latency far
// above the tensor-core bound (1,979 TOPS int8); the design keeps the
// launches few, fills the SMs (split-K) and pipelines the loads.

#include "common.cuh"
#include "hopper_gemm.cuh"
#include "reg_attention.cuh"

namespace {

constexpr float INV127 = (float)(1.0 / 127.0);

// acc * s_row * s_col, unfused as in the plain version
__device__ __forceinline__ float dequant(int acc, float sr, float sc) {
  return __fmul_rn(__fmul_rn((float)acc, sr), sc);
}

// fp32 rows [M, K] -> q int8 [M, K] and scale fp32 [M], K % 4 == 0: one
// warp a row, 16-byte loads; the row is read twice (its maximum, then the
// codes), the second time from L1/L2
__global__ void __launch_bounds__(THREADS) quant_rows_kernel(const float* __restrict__ src, int M, int K,
                                                             int8_t* __restrict__ q, float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= M) return;
  const float4* r4 = reinterpret_cast<const float4*>(src + (size_t)row * K);
  const int n4 = K / 4;
  float amax = 0.f;
#pragma unroll 4
  for (int i = lane; i < n4; i += 32) {
    const float4 v = r4[i];
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), INV127);
  const float inv = 1.f / s;
  char4* q4 = reinterpret_cast<char4*>(q + (size_t)row * K);
#pragma unroll 4
  for (int i = lane; i < n4; i += 32) {
    const float4 v = r4[i];
    q4[i] = make_char4((signed char)__float2int_rn(__fmul_rn(v.x, inv)),
                       (signed char)__float2int_rn(__fmul_rn(v.y, inv)),
                       (signed char)__float2int_rn(__fmul_rn(v.z, inv)),
                       (signed char)__float2int_rn(__fmul_rn(v.w, inv)));
  }
  if (lane == 0) scale[row] = s;
}

int launch_quant_rows(const void* src, int M, int K, void* q, void* scale, cudaStream_t st) {
  if (K % 4) return (int)cudaErrorInvalidValue;
  const int rows = THREADS / 32;
  quant_rows_kernel<<<(M + rows - 1) / rows, THREADS, 0, st>>>((const float*)src, M, K, (int8_t*)q, (float*)scale);
  return (int)cudaGetLastError();
}

// The LayerNorm + quantize row pass: from one read of x, q = int8(v),
// scale[row] (the int8 q or W1 projection's rows) and, with BF16_ROWS,
// y = bf16(v) (K11b's K/V GEMM rows), where v is the fp32 LayerNorm value
// (x - mean) * rstd * w + b, unfused. One warp a row, the row in registers.
template <bool BF16_ROWS>
__global__ void __launch_bounds__(32 * LN_ROWS) ln_quant_rows_kernel(const bf16* __restrict__ x,
                                                                    const bf16* __restrict__ w,
                                                                    const bf16* __restrict__ b, bf16* __restrict__ y,
                                                                    int8_t* __restrict__ q, float* __restrict__ scale,
                                                                    int M, int C, float eps) {
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
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      const uint4 wv = *reinterpret_cast<const uint4*>(w + 8 * c);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + 8 * c);
      const bf16* w8 = reinterpret_cast<const bf16*>(&wv);
      const bf16* b8 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e] - mean, rstd), __bfloat162float(w8[e])),
                            __bfloat162float(b8[e]));
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
      if constexpr (BF16_ROWS) {
        uint4 o;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) o32[e] = pack_bf16(v[i][2 * e], v[i][2 * e + 1]);
        *reinterpret_cast<uint4*>(y + (size_t)row * C + 8 * c) = o;
      }
    }
  }
  const float sc = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), INV127);
  const float inv = 1.f / sc;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      uint2 o;
      int8_t* o8 = reinterpret_cast<int8_t*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = (int8_t)__float2int_rn(__fmul_rn(v[i][e], inv));
      *reinterpret_cast<uint2*>(q + (size_t)row * C + 8 * c) = o;
    }
  }
  if (lane == 0) scale[row] = sc;
}

// y null: the int8 rows alone
int launch_ln_quant_rows(const void* x, const void* w, const void* b, void* y, void* q, void* scale, int M, int C,
                         float eps, cudaStream_t st) {
  if (C % 64 || C > LN_MAX_CHUNKS * 8 * 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + LN_ROWS - 1) / LN_ROWS), block(32 * LN_ROWS);
  if (y != nullptr)
    ln_quant_rows_kernel<true><<<grid, block, 0, st>>>((const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y,
                                                       (int8_t*)q, (float*)scale, M, C, eps);
  else
    ln_quant_rows_kernel<false><<<grid, block, 0, st>>>((const bf16*)x, (const bf16*)w, (const bf16*)b, nullptr,
                                                        (int8_t*)q, (float*)scale, M, C, eps);
  return (int)cudaGetLastError();
}

constexpr int I8_BK = 128;          // int8 k per stage: one 128-byte swizzle row

enum EpiI8 {
  I8_STORE = 0,       // bf16 C = acc * sa * sw * alpha
  I8_BIAS_RESID = 1,  // bf16 C = resid + (acc * sa * sw + bias)
  I8_GEGLU = 2,       // fp32 C[M, N] = a * g * 0.5 * (1 + erf(g / sqrt 2)), [a | g] = acc * sa * sw + bias
                      // over W rows [0, N) | [N, 2N)
};

struct I8Args {
  CUtensorMap a;          // A8 [M, K]
  CUtensorMap w;          // W8 [N, K] (GEGLU: [2N, K])
  const float* sa;        // [M] row scales
  const float* sw;        // [N] column scales (GEGLU: [2N])
  const bf16* bias;       // I8_BIAS_RESID: [N]; I8_GEGLU: [2N]
  const bf16* resid;      // I8_BIAS_RESID: [M, N]
  void* c;                // [M, N]: bf16, fp32 for I8_GEGLU
  float alpha;            // I8_STORE
  int M, N, K;
  int ksplit, stages;
};

// the epilogue of two neighbouring columns (col, col + 1) of one row; g0/g1
// are the gate accumulators (I8_GEGLU)
template <int EPI>
__device__ __forceinline__ void i8_store_pair(const I8Args& g, int row, int col, int a0, int a1, int g0, int g1) {
  if (row >= g.M) return;
  const float sr = g.sa[row];
  float v0 = dequant(a0, sr, g.sw[col]), v1 = dequant(a1, sr, g.sw[col + 1]);
  const size_t off = (size_t)row * g.N + col;
  if (EPI == I8_GEGLU) {
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.N + col));
    const float a[2] = {__fadd_rn(v0, ba.x), __fadd_rn(v1, ba.y)};
    const float gate[2] = {__fadd_rn(dequant(g0, sr, g.sw[g.N + col]), bg.x),
                           __fadd_rn(dequant(g1, sr, g.sw[g.N + col + 1]), bg.y)};
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t = 1.f + erff(__fmul_rn(gate[e], 0.70710678118654752f));
      y[e] = __fmul_rn(__fmul_rn(__fmul_rn(a[e], gate[e]), 0.5f), t);
    }
    *reinterpret_cast<float2*>(static_cast<float*>(g.c) + off) = make_float2(y[0], y[1]);
    return;
  }
  if (EPI == I8_BIAS_RESID) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.resid + off));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    v0 = __fadd_rn(r.x, __fadd_rn(v0, b.x));
    v1 = __fadd_rn(r.y, __fadd_rn(v1, b.y));
  } else {
    v0 = __fmul_rn(v0, g.alpha);
    v1 = __fmul_rn(v1, g.alpha);
  }
  *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.c) + off) = __floats2bfloat162_rn(v0, v1);
}

// grid ((N / BN) * ksplit, ceil(M / 64)), HG_THREADS threads, clusters of
// (ksplit, 1, 1); the accumulator layout is hgemm_kernel's (s32 for f32).
template <int BN, int EPI>
__global__ void __launch_bounds__(HG_THREADS, 1) i8gemm_kernel(const __grid_constant__ I8Args g) {
  constexpr bool DUAL = EPI == I8_GEGLU;
  constexpr int NACC = BN / 2;
  constexpr int STAGE = HG_A_BYTES + BN * 128 * (DUAL ? 2 : 1);
  extern __shared__ unsigned char i8_smem_raw[];
  const uint32_t raw = smem_u32(i8_smem_raw);
  unsigned char* smem = i8_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int ks = g.ksplit, stages = g.stages;
  const uint32_t bars = base + hg_ring_bytes(BN, DUAL ? 2 : 1, stages, ks);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)(blockIdx.x % ks);        // == the cluster rank: clusters span ks consecutive x
  const int n0 = (int)(blockIdx.x / ks) * BN, m0 = blockIdx.y * HG_BM;
  const int nkb = (g.K + I8_BK - 1) / I8_BK;
  const int kb0 = rank * nkb / ks, nk = (rank + 1) * nkb / ks - kb0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (HG_MAX_STAGES + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[NACC];
  int acc2[NACC];                               // used only by GEGLU: the gate columns
  if (warp == 4) {
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(bars + 8 * (HG_MAX_STAGES + s), ((i / stages) - 1) & 1);
        const uint32_t full = bars + 8 * s, sa = base + s * STAGE;
        mbar_expect_tx(full, STAGE);
        const int kc = (kb0 + i) * I8_BK;
        tma_load_2d(sa, &g.a, kc, m0, full);
        tma_load_2d(sa + HG_A_BYTES, &g.w, kc, n0, full);
        if (DUAL) tma_load_2d(sa + HG_A_BYTES + BN * 128, &g.w, kc, g.N + n0, full);
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      acc[e] = 0;
      if (DUAL) acc2[e] = 0;
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8 * s, (i / stages) & 1);
      uint32_t sa = base + s * STAGE;
      asm volatile("" : "+r"(sa));
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        reg_fence_i(acc[e]);
        if (DUAL) reg_fence_i(acc2[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < I8_BK / 32; ++kk) {
        const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(sa + HG_A_BYTES + kk * 32, 16, 1024);
        if constexpr (BN == 128) wgmma_s8_n128(acc, da, db);
        else wgmma_s8_n64(acc, da, db);
        if constexpr (DUAL) wgmma_s8_n64(acc2, da, sw128_desc(sa + HG_A_BYTES + BN * 128 + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                          // k-block i - 1's products are done: free its stage
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        reg_fence_i(acc[e]);
        if (DUAL) reg_fence_i(acc2[e]);
      }
      if (i > 0) mbar_arrive(bars + 8 * (HG_MAX_STAGES + (i - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      reg_fence_i(acc[e]);
      if (DUAL) reg_fence_i(acc2[e]);
    }
  }

  const int quad = lane & 3;
  const int r0 = m0 + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  if (ks == 1) {
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        i8_store_pair<EPI>(g, r0, col, acc[4 * j], acc[4 * j + 1], DUAL ? acc2[4 * j] : 0,
                           DUAL ? acc2[4 * j + 1] : 0);
        i8_store_pair<EPI>(g, r1, col, acc[4 * j + 2], acc[4 * j + 3], DUAL ? acc2[4 * j + 2] : 0,
                           DUAL ? acc2[4 * j + 3] : 0);
      }
    }
    return;
  }

  // split-K: the int32 partials through distributed shared memory, summed in rank order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  int* part = reinterpret_cast<int*>(smem);             // [NACC (x2)][128 consumer threads]
  if (warp < 4) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      part[e * 128 + tid] = acc[e];
      if (DUAL) part[(NACC + e) * 128 + tid] = acc2[e];
    }
  }
  cluster.sync();
  if (warp < 4) {
    const int u0 = rank * (BN / 8) / ks, u1 = (rank + 1) * (BN / 8) / ks;
    for (int j = u0; j < u1; ++j) {
      int v[4] = {0, 0, 0, 0}, gt[4] = {0, 0, 0, 0};
      for (int rr = 0; rr < ks; ++rr) {
        const int* rp = cluster.map_shared_rank(part, rr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] += rp[(4 * j + e) * 128 + tid];
          if (DUAL) gt[e] += rp[(NACC + 4 * j + e) * 128 + tid];
        }
      }
      const int col = n0 + 8 * j + 2 * quad;
      i8_store_pair<EPI>(g, r0, col, v[0], v[1], gt[0], gt[1]);
      i8_store_pair<EPI>(g, r1, col, v[2], v[3], gt[2], gt[3]);
    }
  }
  cluster.sync();                                       // no CTA leaves while another reads its partials
}

template <int BN, int EPI>
int launch_i8gemm_t(const I8Args& g, cudaStream_t st) {
  const int smem = hg_smem_bytes(BN, EPI == I8_GEGLU ? 2 : 1, g.stages, g.ksplit);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(i8gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.N / BN * g.ksplit), (unsigned)((g.M + HG_BM - 1) / HG_BM), 1);
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, i8gemm_kernel<BN, EPI>, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// C = epi(dequant(A8 . W8^T)) for A8 [M, K] with row scales sa and W8 [N, K]
// ([2N, K] for I8_GEGLU) with column scales sw; the plan (bn, ksplit,
// stages) is the wrapper's (ops/hopper_gemm.py::gemm_plan with int8=True).
// g's bias, resid and alpha are the caller's.
int launch_i8gemm(I8Args& g, const void* a8, const void* sa, const void* w8, const void* sw, void* c, int M, int N,
                  int K, int bn, int ksplit, int stages, int epi, cudaStream_t st) {
  const int nkb = (K + I8_BK - 1) / I8_BK;
  if (M <= 0 || K % 64 || bn <= 0 || N % bn || ksplit < 1 || ksplit > HG_MAX_SPLIT || ksplit > nkb ||
      ksplit > bn / 8 || !(bn == 64 || bn == 128) || stages < HG_MIN_STAGES || stages > HG_MAX_STAGES ||
      !(epi == I8_STORE || epi == I8_BIAS_RESID || epi == I8_GEGLU) || (epi == I8_GEGLU && bn != 64))
    return (int)cudaErrorInvalidValue;
  g.sa = (const float*)sa;
  g.sw = (const float*)sw;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  g.ksplit = ksplit;
  g.stages = stages;
  int e = cached_map_2d(&g.a, a8, M, K, HG_BM, 1);
  if (!e) e = cached_map_2d(&g.w, w8, epi == I8_GEGLU ? 2 * N : N, K, bn, 1);
  if (e) return e;
  if (epi == I8_GEGLU) return launch_i8gemm_t<64, I8_GEGLU>(g, st);
  if (epi == I8_STORE)
    return bn == 128 ? launch_i8gemm_t<128, I8_STORE>(g, st) : launch_i8gemm_t<64, I8_STORE>(g, st);
  return bn == 128 ? launch_i8gemm_t<128, I8_BIAS_RESID>(g, st) : launch_i8gemm_t<64, I8_BIAS_RESID>(g, st);
}

}  // namespace

extern "C" {

// K11a: out = x + (quant(y) . W2q^T * sy * s2 + b2), y = a * gelu_erf(g) in fp32,
// [a | g] = quant(LN(x)) . W1q^T * sx * s1 + b1; w1q int8 [2*inner, C], s1 fp32
// [2*inner], w2q int8 [C, inner], s2 fp32 [C], biases bf16. Scratch: x8 int8
// [B*S, C], y fp32 and y8 int8 [B*S, inner], sx/sy fp32 [B*S] (16-byte
// aligned). (w1_split, w1_stages) plan the W1 GEMM (64-wide tiles, value and
// gate side by side), (w2_bn, w2_split, w2_stages) the W2 GEMM.
int apk_fused_ln_geglu_ff_int8(const void* x, const void* ln_w, const void* ln_b, const void* w1q,
                               const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
                               void* x8, void* sx, void* y, void* y8, void* sy, void* out, int B, int S, int C,
                               int inner, float eps, int w1_split, int w1_stages, int w2_bn, int w2_split,
                               int w2_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int e = launch_ln_quant_rows(x, ln_w, ln_b, nullptr, x8, sx, M, C, eps, st);
  if (e) return e;
  I8Args h = {};
  h.bias = (const bf16*)b1;
  e = launch_i8gemm(h, x8, sx, w1q, s1, y, M, inner, C, 64, w1_split, w1_stages, I8_GEGLU, st);
  if (e) return e;
  e = launch_quant_rows(y, M, inner, y8, sy, st);
  if (e) return e;
  I8Args o = {};
  o.bias = (const bf16*)b2;
  o.resid = (const bf16*)x;
  return launch_i8gemm(o, y8, sy, w2q, s2, out, M, C, inner, w2_bn, w2_split, w2_stages, I8_BIAS_RESID, st);
}

// K11b: out = x + int8 OutProj(MHA(q, LN(x) Wk, LN(x) Wv)) + bo with the int8,
// pre-scaled q = quant(LN(x)) . Wq8^T * sx * sq * sm_scale. wq8/wo8 int8 [C, C],
// sq/so fp32 [C], wk/wv bf16 [C, C]. Scratch: x8 int8 [B*S, C] and sx fp32
// [B*S] (reused for the attention output's quantization), scratch bf16
// 4 x [B*S, C] (LN(x), q, k, v) and attn fp32 [B*S, C]. (q_bn, q_split,
// q_stages), (kv_bn, kv_split, kv_stages) and (o_bn, o_split, o_stages)
// plan the q, K/V and out GEMMs.
int apk_fused_ln_self_attention_int8(const void* x, const void* ln_w, const void* ln_b, const void* wq8,
                                     const void* sq, const void* wk, const void* wv, const void* wo8,
                                     const void* so, const void* bo, void* x8, void* sx, void* scratch, void* attn,
                                     void* out, int B, int S, int C, int heads, float eps, float sm_scale, int q_bn,
                                     int q_split, int q_stages, int kv_bn, int kv_split, int kv_stages, int o_bn,
                                     int o_split, int o_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16 *q = xn + mc, *k = q + mc, *v = k + mc;
  int e = launch_ln_quant_rows(x, ln_w, ln_b, xn, x8, sx, M, C, eps, st);
  if (e) return e;
  I8Args qa = {};
  qa.alpha = sm_scale;
  e = launch_i8gemm(qa, x8, sx, wq8, sq, q, M, C, C, q_bn, q_split, q_stages, I8_STORE, st);
  if (e) return e;
  HgArgs kv = {};
  const void* wkv[2] = {wk, wv};
  kv.c[0] = k;
  kv.c[1] = v;
  e = launch_hgemm(kv, xn, wkv, 2, M, C, C, kv_bn, kv_split, kv_stages, HG_STORE, st);
  if (e) return e;
  const FaKeys keys = {k, v, nullptr, S, FA_TK}, none = {nullptr, nullptr, nullptr, 0, FA_TK};
  e = launch_reg_attention(q, keys, none, 0.f, (float*)attn, B, S, heads, C / heads, FA_LOG2E, st);
  if (e) return e;
  e = launch_quant_rows(attn, M, C, x8, sx, st);
  if (e) return e;
  I8Args o = {};
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_i8gemm(o, x8, sx, wo8, so, out, M, C, C, o_bn, o_split, o_stages, I8_BIAS_RESID, st);
}

// K11c: K11b's int8 q/out projections around K2's two-key-set attention over
// context K/V projected here in bf16: text K/V = ctx[:, :sk_text] . Wk^T /
// Wv^T and adapter K/V = ctx[:, sk_text:] . Wki^T / Wvi^T (wki/wvi null: no
// adapter set), combined as softmax(q k^T + bias) v + ip_scale *
// softmax(q ki^T) vi in fp32. ctx [B, Sk_total, Dc] bf16; bias [B, sk_text]
// fp32 or null. Scratch (16-byte aligned): x8 int8 [B*S, C] and sx fp32 [B*S]
// (reused for the attention output's quantization), q bf16 [B*S, C], kv
// bf16 (k, v [B, sk_text, C], then ki, vi [B, Sk_total - sk_text, C]),
// attn fp32 [B*S, C]. tk / tk_ip: keys a tile of each set; (kv_bn, kv_split,
// kv_stages), (q_bn, q_split, q_stages) and (o_bn, o_split, o_stages) plan
// the context K/V, q and out GEMMs.
int apk_fused_ln_cross_attention_int8(const void* x, const void* ctx, int Sk_total, int Dc, int sk_text,
                                      const void* ln_w, const void* ln_b, const void* wq8, const void* sq,
                                      const void* wk, const void* wv, const void* wki, const void* wvi,
                                      const void* wo8, const void* so, const void* bo, float ip_scale,
                                      const void* bias, void* x8, void* sx, void* q, void* kv, void* attn, void* out,
                                      int B, int S, int C, int heads, float eps, float sm_scale, int tk, int tk_ip,
                                      int kv_bn, int kv_split, int kv_stages, int q_bn, int q_split, int q_stages,
                                      int o_bn, int o_split, int o_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  if (sk_ip > 0 && wvi == nullptr) return (int)cudaErrorInvalidValue;
  bf16* k = static_cast<bf16*>(kv);
  bf16* v = k + (size_t)B * sk_text * C;
  bf16* ki = v + (size_t)B * sk_text * C;
  bf16* vi = ki + (size_t)B * sk_ip * C;
  const void* w[4] = {wk, wv, wki, wvi};
  bf16* const kvo[4] = {k, v, ki, vi};
  int e = launch_ctx_kv(ctx, B, Sk_total, Dc, sk_text, sk_ip, w, kvo, C, kv_bn, kv_split, kv_stages, st);
  if (e) return e;
  e = launch_ln_quant_rows(x, ln_w, ln_b, nullptr, x8, sx, M, C, eps, st);
  if (e) return e;
  I8Args qa = {};
  qa.alpha = sm_scale;
  e = launch_i8gemm(qa, x8, sx, wq8, sq, q, M, C, C, q_bn, q_split, q_stages, I8_STORE, st);
  if (e) return e;
  const FaKeys text = {k, v, static_cast<const float*>(bias), sk_text, tk};
  const FaKeys adapter = {ki, vi, nullptr, sk_ip, tk_ip};
  e = launch_reg_attention((const bf16*)q, text, adapter, ip_scale, (float*)attn, B, S, heads, C / heads, FA_LOG2E,
                           st);
  if (e) return e;
  e = launch_quant_rows(attn, M, C, x8, sx, st);
  if (e) return e;
  I8Args o = {};
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_i8gemm(o, x8, sx, wo8, so, out, M, C, C, o_bn, o_split, o_stages, I8_BIAS_RESID, st);
}

}  // extern "C"
