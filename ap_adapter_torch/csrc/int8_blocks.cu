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
// acc * s_row * s_col, unfused as in the plain version.
//
// K11b (redesigned for Hopper) runs six device kernels:
//   * ln_quant_rows_kernel: one warp a row, the row in registers, fp32
//     two-pass statistics; from the one fp32 LayerNorm value of each element
//     it writes both the bf16 row the K/V GEMM reads and the int8 row and
//     fp32 scale of the q projection;
//   * i8gemm_kernel (below): the int8 q GEMM, epilogue * alpha into bf16
//     (q pre-scaled by 1/sqrt(d));
//   * hgemm_kernel<bn, HG_STORE> (hopper_gemm.cuh): K and V, two weight sets
//     in one launch, over the bf16 LayerNorm rows;
//   * reg_attention_kernel<d, false, true, float> (reg_attention.cuh): K1's
//     attention with one key set, softmax scale 1, and an fp32 store;
//   * quant_rows_kernel<false>: the fp32 attention rows to int8 and scales;
//   * i8gemm_kernel: the int8 out GEMM, epilogue + bias + residual.
// i8gemm_kernel is hopper_gemm.cuh's structure for s8: one CTA a 64 x bn
// output tile, a producer warp issuing TMA loads of A8 [M, K] and W8 [N, K]
// (both K-major, as wgmma's 8-bit form requires, and both already lie that
// way) in 128-byte k-blocks (128 int8 values, the 128-byte swizzle's row)
// into a ring of 2-4 stages, one consumer warpgroup running
// wgmma m64nBNk32 s32.s8.s8, exact int32 sums. Where the output tiles are
// fewer than the SMs the k-blocks are split over a thread-block cluster
// and the int32 partials combined, exactly and in rank order, through
// distributed shared memory (ops/hopper_gemm.py::gemm_plan, int8=True). K
// need only be a multiple of 64: a last half block is zero-filled by TMA
// in both operands.
//
// K11a and K11c keep the first port's routines here: quant_rows_kernel with
// its LN form, and gemm_i8_kernel, mma.sync m16n8k32 on 64x64 tiles with one
// unpipelined 64-deep k tile, whose epilogue also forms the fp32 GEGLU
// product a * g * 0.5 * (1 + erf(g / sqrt 2)) from a value and a gate
// accumulator; with common.cuh's context K/V GEMM and streamed attention
// (fp32 output):
//   K11a = LN+quant -> int8 W1 GEMM + GEGLU (fp32 y) -> quant -> int8 W2 GEMM
//          + bias + residual
//   K11c = context K/V bf16 GEMMs (text, adapter) -> LN+quant -> int8 Wq GEMM
//          -> (dual, biased) attention (fp32 out) -> quant -> int8 Wo GEMM +
//          bias + residual
// What is not int8, as on the TPU: the K/V projections and the QK/PV
// products stay bf16 (the TPU package measured those shapes losing under
// int8, and softmax probabilities do not fit an int8 grid).
//
// What bounds these on an H100: at the UNet's widths the int8 GEMMs are small
// (K <= 2560, N <= 5120) and the activations make several round trips through
// device memory (int8 rows, their scales, the fp32 attention output and GEGLU
// product), so the kernels are bound by launch and per-CTA latency far above
// the tensor-core bound (1,979 TOPS int8).

#include "common.cuh"
#include "hopper_gemm.cuh"
#include "reg_attention.cuh"

namespace {

constexpr float INV127 = (float)(1.0 / 127.0);
constexpr int BK8 = 64;          // int8 k-depth of a shared tile (two m16n8k32 steps)
constexpr int LDS8 = BK8 + 16;   // byte stride: 16-byte aligned rows, conflict-free fragment loads

template <bool LN>
__device__ __forceinline__ float qr_load(const void* src, size_t i) {
  if (LN) return __bfloat162float(static_cast<const bf16*>(src)[i]);
  return static_cast<const float*>(src)[i];
}

// rows [M, K] -> q int8 [M, K] and scale fp32 [M]; with LN, src is bf16 and
// the row is first LayerNormed in fp32 as the TPU kernels' _ln does it:
// (x - mean) * rsqrt(var + eps) * w + b
template <bool LN>
__global__ void __launch_bounds__(THREADS) quant_rows_kernel(const void* __restrict__ src,
                                                             const bf16* __restrict__ ln_w,
                                                             const bf16* __restrict__ ln_b, float eps, int M,
                                                             int K, int8_t* __restrict__ q,
                                                             float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= M) return;
  const size_t base = (size_t)row * K;
  float mean = 0.f, rstd = 0.f;
  if (LN) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += qr_load<LN>(src, base + k);
    mean = warp_sum(s) / K;
    float v = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = qr_load<LN>(src, base + k) - mean;
      v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / K + eps);
  }
  auto value = [&](int k) -> float {
    const float x = qr_load<LN>(src, base + k);
    if (!LN) return x;
    return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), __bfloat162float(ln_w[k])), __bfloat162float(ln_b[k]));
  };
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(value(k)));
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), INV127);
  const float inv = 1.f / s;
  for (int k = lane; k < K; k += 32) q[base + k] = (int8_t)__float2int_rn(__fmul_rn(value(k), inv));
  if (lane == 0) scale[row] = s;
}

template <bool LN>
int launch_quant_rows(const void* src, const void* ln_w, const void* ln_b, float eps, int M, int K, void* q,
                      void* scale, cudaStream_t st) {
  const int rows = THREADS / 32;
  quant_rows_kernel<LN><<<(M + rows - 1) / rows, THREADS, 0, st>>>(
      src, (const bf16*)ln_w, (const bf16*)ln_b, eps, M, K, (int8_t*)q, (float*)scale);
  return (int)cudaGetLastError();
}

enum EpiI8 {
  I8_STORE = 0,       // bf16 C = acc * sa * sw * alpha
  I8_BIAS_RESID = 1,  // bf16 C = resid + (acc * sa * sw + bias)
  I8_GEGLU = 2,       // fp32 C[M, N] = a * g * 0.5 * (1 + erf(g / sqrt 2)), [a | g] = acc * sa * sw + bias
                      // over W rows [0, N) | [N, 2N)
};

struct GemmI8Args {
  const int8_t* A;    // [M, K]
  const float* sa;    // [M] row scales
  const int8_t* W;    // [N (x2 for GEGLU), K]
  const float* sw;    // [N (x2)] column scales
  const bf16* bias;   // [N (x2)]
  const bf16* resid;  // [M, N]
  float alpha;
  void* C;            // [M, N]
  int M, N, K;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// acc * s_row * s_col, unfused as in the plain version
__device__ __forceinline__ float dequant(int acc, float sr, float sc) {
  return __fmul_rn(__fmul_rn((float)acc, sr), sc);
}

// One 64x64 output tile per block, 4 warps of 32x32 (2 m16 x 4 n8 mma tiles
// each). Requires K % 64 == 0 and N % 64 == 0 (checked by the caller); rows
// are masked against M. Fragment layouts of mma.m16n8k32 (.s8), by 32-bit
// word: A {row g, word t}, {g + 8, t}, {g, t + 4}, {g + 8, t + 4}; B {word
// t, col g}, {t + 4, g}; C {row g, cols 2t, 2t + 1}, {row g + 8, the same},
// with g = lane / 4 and t = lane % 4.
template <int EPI>
__global__ void __launch_bounds__(THREADS) gemm_i8_kernel(const GemmI8Args g) {
  constexpr bool DUAL = EPI == I8_GEGLU;
  __shared__ __align__(16) int8_t As[BM * LDS8];
  __shared__ __align__(16) int8_t Bs[BN * LDS8];
  __shared__ __align__(16) int8_t Bs2[DUAL ? BN * LDS8 : 16];
  const int M = g.M, N = g.N, K = g.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4], acc2[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        acc2[i][j][e] = 0;
      }

  for (int k0 = 0; k0 < K; k0 += BK8) {
    for (int c = tid; c < BM * BK8 / 16; c += THREADS) {
      const int r = c / (BK8 / 16), kc = (c % (BK8 / 16)) * 16;
      const int row = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) val = *reinterpret_cast<const uint4*>(g.A + (size_t)row * K + k0 + kc);
      *reinterpret_cast<uint4*>(As + r * LDS8 + kc) = val;
      *reinterpret_cast<uint4*>(Bs + r * LDS8 + kc) =
          *reinterpret_cast<const uint4*>(g.W + (size_t)(n0 + r) * K + k0 + kc);
      if (DUAL)
        *reinterpret_cast<uint4*>(Bs2 + r * LDS8 + kc) =
            *reinterpret_cast<const uint4*>(g.W + (size_t)(N + n0 + r) * K + k0 + kc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK8; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm + i * 16 + gid) * LDS8 + kk + tig * 4;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDS8);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * LDS8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + gid) * LDS8 + kk + tig * 4;
        const uint32_t b[2] = {ld32(p), ld32(p + 16)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
        if (DUAL) {
          const int8_t* p2 = Bs2 + (wn + j * 8 + gid) * LDS8 + kk + tig * 4;
          const uint32_t b2[2] = {ld32(p2), ld32(p2 + 16)};
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc2[i][j], a[i], b2);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gid + h * 8;
      if (row >= M) continue;
      const float sr = g.sa[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) v[e] = dequant(acc[i][j][2 * h + e], sr, g.sw[col + e]);
        if (EPI == I8_GEGLU) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = __fadd_rn(v[e], __bfloat162float(g.bias[col + e]));
            const float gate = __fadd_rn(dequant(acc2[i][j][2 * h + e], sr, g.sw[N + col + e]),
                                         __bfloat162float(g.bias[N + col + e]));
            const float t = 1.f + erff(__fmul_rn(gate, 0.70710678118654752f));
            v[e] = __fmul_rn(__fmul_rn(__fmul_rn(a, gate), 0.5f), t);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(g.C) + (size_t)row * N + col) = make_float2(v[0], v[1]);
          continue;
        }
        if (EPI == I8_STORE) {
          v[0] = __fmul_rn(v[0], g.alpha);
          v[1] = __fmul_rn(v[1], g.alpha);
        } else {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(g.resid + (size_t)row * N + col));
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
          v[0] = __fadd_rn(r.x, __fadd_rn(v[0], b.x));
          v[1] = __fadd_rn(r.y, __fadd_rn(v[1], b.y));
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.C) + (size_t)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

template <int EPI>
int launch_gemm_i8(const GemmI8Args& g, cudaStream_t st) {
  dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_i8_kernel<EPI><<<grid, THREADS, 0, st>>>(g);
  return (int)cudaGetLastError();
}

GemmI8Args gemm_i8_args(const void* A, const void* sa, const void* W, const void* sw, void* C, int M, int N,
                        int K) {
  GemmI8Args g = {};
  g.A = (const int8_t*)A;
  g.sa = (const float*)sa;
  g.W = (const int8_t*)W;
  g.sw = (const float*)sw;
  g.C = C;
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

// the int8 out projection: out = x + (quant(attn) . Wo8^T * sa * so + bo); attn
// fp32 [M, C] is quantized into the a8/sa scratch
int out_proj_i8(const void* attn, const void* wo8, const void* so, const void* bo, const void* x, void* a8,
                void* sa, void* out, int M, int C, cudaStream_t st) {
  int e = launch_quant_rows<false>(attn, nullptr, nullptr, 0.f, M, C, a8, sa, st);
  if (e) return e;
  GemmI8Args o = gemm_i8_args(a8, sa, wo8, so, out, M, C, C);
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_gemm_i8<I8_BIAS_RESID>(o, st);
}

// the int8 q projection: q = quant(LN(x)) . Wq8^T * sx * sq * sm_scale (bf16)
int q_proj_i8(const void* x, const void* ln_w, const void* ln_b, float eps, const void* wq8, const void* sq,
              void* x8, void* sx, void* q, int M, int C, float sm_scale, cudaStream_t st) {
  int e = launch_quant_rows<true>(x, ln_w, ln_b, eps, M, C, x8, sx, st);
  if (e) return e;
  GemmI8Args g = gemm_i8_args(x8, sx, wq8, sq, q, M, C, C);
  g.alpha = sm_scale;
  return launch_gemm_i8<I8_STORE>(g, st);
}

// K11b's LayerNorm row pass: from one read of x, y = bf16(v) (the K/V
// GEMM's rows) and q = int8(v), scale[row] (the q projection's), where v is
// the fp32 LayerNorm value (x - mean) * rstd * w + b rounded as
// quant_rows_kernel<true> rounds it. One warp a row, the row in registers.
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
      uint4 o;
      uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e] - mean, rstd), __bfloat162float(w8[e])),
                            __bfloat162float(b8[e]));
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o32[e] = pack_bf16(v[i][2 * e], v[i][2 * e + 1]);
      *reinterpret_cast<uint4*>(y + (size_t)row * C + 8 * c) = o;
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

int launch_ln_quant_rows(const void* x, const void* w, const void* b, void* y, void* q, void* scale, int M, int C,
                         float eps, cudaStream_t st) {
  if (C % 64 || C > LN_MAX_CHUNKS * 8 * 32) return (int)cudaErrorInvalidValue;
  ln_quant_rows_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, (int8_t*)q, (float*)scale, M, C, eps);
  return (int)cudaGetLastError();
}

// softmax(q k^T * scale) v over one key set (k/v [B, S, H * d]) into fp32
// out [B, S, H * d]: the one-set, 64-key-tile kernel with an fp32 store
int launch_reg_attention_f32(const bf16* q, const bf16* k, const bf16* v, float* out, int B, int S, int H, int d,
                             float scale, cudaStream_t st) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const FaKeys keys = {k, v, nullptr, S, FA_TK}, none = {nullptr, nullptr, nullptr, 0, FA_TK};
  const float sl = FA_LOG2E * scale;
  switch (d) {
    case 16: return launch_reg_attention_t<16, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 32: return launch_reg_attention_t<32, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 48: return launch_reg_attention_t<48, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 64: return launch_reg_attention_t<64, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 80: return launch_reg_attention_t<80, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 96: return launch_reg_attention_t<96, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 112: return launch_reg_attention_t<112, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    case 128: return launch_reg_attention_t<128, false, true>(q, keys, none, 0.f, out, B, S, H, sl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int I8_BK = 128;          // int8 k per stage: one 128-byte swizzle row

struct I8Args {
  CUtensorMap a;          // A8 [M, K]
  CUtensorMap w;          // W8 [N, K]
  const float* sa;        // [M] row scales
  const float* sw;        // [N] column scales
  const bf16* bias;       // I8_BIAS_RESID: [N]
  const bf16* resid;      // I8_BIAS_RESID: [M, N]
  bf16* c;                // [M, N]
  float alpha;            // I8_STORE
  int M, N, K;
  int ksplit, stages;
};

// the epilogue of two neighbouring columns (col, col + 1) of one row
template <int EPI>
__device__ __forceinline__ void i8_store_pair(const I8Args& g, int row, int col, int a0, int a1) {
  if (row >= g.M) return;
  const float sr = g.sa[row];
  float v0 = dequant(a0, sr, g.sw[col]), v1 = dequant(a1, sr, g.sw[col + 1]);
  const size_t off = (size_t)row * g.N + col;
  if (EPI == I8_BIAS_RESID) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.resid + off));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
    v0 = __fadd_rn(r.x, __fadd_rn(v0, b.x));
    v1 = __fadd_rn(r.y, __fadd_rn(v1, b.y));
  } else {
    v0 = __fmul_rn(v0, g.alpha);
    v1 = __fmul_rn(v1, g.alpha);
  }
  *reinterpret_cast<__nv_bfloat162*>(g.c + off) = __floats2bfloat162_rn(v0, v1);
}

// grid ((N / BN) * ksplit, ceil(M / 64)), HG_THREADS threads, clusters of
// (ksplit, 1, 1); the accumulator layout is hgemm_kernel's (s32 for f32).
template <int BN, int EPI>
__global__ void __launch_bounds__(HG_THREADS, 1) i8gemm_kernel(const __grid_constant__ I8Args g) {
  constexpr int NACC = BN / 2;
  constexpr int STAGE = HG_A_BYTES + BN * 128;
  extern __shared__ unsigned char i8_smem_raw[];
  const uint32_t raw = smem_u32(i8_smem_raw);
  unsigned char* smem = i8_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int ks = g.ksplit, stages = g.stages;
  const uint32_t bars = base + hg_ring_bytes(BN, false, stages, ks);

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
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8 * s, (i / stages) & 1);
      uint32_t sa = base + s * STAGE;
      asm volatile("" : "+r"(sa));
#pragma unroll
      for (int e = 0; e < NACC; ++e) reg_fence_i(acc[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < I8_BK / 32; ++kk) {
        const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(sa + HG_A_BYTES + kk * 32, 16, 1024);
        if constexpr (BN == 128) wgmma_s8_n128(acc, da, db);
        else wgmma_s8_n64(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();                          // k-block i - 1's products are done: free its stage
#pragma unroll
      for (int e = 0; e < NACC; ++e) reg_fence_i(acc[e]);
      if (i > 0) mbar_arrive(bars + 8 * (HG_MAX_STAGES + (i - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NACC; ++e) reg_fence_i(acc[e]);
  }

  const int quad = lane & 3;
  const int r0 = m0 + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  if (ks == 1) {
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        i8_store_pair<EPI>(g, r0, col, acc[4 * j], acc[4 * j + 1]);
        i8_store_pair<EPI>(g, r1, col, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    return;
  }

  // split-K: the int32 partials through distributed shared memory, summed in rank order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  int* part = reinterpret_cast<int*>(smem);             // [NACC][128 consumer threads]
  if (warp < 4) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) part[e * 128 + tid] = acc[e];
  }
  cluster.sync();
  if (warp < 4) {
    const int u0 = rank * (BN / 8) / ks, u1 = (rank + 1) * (BN / 8) / ks;
    for (int j = u0; j < u1; ++j) {
      int v[4] = {0, 0, 0, 0};
      for (int rr = 0; rr < ks; ++rr) {
        const int* rp = cluster.map_shared_rank(part, rr);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += rp[(4 * j + e) * 128 + tid];
      }
      const int col = n0 + 8 * j + 2 * quad;
      i8_store_pair<EPI>(g, r0, col, v[0], v[1]);
      i8_store_pair<EPI>(g, r1, col, v[2], v[3]);
    }
  }
  cluster.sync();                                       // no CTA leaves while another reads its partials
}

template <int BN, int EPI>
int launch_i8gemm_t(const I8Args& g, cudaStream_t st) {
  const int smem = hg_smem_bytes(BN, false, g.stages, g.ksplit);
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
// with column scales sw; the plan (bn, ksplit, stages) is the wrapper's
// (ops/hopper_gemm.py::gemm_plan with int8=True). g's bias, resid and alpha
// are the caller's.
int launch_i8gemm(I8Args& g, const void* a8, const void* sa, const void* w8, const void* sw, void* c, int M, int N,
                  int K, int bn, int ksplit, int stages, int epi, cudaStream_t st) {
  const int nkb = (K + I8_BK - 1) / I8_BK;
  if (M <= 0 || K % 64 || bn <= 0 || N % bn || ksplit < 1 || ksplit > HG_MAX_SPLIT || ksplit > nkb ||
      ksplit > bn / 8 || !(bn == 64 || bn == 128) || stages < HG_MIN_STAGES || stages > HG_MAX_STAGES ||
      !(epi == I8_STORE || epi == I8_BIAS_RESID))
    return (int)cudaErrorInvalidValue;
  g.sa = (const float*)sa;
  g.sw = (const float*)sw;
  g.c = (bf16*)c;
  g.M = M;
  g.N = N;
  g.K = K;
  g.ksplit = ksplit;
  g.stages = stages;
  int e = cached_map_2d(&g.a, a8, M, K, HG_BM, 1);
  if (!e) e = cached_map_2d(&g.w, w8, N, K, bn, 1);
  if (e) return e;
  if (epi == I8_STORE)
    return bn == 128 ? launch_i8gemm_t<128, I8_STORE>(g, st) : launch_i8gemm_t<64, I8_STORE>(g, st);
  return bn == 128 ? launch_i8gemm_t<128, I8_BIAS_RESID>(g, st) : launch_i8gemm_t<64, I8_BIAS_RESID>(g, st);
}

}  // namespace

extern "C" {

// K11a: out = x + (quant(y) . W2q^T * sy * s2 + b2), y = a * gelu_erf(g) in fp32,
// [a | g] = quant(LN(x)) . W1q^T * sx * s1 + b1; w1q int8 [2*inner, C], s1 fp32
// [2*inner], w2q int8 [C, inner], s2 fp32 [C], biases bf16. Scratch: x8 int8
// [B*S, C], y fp32 and y8 int8 [B*S, inner], sx/sy fp32 [B*S].
int apk_fused_ln_geglu_ff_int8(const void* x, const void* ln_w, const void* ln_b, const void* w1q,
                               const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
                               void* x8, void* sx, void* y, void* y8, void* sy, void* out, int B, int S, int C,
                               int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int e = launch_quant_rows<true>(x, ln_w, ln_b, eps, M, C, x8, sx, st);
  if (e) return e;
  GemmI8Args h = gemm_i8_args(x8, sx, w1q, s1, y, M, inner, C);
  h.bias = (const bf16*)b1;
  e = launch_gemm_i8<I8_GEGLU>(h, st);
  if (e) return e;
  e = launch_quant_rows<false>(y, nullptr, nullptr, 0.f, M, inner, y8, sy, st);
  if (e) return e;
  GemmI8Args o = gemm_i8_args(y8, sy, w2q, s2, out, M, C, inner);
  o.bias = (const bf16*)b2;
  o.resid = (const bf16*)x;
  return launch_gemm_i8<I8_BIAS_RESID>(o, st);
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
  e = launch_reg_attention_f32(q, k, v, (float*)attn, B, S, heads, C / heads, 1.f, st);
  if (e) return e;
  e = launch_quant_rows<false>(attn, nullptr, nullptr, 0.f, M, C, x8, sx, st);
  if (e) return e;
  I8Args o = {};
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_i8gemm(o, x8, sx, wo8, so, out, M, C, C, o_bn, o_split, o_stages, I8_BIAS_RESID, st);
}

// K11c: K11b's int8 q/out projections around K4's attention: text K/V =
// ctx[:, :sk_text] . Wk^T / Wv^T and adapter K/V = ctx[:, sk_text:] . Wki^T /
// Wvi^T projected here in bf16 (wki/wvi null: no adapter branch), combined as
// softmax(q k^T + bias) v + ip_scale * softmax(q ki^T) vi in fp32. ctx [B,
// Sk_total, Dc] bf16; bias [B, sk_text] fp32 or null. Scratch: x8/sx as in
// K11b, q bf16 and attn fp32 [B, S, C], k/v [B, sk_text, C], ki/vi [B,
// Sk_total - sk_text, C].
int apk_fused_ln_cross_attention_int8(const void* x, const void* ctx, int Sk_total, int Dc, int sk_text,
                                      const void* ln_w, const void* ln_b, const void* wq8, const void* sq,
                                      const void* wk, const void* wv, const void* wki, const void* wvi,
                                      const void* wo8, const void* so, const void* bo, float ip_scale,
                                      const void* bias, void* x8, void* sx, void* q, void* k, void* v, void* ki,
                                      void* vi, void* attn, void* out, int B, int S, int C, int heads, float eps,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  int e = launch_ctx_proj(ctx, B, Sk_total, Dc, 0, sk_text, wk, wv, k, v, C, st);
  if (e) return e;
  if (sk_ip > 0) {
    e = launch_ctx_proj(ctx, B, Sk_total, Dc, sk_text, sk_ip, wki, wvi, ki, vi, C, st);
    if (e) return e;
  }
  e = q_proj_i8(x, ln_w, ln_b, eps, wq8, sq, x8, sx, q, M, C, sm_scale, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, sk_text, (const float*)bias,
                       sk_ip > 0 ? (const bf16*)ki : nullptr, sk_ip > 0 ? (const bf16*)vi : nullptr, sk_ip,
                       ip_scale, (float*)attn, B, C, heads, 1.f, st);
  if (e) return e;
  return out_proj_i8(attn, wo8, so, bo, x, x8, sx, out, M, C, st);
}

}  // extern "C"
