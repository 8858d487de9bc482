// Hopper (sm_90a) kernels of the int8 (W8A8) serving configuration
// (UNetConfig.use_int8): the three fused transformer-block ops with their
// q/out projections and GEGLU products in int8.
//
// Replaces the TPU Pallas kernels
//   K11a ap_adapter_tpu/ops/pallas_int8.py::fused_ln_geglu_ff_int8 (:118)
//   K11b ap_adapter_tpu/ops/pallas_int8.py::fused_ln_self_attention_int8 (:259)
//   K11c ap_adapter_tpu/ops/pallas_int8.py::fused_ln_cross_attention_int8 (:410)
// with two routines of this file and two of common.cuh:
//   * quant_rows_kernel: one warp per row; fp32 values (the LayerNorm of a
//     bf16 row with fp32 statistics, or an fp32 row as it is) -> int8
//     q = round(v * (1 / s)) with s = max(amax, 1e-8) * (1/127), the TPU
//     kernels' _quant_rows (pallas_int8.py:80): rounding half to even
//     (__float2int_rn), the products unfused (__fmul_rn), so it rounds where
//     the TPU kernel and the plain version do;
//   * gemm_i8_kernel: C = epilogue(A8 . W8^T) on the int8 tensor cores
//     (mma.sync m16n8k32 s8 -> s32, exact integer sums), W in Linear layout
//     [N, K] with per-output-channel scales (quantize_weight,
//     pallas_int8.py:63). The epilogue dequantizes as acc * s_row * s_col
//     and then: scales by alpha into bf16 (the pre-scaled q projection),
//     adds bias and residual into bf16 (the out projections), or forms the
//     fp32 GEGLU product a * g * 0.5 * (1 + erf(g / sqrt 2)) from a value and
//     a gate accumulator (the first feed-forward product);
//   * from common.cuh: the LN-prologue bf16 GEMM for the self-attention K/V
//     and the gathered context K/V projections, and the streamed attention
//     with its fp32 output (the attention output is quantized from fp32).
// The op entry points (extern "C", plain C ABI for ctypes) chain them:
//   K11a = LN+quant -> int8 W1 GEMM + GEGLU (fp32 y) -> quant -> int8 W2 GEMM
//          + bias + residual
//   K11b = LN+quant -> int8 Wq GEMM (q bf16, pre-scaled) -> LN+KV bf16 GEMM
//          -> attention (fp32 out) -> quant -> int8 Wo GEMM + bias + residual
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
// product), so the kernels are bound by launch latency and memory traffic far
// above the tensor-core bound (1,979 TOPS int8). The design is the simple one:
// 64x64 output tiles of 4 warps, one 64-deep k tile in shared memory per step
// with no load pipeline, the epilogue straight from the accumulator
// registers. wgmma/TMA pipelines, and quantizing inside the GEMM prologue,
// are later work.

#include "common.cuh"

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
// [B*S] (reused for the attention output's quantization), q/k/v bf16 and attn
// fp32 [B, S, C].
int apk_fused_ln_self_attention_int8(const void* x, const void* ln_w, const void* ln_b, const void* wq8,
                                     const void* sq, const void* wk, const void* wv, const void* wo8,
                                     const void* so, const void* bo, void* x8, void* sx, void* q, void* k, void* v,
                                     void* attn, void* out, int B, int S, int C, int heads, float eps,
                                     float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int e = q_proj_i8(x, ln_w, ln_b, eps, wq8, sq, x8, sx, q, M, C, sm_scale, st);
  if (e) return e;
  GemmArgs kv = gemm_args(x, M, C, C);
  kv.ln_w = (const bf16*)ln_w;
  kv.ln_b = (const bf16*)ln_b;
  kv.eps = eps;
  kv.w[0] = (const bf16*)wk; kv.w[1] = (const bf16*)wv;
  kv.c[0] = k; kv.c[1] = v;
  e = launch_gemm<true, false, EPI_STORE>(kv, 2, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, S, nullptr, nullptr, nullptr, 0, 0.f,
                       (float*)attn, B, C, heads, 1.f, st);
  if (e) return e;
  return out_proj_i8(attn, wo8, so, bo, x, x8, sx, out, M, C, st);
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
