// Hopper (sm_90a) kernels for two of the fused UNet transformer-block ops:
//
//   K1 ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention
//      (its _kernel_pipe/_kernel_t/_kernel_kt reorder the same function for
//      the TPU's lanes)
//   K3 ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff
//
// The entry points (extern "C", plain C ABI for ctypes) chain the routines
// of hopper_gemm.cuh and the attention below:
//   K1 = LN rows -> QKV GEMM (three weight sets, one launch, bf16 store)
//        -> register-resident attention -> out GEMM + bias + residual
//   K3 = LN rows -> W1 GEMM with the GEGLU epilogue -> W2 GEMM + bias +
//        residual
// Every GEMM's tile width and split-K come from the wrapper's plan
// (ops/hopper_gemm.py::gemm_plan). The intermediates (LN(x), q/k/v, the
// attention output, the GEGLU product) live in one scratch buffer that the
// wrapper allocates. Every entry point returns the cudaGetLastError() code
// of its first failing launch (0 on success).
//
// What bounds them on an H100 at the edit's shapes (B = 2; S = 1000, 252,
// 64; C = 256, 384, 640): 0.8-3.2 us a call, bf16 tensor-core operations
// at S = 1000 and 252, the weights' bytes at S = 64 (chip_smoke.py's
// bound_ms), so in practice each launch's own latency. common.cuh's chains
// reached 1.5-2% of that: WMMA without a load pipeline, every block
// recomputing its rows' LayerNorm statistics, 20 CTAs for 132 SMs at
// M = 128, and an attention that staged every key tile's logits, the PV
// product and the running output in shared memory as fp32. Here: wgmma fed
// by TMA through a ring of stages, LN once per row, split-K clusters where
// the output tiles are fewer than the SMs, and the attention below.
//
// The attention (reg_attention_kernel<D>): one CTA a tile of 64 query rows
// of one (batch, head), one warp 16 rows; Q's fragments are loaded once
// into registers; K/V tiles of 64 keys arrive by cp.async into a double
// buffer, the next one in flight while the current one is used. QK^T and PV
// run on mma.sync m16n8k16 (bf16 in, fp32 accumulation) with ldmatrix
// (ldmatrix.trans for V); the logits, the probabilities and the output
// accumulator stay in registers (the logits' accumulator layout is P's
// A-operand layout, so P never leaves them), with an online max-subtracted
// fp32 softmax in the exp2 domain; P is rounded to bf16 before PV
// (unnormalised), O / l once at the end. The softmax folds the scale into
// one FFMA a logit, takes ex2.approx and masks only the last tile: the
// exponentials and their bookkeeping, not the products, take most of a
// tile's time at d = 32. A CTA is 4 warps (64 query rows) at every shape:
// at the edit's shapes CTAs of 1 or 2 warps were slower, and splitting a
// query tile's keys over a 2-CTA cluster saved 5% at S = 1000 and nothing
// at S = 252, not worth the cluster. Why mma.sync and not wgmma: the head
// dims are 16-128 in steps of 16 (32, 48 and 80 on the edit path), so one
// head's row is not a whole 128-byte swizzle row: a 64-column TMA box would
// carry the next head's columns for d = 48 and 80, and the products are the
// smaller part of a tile's time at these head dims, so wgmma's higher peak
// would buy little. cp.async copies exactly d columns in 16-byte chunks into
// rows padded by 16 bytes (ldmatrix without bank conflicts). Keys past S are
// zero-filled and masked to -inf; query rows past S are not stored.

#include "hopper_gemm.cuh"

namespace {

constexpr int FA_TK = 64;           // keys per tile
constexpr int FA_THREADS = 128;     // 4 warps, 16 query rows each
constexpr int FA_TQ = 64;           // query rows per CTA

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[4] += A (m16k16, a[4]) * B (k16n8, b0 b1)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory of reg_attention_kernel<d>: Q, then 2 stages of K and V
__host__ __device__ inline int fa_smem_bytes(int d) { return (FA_TQ + 4 * FA_TK) * (d + 8) * 2; }

// ex2.approx: the exponent of the softmax, with the rounding of the logits'
// bf16 products already far above its error
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out[b, i, h*D:(h+1)*D] = softmax(q_i k^T * D^-1/2) v over q/k/v/out [B, S, C];
// grid (ceil(S / FA_TQ), H, B), FA_THREADS threads.
template <int D>
__global__ void __launch_bounds__(FA_THREADS) reg_attention_kernel(const bf16* __restrict__ q,
                                                                  const bf16* __restrict__ k,
                                                                  const bf16* __restrict__ v, bf16* __restrict__ out,
                                                                  int S, int C, float scale_log2) {
  constexpr int LD = D + 8;           // bf16 row stride in shared memory
  constexpr int CH = D / 8;           // 16-byte chunks of a row
  constexpr int NT = D / 8;           // n8 tiles of O
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_TQ;
  const uint32_t qs = smem_u32(fa_smem);
  const uint32_t ks = qs + FA_TQ * LD * 2, vs = ks + 2 * FA_TK * LD * 2;
  const size_t base = (size_t)b * S * C + (size_t)h * D;
  const int ntiles = (S + FA_TK - 1) / FA_TK;

  for (int c = tid; c < FA_TQ * CH; c += FA_THREADS) {
    const int r = c / CH, cc = c % CH, row = q0 + r;
    cp_async16(qs + (r * LD + cc * 8) * 2, q + base + (size_t)(row < S ? row : 0) * C + cc * 8, row < S);
  }
  auto load_kv = [&](int it) {
    const int st = it & 1, k0 = it * FA_TK;
    for (int c = tid; c < FA_TK * CH; c += FA_THREADS) {
      const int r = c / CH, cc = c % CH, row = k0 + r;
      const size_t off = base + (size_t)(row < S ? row : 0) * C + cc * 8;
      const uint32_t so = ((st * FA_TK + r) * LD + cc * 8) * 2;
      cp_async16(ks + so, k + off, row < S);
      cp_async16(vs + so, v + off, row < S);
    }
    cp_async_commit();
  };
  load_kv(0);                         // Q rides in the first group

  uint32_t qf[D / 16][4];
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int quad = lane & 3;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + ((16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8) * 2);
    }
    const uint32_t kt = ks + (it & 1) * FA_TK * LD * 2, vt = vs + (it & 1) * FA_TK * LD * 2;

    // S = Q K^T: 16 rows x 64 keys a warp, eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + ((kp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma16816(s[2 * kp], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * kp + 1], qf[kk], bk[2], bk[3]);
      }

    // online softmax over this tile; rows r and r + 8 of the warp's 16. The
    // maxima are kept in the scaled log2 domain (m = max * scale_log2), the
    // scale folded into one FFMA per logit; keys past S exist only in the
    // last tile, the only one that masks.
    if ((it + 1) * FA_TK > S) {
      const int kb = it * FA_TK + 2 * quad;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kb + 8 * t + (e & 1) >= S) s[t][e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2), mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = fast_exp2(fmaf(s[t][0], scale_log2, -m0));
      s[t][1] = fast_exp2(fmaf(s[t][1], scale_log2, -m0));
      s[t][2] = fast_exp2(fmaf(s[t][2], scale_log2, -m1));
      s[t][3] = fast_exp2(fmaf(s[t][3], scale_log2, -m1));
      ps0 += s[t][0] + s[t][1];
      ps1 += s[t][2] + s[t][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][0] *= c0;
      o[t][1] *= c0;
      o[t][2] *= c1;
      o[t][3] *= c1;
    }

    // O += P V: P from the logits' registers, V by ldmatrix.trans
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]), pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + ((kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 + (lane >> 4) * 8) * 2);
        mma16816(o[2 * dn], pa, bv[0], bv[1]);
        mma16816(o[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                  // the stage is refilled by the next iteration's load
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  bf16* ob = out + base;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * quad;
    if (row0 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * C + col) = pack_bf16(o[t][0] * inv0, o[t][1] * inv0);
    if (row1 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * C + col) = pack_bf16(o[t][2] * inv1, o[t][3] * inv1);
  }
}

template <int D>
int launch_reg_attention_t(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int S, int H,
                           cudaStream_t st) {
  const int smem = fa_smem_bytes(D);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(reg_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  dim3 grid((S + FA_TQ - 1) / FA_TQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  reg_attention_kernel<D><<<grid, FA_THREADS, smem, st>>>(q, k, v, out, S, H * D, scale_log2);
  return (int)cudaGetLastError();
}

int launch_reg_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int S, int H, int d,
                         cudaStream_t st) {
  switch (d) {
    case 16: return launch_reg_attention_t<16>(q, k, v, out, B, S, H, st);
    case 32: return launch_reg_attention_t<32>(q, k, v, out, B, S, H, st);
    case 48: return launch_reg_attention_t<48>(q, k, v, out, B, S, H, st);
    case 64: return launch_reg_attention_t<64>(q, k, v, out, B, S, H, st);
    case 80: return launch_reg_attention_t<80>(q, k, v, out, B, S, H, st);
    case 96: return launch_reg_attention_t<96>(q, k, v, out, B, S, H, st);
    case 112: return launch_reg_attention_t<112>(q, k, v, out, B, S, H, st);
    case 128: return launch_reg_attention_t<128>(q, k, v, out, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1: out = x + Wo . MHA(LN(x) Wq, LN(x) Wk, LN(x) Wv) + bo, x [B, S, C];
// scratch holds 5 x [B, S, C] bf16 (LN(x), q, k, v, the attention output).
// (qkv_bn, qkv_split, qkv_stages) and (out_bn, out_split, out_stages) plan
// the two GEMMs: tile width, split-K and ring stages.
int apk_fused_ln_self_attention(const void* x, const void* ln_w, const void* ln_b, const void* wq, const void* wk,
                                const void* wv, const void* wo, const void* bo, void* scratch, void* out, int B, int S,
                                int C, int heads, float eps, int qkv_bn, int qkv_split, int qkv_stages, int out_bn,
                                int out_split, int out_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16 *q = xn + mc, *k = q + mc, *v = k + mc, *attn = v + mc;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs qkv = {};
  const void* wqkv[3] = {wq, wk, wv};
  qkv.c[0] = q; qkv.c[1] = k; qkv.c[2] = v;
  e = launch_hgemm(qkv, xn, wqkv, 3, M, C, C, qkv_bn, qkv_split, qkv_stages, HG_STORE, st);
  if (e) return e;
  e = launch_reg_attention(q, k, v, attn, B, S, heads, C / heads, st);
  if (e) return e;
  HgArgs o = {};
  o.c[0] = static_cast<bf16*>(out);
  o.bias = static_cast<const bf16*>(bo);
  o.resid = static_cast<const bf16*>(x);
  return launch_hgemm(o, attn, &wo, 1, M, C, C, out_bn, out_split, out_stages, HG_BIAS_RESID, st);
}

// K3: out = x + W2 . (a * gelu_erf(g)) + b2 with [a | g] = LN(x) W1 + b1;
// w1 [2*inner, C], w2 [C, inner]; scratch holds [B, S, C] (LN(x)) and
// [B, S, inner] (the GEGLU product) bf16. The W1 GEMM takes 64-wide tiles
// (value and gate accumulators side by side) split w1_split ways with
// w1_stages, the W2 GEMM (w2_bn, w2_split, w2_stages).
int apk_fused_ln_geglu_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* scratch, void* out, int B, int S, int C, int inner,
                          float eps, int w1_split, int w1_stages, int w2_bn, int w2_split, int w2_stages,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16* y = xn + (size_t)M * C;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs g1 = {};
  g1.c[0] = y;
  g1.bias = static_cast<const bf16*>(b1);
  e = launch_hgemm(g1, xn, &w1, 1, M, inner, C, 64, w1_split, w1_stages, HG_GEGLU, st);
  if (e) return e;
  HgArgs g2 = {};
  g2.c[0] = static_cast<bf16*>(out);
  g2.bias = static_cast<const bf16*>(b2);
  g2.resid = static_cast<const bf16*>(x);
  return launch_hgemm(g2, y, &w2, 1, M, C, inner, w2_bn, w2_split, w2_stages, HG_BIAS_RESID, st);
}

}  // extern "C"
