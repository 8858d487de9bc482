// Hopper (sm_90a) kernels for the three fused UNet transformer-block ops.
//
// Replaces the TPU Pallas kernels
//   K1 ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention
//   K2 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_kv
//   K3 ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff
// with two device routines built around bf16 tensor-core products (WMMA
// 16x16x16, fp32 accumulation):
//   * gemm_kernel: C = epilogue(prologue(A) @ W^T), W in torch Linear layout
//     [N, K]. Optional LayerNorm prologue (fp32 row statistics computed by the
//     block itself, normalised rows rounded to bf16 as they enter shared
//     memory); epilogues: plain store, bias + residual add, and GEGLU
//     (a * gelu_erf(g) from two accumulators, value rows [0, N) and gate rows
//     [N, 2N) of W).
//   * attention_kernel: one block per (query tile of 64, head, batch); K/V
//     streamed through shared memory in tiles of 64 keys with an online
//     max-subtracted fp32 softmax; optional fp32 additive key bias [B, Sk];
//     optional second K/V set combined as out + s * out_2 (the adapter).
// The op entry points (extern "C", plain C ABI for ctypes) chain these:
//   K1 = LN+QKV GEMM (3 weight sets, one launch) -> attention -> out GEMM +
//        bias + residual
//   K2 = LN+Q GEMM -> (dual) attention over hoisted K/V -> out GEMM + bias +
//        residual
//   K3 = LN+W1 GEMM + bias + GEGLU -> W2 GEMM + bias + residual
// Intermediates (q/k/v, the attention output, the GEGLU product) go through
// device memory; the caller allocates them. Every entry point returns the
// cudaGetLastError() code of its first failing launch (0 on success).
//
// What bounds these on an H100: at the UNet's widths (C = 256/384/640) the
// GEMMs are small (K <= 2560) and the attention logits per head are
// 1000x1000 at most, so the kernels are bound by shared-memory traffic and
// per-launch latency rather than by HBM bandwidth or tensor-core peak. The
// design keeps every operand tile in shared memory once per block and the
// softmax statistics in registers; wgmma/TMA pipelines are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int LDS = BK + 8;   // bf16 row stride of the A/B tiles in shared memory
constexpr int LDC = BN + 4;   // fp32 row stride of the output tile

enum Epilogue { EPI_STORE = 0, EPI_BIAS_RESID = 1, EPI_GEGLU = 2 };

struct GemmSets {
  const bf16* w[3];  // [N (x2 for GEGLU), K] row-major
  bf16* c[3];        // [M, N]
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int GEMM_TILE_BYTES = 3 * BM * LDS * 2;    // A, B and the GEGLU gate B
constexpr int GEMM_OUT_BYTES = 2 * BM * LDC * 4;     // value and gate accumulators
constexpr int GEMM_SMEM = GEMM_TILE_BYTES > GEMM_OUT_BYTES ? GEMM_TILE_BYTES : GEMM_OUT_BYTES;

// C[m, n] = epi(sum_k pro(A)[m, k] * W[n, k]) for one 64x64 output tile.
// Requires K % 32 == 0 and N % 64 == 0 (checked by the caller); rows are
// masked against M.
template <bool LN, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const bf16* __restrict__ A, int M, int K,
    const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b, float eps,
    GemmSets sets, int N,
    const bf16* __restrict__ bias, const bf16* __restrict__ resid) {
  constexpr bool DUAL = EPI == EPI_GEGLU;
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  bf16* Bs2 = Bs + BN * LDS;
  float* Cs = reinterpret_cast<float*>(smem);
  float* Cs2 = Cs + BM * LDC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* W = sets.w[blockIdx.z];
  bf16* Cout = sets.c[blockIdx.z];

  if (LN) {
    // two-pass fp32 statistics, one warp per row
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (row < M) {
        const bf16* xr = A + (size_t)row * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += __bfloat162float(xr[k]);
        mean = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = __bfloat162float(xr[k]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / K + eps);
      }
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (DUAL) wmma::fill_fragment(acc2[i][j], 0.f);
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int row = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        val = *reinterpret_cast<const uint4*>(A + (size_t)row * K + k0 + kc);
        if (LN) {
          const uint4 gv = *reinterpret_cast<const uint4*>(ln_w + k0 + kc);
          const uint4 bv = *reinterpret_cast<const uint4*>(ln_b + k0 + kc);
          __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&val);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
          const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
          const float mu = s_mean[r], rs = s_rstd[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            const float2 bf = __bfloat1622float2(b2[e]);
            x2[e] = __floats2bfloat162_rn((xf.x - mu) * rs * gf.x + bf.x,
                                          (xf.y - mu) * rs * gf.y + bf.y);
          }
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = val;
    }
    for (int c = tid; c < BN * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDS + kc) =
          *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kc);
      if (DUAL)
        *reinterpret_cast<uint4*>(Bs2 + r * LDS + kc) =
            *reinterpret_cast<const uint4*>(W + (size_t)(N + n0 + r) * K + k0 + kc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      if (DUAL) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs2 + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC, wmma::mem_row_major);
      if (DUAL)
        wmma::store_matrix_sync(Cs2 + (wm + i * 16) * LDC + wn + j * 16, acc2[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();

  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int row = m0 + r;
    if (row >= M) continue;
    const int col = n0 + cc;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cs[r * LDC + cc + e];
    if (EPI == EPI_BIAS_RESID) {
      const uint4 rv = *reinterpret_cast<const uint4*>(resid + (size_t)row * N + col);
      const uint4 bv = *reinterpret_cast<const uint4*>(bias + col);
      const bf16* r8 = reinterpret_cast<const bf16*>(&rv);
      const bf16* b8 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(r8[e]) + __bfloat162float(b8[e]);
    } else if (EPI == EPI_GEGLU) {
      const uint4 av = *reinterpret_cast<const uint4*>(bias + col);
      const uint4 gv = *reinterpret_cast<const uint4*>(bias + N + col);
      const bf16* a8 = reinterpret_cast<const bf16*>(&av);
      const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = v[e] + __bfloat162float(a8[e]);
        const float g = Cs2[r * LDC + cc + e] + __bfloat162float(g8[e]);
        v[e] = a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
      }
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(Cout + (size_t)row * N + col) = o;
  }
}

constexpr int TQ = 64;   // query rows per block (16 per warp)
constexpr int TK = 64;   // keys per streamed tile
constexpr int LDP = TK + 8;

struct AttnLayout {
  int ldq, lds, ldo;       // bf16 stride of Q/K/V tiles, fp32 stride of S/PV, fp32 stride of O
  size_t q, k, v, s, p, o, f, corr, bytes;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline AttnLayout attn_layout(int d, bool dual) {
  AttnLayout L;
  L.ldq = d + 8;
  L.lds = (d > TK ? d : TK) + 4;
  L.ldo = d + 4;
  size_t off = 0;
  L.q = off; off = align128(off + (size_t)TQ * L.ldq * 2);
  L.k = off; off = align128(off + (size_t)TK * L.ldq * 2);
  L.v = off; off = align128(off + (size_t)TK * L.ldq * 2);
  L.s = off; off = align128(off + (size_t)TQ * L.lds * 4);
  L.p = off; off = align128(off + (size_t)TQ * LDP * 2);
  L.o = off; off = align128(off + (size_t)TQ * L.ldo * 4);
  L.f = off; if (dual) off = align128(off + (size_t)TQ * L.ldo * 4);
  L.corr = off; off = align128(off + (size_t)TQ * 4);
  L.bytes = off;
  return L;
}

// out[b, i, h*d:(h+1)*d] = softmax(q_i k^T * scale + bias) v  (+ s2 * the same
// over the second K/V set, unbiased). d % 16 == 0, d <= 128.
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const bf16* __restrict__ q, int ldq_g, int Sq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv, int Sk,
    const float* __restrict__ bias,
    const bf16* __restrict__ k2, const bf16* __restrict__ v2, int ldkv2, int Sk2, float s2,
    bf16* __restrict__ out, int ldo_g, int d, float sm_scale) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const bool dual = k2 != nullptr;
  const AttnLayout L = attn_layout(d, dual);
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(dyn_smem + L.v);
  float* Ss = reinterpret_cast<float*>(dyn_smem + L.s);
  bf16* Ps = reinterpret_cast<bf16*>(dyn_smem + L.p);
  float* Os = reinterpret_cast<float*>(dyn_smem + L.o);
  float* Fs = reinterpret_cast<float*>(dyn_smem + L.f);
  float* Cr = reinterpret_cast<float*>(dyn_smem + L.corr);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int dv = d / 8;

  for (int c = tid; c < TQ * dv; c += THREADS) {
    const int r = c / dv, cc = (c % dv) * 8, row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < Sq) val = *reinterpret_cast<const uint4*>(q + ((size_t)b * Sq + row) * ldq_g + h * d + cc);
    *reinterpret_cast<uint4*>(Qs + r * L.ldq + cc) = val;
  }
  for (int c = tid; c < TQ * L.ldo; c += THREADS) Os[c] = 0.f;

  float* Sw = Ss + warp * 16 * L.lds;
  const int nsets = dual ? 2 : 1;
  for (int set = 0; set < nsets; ++set) {
    const bf16* kp = set == 0 ? k : k2;
    const bf16* vp = set == 0 ? v : v2;
    const int ld = set == 0 ? ldkv : ldkv2;
    const int skn = set == 0 ? Sk : Sk2;
    const float* bp = set == 0 ? bias : nullptr;
    float m_r[16], l_r[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m_r[r] = -INFINITY;
      l_r[r] = 0.f;
    }

    for (int k0 = 0; k0 < skn; k0 += TK) {
      __syncthreads();
      for (int c = tid; c < TK * dv; c += THREADS) {
        const int r = c / dv, cc = (c % dv) * 8, row = k0 + r;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
        if (row < skn) {
          const size_t off = ((size_t)b * skn + row) * ld + h * d + cc;
          kv = *reinterpret_cast<const uint4*>(kp + off);
          vv = *reinterpret_cast<const uint4*>(vp + off);
        }
        *reinterpret_cast<uint4*>(Ks + r * L.ldq + cc) = kv;
        *reinterpret_cast<uint4*>(Vs + r * L.ldq + cc) = vv;
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 query rows
      for (int j = 0; j < TK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < d; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bb;
          wmma::load_matrix_sync(a, Qs + warp * 16 * L.ldq + kk, L.ldq);
          wmma::load_matrix_sync(bb, Ks + j * 16 * L.ldq + kk, L.ldq);
          wmma::mma_sync(acc, a, bb, acc);
        }
        wmma::store_matrix_sync(Sw + j * 16, acc, L.lds, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax; each lane owns key columns lane and lane + 32
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float x0 = Sw[r * L.lds + lane] * sm_scale;
        float x1 = Sw[r * L.lds + lane + 32] * sm_scale;
        if (bp != nullptr) {
          if (c0 < skn) x0 += bp[(size_t)b * skn + c0];
          if (c1 < skn) x1 += bp[(size_t)b * skn + c1];
        }
        if (c0 >= skn) x0 = -INFINITY;
        if (c1 >= skn) x1 = -INFINITY;
        const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        const float corr = expf(m_r[r] - m_new);
        l_r[r] = l_r[r] * corr + warp_sum(p0 + p1);
        m_r[r] = m_new;
        const int gr = warp * 16 + r;
        Ps[gr * LDP + lane] = __float2bfloat16(p0);
        Ps[gr * LDP + lane + 32] = __float2bfloat16(p1);
        if (lane == 0) Cr[gr] = corr;
      }
      __syncwarp();

      // PV for this warp's rows into Sw (S is dead now)
      for (int dj = 0; dj < d; dj += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
          wmma::load_matrix_sync(a, Ps + warp * 16 * LDP + kk, LDP);
          wmma::load_matrix_sync(bb, Vs + kk * L.ldq + dj, L.ldq);
          wmma::mma_sync(acc, a, bb, acc);
        }
        wmma::store_matrix_sync(Sw + dj, acc, L.lds, wmma::mem_row_major);
      }
      __syncwarp();
      for (int e = lane; e < 16 * d; e += 32) {
        const int r = e / d, c = e % d, gr = warp * 16 + r;
        Os[gr * L.ldo + c] = Os[gr * L.ldo + c] * Cr[gr] + Sw[r * L.lds + c];
      }
      __syncwarp();
    }

    // normalise this set; combine the sets as out_1 + s2 * out_2
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (lane == 0) Cr[warp * 16 + r] = 1.f / l_r[r];
    __syncwarp();
    const bool last = set == nsets - 1;
    for (int e = lane; e < 16 * d; e += 32) {
      const int r = e / d, c = e % d, gr = warp * 16 + r;
      const float val = Os[gr * L.ldo + c] * Cr[gr];
      if (!last) {
        Fs[gr * L.ldo + c] = val;
        Os[gr * L.ldo + c] = 0.f;
      } else {
        const float res = dual ? Fs[gr * L.ldo + c] + s2 * val : val;
        const int row = q0 + gr;
        if (row < Sq) out[((size_t)b * Sq + row) * ldo_g + h * d + c] = __float2bfloat16(res);
      }
    }
    __syncwarp();
  }
}

int launch_attention(const bf16* q, int Sq, const bf16* k, const bf16* v, int Sk, const float* bias,
                     const bf16* k2, const bf16* v2, int Sk2, float s2, bf16* out,
                     int B, int C, int heads, cudaStream_t st) {
  const int d = C / heads;
  const AttnLayout L = attn_layout(d, k2 != nullptr);
  static size_t configured = 0;
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  dim3 grid((Sq + TQ - 1) / TQ, heads, B);
  attention_kernel<<<grid, THREADS, L.bytes, st>>>(q, C, Sq, k, v, C, Sk, bias, k2, v2, C, Sk2, s2, out, C, d,
                                                   1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <bool LN, int EPI>
int launch_gemm(const bf16* A, int M, int K, const bf16* ln_w, const bf16* ln_b, float eps,
                const GemmSets& sets, int nsets, int N, const bf16* bias, const bf16* resid,
                cudaStream_t st) {
  dim3 grid(N / BN, (M + BM - 1) / BM, nsets);
  gemm_kernel<LN, EPI><<<grid, THREADS, 0, st>>>(A, M, K, ln_w, ln_b, eps, sets, N, bias, resid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: out = x + Wo . MHA(LN(x) Wq, LN(x) Wk, LN(x) Wv) + bo, x [B, S, C].
// q/k/v/attn are [B, S, C] scratch buffers.
int apk_fused_ln_self_attention(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                                const void* wk, const void* wv, const void* wo, const void* bo, void* q,
                                void* k, void* v, void* attn, void* out, int B, int S, int C, int heads,
                                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  GemmSets qkv = {{(const bf16*)wq, (const bf16*)wk, (const bf16*)wv}, {(bf16*)q, (bf16*)k, (bf16*)v}};
  int e = launch_gemm<true, EPI_STORE>((const bf16*)x, M, C, (const bf16*)ln_w, (const bf16*)ln_b, eps, qkv, 3,
                                       C, nullptr, nullptr, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, S, nullptr, nullptr, nullptr, 0, 0.f,
                       (bf16*)attn, B, C, heads, st);
  if (e) return e;
  GemmSets o = {{(const bf16*)wo, nullptr, nullptr}, {(bf16*)out, nullptr, nullptr}};
  return launch_gemm<false, EPI_BIAS_RESID>((const bf16*)attn, M, C, nullptr, nullptr, 0.f, o, 1, C,
                                            (const bf16*)bo, (const bf16*)x, st);
}

// K2: out = x + Wo . [softmax(q k^T + bias) v + s * softmax(q ki^T) vi] + bo with
// q = LN(x) Wq against precomputed K/V [B, Sk, C] (ki/vi [B, Sk_ip, C] may be
// null; bias [B, Sk] fp32 may be null). q/attn are [B, S, C] scratch buffers.
int apk_fused_ln_cross_attention_kv(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                                    const void* wo, const void* bo, const void* k, const void* v, int Sk,
                                    const void* bias, const void* ki, const void* vi, int Sk_ip, float ip_scale,
                                    void* q, void* attn, void* out, int B, int S, int C, int heads, float eps,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  GemmSets qs = {{(const bf16*)wq, nullptr, nullptr}, {(bf16*)q, nullptr, nullptr}};
  int e = launch_gemm<true, EPI_STORE>((const bf16*)x, M, C, (const bf16*)ln_w, (const bf16*)ln_b, eps, qs, 1,
                                       C, nullptr, nullptr, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, Sk, (const float*)bias,
                       (const bf16*)ki, (const bf16*)vi, Sk_ip, ip_scale, (bf16*)attn, B, C, heads, st);
  if (e) return e;
  GemmSets o = {{(const bf16*)wo, nullptr, nullptr}, {(bf16*)out, nullptr, nullptr}};
  return launch_gemm<false, EPI_BIAS_RESID>((const bf16*)attn, M, C, nullptr, nullptr, 0.f, o, 1, C,
                                            (const bf16*)bo, (const bf16*)x, st);
}

// K3: out = x + W2 . (a * gelu_erf(g)) + b2 with [a | g] = LN(x) W1 + b1;
// w1 [2*inner, C], w2 [C, inner]; y is an [B, S, inner] scratch buffer.
int apk_fused_ln_geglu_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* y, void* out, int B, int S, int C, int inner,
                          float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  GemmSets g = {{(const bf16*)w1, nullptr, nullptr}, {(bf16*)y, nullptr, nullptr}};
  int e = launch_gemm<true, EPI_GEGLU>((const bf16*)x, M, C, (const bf16*)ln_w, (const bf16*)ln_b, eps, g, 1,
                                       inner, (const bf16*)b1, nullptr, st);
  if (e) return e;
  GemmSets o = {{(const bf16*)w2, nullptr, nullptr}, {(bf16*)out, nullptr, nullptr}};
  return launch_gemm<false, EPI_BIAS_RESID>((const bf16*)y, M, inner, nullptr, nullptr, 0.f, o, 1, C,
                                            (const bf16*)b2, (const bf16*)x, st);
}

}  // extern "C"

extern "C" const char* apk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
