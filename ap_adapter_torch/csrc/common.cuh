// Device routines of K4 and K8 (train_blocks.cu) and the streamed d <= 128
// route of the self-attention (self_attention.cu), with helpers that
// resnet.cu, int8_blocks.cu and hopper_gemm.cuh use too. K1-K3, K7, K9,
// K10 and K11a-c run on the Hopper routines (hopper_gemm.cuh,
// reg_attention.cuh, attn_bwd.cuh and int8_blocks.cu's int8 wgmma GEMM),
// none of these.
//
//   * gemm_kernel: C = epilogue(prologue(A) @ W^T) for W in torch Linear
//     layout [N, K], or C = epilogue(A @ W) for W given as [K, N]
//     (``WT``, the product a backward pass takes with a frozen Linear
//     weight). bf16 WMMA 16x16x16 tiles, fp32 accumulation, 64x64 output
//     tiles of 4 warps. A's rows may be gathered in equal groups from a
//     strided batch (a context slice [B, rows, K] out of [B, Sk, K]).
//     Optional LayerNorm prologue (fp32 row statistics computed by the block
//     itself, normalised rows rounded to bf16 on their way into shared
//     memory). Epilogues: bf16 store, fp32 store, bias + residual.
//   * attention_kernel: one block per (query tile of 64, head, batch); K/V
//     streamed through shared memory in tiles of 64 keys with an online
//     max-subtracted fp32 softmax; optional fp32 additive key bias [B, Sk];
//     optional second K/V set combined as out + s * out_2 (the adapter);
//     output in bf16 or fp32 (OutT; its callers store bf16).
//   * launch_ctx_proj: the K/V projections of a cross-attention site from
//     the raw context rows (text or adapter), gathered in place.
// Each TU that includes this header gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int LDS = BK + 8;   // bf16 row stride of the A/B tiles in shared memory
constexpr int LDB = BN + 8;   // bf16 row stride of a [BK, BN] B tile (W given as [K, N])
constexpr int LDC = BN + 4;   // fp32 row stride of the output tile

enum Epilogue {
  EPI_STORE = 0,        // bf16 C
  EPI_BIAS_RESID = 1,   // bf16 C = acc + bias + resid
  EPI_STORE_F32 = 3,    // fp32 C
};

struct GemmArgs {
  const bf16* A;        // rows: A + (m / a_rpb) * a_bstride + (m % a_rpb) * K
  int M, K;
  int a_rpb;            // rows per gathered group (M for a plain [M, K] matrix)
  long long a_bstride;  // elements between groups
  const bf16* ln_w;
  const bf16* ln_b;
  float eps;
  const bf16* w[3];     // per grid-z slice: [N, K], or [K, N] with WT
  void* c[3];           // per grid-z slice: [M, N]
  int N;
  const bf16* bias;
  const bf16* resid;
};

inline GemmArgs gemm_args(const void* A, int M, int K, int N) {
  GemmArgs g = {};
  g.A = static_cast<const bf16*>(A);
  g.M = M;
  g.K = K;
  g.a_rpb = M;
  g.a_bstride = 0;
  g.N = N;
  return g;
}

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

__device__ __forceinline__ const bf16* a_row(const GemmArgs& g, int m) {
  return g.A + (size_t)(m / g.a_rpb) * g.a_bstride + (size_t)(m % g.a_rpb) * g.K;
}

constexpr int GEMM_TILE_BYTES = 2 * BM * LDS * 2;    // A and B
constexpr int GEMM_OUT_BYTES = BM * LDC * 4;         // the accumulators
constexpr int GEMM_SMEM = GEMM_TILE_BYTES > GEMM_OUT_BYTES ? GEMM_TILE_BYTES : GEMM_OUT_BYTES;
static_assert(BK * LDB <= BM * LDS, "a [BK, BN] B tile must fit the [BN, BK] slot");

// One 64x64 output tile. Requires K % 32 == 0 and N % 64 == 0 (checked by
// the caller); rows are masked against M. The arguments are read in place
// (__grid_constant__): the weight and output pointers are indexed by grid z,
// and a copy of the struct to the stack (128 bytes a thread) made this GEMM
// 16-20% slower at K4's and K8's training shapes on an H100.
template <bool LN, bool WT, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const __grid_constant__ GemmArgs g) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int M = g.M, K = g.K, N = g.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* W = g.w[blockIdx.z];

  if (LN) {
    // two-pass fp32 statistics, one warp per row
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (row < M) {
        const bf16* xr = a_row(g, row);
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += __bfloat162float(xr[k]);
        mean = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = __bfloat162float(xr[k]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / K + g.eps);
      }
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int row = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        val = *reinterpret_cast<const uint4*>(a_row(g, row) + k0 + kc);
        if (LN) {
          const uint4 gv = *reinterpret_cast<const uint4*>(g.ln_w + k0 + kc);
          const uint4 bv = *reinterpret_cast<const uint4*>(g.ln_b + k0 + kc);
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
    if (WT) {
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + nc) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + nc);
      }
    } else {
      for (int c = tid; c < BN * BK / 8; c += THREADS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDS + kc) =
            *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kc);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDS + kk, LDS);
      if (WT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int row = m0 + r;
    if (row >= M) continue;
    const int col = n0 + cc;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cs[r * LDC + cc + e];
    if (EPI == EPI_STORE_F32) {
      float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(g.c[blockIdx.z]) + (size_t)row * N + col);
      o4[0] = make_float4(v[0], v[1], v[2], v[3]);
      o4[1] = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    if (EPI == EPI_BIAS_RESID) {
      const uint4 rv = *reinterpret_cast<const uint4*>(g.resid + (size_t)row * N + col);
      const uint4 bv = *reinterpret_cast<const uint4*>(g.bias + col);
      const bf16* r8 = reinterpret_cast<const bf16*>(&rv);
      const bf16* b8 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(r8[e]) + __bfloat162float(b8[e]);
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(g.c[blockIdx.z]) + (size_t)row * N + col) = o;
  }
}

template <bool LN, bool WT, int EPI>
int launch_gemm(const GemmArgs& g, int nsets, cudaStream_t st) {
  dim3 grid(g.N / BN, (g.M + BM - 1) / BM, nsets);
  gemm_kernel<LN, WT, EPI><<<grid, THREADS, 0, st>>>(g);
  return (int)cudaGetLastError();
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

__device__ __forceinline__ void store_val(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

// out[b, i, h*d:(h+1)*d] = softmax(q_i k^T * scale + bias) v  (+ s2 * the same
// over the second K/V set, unbiased), combined in fp32 and stored as OutT.
// d % 16 == 0, d <= 128.
template <typename OutT>
__global__ void __launch_bounds__(THREADS) attention_kernel(
    const bf16* __restrict__ q, int ldq_g, int Sq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv, int Sk,
    const float* __restrict__ bias,
    const bf16* __restrict__ k2, const bf16* __restrict__ v2, int ldkv2, int Sk2, float s2,
    OutT* __restrict__ out, int ldo_g, int d, float sm_scale) {
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
        if (row < Sq) store_val(out + ((size_t)b * Sq + row) * ldo_g + h * d + c, res);
      }
    }
    __syncwarp();
  }
}

// 1/sqrt(d), the softmax scale of unscaled queries
inline float head_scale(int C, int heads) { return 1.f / sqrtf((float)(C / heads)); }

template <typename OutT>
int launch_attention(const bf16* q, int Sq, const bf16* k, const bf16* v, int Sk, const float* bias,
                     const bf16* k2, const bf16* v2, int Sk2, float s2, OutT* out,
                     int B, int C, int heads, float sm_scale, cudaStream_t st) {
  const int d = C / heads;
  const AttnLayout L = attn_layout(d, k2 != nullptr);
  static size_t configured = 0;
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  dim3 grid((Sq + TQ - 1) / TQ, heads, B);
  attention_kernel<OutT><<<grid, THREADS, L.bytes, st>>>(q, C, Sq, k, v, C, Sk, bias, k2, v2, C, Sk2, s2, out, C, d,
                                                         sm_scale);
  return (int)cudaGetLastError();
}

// the context K/V projections of a cross-attention site: rows [row0, row0 + rows)
// of each batch entry of ctx [B, Sk_total, Dc] times two Linear weights [C, Dc]
int launch_ctx_proj(const void* ctx, int B, int Sk_total, int Dc, int row0, int rows, const void* w0,
                    const void* w1, void* out0, void* out1, int C, cudaStream_t st) {
  GemmArgs p = gemm_args((const bf16*)ctx + (size_t)row0 * Dc, B * rows, Dc, C);
  p.a_rpb = rows;
  p.a_bstride = (long long)Sk_total * Dc;
  p.w[0] = (const bf16*)w0; p.w[1] = (const bf16*)w1;
  p.c[0] = out0; p.c[1] = out1;
  return launch_gemm<false, false, EPI_STORE>(p, 2, st);
}

}  // namespace
