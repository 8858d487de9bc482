// Hopper (sm_90a) kernel for unmasked self-attention over long sequences,
// out = softmax(q k^T / sqrt(d)) v with q/k/v/out [B, S, H, d] bf16.
//
// Replaces both TPU Pallas kernels of this function:
//   K5 ap_adapter_tpu/ops/pallas_packed_attention.py::packed_self_attention
//      (heads packed into the 128 lanes when d divides 128)
//   K6 ap_adapter_tpu/ops/pallas_self_attention.py::pallas_self_attention
//      (any d, the whole K/V of a head resident in VMEM)
// The head packing and the K/V residency are answers to the TPU's lane width
// and VMEM; a Hopper block takes any d that is a multiple of 16 up to 512
// directly, so one kernel serves both call sites. The path that reaches it is
// the VAE mid-block attention (one head, d = 512, S = 4000 at edit time and
// 4096 in training); the smoke also holds it at the UNet's d = 32 and 80.
//
// Design. At d = 512 a streamed online-softmax kernel that keeps a 64-row
// fp32 O beside its Q tile (as common.cuh's attention routine does for
// d <= 128) needs 128 KB + 64 KB of shared memory before any K/V tile. This
// kernel takes a stats pass, then a PV pass, inside one block of 8 warps:
//   1. stream the key tiles once for the row max m and the sum l of
//      exp(s - m) (fp32, max-subtracted, as K6 at pallas_self_attention.py:
//      27-47); S = Q K^T per tile with WMMA bf16 16x16x16, fp32 accumulate;
//   2. stream them again: recompute S, P = exp(s - m) / l rounded to bf16 (as
//      the plain version and sdpa round the probabilities), O += P V with O
//      in WMMA accumulator registers, each warp owning a fixed set of 16x16
//      output fragments; O is already normalised at the end.
// QK^T is computed twice (3 products where an online softmax needs 2), but O
// never leaves registers and needs no per-tile rescale. Shared memory at
// d = 512: Q 32 x 520, K and V 64 x 520 bf16, S and P tiles: 180 KB (one
// block per SM); at d = 32 a few KB. Ragged key tiles (S = 4000) are
// zero-filled and masked to -inf before the softmax; rows past S are not
// stored.
//
// What bounds it on an H100: 4*B*H*S^2*d operations (QK^T and PV) against
// 8*B*S*H*d bytes: 33 us of bf16 tensor-core time for [1, 4000, 1, 512]
// against 16 MB (5 us) of HBM, so operations. The kernel does 1.5x those
// operations, through mma.sync-class WMMA (not wgmma) with no load pipeline,
// and each block re-reads K (twice) and V from L2. wgmma, TMA and an online
// softmax with O in shared memory are later work.

#include "common.cuh"

namespace {

constexpr int SA_TQ = 32;                  // query rows per block
constexpr int SA_TK = 64;                  // keys per streamed tile
constexpr int SA_WARPS = 8;
constexpr int SA_THREADS = SA_WARPS * 32;
constexpr int SA_ROWS = SA_TQ / SA_WARPS;  // softmax rows per warp
constexpr int SA_LDS = SA_TK + 4;          // fp32 row stride of the S tile
constexpr int SA_LDP = SA_TK + 8;          // bf16 row stride of the P tile
constexpr int SA_MAX_D = 512;

struct SaLayout {
  int ld;                                  // bf16 row stride of the Q/K/V tiles
  size_t q, k, v, s, p, bytes;
};

__host__ __device__ inline SaLayout sa_layout(int d) {
  SaLayout L;
  L.ld = d + 8;
  size_t off = 0;
  L.q = off; off = align128(off + (size_t)SA_TQ * L.ld * 2);
  L.k = off; off = align128(off + (size_t)SA_TK * L.ld * 2);
  L.v = off; off = align128(off + (size_t)SA_TK * L.ld * 2);
  L.s = off; off = align128(off + (size_t)SA_TQ * SA_LDS * 4);
  L.p = off; off = align128(off + (size_t)SA_TQ * SA_LDP * 2);
  L.bytes = off;
  return L;
}

// rows [row0, row0 + rows) of one head of a [B, S, H, d] tensor into a tile;
// rows past S are zeros
__device__ __forceinline__ void sa_load(bf16* dst, int ld, const bf16* __restrict__ src, int ldg, int row0,
                                        int rows, int S, int d) {
  const int dv = d / 8;
  for (int c = threadIdx.x; c < rows * dv; c += SA_THREADS) {
    const int r = c / dv, cc = (c % dv) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(src + (size_t)row * ldg + cc);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = val;
  }
}

// S = Q K^T for the tile: 2 x 4 fragments of 16x16, one per warp
__device__ __forceinline__ void sa_scores(const bf16* Qs, const bf16* Ks, float* Ss, int ld, int d, int warp) {
  const int sr = (warp >> 2) * 16, sc = (warp & 3) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(a, Qs + sr * ld + kk, ld);
    wmma::load_matrix_sync(b, Ks + sc * ld + kk, ld);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(Ss + sr * SA_LDS + sc, acc, SA_LDS, wmma::mem_row_major);
}

// MAXF: output fragments per warp; 2 * d / 16 fragments over 8 warps
template <int MAXF>
__global__ void __launch_bounds__(SA_THREADS) self_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ out,
    int S, int H, int d, float sm_scale) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const SaLayout L = sa_layout(d);
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(dyn_smem + L.v);
  float* Ss = reinterpret_cast<float*>(dyn_smem + L.s);
  bf16* Ps = reinterpret_cast<bf16*>(dyn_smem + L.p);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * SA_TQ;
  const int ldg = H * d;
  const size_t head = (size_t)b * S * ldg + (size_t)h * d;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;

  sa_load(Qs, L.ld, qh, ldg, q0, SA_TQ, S, d);

  // pass 1: row max and sum of exp(s - max); warp w owns rows w*4 .. w*4+3,
  // lane l key columns l and l + 32 of each tile
  float m_r[SA_ROWS], l_r[SA_ROWS];
#pragma unroll
  for (int r = 0; r < SA_ROWS; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += SA_TK) {
    __syncthreads();
    sa_load(Ks, L.ld, kh, ldg, k0, SA_TK, S, d);
    __syncthreads();
    sa_scores(Qs, Ks, Ss, L.ld, d, warp);
    __syncthreads();
    const bool ok0 = k0 + lane < S, ok1 = k0 + lane + 32 < S;
#pragma unroll
    for (int r = 0; r < SA_ROWS; ++r) {
      const float* srow = Ss + (warp * SA_ROWS + r) * SA_LDS;
      const float x0 = ok0 ? srow[lane] * sm_scale : -INFINITY;
      const float x1 = ok1 ? srow[lane + 32] * sm_scale : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
      l_r[r] = l_r[r] * expf(m_r[r] - m_new) + warp_sum(expf(x0 - m_new) + expf(x1 - m_new));
      m_r[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < SA_ROWS; ++r) l_r[r] = 1.f / l_r[r];

  // pass 2: O = P V; fragment f = warp + 8 * i covers rows (f & 1) * 16 and
  // columns (f >> 1) * 16 of the [32, d] output
  const int nfrag = 2 * (d / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(o[i], 0.f);
  for (int k0 = 0; k0 < S; k0 += SA_TK) {
    __syncthreads();
    sa_load(Ks, L.ld, kh, ldg, k0, SA_TK, S, d);
    sa_load(Vs, L.ld, vh, ldg, k0, SA_TK, S, d);
    __syncthreads();
    sa_scores(Qs, Ks, Ss, L.ld, d, warp);
    __syncthreads();
    const bool ok0 = k0 + lane < S, ok1 = k0 + lane + 32 < S;
#pragma unroll
    for (int r = 0; r < SA_ROWS; ++r) {
      const int gr = warp * SA_ROWS + r;
      const float* srow = Ss + gr * SA_LDS;
      const float p0 = ok0 ? expf(srow[lane] * sm_scale - m_r[r]) * l_r[r] : 0.f;
      const float p1 = ok1 ? expf(srow[lane + 32] * sm_scale - m_r[r]) * l_r[r] : 0.f;
      Ps[gr * SA_LDP + lane] = __float2bfloat16(p0);
      Ps[gr * SA_LDP + lane + 32] = __float2bfloat16(p1);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXF; ++i) {
      const int f = warp + SA_WARPS * i;
      if (f < nfrag) {
        const int rr = (f & 1) * 16, cf = (f >> 1) * 16;
#pragma unroll
        for (int kk = 0; kk < SA_TK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
          wmma::load_matrix_sync(a, Ps + rr * SA_LDP + kk, SA_LDP);
          wmma::load_matrix_sync(bb, Vs + kk * L.ld + cf, L.ld);
          wmma::mma_sync(o[i], a, bb, o[i]);
        }
      }
    }
  }

  // the S tile is free after the last softmax: stage each fragment there
  // (16x16 fp32 per warp) and store it as bf16
  float* stage = Ss + warp * 256;
  bf16* oh = out + head;
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + SA_WARPS * i;
    if (f < nfrag) {
      const int rr = (f & 1) * 16, cf = (f >> 1) * 16;
      wmma::store_matrix_sync(stage, o[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = q0 + rr + e / 16;
        if (row < S) oh[(size_t)row * ldg + cf + e % 16] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

template <int MAXF>
int launch_self_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int S, int H, int d,
                          cudaStream_t st) {
  const SaLayout L = sa_layout(d);
  static size_t configured = 0;
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(self_attention_kernel<MAXF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  dim3 grid((S + SA_TQ - 1) / SA_TQ, H, B);
  self_attention_kernel<MAXF><<<grid, SA_THREADS, L.bytes, st>>>(q, k, v, out, S, H, d, 1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

static_assert(2 * (SA_MAX_D / 16) <= 8 * SA_WARPS, "MAXF = 8 covers d = 512");

}  // namespace

extern "C" {

// K5/K6: out = softmax(q k^T / sqrt(d)) v per (batch, head); q/k/v/out
// [B, S, H, d] bf16, d % 16 == 0, d <= 512 (checked by the wrapper).
int apk_self_attention(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int d,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 16 || d > SA_MAX_D) return (int)cudaErrorInvalidValue;
  if (d <= 128)
    return launch_self_attention<2>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, B, S, H, d, st);
  return launch_self_attention<8>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, B, S, H, d, st);
}

}  // extern "C"
