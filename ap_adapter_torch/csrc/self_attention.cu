// Hopper (sm_90a) kernel for unmasked self-attention over long sequences,
// out = softmax(q k^T / sqrt(d)) v with q/k/v/out [B, S, H, d] bf16.
//
// Replaces both TPU Pallas kernels of this function:
//   K5 ap_adapter_tpu/ops/pallas_packed_attention.py::packed_self_attention
//      (heads packed into the 128 lanes when d divides 128)
//   K6 ap_adapter_tpu/ops/pallas_self_attention.py::pallas_self_attention
//      (any d, the whole K/V of a head resident in VMEM)
// The head packing and the K/V residency answer the TPU's lane width and
// VMEM. On Hopper the entry point routes by head dim: d % 16 == 0 and
// d <= 128 goes to the streamed online-softmax routine below (the first
// port's attention, 64x64 WMMA tiles with K/V streamed through shared
// memory, kept for this route alone); d % 64 == 0 with 128 < d <= 512 goes
// to wgmma_attention_kernel below. The
// path that reaches it is the VAE mid-block attention (one head, d = 512,
// S = 4000 at edit time and 4096 in training); the smoke also holds the
// entry point at the UNet's d = 32 and 80.
//
// What bounds it on an H100: 4*B*H*S^2*d operations (QK^T and PV) against
// 8*B*S*H*d bytes: 33 us of bf16 tensor-core time for [1, 4000, 1, 512]
// against 16 MB (5 us) of HBM, so operations. The first version of this
// kernel lost to that in four ways; what this design does about each:
//   1. Two passes (a stats pass, then a PV pass) computed QK^T twice. Here
//      one pass with an online max-subtracted fp32 softmax: each key tile's
//      logits are computed once, O is rescaled by exp(m_old - m_new).
//   2. K was read twice and V once per 32-row query tile. Here a block owns
//      64 query rows, Q stays resident in shared memory, and each K/V tile
//      is read once per block: half the L2 traffic of 32-row tiles, a third
//      of the two-pass kernel's.
//   3. WMMA 16x16x16 with both fragments reloaded from shared memory, no
//      load pipeline. Here both products are wgmma: QK^T as m64n32k16 with
//      Q and K from shared memory, PV as m64n64k16 with P from registers
//      (the logits' accumulator layout is the A operand's, FA3's trick) and
//      V from shared memory, transposed. K/V tiles arrive by TMA (128-byte
//      swizzle) into a ring of two stages, signalled by mbarriers: the
//      first thread issues each tile's loads one tile ahead, right after
//      the barrier that already orders the two warpgroups (so the stage it
//      refills is free). No separate producer warp: with one, ptxas holds
//      every thread to the launch bound's 168 registers, setmaxnreg or not,
//      spills, and serializes the wgmmas for want of registers (ptxas
//      C7512); with 256 threads the d = 512 kernel takes 255 registers and
//      spills nothing.
//   4. 5% of the bf16 peak. Two consumer warpgroups split the work: each
//      owns the 64-column blocks b = w, w + 2, ... of d, for the partial
//      logits (QK^T over its blocks of d) and for O (its blocks of the
//      output columns, up to 4 x 32 fp32 registers a thread). The partial
//      logits are exchanged through shared memory in the accumulator's own
//      register order (double-buffered, one named barrier a tile), so both
//      warpgroups hold the full 64 x 32 logits and compute the same softmax.
//      Where B*H*ceil(S/64) is under the SM count (the edit's 63 tiles), a
//      2-CTA cluster splits the keys and rank 1's O, max and sum are
//      combined into rank 0's in fp32 by log-sum-exp through distributed
//      shared memory: one launch either way.
// Shared memory at d = 512: Q 64 KB, 2 stages x (K + V) of 32 keys 128 KB,
// the logit exchange 32 KB: 224 KB of the 227 KB. P is rounded to bf16
// before PV (unnormalised; the plain version rounds the normalised P): the
// tolerance is a fraction of max|plain|. Ragged key tiles are zero-filled by
// TMA and masked to -inf; rows past S are not stored.

#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <mma.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

// -- the streamed route (d <= 128): WMMA tiles, K/V streamed through shared memory --

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

// -- the wgmma route (128 < d <= 512) --


constexpr int WA_TQ = 64;                 // query rows per block
constexpr int WA_TK = 32;                 // keys per pipelined tile
constexpr int WA_CONSUMERS = 256;         // two warpgroups
constexpr int WA_THREADS = WA_CONSUMERS;
constexpr int WA_STAGES = 2;
// the cluster of a launch: none, or two CTAs of one query tile splitting its
// key tiles (ops/self_attention.py::CLUSTER_MODES)
enum WaMode { WA_ALONE = 0, WA_SPLIT_KEYS = 1 };
constexpr int WA_QBLK = WA_TQ * 128;      // bytes of one 64-column block of the Q tile
constexpr int WA_KBLK = WA_TK * 128;      // bytes of one 64-column block of a K or V tile
constexpr int WA_XCHG = 2 * 2 * 16 * 128 * 4;   // parity x warpgroup x 16 logits x 128 threads, fp32
constexpr int WA_SPLIT_XCHG = (128 + 4) * WA_CONSUMERS * 4;   // rank 1's O, max and sum, after the loop

struct WaLayout {
  int q, k[WA_STAGES], v[WA_STAGES], x, bar, bytes;
};

__host__ __device__ inline WaLayout wa_layout(int d) {
  const int nb = d / 64;
  WaLayout L;
  int off = 0;
  L.q = off; off += nb * WA_QBLK;
  for (int s = 0; s < WA_STAGES; ++s) {
    L.k[s] = off; off += nb * WA_KBLK;
    L.v[s] = off; off += nb * WA_KBLK;
  }
  L.x = off; off += WA_XCHG;
  if (off < WA_SPLIT_XCHG) off = WA_SPLIT_XCHG;
  L.bar = off; off += 8 * 8;
  L.bytes = off + 1024;                    // slack to align the base to 1024 (128-byte swizzle atoms)
  return L;
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// the TMA loads of this CTA's key tile it (of [t0, t1)) into stage it & 1,
// issued by one thread; the stage's barrier counts their bytes
__device__ __forceinline__ void load_kv_tile(uint32_t base, const WaLayout& L, const CUtensorMap* map_k,
                                             const CUtensorMap* map_v, int nb, int it, int t0, int col0, int b) {
  const int st = it & 1;
  const uint32_t full = base + L.bar + 8 * st;
  mbar_expect_tx(full, (uint32_t)(2 * nb * WA_KBLK));
  const int k0 = (t0 + it) * WA_TK;
  for (int blk = 0; blk < nb; ++blk) {
    tma_load_3d(base + L.k[st] + blk * WA_KBLK, map_k, col0 + blk * 64, k0, b, full);
    tma_load_3d(base + L.v[st] + blk * WA_KBLK, map_v, col0 + blk * 64, k0, b, full);
  }
}

// the two warpgroups of wgmma_attention_kernel: online softmax over the
// key tiles [t0, t1), then the cluster's combine (WA_SPLIT_KEYS), then the
// bf16 store
template <int NB>
__device__ __forceinline__ void consume(unsigned char* smem, uint32_t base, const WaLayout& L, const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, bf16* __restrict__ out, int S, int H, int d,
                                        int mode, int rank, int t0, int t1, int b, int q0, int col0,
                                        float scale_log2) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = NB > 0 ? NB : d / 64;
  const uint32_t bar_full = base + L.bar, bar_q = bar_full + 16;
  float o[4][32];                          // O: this warpgroup's 64-column blocks 2i + w
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int w = warp >> 2;                 // consumer warpgroup (warps 0-7)
  const int ct = tid & 127;
  const int quad = lane & 3;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // this thread's rows r0 and r0 + 8 of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[i][e] = 0.f;
  float* xs = reinterpret_cast<float*>(smem + L.x);
  mbar_wait(bar_q, 0);
  for (int it = 0; it < t1 - t0; ++it) {
    const int st = it & 1;
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    // the tiles' shared addresses, opaque to the compiler so that it forms
    // each descriptor next to its wgmma instead of holding them all in
    // registers across the loop
    uint32_t qa = base + L.q, ka = base + L.k[st], va = base + L.v[st];
    asm volatile("" : "+r"(qa), "+r"(ka), "+r"(va));

    // partial logits over this warpgroup's blocks of d: 64 x 32 fp32
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) reg_fence(s[e]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int blk = 2 * i + w;
      if (NB > 0 || blk < nb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(s, sw128_desc(qa + blk * WA_QBLK + kk * 32, 16, 1024),
                       sw128_desc(ka + blk * WA_KBLK + kk * 32, 16, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int e = 0; e < 16; ++e) reg_fence(s[e]);

    // exchange the partial logits (the same register order in both warpgroups)
    float* mine = xs + ((it & 1) * 2 + w) * 16 * 128;
    const float* theirs = xs + ((it & 1) * 2 + (1 - w)) * 16 * 128;
#pragma unroll
    for (int e = 0; e < 16; ++e) mine[e * 128 + ct] = s[e];
    consumers_sync();
    // every thread is past tile it - 1 now: refill its stage with tile it + 1
    if (tid == 0 && it >= 1 && it + 1 < t1 - t0) load_kv_tile(base, L, map_k, map_v, nb, it + 1, t0, col0, b);
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] += theirs[e * 128 + ct];

    // online softmax in the log2 domain; keys past S masked
    const int kb = (t0 + it) * WA_TK + 2 * quad;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (kb + 8 * j + (e & 1) >= S) x = -INFINITY;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[4 * j] = exp2f(s[4 * j] - m0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    uint32_t pa[2][4];
#pragma unroll
    for (int js = 0; js < 2; ++js) {
      pa[js][0] = pack_bf16(s[8 * js], s[8 * js + 1]);
      pa[js][1] = pack_bf16(s[8 * js + 2], s[8 * js + 3]);
      pa[js][2] = pack_bf16(s[8 * js + 4], s[8 * js + 5]);
      pa[js][3] = pack_bf16(s[8 * js + 6], s[8 * js + 7]);
    }

    // O = O * corr + P V over this warpgroup's column blocks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[i][4 * j] *= c0;
        o[i][4 * j + 1] *= c0;
        o[i][4 * j + 2] *= c1;
        o[i][4 * j + 3] *= c1;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(o[i][e]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int blk = 2 * i + w;
      if (NB > 0 || blk < nb) {
#pragma unroll
        for (int js = 0; js < 2; ++js)
          wgmma_rs_n64_tb(o[i], pa[js], sw128_desc(va + blk * WA_KBLK + js * 16 * 128, WA_KBLK, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(o[i][e]);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  if (mode == WA_SPLIT_KEYS) {
    // rank 1 hands its O, max and sum to rank 0 through distributed shared
    // memory (its Q and K/V stages are free now); rank 0 combines them
    cg::cluster_group cluster = cg::this_cluster();
    float* xo = reinterpret_cast<float*>(smem);              // [128 registers][256 consumer threads]
    float* xml = xo + 128 * WA_CONSUMERS;                   // [256 consumer threads][4]
    if (rank == 1) {
      consumers_sync();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 32; ++e) xo[(i * 32 + e) * WA_CONSUMERS + tid] = o[i][e];
      *reinterpret_cast<float4*>(xml + 4 * tid) = make_float4(m0, m1, l0, l1);
    }
    cluster.sync();
    if (rank == 0) {
      const float* ro = cluster.map_shared_rank(xo, 1);
      const float4 rml = *reinterpret_cast<const float4*>(cluster.map_shared_rank(xml, 1) + 4 * tid);
      const float n0 = fmaxf(m0, rml.x), n1 = fmaxf(m1, rml.y);
      const float a0 = exp2f(m0 - n0), b0 = exp2f(rml.x - n0);
      const float a1 = exp2f(m1 - n1), b1 = exp2f(rml.y - n1);
      l0 = l0 * a0 + rml.z * b0;
      l1 = l1 * a1 + rml.w * b1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (NB > 0 || 2 * i + w < nb) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = 4 * j;
            o[i][e] = o[i][e] * a0 + ro[(i * 32 + e) * WA_CONSUMERS + tid] * b0;
            o[i][e + 1] = o[i][e + 1] * a0 + ro[(i * 32 + e + 1) * WA_CONSUMERS + tid] * b0;
            o[i][e + 2] = o[i][e + 2] * a1 + ro[(i * 32 + e + 2) * WA_CONSUMERS + tid] * b1;
            o[i][e + 3] = o[i][e + 3] * a1 + ro[(i * 32 + e + 3) * WA_CONSUMERS + tid] * b1;
          }
        }
      }
    }
    cluster.sync();                       // rank 1's shared memory stays until rank 0 has read it
    if (rank != 0) return;
  }
  // O / l, rounded once to bf16
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int ldg = H * d;
  const int row0 = q0 + r0, row1 = row0 + 8;
  bf16* ob = out + (size_t)b * S * ldg + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int blk = 2 * i + w;
    if (NB > 0 || blk < nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = blk * 64 + 8 * j + 2 * quad;
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * ldg + col) = pack_bf16(o[i][4 * j] * inv0, o[i][4 * j + 1] * inv0);
        if (row1 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * ldg + col) =
              pack_bf16(o[i][4 * j + 2] * inv1, o[i][4 * j + 3] * inv1);
      }
    }
  }
}

// grid (ceil(S / 64), H, B), WA_THREADS threads; with WA_SPLIT_KEYS twice
// the query tiles in x and clusters of (2, 1, 1).
// d = 64 * nb, 3 <= nb <= 8; NB = nb where it is known at compile time (8:
// no branch around a wgmma, which would serialize them), else 0. Thread
// t: warpgroup w = t / 128; thread 0 also issues every TMA load.
template <int NB>
__global__ void __launch_bounds__(WA_THREADS, 1) wgmma_attention_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int S, int H, int d, int mode,
    float scale_log2) {
  extern __shared__ unsigned char wa_smem_raw[];
  const uint32_t raw = smem_u32(wa_smem_raw);
  unsigned char* smem = wa_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int nb = NB > 0 ? NB : d / 64;
  const WaLayout L = wa_layout(d);
  const uint32_t bar_full = base + L.bar, bar_q = bar_full + 16;

  const int tid = threadIdx.x;
  const int rank = mode != WA_ALONE ? (int)(blockIdx.x & 1) : 0;
  const int qt = mode == WA_SPLIT_KEYS ? blockIdx.x >> 1 : blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * WA_TQ, col0 = h * d;
  const int ntiles = (S + WA_TK - 1) / WA_TK;
  const int per = mode == WA_SPLIT_KEYS ? (ntiles + 1) / 2 : ntiles;
  const int t0 = mode == WA_SPLIT_KEYS ? rank * per : 0, t1 = min(ntiles, t0 + per);

  if (tid == 0) {
    for (int s = 0; s < WA_STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q once, and the first two key tiles (the ring starts empty)
    mbar_expect_tx(bar_q, (uint32_t)(nb * WA_QBLK));
    for (int blk = 0; blk < nb; ++blk) tma_load_3d(base + L.q + blk * WA_QBLK, &map_q, col0 + blk * 64, q0, b, bar_q);
    for (int it = 0; it < WA_STAGES && it < t1 - t0; ++it) load_kv_tile(base, L, &map_k, &map_v, nb, it, t0, col0, b);
  }
  __syncthreads();
  consume<NB>(smem, base, L, &map_k, &map_v, out, S, H, d, mode, rank, t0, t1, b, q0, col0, scale_log2);
}

// the [B, S, H*d] bf16 tensor as {column, row, batch}; boxes of 64 columns x rows, 128-byte swizzle
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int d, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)H * d, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * d * 2, (cuuint64_t)S * H * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_wgmma_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int S, int H, int d,
                           int mode, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, B, S, H, d, WA_TQ);
  if (!e) e = make_map(&mk, k, B, S, H, d, WA_TK);
  if (!e) e = make_map(&mv, v, B, S, H, d, WA_TK);
  if (e) return e;
  const WaLayout L = wa_layout(d);
  auto kernel = d == 512 ? wgmma_attention_kernel<8> : wgmma_attention_kernel<0>;
  static int configured[2] = {0, 0};
  int& done = configured[d == 512];
  if (L.bytes > done) {
    cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (r != cudaSuccess) return (int)r;
    done = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  const int nq = (S + WA_TQ - 1) / WA_TQ;
  cfg.gridDim = dim3((unsigned)(mode == WA_SPLIT_KEYS ? 2 * nq : nq), (unsigned)H, (unsigned)B);
  cfg.blockDim = dim3(WA_THREADS);
  cfg.dynamicSmemBytes = (size_t)L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = mode == WA_ALONE ? 1u : 2u;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  cudaError_t r = cudaLaunchKernelEx(&cfg, kernel, mq, mk, mv, out, S, H, d, mode, scale_log2);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5/K6: out = softmax(q k^T / sqrt(d)) v per (batch, head); q/k/v/out
// [B, S, H, d] bf16. d % 16 == 0 and d <= 128: the streamed routine
// (mode must be 0); d % 64 == 0 and 128 < d <= 512: the wgmma kernel, its
// 2-CTA cluster as mode says (WaMode). Anything else is refused.
int apk_self_attention(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int d, int mode,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 16 == 0 && d <= 128 && mode == WA_ALONE)
    return launch_attention<bf16>((const bf16*)q, S, (const bf16*)k, (const bf16*)v, S, nullptr, nullptr, nullptr, 0,
                                  0.f, (bf16*)out, B, H * d, H, 1.f / sqrtf((float)d), st);
  if (d % 64 == 0 && d > 128 && d <= 512 && (mode == WA_ALONE || mode == WA_SPLIT_KEYS))
    return launch_wgmma_attention((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, B, S, H, d, mode, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
