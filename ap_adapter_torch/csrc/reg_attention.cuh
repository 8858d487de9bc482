// The register-resident attention of K1, K2, K10, K11b and K11c
// (reg_attention_kernel<D, BIAS, ONE_SET, OutT>): one CTA a tile of 64
// query rows of one (batch, head), one warp 16 rows; Q's fragments are loaded
// once into registers; K/V tiles arrive by cp.async into a double buffer,
// the next one in flight while the current one is used. QK^T and PV run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulation) with ldmatrix
// (ldmatrix.trans for V); the logits, the probabilities and the output
// accumulator stay in registers (the logits' accumulator layout is P's
// A-operand layout, so P never leaves them), with an online max-subtracted
// fp32 softmax in the exp2 domain; P is rounded to bf16 before PV
// (unnormalised), O / l once at the end of a key set. The softmax folds the
// scale into one FFMA a logit, takes ex2.approx and masks only a set's last
// tile: the exponentials and their bookkeeping, not the products, take most
// of a tile's time at d = 32.
// Two key sets in one pass (K2's text and adapter keys, K10's text and
// audio keys): the first set's tiles, then the second's, one sequence for
// the double buffer, so the second set's first tile loads while the first
// set's last one computes. Each set has its own running max and sum; the
// first set's output is normalised into fp32 registers at its end, and the
// CTA stores O_1 / l_1 + s * O_2 / l_2 once as bf16 (the rounding of the
// JAX kernels). A set's key tile is 16, 32 or 64 keys (the wrapper's
// key_tile): at d = 32 a tile's time is its exponentials, and a 64-key tile
// over GPT-2's 8 keys would spend eight times the exponentials they need.
// The first set may carry an fp32 additive key bias (the T5 padding bias):
// bias * log2(e) enters the same FFMA as the scale, before the maximum, and
// masks the keys past the set in that step. A CTA is 4 warps (64 query
// rows) at every shape: at the edit's shapes CTAs of 1 or 2 warps were
// slower for K1, and splitting a query tile's keys over a 2-CTA cluster
// saved 5% at S = 1000 and nothing at S = 252, not worth the cluster. Why
// mma.sync and not wgmma: the head dims are 16-128 in steps of 16 (32, 48
// and 80 on the edit path), so one head's row is not a whole 128-byte
// swizzle row: a 64-column TMA box would carry the next head's columns for
// d = 48 and 80, and the products are the smaller part of a tile's time at
// these head dims, so wgmma's higher peak would buy little. cp.async copies
// exactly d columns in 16-byte chunks into rows padded by 16 bytes
// (ldmatrix without bank conflicts). Keys past a set are zero-filled and
// masked to -inf; query rows past S are not stored.
// The store is bf16 (K1, K2, K10) or fp32 (OutT = float: K11b and K11c,
// whose int8 out projections quantize the attention output from fp32, as
// the TPU kernels do, pallas_int8.py:239-244); the softmax scale is
// 1/sqrt(d), or the caller's (K11b's and K11c's q arrive pre-scaled: 1).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int FA_TK = 64;           // keys a shared-memory stage holds: the widest key tile
constexpr int FA_THREADS = 128;     // 4 warps, 16 query rows each
constexpr int FA_TQ = 64;           // query rows per CTA
constexpr float FA_LOG2E = 1.4426950408889634f;

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

// a key tile width the kernel takes (the wrapper's key_tile)
inline bool fa_tile_ok(int tk) { return tk == 16 || tk == 32 || tk == 64; }

// shared memory of reg_attention_kernel<d>: Q, then 2 stages of K and V
__host__ __device__ inline int fa_smem_bytes(int d) { return (FA_TQ + 4 * FA_TK) * (d + 8) * 2; }

// ex2.approx: the exponent of the softmax, with the rounding of the logits'
// bf16 products already far above its error
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key set of the attention: K/V [B, n, C] (row stride C, a head's
// columns at h * D), n keys (0: no such set) in tiles of tk (16, 32 or 64),
// and an fp32 additive key bias [B, n] or null (the first set only).
struct FaKeys {
  const bf16* k;
  const bf16* v;
  const float* bias;
  int n, tk;
};

// One key tile, 8 * NK keys from k0, against a warp's 16 query rows (qf):
// S = Q K^T in registers, the online softmax of the warp's rows r and r + 8
// (m = the running max in the scaled log2 domain, l = the running sum),
// O += P V with P from the logits' registers and V by ldmatrix.trans. Keys
// at or past n exist only in a set's last tile, the only one that masks;
// under BIAS every logit takes fmaf(s, scale_log2, bias * log2(e)) before
// the maximum, a key past n a bias of -inf.
template <int D, int NK, bool BIAS>
__device__ __forceinline__ void fa_tile(const uint32_t (&qf)[D / 16][4], float (&o)[D / 8][4], float (&m)[2],
                                        float (&l)[2], uint32_t kt, uint32_t vt, int k0, int n,
                                        const float* __restrict__ bias, float scale_log2, int lane) {
  constexpr int LD = D + 8;           // bf16 row stride in shared memory
  constexpr int NT = D / 8;           // n8 tiles of O
  const int quad = lane & 3;
  const int kb = k0 + 2 * quad;       // the key of element e of n8 tile t: kb + 8 t + (e & 1)
  float bl[NK][2];
  if (BIAS) {
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kb + 8 * t + j;
        bl[t][j] = key < n ? __ldg(bias + key) * FA_LOG2E : -INFINITY;
      }
  }

  float s[NK][4];
#pragma unroll
  for (int t = 0; t < NK; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int kp = 0; kp < NK / 2; ++kp) {
      uint32_t bk[4];
      ldsm_x4(bk, kt + ((kp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma16816(s[2 * kp], qf[kk], bk[0], bk[1]);
      mma16816(s[2 * kp + 1], qf[kk], bk[2], bk[3]);
    }

  if (BIAS) {
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = fmaf(s[t][e], scale_log2, bl[t][e & 1]);
  } else if (k0 + 8 * NK > n) {
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kb + 8 * t + (e & 1) >= n) s[t][e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
    mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
  }
  // BIAS: the logits are already scaled; else the scale folds into the exponent's FFMA
  const float mn0 = fmaxf(m[0], BIAS ? quad_max(mx0) : quad_max(mx0) * scale_log2);
  const float mn1 = fmaxf(m[1], BIAS ? quad_max(mx1) : quad_max(mx1) * scale_log2);
  const float c0 = fast_exp2(m[0] - mn0), c1 = fast_exp2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mr = e < 2 ? mn0 : mn1;
      s[t][e] = fast_exp2(BIAS ? s[t][e] - mr : fmaf(s[t][e], scale_log2, -mr));
    }
    ps0 += s[t][0] + s[t][1];
    ps1 += s[t][2] + s[t][3];
  }
  l[0] = l[0] * c0 + ps0;
  l[1] = l[1] * c1 + ps1;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    o[t][0] *= c0;
    o[t][1] *= c0;
    o[t][2] *= c1;
    o[t][3] *= c1;
  }

#pragma unroll
  for (int kp = 0; kp < NK / 2; ++kp) {
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
}

// fa_tile at a tile width of tk keys (uniform across the CTA)
template <int D, bool BIAS>
__device__ __forceinline__ void fa_tile_tk(int tk, const uint32_t (&qf)[D / 16][4], float (&o)[D / 8][4],
                                           float (&m)[2], float (&l)[2], uint32_t kt, uint32_t vt, int k0, int n,
                                           const float* __restrict__ bias, float scale_log2, int lane) {
  if (tk == 64)
    fa_tile<D, 8, BIAS>(qf, o, m, l, kt, vt, k0, n, bias, scale_log2, lane);
  else if (tk == 32)
    fa_tile<D, 4, BIAS>(qf, o, m, l, kt, vt, k0, n, bias, scale_log2, lane);
  else
    fa_tile<D, 2, BIAS>(qf, o, m, l, kt, vt, k0, n, bias, scale_log2, lane);
}

// out[b, i, h*D:(h+1)*D] = softmax(q_i k1^T D^-1/2 + bias) v1
//                          (+ ip_scale * softmax(q_i k2^T D^-1/2) v2 where set 2 has keys)
// over q/out [B, S, C]; BIAS: set 1 carries its bias; ONE_SET: set 1 alone,
// in 64-key tiles, the tile width and the set bound at compile time (K1's
// attention: choosing them at run time cost it 8% at S = 1000 on an H100).
// Grid (ceil(S / FA_TQ), H, B), FA_THREADS threads; the tiles of set 1, then
// those of set 2, run through one double buffer.
template <int D, bool BIAS, bool ONE_SET, typename OutT>
__global__ void __launch_bounds__(FA_THREADS) reg_attention_kernel(const bf16* __restrict__ q, const FaKeys s1,
                                                                  const FaKeys s2, float ip_scale,
                                                                  OutT* __restrict__ out, int S, int C,
                                                                  float scale_log2) {
  constexpr int LD = D + 8;           // bf16 row stride in shared memory
  constexpr int CH = D / 8;           // 16-byte chunks of a row
  constexpr int NT = D / 8;           // n8 tiles of O
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_TQ;
  const uint32_t qs = smem_u32(fa_smem);
  const uint32_t ks = qs + FA_TQ * LD * 2, vs = ks + 2 * FA_TK * LD * 2;
  const size_t base = (size_t)b * S * C + (size_t)h * D;
  const size_t kvbase1 = (size_t)b * s1.n * C + (size_t)h * D;
  const size_t kvbase2 = ONE_SET ? 0 : (size_t)b * s2.n * C + (size_t)h * D;
  const int tk1 = ONE_SET ? FA_TK : s1.tk;
  const int nt1 = (s1.n + tk1 - 1) / tk1;
  const int ntiles = ONE_SET ? nt1 : nt1 + (s2.n + s2.tk - 1) / s2.tk;

  for (int c = tid; c < FA_TQ * CH; c += FA_THREADS) {
    const int r = c / CH, cc = c % CH, row = q0 + r;
    cp_async16(qs + (r * LD + cc * 8) * 2, q + base + (size_t)(row < S ? row : 0) * C + cc * 8, row < S);
  }
  auto load_kv = [&](int it) {        // tile it of the sequence into stage it % 2
    const bool second = !ONE_SET && it >= nt1;
    const bf16* kp = second ? s2.k : s1.k;
    const bf16* vp = second ? s2.v : s1.v;
    const int n = second ? s2.n : s1.n, tk = second ? s2.tk : tk1;
    const int k0 = (second ? it - nt1 : it) * tk, st = it & 1;
    const size_t kvbase = second ? kvbase2 : kvbase1;
    for (int c = tid; c < tk * CH; c += FA_THREADS) {
      const int r = c / CH, cc = c % CH, row = k0 + r;
      const size_t off = kvbase + (size_t)(row < n ? row : 0) * C + cc * 8;
      const uint32_t so = ((st * FA_TK + r) * LD + cc * 8) * 2;
      cp_async16(ks + so, kp + off, row < n);
      cp_async16(vs + so, vp + off, row < n);
    }
    cp_async_commit();
  };
  load_kv(0);                         // Q rides in the first group

  uint32_t qf[D / 16][4];
  float o[NT][4], o1[NT][4];          // o1: set 1's normalised output, once set 1 is done
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto close_set1 = [&]() {           // set 1 is done: its normalised output into o1, set 2 starts afresh
    const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o1[t][0] = o[t][0] * inv0;
      o1[t][1] = o[t][1] * inv0;
      o1[t][2] = o[t][2] * inv1;
      o1[t][3] = o[t][3] * inv1;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  };

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
    const bool first = it < nt1;
    const int tk = first ? tk1 : s2.tk, k0 = (first ? it : it - nt1) * tk;
    if (ONE_SET)
      fa_tile<D, FA_TK / 8, false>(qf, o, m, l, kt, vt, k0, s1.n, nullptr, scale_log2, lane);
    else if (BIAS && first)
      fa_tile_tk<D, true>(tk, qf, o, m, l, kt, vt, k0, s1.n, s1.bias + (size_t)b * s1.n, scale_log2, lane);
    else
      fa_tile_tk<D, false>(tk, qf, o, m, l, kt, vt, k0, first ? s1.n : s2.n, nullptr, scale_log2, lane);
    __syncthreads();                  // the stage is refilled by the next iteration's load
    if (!ONE_SET && it == nt1 - 1) close_set1();
  }
  if (ONE_SET) {
    close_set1();
  } else if (ntiles > nt1) {          // out = O_1 / l_1 + s * O_2 / l_2 in fp32
    const float inv0 = ip_scale / quad_sum(l[0]), inv1 = ip_scale / quad_sum(l[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o1[t][0] += o[t][0] * inv0;
      o1[t][1] += o[t][1] * inv0;
      o1[t][2] += o[t][2] * inv1;
      o1[t][3] += o[t][3] * inv1;
    }
  }

  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  OutT* ob = out + base;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * (lane & 3);
    if constexpr (std::is_same<OutT, float>::value) {
      if (row0 < S) *reinterpret_cast<float2*>(ob + (size_t)row0 * C + col) = make_float2(o1[t][0], o1[t][1]);
      if (row1 < S) *reinterpret_cast<float2*>(ob + (size_t)row1 * C + col) = make_float2(o1[t][2], o1[t][3]);
    } else {
      if (row0 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * C + col) = pack_bf16(o1[t][0], o1[t][1]);
      if (row1 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * C + col) = pack_bf16(o1[t][2], o1[t][3]);
    }
  }
}

template <int D, bool BIAS, bool ONE_SET, typename OutT>
int launch_reg_attention_t(const bf16* q, const FaKeys& s1, const FaKeys& s2, float ip_scale, OutT* out, int B, int S,
                           int H, float scale_log2, cudaStream_t st) {
  const int smem = fa_smem_bytes(D);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(reg_attention_kernel<D, BIAS, ONE_SET, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  dim3 grid((S + FA_TQ - 1) / FA_TQ, H, B);
  reg_attention_kernel<D, BIAS, ONE_SET, OutT><<<grid, FA_THREADS, smem, st>>>(q, s1, s2, ip_scale, out, S, H * D,
                                                                               scale_log2);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int launch_reg_attention_d(const bf16* q, const FaKeys& s1, const FaKeys& s2, float ip_scale, OutT* out, int B, int S,
                           int H, float scale_log2, cudaStream_t st) {
  if (s1.bias) return launch_reg_attention_t<D, true, false>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
  if (s2.n == 0 && s1.tk == FA_TK)
    return launch_reg_attention_t<D, false, true>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
  return launch_reg_attention_t<D, false, false>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
}

// softmax(q k1^T * scale + bias) v1 (+ ip_scale * softmax(q k2^T * scale) v2)
// into out; q/out [B, S, H * d]; scale_log2 = scale * log2(e); set 1 needs a
// key, set 2 may have none. The variant follows the key sets: set 1's bias,
// set 1 alone in 64-key tiles (the compile-time path), or two sets. Each TU
// instantiates only the store type it launches.
template <typename OutT>
int launch_reg_attention(const bf16* q, const FaKeys& s1, const FaKeys& s2, float ip_scale, OutT* out, int B, int S,
                         int H, int d, float scale_log2, cudaStream_t st) {
  if (S < 1 || s1.n < 1 || s2.n < 0 || !fa_tile_ok(s1.tk) || !fa_tile_ok(s2.tk) || (s2.n > 0 && !(s2.k && s2.v)))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_reg_attention_d<16>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 32: return launch_reg_attention_d<32>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 48: return launch_reg_attention_d<48>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 64: return launch_reg_attention_d<64>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 80: return launch_reg_attention_d<80>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 96: return launch_reg_attention_d<96>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 112: return launch_reg_attention_d<112>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    case 128: return launch_reg_attention_d<128>(q, s1, s2, ip_scale, out, B, S, H, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
