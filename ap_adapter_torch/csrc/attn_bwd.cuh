// The register-resident attention backward of K7 and K8
// (reg_attn_bwd_dq_kernel<D, CROSS> and reg_attn_bwd_dkv_kernel<D, OutT>),
// built from the forward's pieces in reg_attention.cuh: mma.sync m16n8k16 with ldmatrix (ldmatrix.trans for a
// product's B taken along the keys or queries), cp.async double buffers,
// the online exp2-domain softmax. For dO = the gradient of the attention
// output, P = softmax(Q K^T * scale), dP = dO V^T and dS = P * (dP - D):
//   dq = scale * dS K, dk = scale * dS^T Q, dv = P^T dO.
//
// reg_attn_bwd_dq_kernel: one CTA a tile of 64 query rows of one (batch, head),
// one warp 16 rows; Q's and dO's fragments are loaded once into registers,
// and the keys are swept twice through one double buffer:
//   * sweep 1 is the forward (reg_attention.cuh's fa_tile, unchanged): the
//     online max and sum and the fp32 output O in registers. At its end
//     lse2 = m + log2(l) (the log-sum-exp in the scaled log2 domain) and
//     D = rowsum(dO * O). D equals rowsum(P * dP), since
//     sum_j P_ij sum_c dO_ic V_jc = sum_c dO_ic O_ic; O stays fp32 for it.
//     The TPU kernel sums the other side, dP against the bf16-rounded
//     normalised P (pallas_fused_block.py:696-698); the two differ by the
//     rounding of P (bf16 before PV here, after normalising there), far
//     inside the backward's tolerance. This replaces the first port's two
//     sweeps for the statistics (one for lse, one for D), so the keys are
//     swept twice, not three times.
//   * sweep 2, a key tile at a time: S = Q K^T and dP = dO V^T (V read as
//     the forward reads K), P = exp2(S * scale * log2e - lse2) rounded to
//     bf16 (the TPU kernel's rounding of P), dS = P * (dP - D) rounded to
//     bf16, and dq += dS K with K through ldmatrix.trans. S, P, dP and dS
//     never leave the registers: the accumulator layout of S and dP is the
//     A-operand layout of dS, as P's is in the forward.
//   It writes dq * scale (bf16, the TPU kernel's rounding before the Wq
//   product) and each row's lse2 and D (fp32) for the dkv kernel.
// reg_attn_bwd_dkv_kernel: one CTA 64 keys of one (batch, head), one warp 16
// keys, whose K and V fragments stay in registers; it loops over the query
// tiles, whose Q, dO, lse2 and D arrive by cp.async into a double buffer:
//   S^T = K Q^T, P^T from lse2, dV += P^T dO; dP^T = V dO^T, dS^T, dK += dS^T Q.
//   dK and dV are fp32 accumulators in registers, stored once, as bf16 for
//   K7 (the TPU kernel casts them before the Wk/Wv products, :716-724) and
//   as fp32 for K8's adapter keys. No atomics:
//   each key's sums belong to one warp, so the result is the same on every
//   run.
// Ragged S: keys past the set are zero-filled and masked (P = 0) in the dq
// kernel; their dk/dv rows are not stored. Query rows past S arrive as
// zeros (Q, dO, lse2 and D): their S^T is 0 and P^T = exp2(0) = 1, finite,
// and both their dP^T (dO = 0) and their Q row are zero, so they add
// nothing to dK or dV; their dq and statistics are not stored.
//
// Key sets (K8, CROSS): the dq kernel takes the forward's two sets (FaKeys),
// the text keys with their fp32 T5 bias (added before the maximum, as
// fa_tile's BIAS path adds it, in both sweeps) and the adapter keys, whose
// output gradient is bf16(ip_scale * dO) (pallas_fused_cross.py:487: the TPU
// kernel rounds it so). It runs sweep 1 for both sets, then sweep 2 for
// both: each set's sweep 1 yields that set's lse2 and D = rowsum(dO_set *
// O_set) and frees O's registers before the next set, and sweep 2
// accumulates dq over both sets. Interleaving the sets instead would keep
// set 1's dq accumulators live across set 2's sweep 1, beside O's, which
// spills at d = 80. 64-key tiles for both sets; keys past a set are masked.
// dq is stored once, bf16(dq * scale), the TPU kernel's rounding before
// the Wq product (:496-497). The dkv kernel then runs over the adapter set
// alone (the text set never needs dk/dv) from the bf16(ip_scale * dO) that
// the dq kernel stores, and keeps dk/dv in fp32 (OutT = float): the
// adapter weight gradients take them.
// Why mma.sync and not wgmma: the head dims of the training path are 32,
// 48 and 80, no whole 128-byte swizzle row (reg_attention.cuh's header).

#pragma once

#include "reg_attention.cuh"

namespace {

constexpr int AB_T = 64;            // query rows of a dq CTA, keys of a dkv CTA, and the tiles each sweeps

// shared memory: dq kernel: Q, dO, 2 stages of K and V; dkv kernel: K, V,
// 2 stages of Q and dO, and 2 stages of 64 lse2 and 64 D
__host__ __device__ inline int ab_dq_smem_bytes(int d) { return 6 * AB_T * (d + 8) * 2; }
__host__ __device__ inline int ab_dkv_smem_bytes(int d) { return 6 * AB_T * (d + 8) * 2 + 4 * AB_T * 4; }

// 4-byte cp.async (zero-filled when !valid)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + 64) of one head's D columns of a [*, rows, ld] bf16 matrix
// (`base` at the batch entry's row 0, column h * D) into a [64, D + 8] tile
// at `dst`; rows at or past `rows` zero-filled
template <int D>
__device__ __forceinline__ void ab_load_rows(uint32_t dst, const bf16* base, int ld, int r0, int rows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < AB_T * CH; c += FA_THREADS) {
    const int r = c / CH, cc = c % CH, row = r0 + r;
    cp_async16(dst + (r * LD + cc * 8) * 2, base + (size_t)(row < rows ? row : 0) * ld + cc * 8, row < rows);
  }
}

// The A fragments of a warp's 16 rows of a [64, D + 8] tile.
template <int D>
__device__ __forceinline__ void ab_frags(uint32_t (&f)[D / 16][4], uint32_t tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(f[kk], tile + ((16 * warp + (lane & 15)) * (D + 8) + kk * 16 + (lane >> 4) * 8) * 2);
}

// acc[8][4] (+)= A (16 x D, fragments a) . B^T for the 64 rows of B, a
// [64, D + 8] tile (rows as the product's columns: Q K^T, dO V^T, K Q^T, V dO^T)
template <int D>
__device__ __forceinline__ void ab_abt(float (&acc)[8][4], const uint32_t (&a)[D / 16][4], uint32_t bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t b[4];
      ldsm_x4(b, bt + ((kp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma16816(acc[2 * kp], a[kk], b[0], b[1]);
      mma16816(acc[2 * kp + 1], a[kk], b[2], b[3]);
    }
}

// acc[D / 8][4] += A (16 x 64, the accumulator-layout values x, rounded to
// bf16) . B for B a [64, D + 8] tile taken along its rows (dS K, P^T dO, dS^T Q)
template <int D>
__device__ __forceinline__ void ab_ab(float (&acc)[D / 8][4], const float (&x)[8][4], uint32_t bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    const uint32_t pa[4] = {pack_bf16(x[2 * kp][0], x[2 * kp][1]), pack_bf16(x[2 * kp][2], x[2 * kp][3]),
                            pack_bf16(x[2 * kp + 1][0], x[2 * kp + 1][1]),
                            pack_bf16(x[2 * kp + 1][2], x[2 * kp + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_t(b, bt + ((kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 + (lane >> 4) * 8) * 2);
      mma16816(acc[2 * dn], pa, b[0], b[1]);
      mma16816(acc[2 * dn + 1], pa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// bf16 pair v times s, rounded to bf16 again
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s, f.y * s);
}

// dq of 64 query rows: grid (ceil(S / 64), H, B), FA_THREADS threads.
// q/dout [B, S, C]; key set 1's K/V [B, n1, C] and, under CROSS, set 2's
// [B, n2, C] (n2 = 0: no second set); dq [B, S, ld_dq] at column h * D;
// set i's lse2/D at lse2_out/dsum_out + i * B * H * S ([B, H, S] each).
// CROSS (K8): set 1 may carry its fp32 key bias [B, n1] (s1.bias), and set
// 2's output gradient is bf16(ip_scale * dO), which the kernel also stores
// into dout_ip [B, S, C] for the dkv kernel. The tiles run as one sequence
// through the double buffer: sweep 1 over set 1's tiles, then set 2's;
// sweep 2 over set 1's, then set 2's.
template <int D, bool CROSS>
__global__ void __launch_bounds__(FA_THREADS) reg_attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ dout, const FaKeys s1, const FaKeys s2, float ip_scale,
    int S, int C, float scale_log2, float scale, bf16* __restrict__ dq, int ld_dq, float* __restrict__ lse2_out,
    float* __restrict__ dsum_out, bf16* __restrict__ dout_ip) {
  constexpr int LD = D + 8, NT = D / 8, TILE = AB_T * LD * 2, NSETS = CROSS ? 2 : 1;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, q0 = blockIdx.x * AB_T;
  const uint32_t qs = smem_u32(ab_smem), dos = qs + TILE, ks = dos + TILE, vs = ks + 2 * TILE;
  const size_t base = (size_t)b * S * C + (size_t)h * D;
  const int n1 = s1.n, n2 = CROSS ? s2.n : 0;
  const int nt1 = (n1 + AB_T - 1) / AB_T, nt2 = (n2 + AB_T - 1) / AB_T, nsweep = nt1 + nt2;
  const float* bias = CROSS && s1.bias != nullptr ? s1.bias + (size_t)b * n1 : nullptr;

  ab_load_rows<D>(qs, q + base, C, q0, S);
  ab_load_rows<D>(dos, dout + base, C, q0, S);
  auto load_kv = [&](int it) {        // tile it of the sequence into stage it % 2
    const int r = it < nsweep ? it : it - nsweep;
    const bool second = CROSS && r >= nt1;
    const int n = second ? n2 : n1, k0 = (second ? r - nt1 : r) * AB_T;
    const size_t kvbase = (size_t)b * n * C + (size_t)h * D;
    ab_load_rows<D>(ks + (it & 1) * TILE, (second ? s2.k : s1.k) + kvbase, C, k0, n);
    ab_load_rows<D>(vs + (it & 1) * TILE, (second ? s2.v : s1.v) + kvbase, C, k0, n);
    cp_async_commit();
  };
  load_kv(0);                         // Q and dO ride in the first group

  uint32_t qf[D / 16][4], df[D / 16][4];
  float o[NT][4];
  float m[2], l[2];
  auto arrive = [&](int it) {         // tile it has landed (and tile it + 1 is in flight)
    if (it + 1 < 2 * nsweep) {
      load_kv(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  // sweep 1, a set at a time: the forward's online softmax and output, then
  // the set's lse2 and D = rowsum(dO * O / l) of rows 16 warp + lane / 4 and
  // + 8 (O's registers are free again before the next set)
  float lse2[NSETS][2], dsum[NSETS][2];
  int it = 0;
#pragma unroll
  for (int set = 0; set < NSETS; ++set) {
    const int n = set ? n2 : n1, nt = set ? nt2 : nt1;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    for (int t = 0; t < nt; ++t, ++it) {
      arrive(it);
      if (it == 0) {
        ab_frags<D>(qf, qs, warp, lane);
        ab_frags<D>(df, dos, warp, lane);
      }
      const uint32_t kt = ks + (it & 1) * TILE, vt = vs + (it & 1) * TILE;
      if (CROSS && set == 0 && bias != nullptr)
        fa_tile<D, AB_T / 8, true>(qf, o, m, l, kt, vt, t * AB_T, n, bias, scale_log2, lane);
      else
        fa_tile<D, AB_T / 8, false>(qf, o, m, l, kt, vt, t * AB_T, n, nullptr, scale_log2, lane);
      __syncthreads();                // the stage is refilled by the next iteration's load
    }
    const bf16* drow = reinterpret_cast<const bf16*>(ab_smem) + AB_T * LD + (16 * warp + (lane >> 2)) * LD + 2 * quad;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + 8 * t));
      float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + 8 * LD + 8 * t));
      if (CROSS && set == 1) {        // set 2's dO: bf16(ip_scale * dO)
        g0 = make_float2(round_bf16(g0.x * ip_scale), round_bf16(g0.y * ip_scale));
        g1 = make_float2(round_bf16(g1.x * ip_scale), round_bf16(g1.y * ip_scale));
      }
      d0 += o[t][0] * g0.x + o[t][1] * g0.y;
      d1 += o[t][2] * g1.x + o[t][3] * g1.y;
    }
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    lse2[set][0] = m[0] + log2f(l0);
    lse2[set][1] = m[1] + log2f(l1);
    dsum[set][0] = quad_sum(d0) / l0;
    dsum[set][1] = quad_sum(d1) / l1;
  }

  // sweep 2, a set at a time: dS and dq, a key tile at a time
  float dqa[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[t][e] = 0.f;
#pragma unroll
  for (int set = 0; set < NSETS; ++set) {
    const int n = set ? n2 : n1, nt = set ? nt2 : nt1;
    const bool biased = CROSS && set == 0 && bias != nullptr;
    if (CROSS && set == 1) {          // set 2's dO fragments: bf16(ip_scale * dO)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) df[kk][j] = scale_bf16x2(df[kk][j], ip_scale);
    }
    for (int t = 0; t < nt; ++t, ++it) {
      arrive(it);
      const uint32_t kt = ks + (it & 1) * TILE, vt = vs + (it & 1) * TILE;
      const int k0 = t * AB_T;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      ab_abt<D>(s, qf, kt, lane);
      ab_abt<D>(dp, df, vt, lane);
      const bool edge = k0 + AB_T > n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float bl[2] = {0.f, 0.f};     // the bias in the log2 domain, as fa_tile adds it; -inf past the set
        if (CROSS && biased) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * quad + c;
            bl[c] = key < n ? __ldg(bias + key) * FA_LOG2E : -INFINITY;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = CROSS && biased ? fmaf(s[j][e], scale_log2, bl[e & 1]) - lse2[set][e >> 1]
                                          : fmaf(s[j][e], scale_log2, -lse2[set][e >> 1]);
          float p = round_bf16(fast_exp2(x));
          if (edge && k0 + 8 * j + 2 * quad + (e & 1) >= n) p = 0.f;
          s[j][e] = p * (dp[j][e] - dsum[set][e >> 1]);          // dS
        }
      }
      ab_ab<D>(dqa, s, kt, lane);
      __syncthreads();
    }
  }

  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  if (quad == 0) {
    const size_t st = ((size_t)b * H + h) * S, set_stride = (size_t)gridDim.z * H * S;
#pragma unroll
    for (int set = 0; set < NSETS; ++set) {
      if (set == 1 && n2 == 0) break;
      if (row0 < S) {
        lse2_out[set * set_stride + st + row0] = lse2[set][0];
        dsum_out[set * set_stride + st + row0] = dsum[set][0];
      }
      if (row1 < S) {
        lse2_out[set * set_stride + st + row1] = lse2[set][1];
        dsum_out[set * set_stride + st + row1] = dsum[set][1];
      }
    }
  }
  bf16* ob = dq + (size_t)b * S * ld_dq + (size_t)h * D;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * quad;
    if (row0 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * ld_dq + col) = pack_bf16(dqa[t][0] * scale, dqa[t][1] * scale);
    if (row1 < S) *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * ld_dq + col) = pack_bf16(dqa[t][2] * scale, dqa[t][3] * scale);
  }
  if (CROSS && n2 > 0) {              // set 2's dO for the dkv kernel, from the resident dO tile
    const bf16* dsm = reinterpret_cast<const bf16*>(ab_smem) + AB_T * LD;
    for (int c = tid; c < AB_T * (D / 2); c += FA_THREADS) {
      const int r = c / (D / 2), cc = 2 * (c % (D / 2)), row = q0 + r;
      if (row < S)
        *reinterpret_cast<uint32_t*>(dout_ip + base + (size_t)row * C + cc) =
            scale_bf16x2(*reinterpret_cast<const uint32_t*>(dsm + r * LD + cc), ip_scale);
    }
  }
}

// dk and dv of 64 keys: grid (ceil(n / 64), H, B), FA_THREADS threads.
// q/dout [B, S, C]; the key set's K/V [B, n, C]; lse2/dsum [B, H, S] from
// the dq kernel; dk/dv [B, n, ld_kv] at column h * D, stored as OutT: bf16
// (K7, the TPU kernel's cast before the Wk/Wv products) or fp32 (K8's
// adapter dk/dv, which the adapter weight gradients take).
template <int D, typename OutT>
__global__ void __launch_bounds__(FA_THREADS) reg_attn_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ dout, const FaKeys keys, int S, int C,
    const float* __restrict__ lse2_in, const float* __restrict__ dsum_in, float scale_log2, float scale,
    OutT* __restrict__ dk, OutT* __restrict__ dv, int ld_kv) {
  constexpr int LD = D + 8, NT = D / 8, TILE = AB_T * LD * 2;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, k0 = blockIdx.x * AB_T, n = keys.n;
  const uint32_t kss = smem_u32(ab_smem), vss = kss + TILE, qs = vss + TILE, dos = qs + 2 * TILE;
  const uint32_t stats = dos + 2 * TILE;                 // [2 stages][lse2 64 | D 64] fp32
  const float* stat_f = reinterpret_cast<const float*>(ab_smem + (stats - kss));
  const size_t base = (size_t)b * S * C + (size_t)h * D;
  const size_t kvbase = (size_t)b * n * C + (size_t)h * D;
  const size_t st_base = ((size_t)b * H + h) * S;
  const int nq = (S + AB_T - 1) / AB_T;

  ab_load_rows<D>(kss, keys.k + kvbase, C, k0, n);
  ab_load_rows<D>(vss, keys.v + kvbase, C, k0, n);
  auto load_q = [&](int it) {         // query tile it into stage it % 2
    const int q0 = it * AB_T, stg = it & 1;
    ab_load_rows<D>(qs + stg * TILE, q + base, C, q0, S);
    ab_load_rows<D>(dos + stg * TILE, dout + base, C, q0, S);
    for (int r = tid; r < AB_T; r += FA_THREADS) {
      const int row = q0 + r;
      const size_t off = st_base + (row < S ? row : 0);
      cp_async4(stats + (stg * 2 * AB_T + r) * 4, lse2_in + off, row < S);
      cp_async4(stats + (stg * 2 * AB_T + AB_T + r) * 4, dsum_in + off, row < S);
    }
    cp_async_commit();
  };
  load_q(0);                          // K and V ride in the first group

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) {
      load_q(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      ab_frags<D>(kf, kss, warp, lane);
      ab_frags<D>(vf, vss, warp, lane);
    }
    const uint32_t qt = qs + (it & 1) * TILE, dt = dos + (it & 1) * TILE;
    const float* lse_t = stat_f + (it & 1) * 2 * AB_T;
    const float* d_t = lse_t + AB_T;
    float x[8][4];                    // S^T, then P^T (16 keys x 64 queries)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[t][e] = 0.f;
    ab_abt<D>(x, kf, qt, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * t + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[t][e] = round_bf16(fast_exp2(fmaf(x[t][e], scale_log2, -((e & 1) ? l2.y : l2.x))));
    }
    ab_ab<D>(dva, x, dt, lane);       // dV += P^T dO
    float dp[8][4];                   // dP^T, then dS^T
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[t][e] = 0.f;
    ab_abt<D>(dp, vf, dt, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 dd = *reinterpret_cast<const float2*>(d_t + 8 * t + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[t][e] = x[t][e] * (dp[t][e] - ((e & 1) ? dd.y : dd.x));
    }
    ab_ab<D>(dka, dp, qt, lane);      // dK += dS^T Q
    __syncthreads();                  // the stage is refilled by the next iteration's load
  }

  const int key0 = k0 + 16 * warp + (lane >> 2), key1 = key0 + 8;
  const size_t ob = (size_t)b * n * ld_kv + (size_t)h * D;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * quad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key1 : key0;
      if (key >= n) continue;
      const float k0v = dka[t][2 * half] * scale, k1v = dka[t][2 * half + 1] * scale;
      const size_t off = ob + (size_t)key * ld_kv + col;
      if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float2*>(dk + off) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(dv + off) = make_float2(dva[t][2 * half], dva[t][2 * half + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[t][2 * half], dva[t][2 * half + 1]);
      }
    }
  }
}

template <int D, bool CROSS>
int launch_ab_dq(const bf16* q, const bf16* dout, const FaKeys& s1, const FaKeys& s2, float ip_scale, int B, int S,
                 int H, bf16* dq, int ld_dq, float* lse2, float* dsum, bf16* dout_ip, cudaStream_t st) {
  const int smem = ab_dq_smem_bytes(D);
  static int configured = 0;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(reg_attn_bwd_dq_kernel<D, CROSS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = 1;
  }
  const float scale = 1.f / sqrtf((float)D), scale_log2 = scale * FA_LOG2E;
  reg_attn_bwd_dq_kernel<D, CROSS><<<dim3((S + AB_T - 1) / AB_T, H, B), FA_THREADS, smem, st>>>(
      q, dout, s1, s2, ip_scale, S, H * D, scale_log2, scale, dq, ld_dq, lse2, dsum, dout_ip);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int launch_ab_dkv(const bf16* q, const bf16* dout, const FaKeys& keys, int B, int S, int H, const float* lse2,
                  const float* dsum, OutT* dk, OutT* dv, int ld_kv, cudaStream_t st) {
  const int smem = ab_dkv_smem_bytes(D);
  static int configured = 0;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(reg_attn_bwd_dkv_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = 1;
  }
  const float scale = 1.f / sqrtf((float)D), scale_log2 = scale * FA_LOG2E;
  reg_attn_bwd_dkv_kernel<D, OutT><<<dim3((keys.n + AB_T - 1) / AB_T, H, B), FA_THREADS, smem, st>>>(
      q, dout, keys, S, H * D, lse2, dsum, scale_log2, scale, dk, dv, ld_kv);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, d>) for a head dim the kernels take (16-128 in steps of 16)
template <typename Fn>
int ab_dispatch(int d, Fn&& fn) {
  switch (d) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 48: return fn(std::integral_constant<int, 48>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 80: return fn(std::integral_constant<int, 80>());
    case 96: return fn(std::integral_constant<int, 96>());
    case 112: return fn(std::integral_constant<int, 112>());
    case 128: return fn(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7: dq, dk, dv of softmax(q k^T d^-1/2) v for the output gradient dout:
// q/dout [B, S, H * d], the key set's k/v [B, n, H * d] (64-key tiles, no
// bias); dq into [B, S, ld_dq], dk and dv into [B, n, ld_kv] (bf16), the
// rows' lse2 and D into lse2/dsum [B, H, S] (fp32 scratch). Two launches on st.
int launch_reg_attn_bwd(const bf16* q, const bf16* dout, const FaKeys& keys, int B, int S, int H, int d, bf16* dq,
                        int ld_dq, bf16* dk, bf16* dv, int ld_kv, float* lse2, float* dsum, cudaStream_t st) {
  if (S < 1 || keys.n < 1 || keys.bias != nullptr || keys.tk != AB_T) return (int)cudaErrorInvalidValue;
  const FaKeys none = {nullptr, nullptr, nullptr, 0, AB_T};
  return ab_dispatch(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    int e = launch_ab_dq<D, false>(q, dout, keys, none, 0.f, B, S, H, dq, ld_dq, lse2, dsum, nullptr, st);
    if (e) return e;
    return launch_ab_dkv<D, bf16>(q, dout, keys, B, S, H, lse2, dsum, dk, dv, ld_kv, st);
  });
}

// K8: dq of softmax(q k^T d^-1/2 + bias) v + ip_scale * softmax(q ki^T d^-1/2) vi
// for the output gradient dout (the text set with its fp32 bias, or none;
// the adapter set, n = 0: none), stored as bf16(dq * d^-1/2) into [B, S, H * d];
// each set's lse2 and D into lse2/dsum [2, B, H, S]; then, with an adapter
// set, its dk/dv [B, n_ip, H * d] in fp32 from its output gradient
// bf16(ip_scale * dout), which the dq kernel leaves in dout_ip [B, S, H * d].
// One launch, or two with an adapter set, on st.
int launch_reg_attn_bwd_cross(const bf16* q, const bf16* dout, const FaKeys& text, const FaKeys& adapter,
                              float ip_scale, int B, int S, int H, int d, bf16* dq, float* lse2, float* dsum,
                              bf16* dout_ip, float* dk, float* dv, cudaStream_t st) {
  if (S < 1 || text.n < 1 || adapter.n < 0 || text.tk != AB_T || adapter.tk != AB_T || adapter.bias != nullptr ||
      (adapter.n > 0 && !(adapter.k && adapter.v && dout_ip && dk && dv)))
    return (int)cudaErrorInvalidValue;
  return ab_dispatch(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const int C = H * D;
    int e = launch_ab_dq<D, true>(q, dout, text, adapter, ip_scale, B, S, H, dq, C, lse2, dsum, dout_ip, st);
    if (e || adapter.n == 0) return e;
    const size_t set = (size_t)B * H * S;
    return launch_ab_dkv<D, float>(q, dout_ip, adapter, B, S, H, lse2 + set, dsum + set, dk, dv, C, st);
  });
}

}  // namespace
