// Hopper (sm_90a) kernels of the adapter-training path: the context-projecting
// cross-attention block and the input-gradient (backward) kernels.
//
// Replaces the TPU Pallas kernels
//   K4 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention
//   K7 ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention_bwd_dx
//   K8 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_bwd
//   K9 ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff_bwd_dx
//
// The TPU kernels run their grid in order and carry dk/dv (and the adapter's
// dk_ip/dv_ip) across query tiles in VMEM scratch, finishing with the
// LayerNorm backward over the whole sequence at the last tile. Blocks on a
// GPU run in no fixed order, so each backward is a chain of launches on one
// stream, with no atomics (the results are deterministic).
//
// K7 and K9 run on the Hopper routines (hopper_gemm.cuh: TMA rings, wgmma,
// epilogues from the registers, split-K clusters; attn_bwd.cuh: the
// register-resident attention backward), seven and four launches:
//   K7 = LN rows (ln_rows_kernel) -> QKV GEMM (three weight sets, one
//        launch, as K1's) -> gattn = g . Wo (the GEMM reading Wo [K, N]
//        MN-major, bf16 store) -> the dq kernel (two sweeps over the keys:
//        the forward's statistics and D = rowsum(dO * O), then dq) -> the
//        dkv kernel (K/V in registers, a loop over the query tiles) ->
//        gxn = [dq | dk | dv] . [Wq; Wk; Wv] (one MN-major GEMM, K = 3C,
//        fp32 store: dq, dk and dv are the column blocks of one [M, 3C]
//        bf16 buffer) -> ln_bwd_kernel;
//   K9 = LN rows -> one GEMM for the three products of a 64 x 64 tile of
//        gy1 (a and gate from W1, gh = g . W2) with the GEGLU backward in
//        its epilogue (gh stays fp32 in registers, never in device memory)
//        -> gxn = gy1 . W1 (MN-major, K = 8C, fp32 store, split-K clusters
//        where the plan says) -> ln_bwd_kernel.
// Every GEMM's tile width, split-K and stages come from the wrapper's plan
// (ops/fused_block.py::k7_plan, ops/fused_ff.py::k9_plan).
//
// K4 and K8 keep the first port's routines (common.cuh's WMMA GEMM and
// streamed attention; the backward passes below): recompute the projections
// (LN + Q GEMM, the context K/V GEMMs) and gattn = g . Wo; attn_bwd_dq_kernel,
// one block per (query tile, head, batch): per key set, the row
// log-sum-exp (pass 1), D = rowsum(P * dP) (pass 2), and dq += dS . K
// (pass 3); attn_bwd_dkv_kernel, one block per (key tile, head, batch),
// looping over the query tiles for the adapter's dk_ip/dv_ip in fp32 shared
// memory; gxn = dq . Wq in fp32; ln_bwd_kernel. The softmax is the forward
// kernel's: online max-subtracted, fp32, so the recomputed probabilities are
// exp(s - lse) of the same logits. What bounds them on an H100: 64x64 WMMA
// tiles with shared-memory accumulators, every pass reloading K/V from
// device memory; the bounds and the measured times are in PERF.md. K8 can
// take attn_bwd.cuh's sweeps next, with a second key set and the T5 bias.

#include "attn_bwd.cuh"
#include "hopper_gemm.cuh"

namespace {

struct BwdSet {
  const bf16* k;      // [B, Sk, C]
  const bf16* v;
  int Sk;
  const float* bias;  // [B, Sk] additive, or null
  float gscale;       // this set's share of the output gradient (1, or ip_scale)
  float* lse;         // [B, H, Sq] row log-sum-exp of the scaled, biased logits
  float* dsum;        // [B, H, Sq] D = rowsum(P * dP)
};

struct BwdSets {
  BwdSet s[2];
  int n;
};

struct BwdLayout {
  int ldq, lds, ldo;
  size_t q, o, k, v, s, dp, p, ds, dk, dv, st, bytes;
};

// dq kernel: Q, dO, K, V tiles; S and dP (fp32); dS (bf16); the dQ
// accumulator. dkv kernel: the same tiles, P as well, and dK/dV accumulators.
__host__ __device__ inline BwdLayout bwd_layout(int d, bool dkv) {
  BwdLayout L;
  L.ldq = d + 8;
  L.lds = TK + 4;
  L.ldo = d + 4;
  size_t off = 0;
  L.q = off; off = align128(off + (size_t)TQ * L.ldq * 2);
  L.o = off; off = align128(off + (size_t)TQ * L.ldq * 2);
  L.k = off; off = align128(off + (size_t)TK * L.ldq * 2);
  L.v = off; off = align128(off + (size_t)TK * L.ldq * 2);
  L.s = off; off = align128(off + (size_t)TQ * L.lds * 4);
  L.dp = off; off = align128(off + (size_t)TQ * L.lds * 4);
  L.ds = off; off = align128(off + (size_t)TQ * LDP * 2);
  L.p = off; if (dkv) off = align128(off + (size_t)TQ * LDP * 2);
  L.dk = off; off = align128(off + (size_t)TK * L.ldo * 4);
  L.dv = off; if (dkv) off = align128(off + (size_t)TK * L.ldo * 4);
  L.st = off; off = align128(off + (size_t)2 * TQ * 4);
  L.bytes = off;
  return L;
}

// rows [row0, row0 + 64) of a [B, rows, C] bf16 matrix, head h, into a
// [64, ld] tile; rows past ``rows`` are zero
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int b, int rows, int row0,
                                          int C, int h, int d) {
  const int dv = d / 8;
  for (int c = threadIdx.x; c < 64 * dv; c += THREADS) {
    const int r = c / dv, cc = (c % dv) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) val = *reinterpret_cast<const uint4*>(src + ((size_t)b * rows + row) * C + h * d + cc);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = val;
  }
}

// out[16 x 64] (fp32, ld lds) = A[16 x d] . B[64 x d]^T, both row-major bf16 tiles
__device__ __forceinline__ void warp_abt(float* out, int lds, const bf16* A, const bf16* Bt, int ld, int d) {
  for (int j = 0; j < TK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bb;
      wmma::load_matrix_sync(a, A + kk, ld);
      wmma::load_matrix_sync(bb, Bt + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc, a, bb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, lds, wmma::mem_row_major);
  }
}

// acc[16 x d] (fp32 smem, ld ldo) += A[16 x 64] . B[64 x d]; A is row-major
// (TRANS_A false) or the transpose of a row-major [64 x 16] slice (true)
template <bool TRANS_A>
__device__ __forceinline__ void warp_acc_ab(float* acc_s, int ldo, const bf16* A, int lda, const bf16* Bm, int ldb,
                                            int d) {
  typedef typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type ALayout;
  for (int dj = 0; dj < d; dj += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, acc_s + dj, ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(a, TRANS_A ? A + kk * lda : A + kk, lda);
      wmma::load_matrix_sync(bb, Bm + kk * ldb + dj, ldb);
      wmma::mma_sync(acc, a, bb, acc);
    }
    wmma::store_matrix_sync(acc_s + dj, acc, ldo, wmma::mem_row_major);
  }
}

// dq = sm_scale * sum over sets of dS . K, with the sets' row statistics
// written for the dkv kernel. q/dO/dq are [B, Sq, C].
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ dout, int Sq, const BwdSets sets,
    bf16* __restrict__ dq, int C, int d, float sm_scale) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const BwdLayout L = bwd_layout(d, false);
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem + L.q);
  bf16* Os = reinterpret_cast<bf16*>(dyn_smem + L.o);
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(dyn_smem + L.v);
  float* Ss = reinterpret_cast<float*>(dyn_smem + L.s);
  float* Ps = reinterpret_cast<float*>(dyn_smem + L.dp);
  bf16* dSs = reinterpret_cast<bf16*>(dyn_smem + L.ds);
  float* dQ = reinterpret_cast<float*>(dyn_smem + L.dk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ, H = gridDim.y;
  load_tile(Qs, L.ldq, q, b, Sq, q0, C, h, d);
  load_tile(Os, L.ldq, dout, b, Sq, q0, C, h, d);
  for (int c = threadIdx.x; c < TQ * L.ldo; c += THREADS) dQ[c] = 0.f;

  float* Sw = Ss + warp * 16 * L.lds;
  float* Pw = Ps + warp * 16 * L.lds;
  const bf16* Qw = Qs + warp * 16 * L.ldq;
  const bf16* Ow = Os + warp * 16 * L.ldq;
  for (int si = 0; si < sets.n; ++si) {
    const BwdSet set = sets.s[si];
    const int Sk = set.Sk;
    float m_r[16], l_r[16], d_r[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m_r[r] = -INFINITY;
      l_r[r] = 0.f;
      d_r[r] = 0.f;
    }
    // pass 1: row max and sum -> lse; pass 2: D; pass 3: dq
    for (int pass = 0; pass < 3; ++pass) {
      for (int k0 = 0; k0 < Sk; k0 += TK) {
        __syncthreads();
        load_tile(Ks, L.ldq, set.k, b, Sk, k0, C, h, d);
        if (pass > 0) load_tile(Vs, L.ldq, set.v, b, Sk, k0, C, h, d);
        __syncthreads();
        warp_abt(Sw, L.lds, Qw, Ks, L.ldq, d);
        if (pass > 0) warp_abt(Pw, L.lds, Ow, Vs, L.ldq, d);
        __syncwarp();
        const int c0 = k0 + lane, c1 = k0 + lane + 32;
        float b0 = 0.f, b1 = 0.f;
        if (set.bias != nullptr) {
          if (c0 < Sk) b0 = set.bias[(size_t)b * Sk + c0];
          if (c1 < Sk) b1 = set.bias[(size_t)b * Sk + c1];
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float x0 = c0 < Sk ? Sw[r * L.lds + lane] * sm_scale + b0 : -INFINITY;
          const float x1 = c1 < Sk ? Sw[r * L.lds + lane + 32] * sm_scale + b1 : -INFINITY;
          if (pass == 0) {
            const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
            l_r[r] = l_r[r] * expf(m_r[r] - m_new) + warp_sum(expf(x0 - m_new) + expf(x1 - m_new));
            m_r[r] = m_new;
          } else {
            const float p0 = expf(x0 - m_r[r]), p1 = expf(x1 - m_r[r]);   // m_r holds the lse now
            const float dp0 = set.gscale * Pw[r * L.lds + lane];
            const float dp1 = set.gscale * Pw[r * L.lds + lane + 32];
            if (pass == 1) {
              d_r[r] += warp_sum(p0 * dp0 + p1 * dp1);
            } else {
              dSs[(warp * 16 + r) * LDP + lane] = __float2bfloat16(p0 * (dp0 - d_r[r]));
              dSs[(warp * 16 + r) * LDP + lane + 32] = __float2bfloat16(p1 * (dp1 - d_r[r]));
            }
          }
        }
        if (pass == 2) {
          __syncwarp();
          warp_acc_ab<false>(dQ + warp * 16 * L.ldo, L.ldo, dSs + warp * 16 * LDP, LDP, Ks, L.ldq, d);
        }
        __syncwarp();
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < 16; ++r) m_r[r] = m_r[r] + logf(l_r[r]);
      }
    }
    if (lane < 16) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int row = q0 + warp * 16 + r;
        if (r == lane && row < Sq) {
          set.lse[((size_t)b * H + h) * Sq + row] = m_r[r];
          set.dsum[((size_t)b * H + h) * Sq + row] = d_r[r];
        }
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * d; e += 32) {
    const int r = e / d, c = e % d, row = q0 + warp * 16 + r;
    if (row < Sq) dq[((size_t)b * Sq + row) * C + h * d + c] = __float2bfloat16(dQ[(warp * 16 + r) * L.ldo + c] * sm_scale);
  }
}

// dk = sm_scale * dS^T . Q, dv = gscale * P^T . dO for one key set, over
// every query tile, fp32 [B, Sk, C].
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ dout, int Sq, const BwdSet set,
    float* __restrict__ dk32, float* __restrict__ dv32, int C, int d, float sm_scale) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const BwdLayout L = bwd_layout(d, true);
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem + L.q);
  bf16* Os = reinterpret_cast<bf16*>(dyn_smem + L.o);
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(dyn_smem + L.v);
  float* Ss = reinterpret_cast<float*>(dyn_smem + L.s);
  float* dPs = reinterpret_cast<float*>(dyn_smem + L.dp);
  bf16* dSs = reinterpret_cast<bf16*>(dyn_smem + L.ds);
  bf16* Pb = reinterpret_cast<bf16*>(dyn_smem + L.p);
  float* dK = reinterpret_cast<float*>(dyn_smem + L.dk);
  float* dV = reinterpret_cast<float*>(dyn_smem + L.dv);
  float* lse_s = reinterpret_cast<float*>(dyn_smem + L.st);
  float* d_s = lse_s + TQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK, H = gridDim.y;
  const int Sk = set.Sk;
  load_tile(Ks, L.ldq, set.k, b, Sk, k0, C, h, d);
  load_tile(Vs, L.ldq, set.v, b, Sk, k0, C, h, d);
  for (int c = threadIdx.x; c < TK * L.ldo; c += THREADS) {
    dK[c] = 0.f;
    dV[c] = 0.f;
  }
  const int c0 = k0 + lane, c1 = k0 + lane + 32;
  float b0 = 0.f, b1 = 0.f;
  if (set.bias != nullptr) {
    if (c0 < Sk) b0 = set.bias[(size_t)b * Sk + c0];
    if (c1 < Sk) b1 = set.bias[(size_t)b * Sk + c1];
  }
  float* Sw = Ss + warp * 16 * L.lds;
  float* dPw = dPs + warp * 16 * L.lds;
  for (int q0 = 0; q0 < Sq; q0 += TQ) {
    __syncthreads();
    load_tile(Qs, L.ldq, q, b, Sq, q0, C, h, d);
    load_tile(Os, L.ldq, dout, b, Sq, q0, C, h, d);
    for (int r = threadIdx.x; r < TQ; r += THREADS) {
      const int row = q0 + r;
      lse_s[r] = row < Sq ? set.lse[((size_t)b * H + h) * Sq + row] : INFINITY;
      d_s[r] = row < Sq ? set.dsum[((size_t)b * H + h) * Sq + row] : 0.f;
    }
    __syncthreads();
    // this warp's 16 query rows against the block's 64 keys
    warp_abt(Sw, L.lds, Qs + warp * 16 * L.ldq, Ks, L.ldq, d);
    warp_abt(dPw, L.lds, Os + warp * 16 * L.ldq, Vs, L.ldq, d);
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int gr = warp * 16 + r;
      const float lse = lse_s[gr], dsum = d_s[gr];
      const float p0 = c0 < Sk ? expf(Sw[r * L.lds + lane] * sm_scale + b0 - lse) : 0.f;
      const float p1 = c1 < Sk ? expf(Sw[r * L.lds + lane + 32] * sm_scale + b1 - lse) : 0.f;
      const float dp0 = set.gscale * dPw[r * L.lds + lane], dp1 = set.gscale * dPw[r * L.lds + lane + 32];
      Pb[gr * LDP + lane] = __float2bfloat16(p0);
      Pb[gr * LDP + lane + 32] = __float2bfloat16(p1);
      dSs[gr * LDP + lane] = __float2bfloat16(p0 * (dp0 - dsum));
      dSs[gr * LDP + lane + 32] = __float2bfloat16(p1 * (dp1 - dsum));
    }
    __syncthreads();
    // this warp's 16 keys: dV += P^T dO, dK += dS^T Q
    warp_acc_ab<true>(dV + warp * 16 * L.ldo, L.ldo, Pb + warp * 16, LDP, Os, L.ldq, d);
    warp_acc_ab<true>(dK + warp * 16 * L.ldo, L.ldo, dSs + warp * 16, LDP, Qs, L.ldq, d);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TK * d; e += THREADS) {
    const int r = e / d, c = e % d, key = k0 + r;
    if (key >= Sk) continue;
    const size_t off = ((size_t)b * Sk + key) * C + h * d + c;
    dk32[off] = dK[r * L.ldo + c] * sm_scale;
    dv32[off] = dV[r * L.ldo + c] * set.gscale;
  }
}

// dx = rstd * (gn - mean(gn) - nhat * mean(gn * nhat)) + g with gn = gxn * ln_w:
// the LayerNorm backward and the residual path, one warp per row.
__global__ void __launch_bounds__(THREADS) ln_bwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gxn, const bf16* __restrict__ ln_w,
    const bf16* __restrict__ g, bf16* __restrict__ dx, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * C;
  const float* gr = gxn + (size_t)row * C;
  float s = 0.f;
  for (int k = lane; k < C; k += 32) s += __bfloat162float(xr[k]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float dd = __bfloat162float(xr[k]) - mean;
    v += dd * dd;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float gn = gr[k] * __bfloat162float(ln_w[k]);
    s1 += gn;
    s2 += gn * (__bfloat162float(xr[k]) - mean) * rstd;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int k = lane; k < C; k += 32) {
    const float nhat = (__bfloat162float(xr[k]) - mean) * rstd;
    const float gn = gr[k] * __bfloat162float(ln_w[k]);
    dx[(size_t)row * C + k] =
        __float2bfloat16(rstd * (gn - m1 - nhat * m2) + __bfloat162float(g[(size_t)row * C + k]));
  }
}

int set_smem(const void* fn, size_t bytes, size_t* configured) {
  if (bytes > *configured) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    *configured = bytes;
  }
  return 0;
}

int launch_attn_bwd(const bf16* q, const bf16* dout, int Sq, const BwdSets& sets, bf16* dq, int dkv_set,
                    float* dk32, float* dv32, int B, int C, int heads, cudaStream_t st) {
  static size_t dq_configured = 0, dkv_configured = 0;
  const int d = C / heads;
  const float scale = 1.f / sqrtf((float)d);
  const BwdLayout Lq = bwd_layout(d, false), Lk = bwd_layout(d, true);
  int e = set_smem((const void*)attn_bwd_dq_kernel, Lq.bytes, &dq_configured);
  if (e) return e;
  attn_bwd_dq_kernel<<<dim3((Sq + TQ - 1) / TQ, heads, B), THREADS, Lq.bytes, st>>>(q, dout, Sq, sets, dq, C, d,
                                                                                     scale);
  e = (int)cudaGetLastError();
  if (e || dkv_set < 0) return e;
  e = set_smem((const void*)attn_bwd_dkv_kernel, Lk.bytes, &dkv_configured);
  if (e) return e;
  const BwdSet& s = sets.s[dkv_set];
  attn_bwd_dkv_kernel<<<dim3((s.Sk + TK - 1) / TK, heads, B), THREADS, Lk.bytes, st>>>(
      q, dout, Sq, s, dk32, dv32, C, d, scale);
  return (int)cudaGetLastError();
}

int launch_ln_bwd(const void* x, const void* gxn, const void* ln_w, const void* g, void* dx, int M, int C,
                  float eps, cudaStream_t st) {
  const int rows = THREADS / 32;
  ln_bwd_kernel<<<(M + rows - 1) / rows, THREADS, 0, st>>>((const bf16*)x, (const float*)gxn, (const bf16*)ln_w,
                                                           (const bf16*)g, (bf16*)dx, M, C, eps);
  return (int)cudaGetLastError();
}

// out = A . W, W [K, N] (a Linear weight [out = K, in = N] used backwards)
template <int EPI>
int launch_gemm_wt(const void* A, int M, int K, const void* W, int N, void* out, cudaStream_t st) {
  GemmArgs a = gemm_args(A, M, K, N);
  a.w[0] = (const bf16*)W;
  a.c[0] = out;
  return launch_gemm<false, true, EPI>(a, 1, st);
}

int launch_ln_proj(const void* x, int M, int C, const void* ln_w, const void* ln_b, float eps, const void* w,
                   void* out, cudaStream_t st) {
  GemmArgs a = gemm_args(x, M, C, C);
  a.ln_w = (const bf16*)ln_w;
  a.ln_b = (const bf16*)ln_b;
  a.eps = eps;
  a.w[0] = (const bf16*)w;
  a.c[0] = out;
  return launch_gemm<true, false, EPI_STORE>(a, 1, st);
}

}  // namespace

extern "C" {

// K4: out = x + Wo . [softmax(q k^T + bias) v + s * softmax(q ki^T) vi] + bo with
// q = LN(x) Wq, k/v = ctx[:, :sk_text] Wk/Wv^T and ki/vi = ctx[:, sk_text:] Wki/Wvi^T
// projected here (wki/wvi null: no adapter branch, the whole context is text).
// ctx [B, Sk_total, Dc]; bias [B, sk_text] fp32 or null; q/attn [B, S, C],
// k/v [B, sk_text, C] and ki/vi [B, Sk_total - sk_text, C] are scratch.
int apk_fused_ln_cross_attention(const void* x, const void* ctx, int Sk_total, int Dc, int sk_text,
                                 const void* ln_w, const void* ln_b, const void* wq, const void* wk,
                                 const void* wv, const void* wki, const void* wvi, const void* wo, const void* bo,
                                 float ip_scale, const void* bias, void* q, void* k, void* v, void* ki, void* vi,
                                 void* attn, void* out, int B, int S, int C, int heads, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  int e = launch_ctx_proj(ctx, B, Sk_total, Dc, 0, sk_text, wk, wv, k, v, C, st);
  if (e) return e;
  if (sk_ip > 0) {
    e = launch_ctx_proj(ctx, B, Sk_total, Dc, sk_text, sk_ip, wki, wvi, ki, vi, C, st);
    if (e) return e;
  }
  e = launch_ln_proj(x, M, C, ln_w, ln_b, eps, wq, q, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, sk_text, (const float*)bias,
                       sk_ip > 0 ? (const bf16*)ki : nullptr, sk_ip > 0 ? (const bf16*)vi : nullptr, sk_ip,
                       ip_scale, (bf16*)attn, B, C, heads, head_scale(C, heads), st);
  if (e) return e;
  GemmArgs o = gemm_args(attn, M, C, C);
  o.w[0] = (const bf16*)wo;
  o.c[0] = out;
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_gemm<false, false, EPI_BIAS_RESID>(o, 1, st);
}

// K7: dx of K1 for the output gradient g [B, S, C]. scratch holds 8 x [B, S,
// C] bf16 (LN(x), q, k, v, gattn, then [dq | dk | dv] as [B, S, 3C]); stats
// 2 x [B, heads, S] fp32 (the rows' lse2 and D) then gxn [B, S, C] fp32.
// (qkv_*), (go_*) and (gx_*) plan the QKV, g . Wo and gxn GEMMs: tile width,
// split-K and ring stages.
int apk_fused_ln_self_attention_bwd_dx(const void* x, const void* g, const void* ln_w, const void* ln_b,
                                       const void* wq, const void* wk, const void* wv, const void* wo, void* scratch,
                                       void* stats, void* dx, int B, int S, int C, int heads, float eps, int qkv_bn,
                                       int qkv_split, int qkv_stages, int go_bn, int go_split, int go_stages,
                                       int gx_bn, int gx_split, int gx_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16 *q = xn + mc, *k = q + mc, *v = k + mc, *gattn = v + mc, *dqkv = gattn + mc;
  float* lse2 = static_cast<float*>(stats);
  float* dsum = lse2 + (size_t)B * heads * S;
  float* gxn = dsum + (size_t)B * heads * S;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs qkv = {};
  const void* wqkv[3] = {wq, wk, wv};
  qkv.c[0] = q; qkv.c[1] = k; qkv.c[2] = v;
  e = launch_hgemm(qkv, xn, wqkv, 3, M, C, C, qkv_bn, qkv_split, qkv_stages, HG_STORE, st);
  if (e) return e;
  HgArgs go = {};
  go.c[0] = gattn;
  e = launch_hgemm_kn(go, g, &wo, 1, M, C, C, go_bn, go_split, go_stages, HG_STORE, st);
  if (e) return e;
  const FaKeys keys = {k, v, nullptr, S, AB_T};
  e = launch_reg_attn_bwd(q, gattn, keys, B, S, heads, C / heads, dqkv, 3 * C, dqkv + C, dqkv + 2 * C, 3 * C, lse2,
                          dsum, st);
  if (e) return e;
  HgArgs gx = {};
  gx.cf = gxn;
  e = launch_hgemm_kn(gx, dqkv, wqkv, 3, M, C, 3 * C, gx_bn, gx_split, gx_stages, HG_STORE_F32, st);
  if (e) return e;
  return launch_ln_bwd(x, gxn, ln_w, g, dx, M, C, eps, st);
}

// K8: dx of K4, and (adapter sites) dki/dvi [B, Sk_ip, C] fp32, the gradients
// of the adapter's projected K/V per context position. Scratch as K4's plus
// gattn/dq [B, S, C] bf16, lse/dsum [2, B, heads, S] fp32, gxn [B, S, C] fp32.
int apk_fused_ln_cross_attention_bwd(const void* x, const void* g, const void* ctx, int Sk_total, int Dc,
                                     int sk_text, const void* ln_w, const void* ln_b, const void* wq,
                                     const void* wk, const void* wv, const void* wki, const void* wvi,
                                     const void* wo, float ip_scale, const void* bias, void* q, void* k, void* v,
                                     void* ki, void* vi, void* gattn, void* dq, void* lse, void* dsum, void* gxn,
                                     void* dx, void* dki, void* dvi, int B, int S, int C, int heads, float eps,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  int e = launch_ctx_proj(ctx, B, Sk_total, Dc, 0, sk_text, wk, wv, k, v, C, st);
  if (e) return e;
  if (sk_ip > 0) {
    e = launch_ctx_proj(ctx, B, Sk_total, Dc, sk_text, sk_ip, wki, wvi, ki, vi, C, st);
    if (e) return e;
  }
  e = launch_ln_proj(x, M, C, ln_w, ln_b, eps, wq, q, st);
  if (e) return e;
  e = launch_gemm_wt<EPI_STORE>(g, M, C, wo, C, gattn, st);
  if (e) return e;
  const size_t stat = (size_t)B * heads * S;
  BwdSets sets = {};
  sets.n = sk_ip > 0 ? 2 : 1;
  sets.s[0] = {(const bf16*)k, (const bf16*)v, sk_text, (const float*)bias, 1.f, (float*)lse, (float*)dsum};
  sets.s[1] = {(const bf16*)ki, (const bf16*)vi, sk_ip, nullptr, ip_scale, (float*)lse + stat,
               (float*)dsum + stat};
  e = launch_attn_bwd((const bf16*)q, (const bf16*)gattn, S, sets, (bf16*)dq, sk_ip > 0 ? 1 : -1, (float*)dki,
                      (float*)dvi, B, C, heads, st);
  if (e) return e;
  e = launch_gemm_wt<EPI_STORE_F32>(dq, M, C, wq, C, gxn, st);
  if (e) return e;
  return launch_ln_bwd(x, gxn, ln_w, g, dx, M, C, eps, st);
}

// K9: dx of K3. gy1 = [gh * gelu(gate) | gh * a * gelu'(gate)] with gh = g . W2
// and [a | gate] = LN(x) W1^T + b1, one GEMM a 64 x 64 tile of each half
// (bf16 [M, 2 inner]); gxn = gy1 . W1 (fp32 [M, C]); then the LayerNorm
// backward. scratch holds LN(x) [B, S, C] and gy1 [B, S, 2 inner] bf16; gxn
// is fp32 scratch. (gy_split, gy_stages) plan the three-product GEMM
// (64-wide tiles), (gx_bn, gx_split, gx_stages) the gxn GEMM.
int apk_fused_ln_geglu_ff_bwd_dx(const void* x, const void* g, const void* ln_w, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, void* scratch, void* gxn, void* dx,
                                 int B, int S, int C, int inner, float eps, int gy_split, int gy_stages, int gx_bn,
                                 int gx_split, int gx_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16* gy1 = xn + (size_t)M * C;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  e = launch_hgemm_geglu_bwd(xn, g, w1, b1, w2, gy1, M, inner, C, gy_split, gy_stages, st);
  if (e) return e;
  HgArgs gx = {};
  gx.cf = static_cast<float*>(gxn);
  e = launch_hgemm_kn(gx, gy1, &w1, 1, M, C, 2 * inner, gx_bn, gx_split, gx_stages, HG_STORE_F32, st);
  if (e) return e;
  return launch_ln_bwd(x, gxn, ln_w, g, dx, M, C, eps, st);
}

}  // extern "C"
