// Hopper (sm_90a) kernels for the UNet's resnet sites:
//   K12 GroupNorm(+SiLU), replaces
//       ap_adapter_tpu/ops/pallas_groupnorm.py::fused_group_norm
//   K13 the whole ResnetBlock2D, GN+SiLU -> conv3x3 -> +temb -> GN+SiLU ->
//       conv3x3 -> +shortcut, replaces
//       ap_adapter_tpu/ops/pallas_resnet.py::fused_resnet_block
//
// Layout. The port's UNet tensors are NCHW in shape, but channels-last in
// memory: the NHWC latent is permuted to NCHW at the UNet's entry and every
// conv, cat, resize and residual add keeps that memory format. So both
// kernels read and write [B, H*W, C] rows (channels contiguous), the JAX
// kernels' own layout, and the wrappers take these tensors as they are: no
// transpose, where an NCHW-contiguous kernel would cost a copy of x in and of
// the output back (2 * B*H*W*C bytes each way) per call.
//
// GroupNorm statistics (both ops). A block takes a chunk of positions of one
// sample, all channels: each thread owns 8 channels (one 16-byte load per
// position) and a Welford state per channel; the block then combines, per
// group, its channels' states in a fixed order (Chan's pairwise combine) and
// writes (mean, M2) for (sample, group, chunk). gn_finalize_kernel combines
// a group's chunks in order and writes each channel's fp32 (scale, shift) =
// (gamma * rstd, beta - mean * gamma * rstd). No atomics, so every run gives
// the same bits; no E[x^2] - E[x]^2 (the TPU kernels' one-pass form,
// pallas_groupnorm.py:51-53), which cancels when |mean| >> std.
//
// K12 = statistics + finalize + gn_apply_kernel (y = x * scale + shift, SiLU
// in fp32, one rounding to bf16, as the TPU kernel does). Bound: bytes, one
// read and one write of x (the statistics read x once more).
//
// K13 = statistics of x, conv1, statistics of h, conv2. Each conv is an
// implicit GEMM, C[n, co] = sum_k A[n, k] * W[k, co], over the B*H*W output
// positions n and k = tap * C_x + ci: the HWIO weight [3, 3, C_x, C_out]
// (the JAX layout; the UNet prepares it once from its torch weight) is the
// [9 C_x, C_out] B operand as it lies. With C_x % 32 == 0 a K tile of 32 is
// one tap and 32 contiguous channels, gathered from the shifted position with
// 16-byte loads; GN+SiLU is applied in fp32 from the (scale, shift) table and
// the value rounded to bf16, and a tap outside the image gives 0 (SAME
// padding pads the activated value, not the raw input, as the TPU kernel
// masks after GN+SiLU at pallas_resnet.py:131-137). conv1's epilogue adds its
// bias and the time embedding (one row for the batch, or one per sample) and
// stores h in bf16, as the TPU kernel stages it (:167-170); conv2's adds its
// bias and the shortcut: the 1x1 shortcut is C_in more rows of K over the raw
// x (weight [C_in, C_out]), the identity shortcut is x added in the epilogue.
// Tiles: 64 positions x 64 output channels x 32 of K, 4 warps of 32x32 WMMA
// bf16 16x16x16 fragments, fp32 accumulate.
//
// What bounds K13 on an H100: operations, 2 * B*H*W * C_out * (9 C_in +
// 9 C_out [+ C_in]): 4.7 GFLOP (4.8 us) for the level-0 128 -> 128 block at
// B = 2 against 8.6 MB (2.6 us). At level 3 (32 x 2, B = 2) there are 128
// positions: two position tiles by ten channel tiles over a K of up to
// 11,520, the small-M tiling problem of K1-K3, accepted here. wgmma, a load
// pipeline and split-K are later work.

#include "common.cuh"

namespace {

constexpr int GN_THREADS = 256;
constexpr int GN_MAX_C = 8 * GN_THREADS;   // channel states per block
constexpr int GN_APPLY_THREADS = 256;

__device__ __forceinline__ void welford(float n, float& mean, float& m2, float x) {
  const float delta = x - mean;
  mean += delta / n;
  m2 += delta * (x - mean);
}

// (n, mean, m2) += (nb, mb, m2b), Chan et al.'s pairwise combine
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = mb - mean;
  const float f = nb / nn;
  mean += delta * f;
  m2 += m2b + delta * delta * n * f;
  n = nn;
}

// grid (nsplit, B): positions [j * pchunk, (j + 1) * pchunk) of sample b of
// x [B, HW, C] -> part[(b * G + g) * nsplit + j] = (mean, M2) of group g.
// C % 8 == 0 and C <= GN_MAX_C.
__global__ void __launch_bounds__(GN_THREADS) gn_partial_kernel(const bf16* __restrict__ x, int HW, int C, int G,
                                                                 int pchunk, float2* __restrict__ part) {
  __shared__ float s_n[GN_THREADS], s_mean[GN_MAX_C], s_m2[GN_MAX_C];
  const int j = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int vc_count = C / 8, rows = GN_THREADS / vc_count;
  const int row = threadIdx.x / vc_count, vc = threadIdx.x % vc_count;
  const int p1 = min((j + 1) * pchunk, HW);
  if (row < rows) {
    float n = 0.f, mean[8], m2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) mean[e] = m2[e] = 0.f;
    for (int p = j * pchunk + row; p < p1; p += rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + ((size_t)b * HW + p) * C + vc * 8);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      n += 1.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) welford(n, mean[e], m2[e], __bfloat162float(v[e]));
    }
    if (vc == 0) s_n[row] = n;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s_mean[row * C + vc * 8 + e] = mean[e];
      s_m2[row * C + vc * 8 + e] = m2[e];
    }
  }
  __syncthreads();
  const int cpg = C / G;
  for (int g = threadIdx.x; g < G; g += GN_THREADS) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = 0; r < rows; ++r)
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) chan(n, mean, m2, s_n[r], s_mean[r * C + c], s_m2[r * C + c]);
    part[((size_t)b * G + g) * nsplit + j] = make_float2(mean, m2);
  }
}

// grid (B): ss[b, c] = (gamma[c] * rstd, beta[c] - mean * gamma[c] * rstd) of c's group
__global__ void gn_finalize_kernel(const float2* __restrict__ part, int nsplit, int pchunk, int HW, int C, int G,
                                   const bf16* __restrict__ gamma, const bf16* __restrict__ beta, float eps,
                                   float2* __restrict__ ss) {
  const int b = blockIdx.x, cpg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float2* p = part + ((size_t)b * G + c / cpg) * nsplit;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int j = 0; j < nsplit; ++j) chan(n, mean, m2, (float)(min(pchunk, HW - j * pchunk) * cpg), p[j].x, p[j].y);
    const float s = rsqrtf(m2 / n + eps) * __bfloat162float(gamma[c]);
    ss[(size_t)b * C + c] = make_float2(s, __bfloat162float(beta[c]) - mean * s);
  }
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// one thread per 8 values of x [B, HW, C]: y = x * scale + shift (+ SiLU)
__global__ void __launch_bounds__(GN_APPLY_THREADS) gn_apply_kernel(const bf16* __restrict__ x,
                                                                     const float2* __restrict__ ss,
                                                                     bf16* __restrict__ y, long long n8, int HW,
                                                                     int C, int act) {
  const long long i = (long long)blockIdx.x * GN_APPLY_THREADS + threadIdx.x;
  if (i >= n8) return;
  const long long e0 = i * 8;
  const int c0 = (int)(e0 % C);
  const float2* t = ss + (e0 / ((long long)HW * C)) * C + c0;
  const uint4 raw = *reinterpret_cast<const uint4*>(x + e0);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  uint4 res;
  bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float a = fmaf(__bfloat162float(v[u]), t[u].x, t[u].y);
    r[u] = __float2bfloat16(act ? silu(a) : a);
  }
  *reinterpret_cast<uint4*>(y + e0) = res;
}

// the statistics of x [B, HW, C] into ss [B, C] (partials in part [B*G*nsplit])
int launch_gn_stats(const bf16* x, const bf16* gamma, const bf16* beta, float2* part, int nsplit, int pchunk,
                    float2* ss, int B, int C, int HW, int G, float eps, cudaStream_t st) {
  gn_partial_kernel<<<dim3(nsplit, B), GN_THREADS, 0, st>>>(x, HW, C, G, pchunk, part);
  int e = (int)cudaGetLastError();
  if (e) return e;
  gn_finalize_kernel<<<B, 256, 0, st>>>(part, nsplit, pchunk, HW, C, G, gamma, beta, eps, ss);
  return (int)cudaGetLastError();
}

struct ConvArgs {
  const bf16* x;        // conv input [B, H*W, Cx]
  const float2* ss;     // its GN (scale, shift) [B, Cx]
  const bf16* w;        // [9 * Cx, Cout]: an HWIO weight [3, 3, Cx, Cout]
  const bf16* bias;     // [Cout]
  const bf16* temb;     // [Cout] (temb_bstride 0) or [B, Cout] (temb_bstride Cout), or null
  int temb_bstride;
  const bf16* xs;       // the shortcut's source [B, H*W, Cin] (the block's x), or null
  const bf16* wsc;      // [Cin, Cout] 1x1 shortcut, or null for the identity
  const bf16* bsc;      // [Cout] or null
  bf16* out;            // [B, H*W, Cout]
  int B, Cx, Cin, Cout, H, W;
};

constexpr int CV_SMEM_TILES = BM * LDS * 2 + BK * LDB * 2;
constexpr int CV_SMEM = CV_SMEM_TILES > BM * LDC * 4 ? CV_SMEM_TILES : BM * LDC * 4;

// grid (ceil(B*H*W / 64), ceil(Cout / 64)); Cx % 32 == 0, Cin % 32 == 0,
// Cout % 8 == 0 (checked by the wrapper)
__global__ void __launch_bounds__(THREADS) conv3x3_gn_kernel(const ConvArgs a) {
  __shared__ __align__(128) unsigned char smem[CV_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);             // [BM positions][BK k]
  bf16* Bs = As + BM * LDS;                             // [BK k][BN co]
  float* Cs = reinterpret_cast<float*>(smem);           // [BM][LDC], after the K loop

  const int HW = a.H * a.W, M = a.B * HW;
  const int K1 = 9 * a.Cx, K = K1 + (a.wsc != nullptr ? a.Cin : 0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool sc = k0 >= K1;            // a K tile is all taps or all shortcut rows
    const int tap = sc ? 4 : k0 / a.Cx;  // the shortcut reads the centre position
    const int ci0 = sc ? k0 - K1 : k0 - tap * a.Cx;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    // activations: 8 channels per chunk, GN+SiLU on the way in, 0 off the image
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8, m = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        const int b = m / HW, p = m % HW;
        const int hs = p / a.W + dh, ws = p % a.W + dw;
        if (hs >= 0 && hs < a.H && ws >= 0 && ws < a.W) {
          const int ci = ci0 + kc;
          if (sc) {
            val = *reinterpret_cast<const uint4*>(a.xs + ((size_t)b * HW + p) * a.Cin + ci);
          } else {
            const uint4 raw = *reinterpret_cast<const uint4*>(a.x + ((size_t)b * HW + hs * a.W + ws) * a.Cx + ci);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
            const float2* t = a.ss + (size_t)b * a.Cx + ci;
            bf16* o = reinterpret_cast<bf16*>(&val);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(silu(fmaf(__bfloat162float(v[e]), t[e].x, t[e].y)));
          }
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = val;
    }
    // weights: [BK, BN] rows of W (taps) or Wsc (the shortcut)
    const bf16* wsrc = sc ? a.wsc + (size_t)(k0 - K1) * a.Cout : a.w + (size_t)k0 * a.Cout;
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + nc < a.Cout) val = *reinterpret_cast<const uint4*>(wsrc + (size_t)r * a.Cout + n0 + nc);
      *reinterpret_cast<uint4*>(Bs + r * LDB + nc) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: bias, temb / shortcut, 8 output channels per chunk
  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int m = m0 + r, co = n0 + cc;
    if (m >= M || co >= a.Cout) continue;
    const int b = m / HW;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cs[r * LDC + cc + e] + __bfloat162float(a.bias[co + e]);
    if (a.temb != nullptr) {
      const bf16* t = a.temb + (size_t)b * a.temb_bstride + co;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(t[e]);
    }
    if (a.xs != nullptr) {
      const bf16* s = a.wsc != nullptr ? a.bsc + co : a.xs + (size_t)m * a.Cout + co;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(s[e]);
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(a.out + (size_t)m * a.Cout + co) = o;
  }
}

int launch_conv(const ConvArgs& a, cudaStream_t st) {
  dim3 grid((a.B * a.H * a.W + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  conv3x3_gn_kernel<<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K12: y = GroupNorm(x) (then SiLU when act) for x [B, HW, C] bf16 (channels
// contiguous); part [B*G*nsplit] float2 and ss [B, C] float2 are scratch.
int apk_group_norm_silu(const void* x, const void* gamma, const void* beta, void* part, int nsplit, int pchunk,
                        void* ss, void* y, int B, int C, int HW, int G, float eps, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 8 || C > GN_MAX_C) return (int)cudaErrorInvalidValue;
  int e = launch_gn_stats((const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (float2*)part, nsplit, pchunk,
                          (float2*)ss, B, C, HW, G, eps, st);
  if (e) return e;
  const long long n8 = (long long)B * HW * C / 8;
  gn_apply_kernel<<<(unsigned)((n8 + GN_APPLY_THREADS - 1) / GN_APPLY_THREADS), GN_APPLY_THREADS, 0, st>>>(
      (const bf16*)x, (const float2*)ss, (bf16*)y, n8, HW, C, act);
  return (int)cudaGetLastError();
}

// K13: out = shortcut(x) + conv2(silu(gn2(h))) with h = conv1(silu(gn1(x))) +
// temb; x [B, H*W, Cin], out [B, H*W, Cout] (channels contiguous), conv
// weights HWIO; temb null, [Cout] (temb_bstride 0) or [B, Cout]; wsc/bsc null
// for the identity shortcut. part1/ss1 (over Cin), h, part2/ss2 (over Cout)
// are scratch.
int apk_fused_resnet_block(const void* x, const void* temb, int temb_bstride, const void* gn1_w, const void* gn1_b,
                           const void* w1, const void* b1, const void* gn2_w, const void* gn2_b, const void* w2,
                           const void* b2, const void* wsc, const void* bsc, void* part1, int nsplit1, int pchunk1,
                           void* ss1, void* h, void* part2, int nsplit2, int pchunk2, void* ss2, void* out, int B,
                           int Cin, int Cout, int H, int W, int G, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 32 || Cout % 32 || Cin > GN_MAX_C || Cout > GN_MAX_C) return (int)cudaErrorInvalidValue;
  const int HW = H * W;
  int e = launch_gn_stats((const bf16*)x, (const bf16*)gn1_w, (const bf16*)gn1_b, (float2*)part1, nsplit1, pchunk1,
                          (float2*)ss1, B, Cin, HW, G, eps, st);
  if (e) return e;
  ConvArgs c1 = {};
  c1.x = (const bf16*)x;
  c1.ss = (const float2*)ss1;
  c1.w = (const bf16*)w1;
  c1.bias = (const bf16*)b1;
  c1.temb = (const bf16*)temb;
  c1.temb_bstride = temb_bstride;
  c1.out = (bf16*)h;
  c1.B = B; c1.Cx = Cin; c1.Cin = Cin; c1.Cout = Cout; c1.H = H; c1.W = W;
  e = launch_conv(c1, st);
  if (e) return e;
  e = launch_gn_stats((const bf16*)h, (const bf16*)gn2_w, (const bf16*)gn2_b, (float2*)part2, nsplit2, pchunk2,
                      (float2*)ss2, B, Cout, HW, G, eps, st);
  if (e) return e;
  ConvArgs c2 = {};
  c2.x = (const bf16*)h;
  c2.ss = (const float2*)ss2;
  c2.w = (const bf16*)w2;
  c2.bias = (const bf16*)b2;
  c2.xs = (const bf16*)x;
  c2.wsc = (const bf16*)wsc;
  c2.bsc = (const bf16*)bsc;
  c2.out = (bf16*)out;
  c2.B = B; c2.Cx = Cout; c2.Cin = Cin; c2.Cout = Cout; c2.H = H; c2.W = W;
  return launch_conv(c2, st);
}

}  // extern "C"
