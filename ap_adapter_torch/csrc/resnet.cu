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
// GroupNorm (both ops): one launch, gn_cluster_kernel. The n CTAs of one
// sample form a thread-block cluster (n <= 16, a power of two); CTA j takes
// the contiguous positions [j * pchunk, (j + 1) * pchunk), all channels, each
// thread 8 channels by 16-byte loads, and holds the chunk in shared memory
// where it fits (else it reads it again, from L2). Per group it computes the
// chunk's sum, then its mean, then the centred sum of squares: no division
// and no Welford step per value, and no E[x^2] - E[x]^2 (the TPU kernels'
// one-pass form, pallas_groupnorm.py:51-53, which cancels when |mean| >> std).
// It publishes (count, mean, M2) per group in its shared memory; after
// cluster.sync() every CTA reads all n partials through distributed shared
// memory in rank order and combines them by Chan's rule, so every CTA forms
// the same per-channel fp32 (scale, shift) = (gamma * rstd, beta - mean *
// gamma * rstd). Each pass keeps 8 loads a thread in flight. No atomics
// and a fixed order: every run gives the same bits.
//
// K12 = gn_cluster_kernel with its apply pass: y = x * scale + shift, SiLU in
// fp32, one rounding to bf16, as the TPU kernel does. Bound: bytes, one read
// and one write of x. K13 runs the same kernel without the apply pass: rank 0
// of each cluster writes the (scale, shift) table its convs read.
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

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GN_MAX_C = 2048;             // channels a block takes (8 per thread, up to 256 threads a row)
constexpr int GN_MAX_CLUSTER = 16;
constexpr int GN_MAX_THREADS = 512;
constexpr int GN_UNROLL = 8;                // 16-byte loads in flight per thread and pass

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

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

struct GnArgs {
  const bf16* x;        // [B, HW, C]
  const bf16* gamma;
  const bf16* beta;
  bf16* y;              // [B, HW, C], or null: statistics only
  float2* ss;           // [B, C] (scale, shift) written by rank 0 when y is null
  int HW, C, G, pchunk, hold;
  float eps;
  int act;
};

// Shared memory of one CTA: per-thread sums [rows][C], the (scale, shift)
// table [C] (a per-channel scratch before), the published partials [G][3],
// the combined (mean, rstd) [G][2], all n CTAs' partials gathered [n][G][3],
// then the chunk when it is held.
struct GnLayout {
  int red, ss, part, stat, gath, chunk, bytes;
};

__host__ __device__ inline GnLayout gn_layout(int C, int G, int n, int threads, int pchunk, int hold) {
  const int rows = threads / (C / 8);
  GnLayout L;
  int off = 0;
  L.red = off; off += rows * C * 4;
  L.ss = off; off += C * 8;
  L.part = off; off += G * 3 * 4;
  L.stat = off; off += G * 2 * 4;
  L.gath = off; off += n * G * 3 * 4;
  off = (off + 15) & ~15;
  L.chunk = off; if (hold) off += pchunk * C * 2;
  L.bytes = off;
  return L;
}

// Per-group sums over the block of 8 per-thread channel values acc (threads
// past the last row hold zeros): rows summed per channel in order, then each
// group's channels by one warp. All threads must call it.
__device__ void gn_group_sums(const float* acc, bool active, int row, int vc, int C, int G, float* red, float* chan_sum,
                              float* out) {
  const int rows = blockDim.x / (C / 8), cpg = C / G;
  if (active) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[row * C + vc * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) t += red[r * C + c];
    chan_sum[c] = t;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {
    float t = 0.f;
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) t += chan_sum[c];
    t = warp_sum(t);
    if (lane == 0) out[g] = t;
  }
  __syncthreads();
}

// grid (n, B), cluster (n, 1, 1); blockDim a multiple of 32 with
// (C / 8) * rows <= blockDim. See the note above.
__global__ void __launch_bounds__(GN_MAX_THREADS) gn_cluster_kernel(const GnArgs a) {
  extern __shared__ __align__(16) unsigned char gn_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, G = a.G, cpg = C / G, vcn = C / 8;
  const int rows = blockDim.x / vcn, row = threadIdx.x / vcn, vc = threadIdx.x % vcn;
  const bool active = row < rows;
  const int j = blockIdx.x, n = gridDim.x, b = blockIdx.y;
  const int p0 = min(j * a.pchunk, a.HW), npos = min(a.pchunk, a.HW - p0);
  const GnLayout L = gn_layout(C, G, n, blockDim.x, a.pchunk, a.hold);
  float* red = reinterpret_cast<float*>(gn_smem + L.red);
  float2* ss = reinterpret_cast<float2*>(gn_smem + L.ss);
  float* part = reinterpret_cast<float*>(gn_smem + L.part);
  float* stat = reinterpret_cast<float*>(gn_smem + L.stat);
  float* gath = reinterpret_cast<float*>(gn_smem + L.gath);
  bf16* chunk = reinterpret_cast<bf16*>(gn_smem + L.chunk);
  const bf16* xs = a.x + ((size_t)b * a.HW + p0) * C + vc * 8;

  // the chunk's per-group sums, the chunk into shared memory on the way
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (active) {
    for (int p = row; p < npos; p += rows * GN_UNROLL) {
      uint4 raw[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (p + u * rows < npos) raw[u] = *reinterpret_cast<const uint4*>(xs + (size_t)(p + u * rows) * C);
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        const int q = p + u * rows;
        if (q < npos) {
          if (a.hold) *reinterpret_cast<uint4*>(chunk + q * C + vc * 8) = raw[u];
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += __bfloat162float(v[e]);
        }
      }
    }
  }
  float* chan_sum = reinterpret_cast<float*>(ss);
  gn_group_sums(acc, active, row, vc, C, G, red, chan_sum, stat);
  const float cnt = (float)(npos * cpg);
  for (int g = threadIdx.x; g < G; g += blockDim.x) stat[G + g] = npos > 0 ? stat[g] / cnt : 0.f;
  __syncthreads();

  // the centred sum of squares around the chunk's group means
  float mu[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mu[e] = stat[G + (vc * 8 + e) / cpg];
    acc[e] = 0.f;
  }
  if (active) {
    for (int p = row; p < npos; p += rows * GN_UNROLL) {
      uint4 raw[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        const int q = p + u * rows;
        if (q < npos)
          raw[u] = a.hold ? *reinterpret_cast<const uint4*>(chunk + q * C + vc * 8)
                          : *reinterpret_cast<const uint4*>(xs + (size_t)q * C);
      }
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        if (p + u * rows < npos) {
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dv = __bfloat162float(v[e]) - mu[e];
            acc[e] += dv * dv;
          }
        }
      }
    }
  }
  gn_group_sums(acc, active, row, vc, C, G, red, chan_sum, stat);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    part[3 * g] = cnt;
    part[3 * g + 1] = stat[G + g];
    part[3 * g + 2] = stat[g];
  }

  // every CTA gathers all partials of the sample (one remote read a
  // thread), then combines them in rank order
  cluster.sync();
  for (int i = threadIdx.x; i < n * G; i += blockDim.x) {
    const float* rp = cluster.map_shared_rank(part, i / G) + 3 * (i % G);
    gath[3 * i] = rp[0];
    gath[3 * i + 1] = rp[1];
    gath[3 * i + 2] = rp[2];
  }
  cluster.sync();                    // no CTA leaves while another reads its partials
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float nn = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = 0; r < n; ++r) chan(nn, mean, m2, gath[3 * (r * G + g)], gath[3 * (r * G + g) + 1],
                                     gath[3 * (r * G + g) + 2]);
    stat[2 * g] = mean;
    stat[2 * g + 1] = rsqrtf(m2 / nn + a.eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float sc = stat[2 * g + 1] * __bfloat162float(a.gamma[c]);
    const float2 t = make_float2(sc, __bfloat162float(a.beta[c]) - stat[2 * g] * sc);
    ss[c] = t;
    if (a.y == nullptr && j == 0) a.ss[(size_t)b * C + c] = t;
  }
  if (a.y == nullptr) return;
  __syncthreads();

  // y = x * scale + shift (+ SiLU), from the held chunk or again from L2
  if (!active) return;
  float2 t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = ss[vc * 8 + e];
  bf16* ys = a.y + ((size_t)b * a.HW + p0) * C + vc * 8;
  for (int p = row; p < npos; p += rows * GN_UNROLL) {
    uint4 raw[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int q = p + u * rows;
      if (q < npos)
        raw[u] = a.hold ? *reinterpret_cast<const uint4*>(chunk + q * C + vc * 8)
                        : *reinterpret_cast<const uint4*>(xs + (size_t)q * C);
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int q = p + u * rows;
      if (q < npos) {
        const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
        uint4 res;
        bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = fmaf(__bfloat162float(v[e]), t[e].x, t[e].y);
          r[e] = __float2bfloat16(a.act ? silu(y) : y);
        }
        *reinterpret_cast<uint4*>(ys + (size_t)q * C) = res;
      }
    }
  }
}

// one gn_cluster_kernel launch over x [B, HW, C]: the plan (n CTAs a sample,
// pchunk positions each, threads, hold) comes from the wrapper
int launch_gn(const GnArgs& a, int B, int n, int threads, cudaStream_t st) {
  if (a.C % 8 || a.C > GN_MAX_C || a.C % a.G || n < 1 || n > GN_MAX_CLUSTER || (n & (n - 1)) ||
      threads % 32 || threads > GN_MAX_THREADS || threads < a.C / 8 || (long long)n * a.pchunk < a.HW)
    return (int)cudaErrorInvalidValue;
  const GnLayout L = gn_layout(a.C, a.G, n, threads, a.pchunk, a.hold);
  static int configured = -1;
  if (configured < 0) {
    cudaError_t e = cudaFuncSetAttribute(gn_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    configured = 0;
  }
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(gn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n, (unsigned)B);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel, a);
  if (e != cudaSuccess) return (int)e;
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
// contiguous), in one clustered launch: n CTAs per sample (a cluster),
// pchunk positions each, threads per CTA, the chunk held in shared memory
// when hold (the wrapper's plan, ops/groupnorm.py::gn_cluster_plan).
int apk_group_norm_silu(const void* x, const void* gamma, const void* beta, void* y, int B, int C, int HW, int G,
                        int n, int pchunk, int threads, int hold, float eps, int act, void* stream) {
  GnArgs a = {(const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y, nullptr, HW, C, G, pchunk, hold,
              eps, act};
  return launch_gn(a, B, n, threads, static_cast<cudaStream_t>(stream));
}

// K13: out = shortcut(x) + conv2(silu(gn2(h))) with h = conv1(silu(gn1(x))) +
// temb; x [B, H*W, Cin], out [B, H*W, Cout] (channels contiguous), conv
// weights HWIO; temb null, [Cout] (temb_bstride 0) or [B, Cout]; wsc/bsc null
// for the identity shortcut. The GroupNorm statistics of x and of h are
// gn_cluster_kernel launches (plans n/pchunk/threads/hold over Cin and Cout)
// writing ss1/ss2 [B, C] float2; h is scratch.
int apk_fused_resnet_block(const void* x, const void* temb, int temb_bstride, const void* gn1_w, const void* gn1_b,
                           const void* w1, const void* b1, const void* gn2_w, const void* gn2_b, const void* w2,
                           const void* b2, const void* wsc, const void* bsc, int n1, int pchunk1, int threads1,
                           int hold1, void* ss1, void* h, int n2, int pchunk2, int threads2, int hold2, void* ss2,
                           void* out, int B, int Cin, int Cout, int H, int W, int G, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 32 || Cout % 32 || Cin > GN_MAX_C || Cout > GN_MAX_C) return (int)cudaErrorInvalidValue;
  const int HW = H * W;
  GnArgs g1 = {(const bf16*)x, (const bf16*)gn1_w, (const bf16*)gn1_b, nullptr, (float2*)ss1, HW, Cin, G, pchunk1,
               hold1, eps, 0};
  int e = launch_gn(g1, B, n1, threads1, st);
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
  GnArgs g2 = {(const bf16*)h, (const bf16*)gn2_w, (const bf16*)gn2_b, nullptr, (float2*)ss2, HW, Cout, G, pchunk2,
               hold2, eps, 0};
  e = launch_gn(g2, B, n2, threads2, st);
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
