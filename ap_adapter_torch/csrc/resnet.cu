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
// and one write of x.
//
// K13 (redesigned for Hopper) = four launches: K12's launch on x with SiLU
// (a1 = silu(gn1(x)) into scratch, once, where the first port's conv
// recomputed GN+SiLU for each of the 9 taps of every value; the value is
// bit for bit the one that conv gathered, bf16(silu(fmaf(x, scale,
// shift)))), conv1 over a1, K12's launch on h, conv2 over a2 = silu(gn2(h)).
// Each conv is an implicit GEMM, C[n, co] = sum_k A[n, k] * W[k, co], over
// the output positions n and k = tap * C_x + ci, on conv_kernel<BN>:
//   * A by TMA through a 4-D tensor map over the activated input
//     [B, H, W, C_x] ({channel, w, h, b}), a box of 64 channels (128 bytes,
//     128-byte swizzle) x the whole width W x R = 64 / W rows x 1 sample: a
//     tile is R whole rows of one sample, R * W <= 64 positions, each one
//     128-byte row of the box, which is wgmma's K-major A tile as it
//     stands. For tap (dh, dw) the producer loads the box at
//     (ci0, dw, h0 + dh, b): TMA zero-fills every element outside the
//     tensor, negative coordinates included, and that zero is exactly the
//     SAME padding of the activated value (pallas_resnet.py:135-137), with
//     no masking code; the ragged H (125, 63) and a last tile's rows past H
//     come free;
//   * B, the HWIO weight [3, 3, C_x, C_out] as it lies ([9 C_x, C_out], the
//     JAX layout; the UNet prepares it once from its torch weight), by TMA
//     boxes of 64 k-rows x 64 output channels: wgmma reads it MN-major
//     (a transposed B descriptor), so no copy of the weights, ever;
//   * a producer warp keeps a ring of 2-4 stages full; one consumer
//     warpgroup runs wgmma m64n64k16 (BN / 64 of them a k-step);
//   * where the output tiles are fewer than the SMs (level 3: 2 position
//     tiles x 10 channel tiles over up to 200 k-blocks) the k-blocks are
//     split over a thread-block cluster and the fp32 partials combined in
//     rank order through distributed shared memory, bit-equal from run to
//     run (hopper_gemm.cuh's combine; the plan is ops/resnet.py::conv_plan);
//   * the epilogue from the accumulator registers: conv1 adds its bias and
//     the time embedding (one row for the batch, or one per sample) and
//     stores h in bf16, as the TPU kernel stages it (:167-170); conv2 adds
//     its bias and the shortcut: the 1x1 shortcut is C_in more k-blocks over
//     the raw x, through a second pair of tensor maps, the identity shortcut
//     is x added in the epilogue.
// Widths: C_in and C_out multiples of 64 (every UNet width is: 128 to
// 1280), W <= 64; the wrapper refuses the rest.
//
// What bounds K13 on an H100: operations, 2 * B*H*W * C_out * (9 C_in +
// 9 C_out [+ C_in]): 4.7 GFLOP (4.8 us) for the level-0 128 -> 128 block at
// B = 2 against 8.6 MB (2.6 us); at level 3 the weights' bytes (up to
// 14.7 MB a conv, 4.4 us).

#include "common.cuh"
#include "hopper.cuh"
#include "hopper_gemm.cuh"

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
  bf16* y;              // [B, HW, C]
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
    ss[c] = make_float2(sc, __bfloat162float(a.beta[c]) - stat[2 * g] * sc);
  }
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

constexpr int CV_BK = 64;           // channels a k-block: one 128-byte swizzle row of bf16
constexpr int CV_B_BYTES = CV_BK * 128;   // one 64 x 64 box of B

struct ConvArgs {
  CUtensorMap a;        // the activated conv input [B, H, W, C_x], box {64, W, R, 1}
  CUtensorMap xs;       // the block's raw x [B, H, W, C_in] (1x1 shortcut), box {64, W, R, 1}
  CUtensorMap w;        // [9 C_x, C_out] (HWIO [3, 3, C_x, C_out]), box {64 co, 64 k}
  CUtensorMap wsc;      // [C_in, C_out] 1x1 shortcut weight, box {64 co, 64 k}
  const bf16* bias;     // [C_out]
  const bf16* temb;     // [C_out] (temb_bstride 0) or [B, C_out] (temb_bstride C_out), or null
  int temb_bstride;
  const bf16* resid;    // identity shortcut: x [B, H*W, C_out], or null
  const bf16* bsc;      // 1x1 shortcut bias [C_out], or null
  bf16* out;            // [B, H*W, C_out]
  int H, W, R, tps;     // R rows of W positions a tile (R * W <= 64), tps = ceil(H / R) tiles a sample
  int Cout;
  int cxb, kb_sc;       // 64-channel blocks of C_x (a tap's k-blocks) and of the shortcut's C_in (or 0)
  int ksplit, stages;
};

// the epilogue of two neighbouring channels (col, col + 1) of tile row r
// (position (h0 + r / W, r % W) of sample b): bias, then temb, then the
// shortcut (its bias or x), in fp32; one rounding to bf16
__device__ __forceinline__ void conv_store_pair(const ConvArgs& g, int b, int h0, int r, int col, float v0,
                                                float v1) {
  const int h = h0 + r / g.W;
  if (r >= g.R * g.W || h >= g.H) return;
  const size_t off = (((size_t)b * g.H + h) * g.W + r % g.W) * g.Cout + col;
  const float2 bi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
  v0 += bi.x;
  v1 += bi.y;
  if (g.temb != nullptr) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g.temb + (size_t)b * g.temb_bstride + col));
    v0 += t.x;
    v1 += t.y;
  }
  if (g.resid != nullptr || g.bsc != nullptr) {
    const bf16* sp = g.bsc != nullptr ? g.bsc + col : g.resid + off;
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sp));
    v0 += t.x;
    v1 += t.y;
  }
  *reinterpret_cast<uint32_t*>(g.out + off) = pack_bf16(v0, v1);
}

// grid ((C_out / BN) * ksplit, B * tps), HG_THREADS threads, clusters of
// (ksplit, 1, 1). k-block kb < 9 * cxb is tap kb / cxb, channels
// 64 * (kb % cxb); the kb_sc after them are the 1x1 shortcut's. The
// accumulator layout is hgemm_kernel's: element e at tile row 16 * warp +
// lane / 4 + 8 * ((e / 2) % 2), channel 8 * (e / 4) + 2 * (lane % 4) + e % 2.
template <int BN>
__global__ void __launch_bounds__(HG_THREADS, 1) conv_kernel(const __grid_constant__ ConvArgs g) {
  constexpr int NSUB = BN / 64;
  constexpr int NACC = BN / 2;
  constexpr int STAGE = HG_A_BYTES + NSUB * CV_B_BYTES;
  extern __shared__ unsigned char cv_smem_raw[];
  const uint32_t raw = smem_u32(cv_smem_raw);
  unsigned char* smem = cv_smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const int ks = g.ksplit, stages = g.stages;
  const uint32_t bars = base + hg_ring_bytes(BN, 1, stages, ks);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)(blockIdx.x % ks);        // == the cluster rank: clusters span ks consecutive x
  const int n0 = (int)(blockIdx.x / ks) * BN;
  const int b = blockIdx.y / g.tps, h0 = (int)(blockIdx.y % g.tps) * g.R;
  const int kb_taps = 9 * g.cxb, nkb = kb_taps + g.kb_sc;
  const int kb0 = rank * nkb / ks, nk = (rank + 1) * nkb / ks - kb0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (HG_MAX_STAGES + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NACC];
  if (warp == 4) {
    if (lane == 0) {
      const uint32_t bytes = g.R * g.W * 128 + NSUB * CV_B_BYTES;
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages, kb = kb0 + i;
        if (i >= stages) mbar_wait(bars + 8 * (HG_MAX_STAGES + s), ((i / stages) - 1) & 1);
        const uint32_t full = bars + 8 * s, sa = base + s * STAGE;
        mbar_expect_tx(full, bytes);
        if (kb < kb_taps) {
          const int tap = kb / g.cxb;
          tma_load_4d(sa, &g.a, (kb % g.cxb) * CV_BK, tap % 3 - 1, h0 + tap / 3 - 1, b, full);
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
            tma_load_2d(sa + HG_A_BYTES + j * CV_B_BYTES, &g.w, n0 + 64 * j, kb * CV_BK, full);
        } else {
          const int kc = (kb - kb_taps) * CV_BK;
          tma_load_4d(sa, &g.xs, kc, 0, h0, b, full);
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
            tma_load_2d(sa + HG_A_BYTES + j * CV_B_BYTES, &g.wsc, n0 + 64 * j, kc, full);
        }
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8 * s, (i / stages) & 1);
      uint32_t sa = base + s * STAGE;
      asm volatile("" : "+r"(sa));
#pragma unroll
      for (int e = 0; e < NACC; ++e) reg_fence(acc[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CV_BK / 16; ++kk) {
        const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          wgmma_ss_n64_tb(acc + 32 * j, da,
                          sw128_desc(sa + HG_A_BYTES + j * CV_B_BYTES + kk * 16 * 128, CV_B_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                          // k-block i - 1's products are done: free its stage
#pragma unroll
      for (int e = 0; e < NACC; ++e) reg_fence(acc[e]);
      if (i > 0) mbar_arrive(bars + 8 * (HG_MAX_STAGES + (i - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NACC; ++e) reg_fence(acc[e]);
  }

  const int quad = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  if (ks == 1) {
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        conv_store_pair(g, b, h0, r0, col, acc[4 * j], acc[4 * j + 1]);
        conv_store_pair(g, b, h0, r1, col, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    return;
  }

  // split-K: the partials through distributed shared memory, summed in rank order
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(smem);         // [NACC][128 consumer threads]
  if (warp < 4) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) part[e * 128 + tid] = acc[e];
  }
  cluster.sync();
  if (warp < 4) {
    const int u0 = rank * (BN / 8) / ks, u1 = (rank + 1) * (BN / 8) / ks;
    for (int j = u0; j < u1; ++j) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int rr = 0; rr < ks; ++rr) {
        const float* rp = cluster.map_shared_rank(part, rr);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += rp[(4 * j + e) * 128 + tid];
      }
      const int col = n0 + 8 * j + 2 * quad;
      conv_store_pair(g, b, h0, r0, col, v[0], v[1]);
      conv_store_pair(g, b, h0, r1, col, v[2], v[3]);
    }
  }
  cluster.sync();                                       // no CTA leaves while another reads its partials
}

template <int BN>
int launch_conv_t(const ConvArgs& g, int B, cudaStream_t st) {
  const int smem = hg_smem_bytes(BN, 1, g.stages, g.ksplit);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.Cout / BN * g.ksplit), (unsigned)(B * g.tps), 1);
  cfg.blockDim = dim3(HG_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, conv_kernel<BN>, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// one 3x3 SAME conv over the activated a [B, H, W, Cx] into out [B, H, W,
// Cout] (+ bias, + temb; + the 1x1 shortcut of xs [B, H, W, Cin] by wsc and
// bsc, or + the identity shortcut resid), planned (bn, ksplit, stages) by
// the wrapper (ops/resnet.py::conv_plan)
int launch_conv(ConvArgs& g, const void* a, const void* w, const void* xs, const void* wsc, int B, int H, int W,
                int Cx, int Cin, int Cout, int bn, int ksplit, int stages, cudaStream_t st) {
  const int kb_sc = wsc != nullptr ? Cin / CV_BK : 0, nkb = 9 * (Cx / CV_BK) + kb_sc;
  if (B < 1 || H < 1 || W < 1 || W > 64 || Cx % CV_BK || (wsc != nullptr && Cin % CV_BK) || !(bn == 64 || bn == 128) ||
      Cout % bn || ksplit < 1 || ksplit > HG_MAX_SPLIT || ksplit > nkb || ksplit > bn / 8 ||
      stages < HG_MIN_STAGES || stages > HG_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  g.H = H;
  g.W = W;
  g.R = 64 / W;
  g.tps = (H + g.R - 1) / g.R;
  g.Cout = Cout;
  g.cxb = Cx / CV_BK;
  g.kb_sc = kb_sc;
  g.ksplit = ksplit;
  g.stages = stages;
  int e = make_map_act(&g.a, a, B, H, W, Cx, g.R);
  if (!e) e = cached_map_2d(&g.w, w, 9 * Cx, Cout, CV_BK);
  if (!e && kb_sc) e = make_map_act(&g.xs, xs, B, H, W, Cin, g.R);
  if (!e && kb_sc) e = cached_map_2d(&g.wsc, wsc, Cin, Cout, CV_BK);
  if (e) return e;
  return bn == 128 ? launch_conv_t<128>(g, B, st) : launch_conv_t<64>(g, B, st);
}

}  // namespace

extern "C" {

// K12: y = GroupNorm(x) (then SiLU when act) for x [B, HW, C] bf16 (channels
// contiguous), in one clustered launch: n CTAs per sample (a cluster),
// pchunk positions each, threads per CTA, the chunk held in shared memory
// when hold (the wrapper's plan, ops/groupnorm.py::gn_cluster_plan).
int apk_group_norm_silu(const void* x, const void* gamma, const void* beta, void* y, int B, int C, int HW, int G,
                        int n, int pchunk, int threads, int hold, float eps, int act, void* stream) {
  GnArgs a = {(const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y, HW, C, G, pchunk, hold, eps, act};
  return launch_gn(a, B, n, threads, static_cast<cudaStream_t>(stream));
}

// K13: out = shortcut(x) + conv2(silu(gn2(h))) with h = conv1(silu(gn1(x))) +
// temb; x [B, H*W, Cin], out [B, H*W, Cout] (channels contiguous), conv
// weights HWIO; temb null, [Cout] (temb_bstride 0) or [B, Cout]; wsc/bsc null
// for the identity shortcut. The GroupNorms are gn_cluster_kernel launches
// with SiLU (plans n/pchunk/threads/hold over Cin and Cout) writing a1
// [B, H*W, Cin] and a2 [B, H*W, Cout]; h is scratch. (c1_bn, c1_split,
// c1_stages) and (c2_bn, c2_split, c2_stages) plan the convs.
int apk_fused_resnet_block(const void* x, const void* temb, int temb_bstride, const void* gn1_w, const void* gn1_b,
                           const void* w1, const void* b1, const void* gn2_w, const void* gn2_b, const void* w2,
                           const void* b2, const void* wsc, const void* bsc, int n1, int pchunk1, int threads1,
                           int hold1, void* a1, void* h, int n2, int pchunk2, int threads2, int hold2, void* a2,
                           void* out, int B, int Cin, int Cout, int H, int W, int G, float eps, int c1_bn,
                           int c1_split, int c1_stages, int c2_bn, int c2_split, int c2_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % CV_BK || Cout % CV_BK || Cin > GN_MAX_C || Cout > GN_MAX_C) return (int)cudaErrorInvalidValue;
  const int HW = H * W;
  GnArgs g1 = {(const bf16*)x, (const bf16*)gn1_w, (const bf16*)gn1_b, (bf16*)a1, HW, Cin, G, pchunk1, hold1, eps, 1};
  int e = launch_gn(g1, B, n1, threads1, st);
  if (e) return e;
  ConvArgs c1 = {};
  c1.bias = (const bf16*)b1;
  c1.temb = (const bf16*)temb;
  c1.temb_bstride = temb_bstride;
  c1.out = (bf16*)h;
  e = launch_conv(c1, a1, w1, nullptr, nullptr, B, H, W, Cin, Cin, Cout, c1_bn, c1_split, c1_stages, st);
  if (e) return e;
  GnArgs g2 = {(const bf16*)h, (const bf16*)gn2_w, (const bf16*)gn2_b, (bf16*)a2, HW, Cout, G, pchunk2, hold2, eps,
               1};
  e = launch_gn(g2, B, n2, threads2, st);
  if (e) return e;
  ConvArgs c2 = {};
  c2.bias = (const bf16*)b2;
  c2.resid = wsc == nullptr ? (const bf16*)x : nullptr;
  c2.bsc = (const bf16*)bsc;
  c2.out = (bf16*)out;
  return launch_conv(c2, a2, w2, x, wsc, B, H, W, Cout, Cin, Cout, c2_bn, c2_split, c2_stages, st);
}

}  // extern "C"
