// Hopper (sm_90a) kernels of the adapter-training path: the input-gradient
// (backward) kernels.
//
// Replaces the TPU Pallas kernels
//   K7 ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention_bwd_dx
//   K8 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_bwd
//   K9 ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff_bwd_dx
// (K8's forward, K4, is in fused_hopper.cu beside K2, whose chain it runs.)
//
// The TPU kernels run their grid in order and carry dk/dv (and the adapter's
// dk_ip/dv_ip) across query tiles in VMEM scratch, finishing with the
// LayerNorm backward over the whole sequence at the last tile. Blocks on a
// GPU run in no fixed order, so each backward is a chain of launches on one
// stream, with no atomics (the results are deterministic), on the Hopper
// routines (hopper_gemm.cuh: TMA rings, wgmma, epilogues from the
// registers, split-K clusters; attn_bwd.cuh: the register-resident
// attention backward):
//   K7 = LN rows (ln_rows_kernel) -> QKV GEMM (three weight sets, one
//        launch, as K1's) -> gattn = g . Wo (the GEMM reading Wo [K, N]
//        MN-major, bf16 store) -> the dq kernel (two sweeps over the keys:
//        the forward's statistics and D = rowsum(dO * O), then dq) -> the
//        dkv kernel (K/V in registers, a loop over the query tiles) ->
//        gxn = [dq | dk | dv] . [Wq; Wk; Wv] (one MN-major GEMM, K = 3C,
//        fp32 store: dq, dk and dv are the column blocks of one [M, 3C]
//        bf16 buffer) -> ln_bwd_kernel;                       (7 launches)
//   K8 = the context K/V GEMM (launch_ctx_kv: the text K/V and, at adapter
//        sites, the adapter K/V, 2 or 4 weight sets in one launch through
//        3-D tensor maps, as K11c's) -> LN rows -> Q GEMM -> gattn = g . Wo
//        -> the two-set dq kernel (sweep 1 over the text keys with their
//        T5 bias and then the adapter keys, sweep 2 over both; the
//        adapter's output gradient bf16(ip_scale * gattn)) -> the dkv
//        kernel over the adapter keys alone, fp32 dk_ip/dv_ip -> gxn =
//        dq . Wq (MN-major, fp32 store) -> ln_bwd_kernel;  (8 launches, 7
//        without an adapter set: no dkv kernel; the text set never needs
//        dk/dv)
//   K9 = LN rows -> one GEMM for the three products of a 64 x 64 tile of
//        gy1 (a and gate from W1, gh = g . W2) with the GEGLU backward in
//        its epilogue (gh stays fp32 in registers, never in device memory)
//        -> gxn = gy1 . W1 (MN-major, K = 8C, fp32 store, split-K clusters
//        where the plan says) -> ln_bwd_kernel.               (4 launches)
// Every GEMM's tile width, split-K and stages come from the wrapper's plan
// (ops/fused_block.py::k7_plan, ops/fused_cross.py::k8_plan,
// ops/fused_ff.py::k9_plan).

#include "attn_bwd.cuh"
#include "hopper_gemm.cuh"

namespace {

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

int launch_ln_bwd(const void* x, const void* gxn, const void* ln_w, const void* g, void* dx, int M, int C,
                  float eps, cudaStream_t st) {
  const int rows = THREADS / 32;
  ln_bwd_kernel<<<(M + rows - 1) / rows, THREADS, 0, st>>>((const bf16*)x, (const float*)gxn, (const bf16*)ln_w,
                                                           (const bf16*)g, (bf16*)dx, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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

// K8: dx of K4 for the output gradient g [B, S, C], and (adapter sites,
// wki/wvi not null) dki/dvi [B, Sk_total - sk_text, C] fp32, the gradients
// of the adapter's projected K/V per context position. ctx [B, Sk_total, Dc];
// bias [B, sk_text] fp32 or null. Scratch (16-byte aligned, the plan's
// offsets): kv bf16 (k, v [B, sk_text, C], then ki, vi [B, sk_ip, C]); act
// 5 x [B, S, C] bf16 (LN(x), q, gattn, the adapter's bf16(ip_scale * gattn),
// dq); stats fp32 (lse2 and D [2, B, heads, S] each, then gxn [B, S, C]).
// (kv_*), (q_*), (go_*) and (gx_*) plan the context K/V, Q, g . Wo and gxn
// GEMMs: tile width, split-K and ring stages.
int apk_fused_ln_cross_attention_bwd(const void* x, const void* g, const void* ctx, int Sk_total, int Dc,
                                     int sk_text, const void* ln_w, const void* ln_b, const void* wq,
                                     const void* wk, const void* wv, const void* wki, const void* wvi,
                                     const void* wo, float ip_scale, const void* bias, void* kv, void* act,
                                     void* stats, void* dx, void* dki, void* dvi, int B, int S, int C, int heads,
                                     float eps, int kv_bn, int kv_split, int kv_stages, int q_bn, int q_split,
                                     int q_stages, int go_bn, int go_split, int go_stages, int gx_bn, int gx_split,
                                     int gx_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  if (sk_ip > 0 && (wvi == nullptr || dki == nullptr || dvi == nullptr)) return (int)cudaErrorInvalidValue;
  bf16* k = static_cast<bf16*>(kv);
  bf16* v = k + (size_t)B * sk_text * C;
  bf16* ki = v + (size_t)B * sk_text * C;
  bf16* vi = ki + (size_t)B * sk_ip * C;
  bf16* xn = static_cast<bf16*>(act);
  bf16 *q = xn + mc, *gattn = q + mc, *gattn_ip = gattn + mc, *dq = gattn_ip + mc;
  float* lse2 = static_cast<float*>(stats);
  float* dsum = lse2 + (size_t)2 * B * heads * S;
  float* gxn = dsum + (size_t)2 * B * heads * S;
  const void* w[4] = {wk, wv, wki, wvi};
  bf16* const kvo[4] = {k, v, ki, vi};
  int e = launch_ctx_kv(ctx, B, Sk_total, Dc, sk_text, sk_ip, w, kvo, C, kv_bn, kv_split, kv_stages, st);
  if (e) return e;
  e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs qa = {};
  qa.c[0] = q;
  e = launch_hgemm(qa, xn, &wq, 1, M, C, C, q_bn, q_split, q_stages, HG_STORE, st);
  if (e) return e;
  HgArgs go = {};
  go.c[0] = gattn;
  e = launch_hgemm_kn(go, g, &wo, 1, M, C, C, go_bn, go_split, go_stages, HG_STORE, st);
  if (e) return e;
  const FaKeys text = {k, v, static_cast<const float*>(bias), sk_text, AB_T};
  const FaKeys adapter = {ki, vi, nullptr, sk_ip, AB_T};
  e = launch_reg_attn_bwd_cross(q, gattn, text, adapter, ip_scale, B, S, heads, C / heads, dq, lse2, dsum, gattn_ip,
                                static_cast<float*>(dki), static_cast<float*>(dvi), st);
  if (e) return e;
  HgArgs gx = {};
  gx.cf = gxn;
  e = launch_hgemm_kn(gx, dq, &wq, 1, M, C, C, gx_bn, gx_split, gx_stages, HG_STORE_F32, st);
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
