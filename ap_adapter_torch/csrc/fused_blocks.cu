// Hopper (sm_90a) kernels for the fused UNet cross-attention block and the
// bare dual-KV attention.
//
// Replaces the TPU Pallas kernels
//   K2 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_kv
//   K10 ap_adapter_tpu/ops/pallas_attention.py::fused_dual_kv_attention
// with the two device routines of common.cuh (the WMMA GEMM with its
// LayerNorm prologue and epilogues, and the streamed online-softmax
// attention). The op entry points (extern "C", plain C ABI for ctypes) chain
// them:
//   K2 = LN+Q GEMM -> (dual) attention over hoisted K/V -> out GEMM + bias +
//        residual
//   K10 = the attention routine alone, over both key sets
// K1 and K3 moved to fused_hopper.cu (wgmma/TMA GEMMs and a register-resident
// attention); K2 moves onto those routines in later work.
// Intermediates (q, the attention output) go through device memory; the
// caller allocates them. Every entry point returns the cudaGetLastError()
// code of its first failing launch (0 on success).
//
// What bounds these on an H100: at the UNet's widths (C = 256/384/640) the
// GEMMs are small (K <= 2560) and the attention's keys are few (8-512), so
// the kernels are bound by shared-memory traffic and per-launch latency
// rather than by HBM bandwidth or tensor-core peak. The design keeps every
// operand tile in shared memory once per block and the softmax statistics
// in registers.

#include "common.cuh"

extern "C" {

// K2: out = x + Wo . [softmax(q k^T + bias) v + s * softmax(q ki^T) vi] + bo with
// q = LN(x) Wq against precomputed K/V [B, Sk, C] (ki/vi [B, Sk_ip, C] may be
// null; bias [B, Sk] fp32 may be null). q/attn are [B, S, C] scratch buffers.
int apk_fused_ln_cross_attention_kv(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                                    const void* wo, const void* bo, const void* k, const void* v, int Sk,
                                    const void* bias, const void* ki, const void* vi, int Sk_ip, float ip_scale,
                                    void* q, void* attn, void* out, int B, int S, int C, int heads, float eps,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  GemmArgs qs = gemm_args(x, M, C, C);
  qs.ln_w = (const bf16*)ln_w;
  qs.ln_b = (const bf16*)ln_b;
  qs.eps = eps;
  qs.w[0] = (const bf16*)wq;
  qs.c[0] = q;
  int e = launch_gemm<true, false, EPI_STORE>(qs, 1, st);
  if (e) return e;
  e = launch_attention((const bf16*)q, S, (const bf16*)k, (const bf16*)v, Sk, (const float*)bias,
                       (const bf16*)ki, (const bf16*)vi, Sk_ip, ip_scale, (bf16*)attn, B, C, heads,
                       head_scale(C, heads), st);
  if (e) return e;
  GemmArgs o = gemm_args(attn, M, C, C);
  o.w[0] = (const bf16*)wo;
  o.c[0] = out;
  o.bias = (const bf16*)bo;
  o.resid = (const bf16*)x;
  return launch_gemm<false, false, EPI_BIAS_RESID>(o, 1, st);
}

// K10: out = softmax(q kt^T / sqrt(D)) vt + ip_scale * softmax(q ki^T / sqrt(D)) vi,
// q/out [B, Sq, H, D], kt/vt [B, St, H, D], ki/vi [B, Si, H, D], all contiguous
// (so q, the keys and out share the row stride C = H * D that the routine
// assumes); St, Si > 0, D % 16 == 0, D <= 128. Each set runs its own online
// softmax and is normalised in fp32; the sum is rounded to bf16 once.
// Bound by bytes (q and out dominate: a few MB at the UNet's shapes, well
// under a microsecond of HBM time), so in practice by launch latency; the
// grid is (Sq / 64) x H x B blocks, 16 at the UNet's S = 64 level.
int apk_dual_kv_attention(const void* q, const void* kt, const void* vt, int St, const void* ki, const void* vi,
                          int Si, float ip_scale, void* out, int B, int Sq, int H, int D, void* stream) {
  return launch_attention((const bf16*)q, Sq, (const bf16*)kt, (const bf16*)vt, St, nullptr, (const bf16*)ki,
                          (const bf16*)vi, Si, ip_scale, (bf16*)out, B, H * D, H, 1.f / sqrtf((float)D),
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"

extern "C" const char* apk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
