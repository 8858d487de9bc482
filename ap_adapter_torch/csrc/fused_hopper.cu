// Hopper (sm_90a) kernels for the fused UNet transformer-block ops and the
// bare dual-KV attention:
//
//   K1 ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention
//      (its _kernel_pipe/_kernel_t/_kernel_kt reorder the same function for
//      the TPU's lanes)
//   K2 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_kv
//   K4 ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention
//   K3 ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff
//   K10 ap_adapter_tpu/ops/pallas_attention.py::fused_dual_kv_attention
//
// The entry points (extern "C", plain C ABI for ctypes) chain the routines
// of hopper_gemm.cuh and the attention below:
//   K1 = LN rows -> QKV GEMM (three weight sets, one launch, bf16 store)
//        -> register-resident attention -> out GEMM + bias + residual
//   K2 = LN rows -> Q GEMM (bf16 store) -> register-resident attention over
//        the hoisted text K/V (with its fp32 key bias, if any) and the
//        adapter K/V -> out GEMM + bias + residual
//   K4 = the context K/V GEMM (hopper_gemm.cuh's launch_ctx_kv: the text
//        and adapter rows of the context through one 3-D tensor map each,
//        2 or 4 weight sets in one launch), then K2's four launches over
//        the K/V it projected (K4 is the training forward: K/V are not
//        hoisted there)
//   K3 = LN rows -> W1 GEMM with the GEGLU epilogue -> W2 GEMM + bias +
//        residual
//   K10 = the register-resident attention alone, over both key sets
// Every GEMM's tile width and split-K and every key set's tile width come
// from the wrapper's plan (ops/hopper_gemm.py::gemm_plan,
// ops/fused_cross.py::key_tile). The intermediates (LN(x), q/k/v, the
// attention output, the GEGLU product) live in one scratch buffer that the
// wrapper allocates. Every entry point returns the cudaGetLastError() code
// of its first failing launch (0 on success).
//
// What bounds them on an H100 at the edit's shapes (B = 2; S = 1000, 252,
// 64; C = 256, 384, 640): 0.8-3.2 us a call, bf16 tensor-core operations
// at S = 1000 and 252, the weights' bytes at S = 64 (chip_smoke.py's
// bound_ms), so in practice each launch's own latency. The first port's
// chains (a WMMA GEMM and a streamed attention) reached 1.5-2% of that:
// WMMA without a load pipeline, every block recomputing its rows'
// LayerNorm statistics, 20 CTAs for 132 SMs at M = 128, and an attention
// that staged every key tile's logits, the PV product and the running
// output in shared memory as fp32. Here: wgmma fed by TMA through a ring
// of stages, LN once per row, split-K clusters where
// the output tiles are fewer than the SMs, and a register-resident attention.
//
// The attention is reg_attention_kernel (reg_attention.cuh), which K11b
// and K11c (int8_blocks.cu) run too, with an fp32 store.

#include "hopper_gemm.cuh"
#include "reg_attention.cuh"

namespace {

// softmax(q k1^T d^-1/2 + bias) v1 (+ ip_scale * softmax(q k2^T d^-1/2) v2)
// into bf16 out (reg_attention.cuh)
int launch_reg_attention(const bf16* q, const FaKeys& s1, const FaKeys& s2, float ip_scale, bf16* out, int B, int S,
                         int H, int d, cudaStream_t st) {
  return launch_reg_attention<bf16>(q, s1, s2, ip_scale, out, B, S, H, d, FA_LOG2E / sqrtf((float)d), st);
}

// K2's chain after the K/V: out = x + Wo . [softmax(q k^T d^-1/2 + bias) v +
// ip_scale * softmax(q ki^T d^-1/2) vi] + bo with q = LN(x) Wq: LN rows -> Q
// GEMM (bf16 store) -> the two-key-set attention -> out GEMM + bias +
// residual. scratch holds 3 x [B, S, C] bf16 (LN(x), q, the attention output).
int cross_attention_chain(const void* x, const void* ln_w, const void* ln_b, const void* wq, const void* wo,
                          const void* bo, const FaKeys& text, const FaKeys& adapter, float ip_scale, void* scratch,
                          void* out, int B, int S, int C, int heads, float eps, int q_bn, int q_split, int q_stages,
                          int out_bn, int out_split, int out_stages, cudaStream_t st) {
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16 *q = xn + mc, *attn = q + mc;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs qa = {};
  qa.c[0] = q;
  e = launch_hgemm(qa, xn, &wq, 1, M, C, C, q_bn, q_split, q_stages, HG_STORE, st);
  if (e) return e;
  e = launch_reg_attention(q, text, adapter, ip_scale, attn, B, S, heads, C / heads, st);
  if (e) return e;
  HgArgs o = {};
  o.c[0] = static_cast<bf16*>(out);
  o.bias = static_cast<const bf16*>(bo);
  o.resid = static_cast<const bf16*>(x);
  return launch_hgemm(o, attn, &wo, 1, M, C, C, out_bn, out_split, out_stages, HG_BIAS_RESID, st);
}

}  // namespace

extern "C" {

// K1: out = x + Wo . MHA(LN(x) Wq, LN(x) Wk, LN(x) Wv) + bo, x [B, S, C];
// scratch holds 5 x [B, S, C] bf16 (LN(x), q, k, v, the attention output).
// (qkv_bn, qkv_split, qkv_stages) and (out_bn, out_split, out_stages) plan
// the two GEMMs: tile width, split-K and ring stages.
int apk_fused_ln_self_attention(const void* x, const void* ln_w, const void* ln_b, const void* wq, const void* wk,
                                const void* wv, const void* wo, const void* bo, void* scratch, void* out, int B, int S,
                                int C, int heads, float eps, int qkv_bn, int qkv_split, int qkv_stages, int out_bn,
                                int out_split, int out_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t mc = (size_t)M * C;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16 *q = xn + mc, *k = q + mc, *v = k + mc, *attn = v + mc;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs qkv = {};
  const void* wqkv[3] = {wq, wk, wv};
  qkv.c[0] = q; qkv.c[1] = k; qkv.c[2] = v;
  e = launch_hgemm(qkv, xn, wqkv, 3, M, C, C, qkv_bn, qkv_split, qkv_stages, HG_STORE, st);
  if (e) return e;
  const FaKeys keys = {k, v, nullptr, S, FA_TK}, none = {nullptr, nullptr, nullptr, 0, FA_TK};
  e = launch_reg_attention(q, keys, none, 0.f, attn, B, S, heads, C / heads, st);
  if (e) return e;
  HgArgs o = {};
  o.c[0] = static_cast<bf16*>(out);
  o.bias = static_cast<const bf16*>(bo);
  o.resid = static_cast<const bf16*>(x);
  return launch_hgemm(o, attn, &wo, 1, M, C, C, out_bn, out_split, out_stages, HG_BIAS_RESID, st);
}

// K2: out = x + Wo . [softmax(q k^T d^-1/2 + bias) v + ip_scale * softmax(q ki^T d^-1/2) vi] + bo,
// q = LN(x) Wq, over the hoisted K/V: k/v [B, Sk, C]; ki/vi [B, Sk_ip, C]
// (null with Sk_ip = 0: no adapter set); bias [B, Sk] fp32 or null. scratch
// holds 3 x [B, S, C] bf16 (LN(x), q, the attention output). tk / tk_ip:
// keys a tile of each set; (q_bn, q_split, q_stages) and (out_bn, out_split,
// out_stages) plan the two GEMMs.
int apk_fused_ln_cross_attention_kv(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                                    const void* wo, const void* bo, const void* k, const void* v, int Sk,
                                    const void* bias, const void* ki, const void* vi, int Sk_ip, float ip_scale,
                                    void* scratch, void* out, int B, int S, int C, int heads, float eps, int tk,
                                    int tk_ip, int q_bn, int q_split, int q_stages, int out_bn, int out_split,
                                    int out_stages, void* stream) {
  const FaKeys text = {static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const float*>(bias),
                       Sk, tk};
  const FaKeys adapter = {static_cast<const bf16*>(ki), static_cast<const bf16*>(vi), nullptr, ki ? Sk_ip : 0,
                          tk_ip};
  return cross_attention_chain(x, ln_w, ln_b, wq, wo, bo, text, adapter, ip_scale, scratch, out, B, S, C, heads, eps,
                               q_bn, q_split, q_stages, out_bn, out_split, out_stages,
                               static_cast<cudaStream_t>(stream));
}

// K4: K2 over K/V projected here from the raw context: text K/V =
// ctx[:, :sk_text] . Wk^T / Wv^T and adapter K/V = ctx[:, sk_text:] . Wki^T /
// Wvi^T (wki/wvi null: no adapter set, the whole context is text), in one
// launch of the context K/V GEMM, then K2's chain. ctx [B, Sk_total, Dc];
// bias [B, sk_text] fp32 or null. kv holds k, v [B, sk_text, C], then ki, vi
// [B, Sk_total - sk_text, C] (bf16), scratch K2's 3 x [B, S, C]; tk / tk_ip
// and (kv_*), (q_*), (out_*) as the wrapper's plan (ops/fused_cross.py::k4_plan) says.
int apk_fused_ln_cross_attention(const void* x, const void* ctx, int Sk_total, int Dc, int sk_text,
                                 const void* ln_w, const void* ln_b, const void* wq, const void* wk, const void* wv,
                                 const void* wki, const void* wvi, const void* wo, const void* bo, float ip_scale,
                                 const void* bias, void* kv, void* scratch, void* out, int B, int S, int C,
                                 int heads, float eps, int tk, int tk_ip, int kv_bn, int kv_split, int kv_stages,
                                 int q_bn, int q_split, int q_stages, int out_bn, int out_split, int out_stages,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sk_ip = wki != nullptr ? Sk_total - sk_text : 0;
  if (sk_ip > 0 && wvi == nullptr) return (int)cudaErrorInvalidValue;
  bf16* k = static_cast<bf16*>(kv);
  bf16* v = k + (size_t)B * sk_text * C;
  bf16* ki = v + (size_t)B * sk_text * C;
  bf16* vi = ki + (size_t)B * sk_ip * C;
  const void* w[4] = {wk, wv, wki, wvi};
  bf16* const kvo[4] = {k, v, ki, vi};
  int e = launch_ctx_kv(ctx, B, Sk_total, Dc, sk_text, sk_ip, w, kvo, C, kv_bn, kv_split, kv_stages, st);
  if (e) return e;
  const FaKeys text = {k, v, static_cast<const float*>(bias), sk_text, tk};
  const FaKeys adapter = {ki, vi, nullptr, sk_ip, tk_ip};
  return cross_attention_chain(x, ln_w, ln_b, wq, wo, bo, text, adapter, ip_scale, scratch, out, B, S, C, heads, eps,
                               q_bn, q_split, q_stages, out_bn, out_split, out_stages, st);
}

// K3: out = x + W2 . (a * gelu_erf(g)) + b2 with [a | g] = LN(x) W1 + b1;
// w1 [2*inner, C], w2 [C, inner]; scratch holds [B, S, C] (LN(x)) and
// [B, S, inner] (the GEGLU product) bf16. The W1 GEMM takes 64-wide tiles
// (value and gate accumulators side by side) split w1_split ways with
// w1_stages, the W2 GEMM (w2_bn, w2_split, w2_stages).
int apk_fused_ln_geglu_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* scratch, void* out, int B, int S, int C, int inner,
                          float eps, int w1_split, int w1_stages, int w2_bn, int w2_split, int w2_stages,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  bf16* xn = static_cast<bf16*>(scratch);
  bf16* y = xn + (size_t)M * C;
  int e = launch_ln_rows(x, ln_w, ln_b, xn, M, C, eps, st);
  if (e) return e;
  HgArgs g1 = {};
  g1.c[0] = y;
  g1.bias = static_cast<const bf16*>(b1);
  e = launch_hgemm(g1, xn, &w1, 1, M, inner, C, 64, w1_split, w1_stages, HG_GEGLU, st);
  if (e) return e;
  HgArgs g2 = {};
  g2.c[0] = static_cast<bf16*>(out);
  g2.bias = static_cast<const bf16*>(b2);
  g2.resid = static_cast<const bf16*>(x);
  return launch_hgemm(g2, y, &w2, 1, M, C, inner, w2_bn, w2_split, w2_stages, HG_BIAS_RESID, st);
}

// K10: out = softmax(q kt^T D^-1/2) vt + ip_scale * softmax(q ki^T D^-1/2) vi,
// q/out [B, Sq, H, D], kt/vt [B, St, H, D], ki/vi [B, Si, H, D], all
// contiguous (row stride C = H * D, as K2's [B, S, C]); St, Si >= 1;
// tk_t / tk_i: keys a tile of each set. One launch of the attention above.
int apk_dual_kv_attention(const void* q, const void* kt, const void* vt, int St, const void* ki, const void* vi,
                          int Si, float ip_scale, void* out, int B, int Sq, int H, int D, int tk_t, int tk_i,
                          void* stream) {
  if (Si < 1) return (int)cudaErrorInvalidValue;
  const FaKeys text = {static_cast<const bf16*>(kt), static_cast<const bf16*>(vt), nullptr, St, tk_t};
  const FaKeys audio = {static_cast<const bf16*>(ki), static_cast<const bf16*>(vi), nullptr, Si, tk_i};
  return launch_reg_attention(static_cast<const bf16*>(q), text, audio, ip_scale, static_cast<bf16*>(out), B, Sq, H,
                              D, static_cast<cudaStream_t>(stream));
}

const char* apk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
