"""PyTorch + CUDA build of the AP-adapter AudioLDM2 edit pipeline.

The counterpart of ``ap_adapter_tpu`` (which stays the numerical reference):
the same modules under the same names, written with ``torch.nn`` and plain
tensor functions. The three fused UNet kernels (pre-LN self-attention,
pre-LN cross-attention over hoisted K/V, pre-LN GEGLU feed-forward) are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use
and bound through ``ctypes``; on CPU tensors their plain PyTorch versions run.

Public layouts follow the JAX package: latents NHWC ``[B, T, F, C]``,
attention activations ``[B, S, C]``, conditioning tokens ``[B, S, D]``.
Parameter names follow the HF/diffusers state-dict keys.
"""

from ap_adapter_torch.configs import PipelineConfig, tiny_pipeline_config

__all__ = ["PipelineConfig", "tiny_pipeline_config"]
