"""The benchmark's plain reference: AudioLDM2 with the AP-adapter and
AudioLDM v1, in plain PyTorch and float32 (TF32 off).

It follows the published model descriptions (diffusers' AudioLDM2 and
AudioLDM pipelines, transformers' CLAP, T5, GPT-2 and SpeechT5 HiFi-GAN, the
AP-adapter's decoupled audio K/V) with the parameter names of those
checkpoints, so the benchmark hands it the same state dict it hands the
program. It imports nothing of the program and nothing of JAX, and has no
kernels, no caches of step invariants and no batching tricks: every UNet
step projects its cross-attention K/V from the context and every timestep
embedding is computed in the step.
"""
