"""The benchmark of ap_adapter_torch on the NVIDIA H100 (see run.py)."""
