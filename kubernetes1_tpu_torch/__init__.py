"""kubernetes1_tpu_torch: the PyTorch/CUDA port of kubernetes1_tpu's workloads.

A package of its own beside the JAX one, for an NVIDIA H100.  It imports
nothing of ``kubernetes1_tpu`` (it keeps its own copies of the host-side
helpers it needs) and never imports JAX.  Its first slice is the Llama
decode server (``workloads.llama``), with attention, RMSNorm and RoPE as
hand-written CUDA kernels (``kernels``, sources in ``csrc``).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
