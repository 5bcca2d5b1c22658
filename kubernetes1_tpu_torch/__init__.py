"""kubernetes1_tpu_torch: the PyTorch/CUDA port of kubernetes1_tpu's workloads.

A package of its own beside the JAX one, for an NVIDIA H100.  It imports
nothing of ``kubernetes1_tpu`` (it keeps its own copies of the host-side
helpers it needs) and never imports JAX.  It serves and trains Llama
(``workloads.llama``: the decode server and the train step), trains
ResNet-50 (``workloads.resnet``, ``workloads.resnet_bench``) and BERT's
masked LM (``workloads.bert``), and runs ring attention over a
``DeviceMesh`` axis (``workloads.ringattention``), with attention (causal
and not), RMSNorm, RoPE, SwiGLU, the cross-entropy, batch norm, LayerNorm,
tanh-GELU and ring attention's merge and accumulating block backward as
hand-written CUDA kernels, forward and backward (``kernels``, sources in
``csrc``).  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
