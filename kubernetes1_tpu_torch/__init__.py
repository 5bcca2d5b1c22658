"""kubernetes1_tpu_torch: the PyTorch/CUDA port of kubernetes1_tpu's workloads.

A package of its own beside the JAX one, for an NVIDIA H100.  It imports
nothing of ``kubernetes1_tpu`` (it keeps its own copies of the host-side
helpers it needs) and never imports JAX.  It serves and trains Llama
(``workloads.llama``: the decode server and the train step), trains
ResNet-50 (``workloads.resnet``, ``workloads.resnet_bench``) and BERT's
masked LM (``workloads.bert``), runs ring attention over a
``DeviceMesh`` axis (``workloads.ringattention``) and the Llama bench
payload (``workloads.llama_bench``), with attention (causal and not),
RMSNorm, RoPE, SwiGLU, the cross-entropy, batch norm, LayerNorm,
tanh-GELU and ring attention's merge and accumulating block backward as
hand-written CUDA kernels, forward and backward, and the optimizer
updates (``optim``: AdamW, Adafactor, SGD with momentum) as multi-tensor
kernels (``kernels``, sources in ``csrc``).  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
