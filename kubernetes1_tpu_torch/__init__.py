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

It also carries the ``nvidia.com/gpu`` device plane, the counterpart of
the JAX package's ``google.com/tpu`` one: a device plugin
(``deviceplugin.gpu_plugin``) that speaks the kubelet's plugin protocol
over its own copy of the wire code (``deviceplugin.api``), advertises
each card with its model, memory and UUID and hands the card to a pod
through ``CUDA_VISIBLE_DEVICES``; and the specs a pod that wants a card
is built from (``workloads.specs``, ``workloads.llama.serving_deployment``),
in the pod-level ``extendedResources`` form the orchestrator admits; and
the pod launcher (``workloads.launch``) that starts a multi-card pod of
an Indexed Job as one process a card under torchrun, from the rank,
world and coordinator the plugin injects.

It speaks to the orchestrator's apiserver through a client of its own
(``client``: REST calls and a list+watch informer over wire-form dicts),
on which run the RL actor/learner workload and its churn driver
(``workloads.rl_actor``) and the serving fleet with its rolling update
(``workloads.servefleet``).
"""

GPU_RESOURCE = "nvidia.com/gpu"
