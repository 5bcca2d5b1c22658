"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every module holds one op's wrapper (a CPU tensor takes the plain
version, which autograd differentiates; a CUDA tensor launches the kernel
or raises, through a ``torch.autograd.Function`` whose backward is a
kernel too where a gradient is wanted), the plain forward and backward,
and the ``build.Kernel`` objects (``KERNEL``, ``KERNEL_BWD``; batch norm's
``KERNEL_STATS``, ``KERNEL_APPLY``, ``KERNEL_BWD``; non-causal attention's
``KERNEL_NC``, ``KERNEL_BWD_NC``; the cross-entropy over f32 logits'
``KERNEL_F32``, ``KERNEL_BWD_F32``; ring attention's ``RING_BLOCK``,
``RING_BLOCK_NC``, ``RING_MERGE``, ``RING_BLOCK_BWD``, ``RING_BLOCK_BWD_NC``;
the optimizers' ``KERNEL_ADAMW``, ``KERNEL_ADAFACTOR``, ``KERNEL_SGDM``, whose
wrappers take a ``LeafTable`` of every weight) that bind the C entry points
and count their launches.  ``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
