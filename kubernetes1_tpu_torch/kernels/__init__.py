"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every module holds one kernel's wrapper (a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises), the plain version,
and the ``KERNEL`` object that binds the C entry point and counts its
launches.  ``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
