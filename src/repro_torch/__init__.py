"""PyTorch and CUDA port of the Saddle-SVC solver.

A second package beside the JAX reference ``repro``: the same algorithms
and layouts, written with torch tensors, whose dense passes run through
hand-written CUDA kernels on an NVIDIA Hopper card (``kernels/csrc``) and
through their plain PyTorch versions on the CPU.  It imports nothing of
JAX and nothing of ``repro``.
"""
