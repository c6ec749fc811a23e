"""Hand-written CUDA kernels for Hopper (sm_90a), one package each.

Each package holds ``csrc/<name>.cu`` (the kernel, with a plain C entry
point), ``ref.py`` (its plain PyTorch version — the oracle and the CPU
path) and ``ops.py`` (the wrapper: CUDA tensors launch the kernel or
raise, CPU tensors run the plain version, and a launch counter shows
which ran).  ``_build.py`` compiles a kernel with ``nvcc`` at first use.
"""
