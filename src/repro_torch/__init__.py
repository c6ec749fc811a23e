"""repro_torch — the serverless MapReduce framework on PyTorch and CUDA.

A port of the ``repro`` package (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU, module for module: ``repro_torch/engine/plan.py`` is the
partner of ``repro/engine/plan.py``.  It imports torch and numpy, never
JAX and nothing of ``repro``; the framework-free host modules are copied,
not imported.

This slice carries the paper's main path — the windowed streaming
aggregate over an event log with exactly-once sinks::

    event log → StreamSource micro-batches → StreamingCoordinator
      → CompiledStreamAggregate.step (the fused fold) → ObjectStore sink

with the fused fold as a hand-written CUDA kernel
(``kernels/fused_fold/csrc/fused_fold.cu``).  Beside it: array (batch)
pipelines with the ``hash_combine`` kernel, and LM serving
(``models``, ``launch/serve.py``) for the dense attention family, with the
``flash_attention`` kernels, and for Mamba-1 (falcon-mamba-7b), with the
``mamba_scan`` kernel.  Around them the paper's own system: the host
batch job (``core``: Coordinator → Splitter → Mappers → Reducers →
Finalizer over the object store) and the multi-tenant job service
(``service.JobServer``, ``launch.serve.JobRPC`` / ``JobSocketServer``),
whose tenants fold on the device their programs were built for.  Entry
points take a
``device`` and default to ``"cuda"``; a build on a host without CUDA
raises unless the caller asks for ``device="cpu"``, where each kernel's
wrapper runs its plain PyTorch version.  What is not ported yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""
