"""PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The package mirrors ``src/repro/`` module for module.  Plain tensor code is
PyTorch; the two Pallas kernels of the multi-tenant replay path are CUDA C++
kernels written for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
and bound with ``ctypes`` (:mod:`repro_torch.kernels.build`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor each kernel wrapper runs the kernel's plain PyTorch version.  The
crypto arithmetic is exact: results match the JAX package bit for bit.  The
LM serving path (``configs``, ``models``, ``launch.serve.serve_lm``) and its
training path (``optim``, ``data``, ``checkpoint``, ``runtime``,
``launch.train``) are floating point and plain PyTorch ops; they match the
JAX package within the tolerances their tests state.
"""
