"""PyTorch/CUDA port of the HPCC reproduction (``repro``), one slice at a time.

Module paths mirror ``src/repro``: each file here names the reference file it
is held against. The port imports ``torch``, numpy and scipy, never ``jax``
and nothing of ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; every kernel that ``repro`` wrote in Pallas is a
CUDA C++ kernel for Hopper (``kernels/csrc``), and its plain PyTorch version
(``kernels/ref.py``) serves tensors that lie on the CPU.
"""
