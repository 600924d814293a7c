"""repro_torch — the PyTorch + CUDA port of the ``repro`` package.

The JAX package (``repro``) is the reference; this package copies its layout
file for file (``repro_torch/x/y.py`` is the counterpart of ``repro/x/y.py``)
and runs on one NVIDIA H100.  It imports ``torch`` and ``numpy`` and nothing
of JAX or of ``repro``.  Every Pallas kernel on a ported path is a CUDA
kernel written by hand for Hopper (``csrc/``), built at first use.
"""
