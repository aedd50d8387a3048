"""PyTorch/CUDA port of ``uuo_mocap_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
and function names so each counterpart is easy to find.  Plain tensor code
is PyTorch; the nearest-vertex kernels that the JAX package wrote in Pallas
are CUDA C++ kernels for ``sm_90a`` (``csrc/chamfer.cu``, bound in
``ops/chamfer_kernels.py``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""
