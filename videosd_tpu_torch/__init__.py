"""videosd_tpu_torch: the PyTorch + CUDA port of videosd_tpu.

It runs the per-frame LCM img2img (+ControlNet) program of
``videosd_tpu.pipelines.lcm_img2img`` on an NVIDIA H100 with PyTorch for
the plain tensor code and hand-written Hopper kernels where the JAX package
has Pallas TPU kernels (``csrc/``, built at first use by ``_build``).  The
JAX package is the reference each part is held against; this package never
imports JAX or ``videosd_tpu``.
"""

from videosd_tpu_torch.version import __version__

__all__ = ["__version__"]
