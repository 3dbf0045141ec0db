"""Kernel K2's module (``ops/cuda/preprocess_kernel.py``) against the JAX one.

On the CPU the wrappers take their plain versions, which are held against
the JAX ``fused_preprocess`` and ``sobel_magnitude_pallas`` with the Pallas
stencil run in interpret mode, as ``tests/test_preprocess_kernel.py`` runs
it.  Bars: img within 1e-5; the magnitude within 1 fp32 ulp; the edge map
within JAX's own bar (at most 0.1 % of pixels off by more than 1e-4) and
within 2e-6 relative elsewhere.  Under ``jax.jit`` XLA rounds the luma and
the normalization differently from the same math run op by op: measured,
73 % of edge pixels differ by 1-2 ulp (<= 1.02e-6 relative), and at
256x128 7 pixels (0.021 %) differ by up to 2.3e-3, where the luma floor
falls on the other side.  Against JAX's op-by-op math the plain version is
exact.  The CUDA kernel runs only on the card, in
``tests/test_torch_port_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videosd_tpu.ops import sobel as JS
from videosd_tpu.ops.pallas import preprocess_kernel as JK
from videosd_tpu_torch.ops import preprocess as PP
from videosd_tpu_torch.ops import sobel as PS
from videosd_tpu_torch.ops.cuda import preprocess_kernel as K2

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("hw", [(128, 128), (256, 128)], ids=["128x128", "256x128"])
def test_fused_preprocess_matches_interpreted_kernel(hw, dtype):
    jdt, tdt = _DTYPES[dtype]
    frame = np.random.default_rng(42).integers(0, 256, (*hw, 3), dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        jimg, jedge = JK.fused_preprocess(jnp.asarray(frame), 0.11, 0.8, out_dtype=jdt)
    launches = K2.launches
    img, edge = K2.fused_preprocess(torch.from_numpy(frame), 0.11, 0.8, out_dtype=tdt)
    assert K2.launches == launches  # CPU tensors never launch the kernel
    assert img.dtype == tdt and img.shape == (*hw, 3) and edge.shape == hw
    np.testing.assert_allclose(img.float().numpy(), np.asarray(jimg, np.float32), atol=1e-5, rtol=0)
    got, want = edge.numpy(), np.asarray(jedge)
    # JAX's own bar: the rest of the pixels sit on a luma floor boundary
    boundary = np.abs(got - want) > 1e-4
    assert boundary.mean() < 0.001
    np.testing.assert_allclose(got[~boundary], want[~boundary], rtol=2e-6, atol=0)
    assert 0.0 < (got == 1.0).mean() < 0.5 and (got == 0.0).mean() > 0.0
    # the plain version is JAX's op-by-op math exactly
    x01 = jnp.asarray(frame, jnp.float32) / 255.0
    np.testing.assert_array_equal(got, np.asarray(JS.sobel_edges(JS.rgb_to_gray(x01), 0.11, 0.8)))


def test_sobel_magnitude_matches_interpreted_kernel():
    gray = np.random.default_rng(3).random((128, 256)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK.sobel_magnitude_pallas(jnp.asarray(gray)))
    got = K2.sobel_magnitude(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_plain_version_is_the_frame_program_path():
    """At a camera size off the TPU's 128-tiling, the plain version is
    exactly the port's preprocess_frame + sobel_control_image."""
    frame = np.random.default_rng(4).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    img, edge = K2.fused_preprocess_reference(torch.from_numpy(frame), out_dtype=torch.float32)
    x01 = PP.preprocess_frame(torch.from_numpy(frame)[None], 480, 640)[0]
    np.testing.assert_array_equal(edge.numpy(), PS.sobel_control_image(x01)[..., 0].numpy())
    np.testing.assert_array_equal(img.numpy(), (x01 * 2.0 - 1.0).numpy())


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        K2.fused_preprocess(torch.zeros(8, 8, 3, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        K2.sobel_magnitude(torch.zeros(8, 8, device="meta"))
