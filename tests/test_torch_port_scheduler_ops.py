"""The port's scheduler and frame ops against the JAX package (CPU).

The ladder and the uint8 ops must match exactly: the ladder is integer
math, and the Sobel thresholds must land on the same pixels.  The float
scheduler steps are held at fp32 resolution (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.ops import preprocess as JP
from videosd_tpu.ops import sobel as JS
from videosd_tpu.schedulers import lcm as JL
from videosd_tpu_torch.ops import preprocess as PP
from videosd_tpu_torch.ops import sobel as PS
from videosd_tpu_torch.schedulers import lcm as PLCM

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_CFG_J, _CFG_P = JL.LCMSchedulerConfig(), PLCM.LCMSchedulerConfig()
_ALPHAS = JL.make_alphas_cumprod(_CFG_J)


@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_timestep_schedule_per_element(steps):
    """Per-element strengths, including ones with fewer valid steps than
    ``steps`` (the masked ladder) and one with none."""
    strength = np.array([1.0, 0.6, 0.5, 0.3, 0.1, 0.04, 0.02, 0.0], np.float32)
    ts, valid = PLCM.timestep_schedule(_CFG_P, steps, torch.from_numpy(strength))
    jts, jvalid = jax.vmap(lambda s: JL.timestep_schedule(_CFG_J, steps, s))(
        jnp.asarray(strength)
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    if steps >= 2:
        assert 0 < valid[6].sum() < steps  # strength 0.02: a partial ladder


def test_add_noise_and_step(rng):
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    t = np.array([999, 519, 39], np.int64)
    t_prev = np.array([759, 259, 39], np.int64)
    alphas = torch.from_numpy(_ALPHAS)
    np.testing.assert_allclose(
        PLCM.add_noise(alphas, torch.from_numpy(x), torch.from_numpy(noise),
                       torch.from_numpy(t)).numpy(),
        np.asarray(JL.add_noise(_ALPHAS, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))),
        atol=1e-6, rtol=1e-6,
    )
    for multistep in (True, False):
        got = PLCM.step(_CFG_P, alphas, torch.from_numpy(eps), torch.from_numpy(t),
                        torch.from_numpy(t_prev), torch.from_numpy(x),
                        noise=torch.from_numpy(noise), multistep=multistep)
        want = JL.step(_CFG_J, _ALPHAS, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev),
                       jnp.asarray(x), noise=jnp.asarray(noise), multistep=multistep)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("in_hw", [(32, 32), (48, 32), (32, 40)])
def test_preprocess_crop_exact(rng, in_hw):
    frame = rng.integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    got = PP.preprocess_frame(torch.from_numpy(frame), 32, 32).numpy()
    want = np.asarray(JP.preprocess_frame(jnp.asarray(frame), 32, 32))
    np.testing.assert_array_equal(got, want)


def test_preprocess_resize_not_ported(rng):
    """A crop that needs a resize (here an exact 2x decimation) goes through
    the port's copy of ``jax.image.resize``'s lanczos3 weights."""
    frame = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    got = PP.preprocess_frame(torch.from_numpy(frame), 32, 32).numpy()
    want = np.asarray(JP.preprocess_frame(jnp.asarray(frame), 32, 32))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_postprocess_exact(rng):
    img = rng.uniform(-1.2, 1.2, (2, 16, 16, 3)).astype(np.float32)
    img[0, 0, :4, 0] = [(k + 0.5) / 255.0 * 2 - 1 for k in (0, 1, 2, 3)]  # round-half ties
    got = PP.postprocess_image(torch.from_numpy(img)).numpy()
    want = np.asarray(JP.postprocess_image(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sobel_control_image_exact(seed):
    """uint8 inputs: luma floor, per-image max and both thresholds land on
    the same pixels."""
    r = np.random.default_rng(seed)
    frame = r.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    frame[1, 8:24, 8:24] = 200  # flat patch: edges on its border only
    img01 = frame.astype(np.float32) / 255.0
    got = PS.sobel_control_image(torch.from_numpy(img01)).numpy()
    want = np.asarray(JS.sobel_control_image(jnp.asarray(img01)))
    np.testing.assert_array_equal(got, want)
    assert ((got > 0) & (got < 1)).any() and (got == 1).any() and (got == 0).any()
    np.testing.assert_array_equal(
        PS.rgb_to_gray(torch.from_numpy(img01)).numpy(),
        np.asarray(JS.rgb_to_gray(jnp.asarray(img01))),
    )
