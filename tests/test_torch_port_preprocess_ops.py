"""The port's frame pre-processing ops and safety classifier against JAX's (fp32, CPU).

Inputs are numpy arrays drawn from a seed; each op runs on both sides:
``crop_resize`` at the geometries of ``tests/test_ops.py`` (exact box,
upscale against the mailbox edge, downscale, the center crop of a camera
frame in a 768x768 mailbox), the static-crop resize of
``preprocess_frame`` against ``jax.image.resize``, the I420 layouts, and
the safety classifier's flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.ops import preprocess as J
from videosd_tpu.pipelines import safety as JS
from videosd_tpu_torch.ops import preprocess as P
from videosd_tpu_torch.pipelines import safety as PS

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)


def _camera_box(cam_hw, out_hw):
    left, top, right, bottom = J.center_crop_box(cam_hw[1], cam_hw[0], out_hw[1], out_hw[0])
    return [top, left, bottom - top, right - left]


# (mailbox H, W), per-element camera extents, per-element boxes, output (H, W)
GEOMETRIES = {
    "exact_box": ((64, 64), [(40, 40), (64, 64)], [[4, 4, 32, 32], [0, 32, 32, 32]], (32, 32)),
    "upscale_mailbox_edge": ((64, 64), [(24, 32), (4, 8)], [[0, 0, 24, 32], [0, 0, 4, 8]], (48, 64)),
    "downscale": ((48, 48), [(48, 48), (48, 40)], [[0, 0, 48, 48], [4, 0, 40, 40]], (32, 32)),
    "camera_768_center_crop": ((768, 768), [(576, 768), (480, 640)],
                               [_camera_box((576, 768), (512, 512)),
                                _camera_box((480, 640), (512, 512))], (512, 512)),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_crop_resize_matches_jax(name):
    (mh, mw), cams, boxes, (oh, ow) = GEOMETRIES[name]
    rng = np.random.default_rng(0)
    mail = np.zeros((len(cams), mh, mw, 3), np.uint8)
    for b, (ch, cw) in enumerate(cams):
        mail[b, :ch, :cw] = rng.integers(0, 256, (ch, cw, 3), dtype=np.uint8)
    box = np.array(boxes, np.int32)
    want = np.asarray(J.crop_resize(jnp.asarray(mail), jnp.asarray(box), oh, ow))
    got = P.crop_resize(torch.from_numpy(mail), torch.from_numpy(box), oh, ow)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw", [(48, 64), (24, 24)], ids=["48x64_down", "24x24_up"])
def test_preprocess_frame_resize_matches_jax_image_resize(in_hw):
    frame = np.random.default_rng(1).integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    want = np.asarray(J.preprocess_frame(jnp.asarray(frame), 32, 32))
    got = P.preprocess_frame(torch.from_numpy(frame), 32, 32)
    assert tuple(got.shape) == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_i420_to_rgb255_matches_jax():
    packed = np.random.default_rng(2).integers(0, 256, (2, 48, 40), dtype=np.uint8)
    want = np.asarray(J.i420_to_rgb255(jnp.asarray(packed)))
    got = P.i420_to_rgb255(torch.from_numpy(packed))
    assert tuple(got.shape) == want.shape == (2, 32, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_rgb_to_i420_within_one_level_of_jax():
    img = np.random.default_rng(3).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    want = np.asarray(J.rgb_to_i420(jnp.asarray(img))).astype(int)
    got = P.rgb_to_i420(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (2, 48, 48)
    diff = np.abs(got.numpy().astype(int) - want)
    print(f"rgb_to_i420: {int((diff > 0).sum())} of {diff.size} samples differ from JAX by 1")
    assert diff.max() <= 1


def test_safety_classifier_and_hook_match_jax():
    """Images with 0-100 % skin-chroma pixels: the flags and the blacked-out
    images equal JAX's at thresholds that do not coincide with a fraction."""
    rng = np.random.default_rng(4)
    # a green background: chroma outside the skin box
    img = (rng.random((6, 16, 16, 3)) * 0.2 + [0.0, 0.6, 0.3]).astype(np.float32)
    skin = np.array([200, 140, 120], np.float32) / 255.0
    for b, frac in enumerate((0.0, 0.2, 0.45, 0.55, 0.8, 1.0)):
        mask = rng.permutation(256)[: int(round(frac * 256))]
        img[b].reshape(-1, 3)[mask] = skin
    pm1 = img * 2.0 - 1.0
    for thr in (-1.0, 0.3, 0.5, 0.7, 1.0):
        want = np.asarray(JS.skin_stats_classifier(thr)(jnp.asarray(img)))
        got = PS.skin_stats_classifier(thr)(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, want)
        out = PS.default_safety_hook(thr)(torch.from_numpy(pm1)).numpy()
        np.testing.assert_array_equal(out, np.asarray(JS.default_safety_hook(thr)(jnp.asarray(pm1))))
    assert PS.skin_stats_classifier(0.5)(torch.from_numpy(img)).tolist() == [False] * 3 + [True] * 3
