"""Safety-checker seam of the frame program, on tensors.

Counterpart of ``videosd_tpu/pipelines/safety.py``: a hook applied to the
decoded images (``ModelBundle.safety_hook``, images in [-1,1] -> images)
between the decode and the uint8 postprocess, the combinator that turns a
classifier into such a hook by blacking out flagged images, and the small
built-in skin-chroma classifier.  Off unless a bundle sets a hook.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["default_safety_hook", "make_blackout_hook", "skin_stats_classifier"]


def make_blackout_hook(classify: Callable) -> Callable:
    """Lift ``classify(images01 [B,H,W,3] in [0,1]) -> bool [B]`` into a
    hook ``images_pm1 -> images_pm1`` that sets flagged images to black
    (-1 in the image dtype)."""

    def hook(images_pm1):
        img01 = torch.clamp(images_pm1.float() * 0.5 + 0.5, 0.0, 1.0)
        flagged = classify(img01)
        black = images_pm1.new_tensor(-1.0)
        return torch.where(flagged[:, None, None, None], black, images_pm1)

    return hook


def skin_stats_classifier(threshold: float = 0.5) -> Callable:
    """Flag images whose fraction of skin-chroma pixels (BT.601 full range:
    Cb in [77, 127], Cr in [133, 173]) exceeds ``threshold``.  Returns
    ``classify(img01 [B,H,W,3]) -> bool [B]``."""

    def classify(img01):
        x = img01.float() * 255.0
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        skin = (cb >= 77.0) & (cb <= 127.0) & (cr >= 133.0) & (cr <= 173.0)
        return skin.float().mean(dim=(1, 2)) > threshold

    return classify


def default_safety_hook(threshold: float = 0.5) -> Callable:
    """The built-in hook: :func:`skin_stats_classifier` lifted by
    :func:`make_blackout_hook`."""
    return make_blackout_hook(skin_stats_classifier(threshold))
