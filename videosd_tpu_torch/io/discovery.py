"""Local HF-cache checkpoint discovery (nothing downloads): the port's copy
of ``videosd_tpu/io/discovery.py`` (held equal by
``tests/test_torch_port_copies.py``).

``weights: auto`` picks the newest cached snapshot of the configured repos
in the hub-cache layout (``~/.cache/huggingface/hub``), an explicit
directory is used as it is, and ``random`` skips discovery.
"""

from __future__ import annotations

import os

__all__ = ["find_snapshot", "resolve_weights", "DEFAULT_TAESD"]

# the reference swaps in the tiny VAE from this repo (videopipeline.py:67)
DEFAULT_TAESD = "madebyollin/taesd"


def find_snapshot(repo_id: str, cache: str | None = None) -> str | None:
    """Newest local HF-hub snapshot dir for ``repo_id``, or None."""
    if not repo_id:
        return None
    cache = cache or os.environ.get(
        "HF_HUB_CACHE", os.path.expanduser("~/.cache/huggingface/hub")
    )
    d = os.path.join(cache, "models--" + repo_id.replace("/", "--"), "snapshots")
    if os.path.isdir(d):
        snaps = sorted(
            os.listdir(d), key=lambda s: os.path.getmtime(os.path.join(d, s))
        )
        if snaps:
            return os.path.join(d, snaps[-1])
    return None


def resolve_weights(
    model: str | None,
    *,
    controlnet: str | None = None,
    taesd: str | None = DEFAULT_TAESD,
    setting: str = "auto",
    cache: str | None = None,
) -> dict | None:
    """Resolve the ``weights`` config key to checkpoint directories.

    Returns ``{"model_dir", "controlnet_dir", "taesd_dir"}`` (values may
    be None for the optional components) or None when serving should
    random-init:

    - ``setting == "random"`` → None.
    - ``setting == "auto"`` → newest cached snapshot of ``model``; None if
      no snapshot exists (the caller falls back to random init, loudly).
    - anything else → an explicit ask: a directory path is used verbatim,
      a repo id is looked up in the cache; a miss raises
      ``FileNotFoundError`` (an explicit ask must never silently degrade).

    ControlNet / TAESD are best-effort in every mode: a missing snapshot
    leaves the corresponding dir None (random-init ControlNet is a safe
    no-op — its output convs are zero — and random TAESD is only reached
    with ``vae: taesd``, which real deployments pair with the tiny-VAE
    snapshot the reference also pulls, videopipeline.py:67-69).
    """
    setting = str(setting or "random").strip()
    if setting.lower() == "random":
        return None
    if setting.lower() == "auto":
        model_dir = find_snapshot(model, cache)
        if model_dir is None:
            return None
    elif os.path.isdir(setting):
        model_dir = setting
    else:
        model_dir = find_snapshot(setting, cache)
        if model_dir is None:
            raise FileNotFoundError(
                f"weights: {setting!r} is neither a directory nor a cached "
                f"HF snapshot (cache={cache or '~/.cache/huggingface/hub'})"
            )
    return {
        "model_dir": model_dir,
        "controlnet_dir": find_snapshot(controlnet, cache),
        "taesd_dir": find_snapshot(taesd, cache),
    }
