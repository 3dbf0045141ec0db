"""The sharded and pipelined frames against the single-device program.

Counterpart of ``videosd_tpu/parallel/verify.py``: the frame program over a
(data, model) mesh (:func:`verify_flagship_dp_tp`) or the 2-stage pipeline
(:func:`verify_pipeline_parallel`), held to the single-device
``build_frame_program`` on the same inputs, random weights.  A tensor split
that cuts a fused QKV weight wrong, drops a partial sum or mixes the GEGLU
halves gives garbage here, trained weights or not.  In fp32 the two differ
only by the order of the partial sums, so the uint8 images agree within
``max_u8_diff`` levels and the latents within 1e-4 (JAX's bars).

``devices`` are the mesh's slots (repeated entries allowed: eight ``cpu``
ones in the CPU tests, ``cuda:0`` several times on a one-card machine);
``dtype`` the bundle's (fp32 for the bars above).  No compile cache is set
up: the port compiles nothing.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["verify_flagship_dp_tp", "verify_pipeline_parallel"]


def _inputs(bundle, b: int, size: int) -> tuple:
    from videosd_tpu_torch.pipelines.lcm_img2img import build_prompt_encoder
    from videosd_tpu_torch.tools.turbo_ladder import structured_frame

    ctx, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    kw = {}
    if bundle.unet_cfg.addition_embed_type == "text_time":
        kw["pooled_embeds"] = pooled.repeat(b, 1)  # SDXL's pooled embeds ride the data axis too
    args = (np.stack([structured_frame(i, size, size) for i in range(b)]), ctx.repeat(b, 1, 1),
            np.linspace(0.4, 0.8, b).astype(np.float32), np.full((b,), 5.0, np.float32),
            np.full((b,), 2.0, np.float32), np.arange(23, 23 + b, dtype=np.int32))
    return args, kw


def _compare(got, want, max_u8_diff: int, extra: dict, what: str) -> dict:
    diff = (got[0].cpu().int() - want[0].cpu().int()).abs()
    lat, lat1 = got[1].cpu().float(), want[1].cpu().float()
    result = {
        "max_diff": int(diff.max()),
        "mean_diff": float(diff.float().mean()),
        "latents_allclose": bool(torch.allclose(lat, lat1, rtol=1e-4, atol=1e-4)),
        "latents_rel_l2": float((lat - lat1).norm() / lat1.norm()),
        **extra,
    }
    if result["max_diff"] > max_u8_diff or not result["latents_allclose"]:
        raise AssertionError(f"{what} != single-device: {result}")
    return result


def verify_flagship_dp_tp(n_devices: int | None = None, *, model_parallel: int | None = None,
                          family: str = "sd15", size: int = 512, steps: int = 4,
                          max_u8_diff: int = 2, devices=None, dtype=torch.float32) -> dict:
    """The ``family`` frame (ControlNet + TAESD, ``size``², ``steps`` steps)
    over an ``n_devices`` mesh against the single-device program on the
    mesh's first device.  Returns ``{"max_diff", "mean_diff",
    "latents_allclose", "latents_rel_l2", "mesh": (dp, tp), "batch"}``;
    raises AssertionError past the bars.  ``model_parallel`` defaults to the
    tallest of 4, 2, 1 that divides the devices, as JAX's."""
    from videosd_tpu_torch.parallel.mesh import make_mesh
    from videosd_tpu_torch.parallel.serving import ShardedFrameEngine
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program

    mesh_devices = list(make_mesh(n_devices, devices=devices).devices.flat)
    n = len(mesh_devices)
    if model_parallel is None:
        model_parallel = max(m for m in (4, 2, 1) if n % m == 0 and m <= n)
    bundle = ModelBundle.random(family, dtype=dtype, device=mesh_devices[0])
    eng = ShardedFrameEngine(bundle, devices=mesh_devices, model_parallel=model_parallel)
    b = eng.data_size
    spec = FrameSpec(batch=b, height=size, width=size, steps=steps)
    args, kw = _inputs(bundle, b, size)
    got = eng.run(spec, *args, **kw)
    want = build_frame_program(bundle, spec)(*args, **kw)
    mesh = (eng.mesh.shape["data"], eng.mesh.shape["model"])
    return _compare(got, want, max_u8_diff, {"mesh": mesh, "batch": b}, "sharded")


def verify_pipeline_parallel(n_devices: int | None = None, *, model_parallel: int = 2,
                             family: str = "tiny", size: int = 64, steps: int = 2,
                             max_u8_diff: int = 2, devices=None, dtype=torch.float32) -> dict:
    """The frame through ``PipelinedFrameEngine`` (two stages, dp x tp in
    each) against the single-device program, after checking that each
    stage's weights sit only on its own slots (by the placement record).
    Returns the keys of :func:`verify_flagship_dp_tp` with ``stage_mesh``
    and ``stages`` in place of ``mesh``, and ``stage_bytes``."""
    from videosd_tpu_torch.parallel.mesh import make_mesh
    from videosd_tpu_torch.parallel.pipe import PipelinedFrameEngine
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program

    mesh_devices = list(make_mesh(n_devices, devices=devices).devices.flat)
    bundle = ModelBundle.random(family, dtype=dtype, device=mesh_devices[0])
    eng = PipelinedFrameEngine(bundle, devices=mesh_devices, model_parallel=model_parallel)
    b = eng.data_size
    spec = FrameSpec(batch=b, height=size, width=size, steps=steps)
    # the capacity claim: each stage's weights occupy only its slots
    meshes = (eng.pipe.mesh0, eng.pipe.mesh1)
    own = [set(int(s) for s in m.slots.flat) for m in meshes]
    for stage in (0, 1):
        for p in eng.placements(stage):
            if not set(p.slots.values()) <= own[stage] or own[0] & own[1]:
                raise AssertionError(f"stage {stage} weights on slots "
                                     f"{sorted(set(p.slots.values()))}, its own {own[stage]}")
    args, kw = _inputs(bundle, b, size)
    got = eng.run(spec, *args, **kw)
    want = build_frame_program(bundle, spec)(*args, **kw)
    extra = {"stage_mesh": (meshes[0].shape["data"], meshes[0].shape["model"]), "stages": 2,
             "batch": b, "stage_bytes": [sum(p.nbytes() for p in eng.placements(s))
                                         for s in (0, 1)]}
    return _compare(got, want, max_u8_diff, extra, "pipelined")
