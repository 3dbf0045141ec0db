"""Configuration surface of the serving engine: the port's copy of
``videosd_tpu/config.py``.

The same ``config.yaml`` keys, live per-stream option table and
``ServerConfig`` as the JAX package (held equal by
``tests/test_torch_port_copies.py``); the one difference is that the
``lora`` setting's normalizer (``videosd_tpu/io/lora.py``) is copied here,
so nothing of the JAX package is imported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import yaml

__all__ = [
    "ServerConfig",
    "StreamOptions",
    "coerce_option",
    "coerce_options",
    "default_options",
    "load_config",
]


# Live per-stream option schema.  Keys + coercions re-state the reference's
# data-channel handler (server.py:171-187); defaults re-state the client's
# initOptions (index.tsx:35-47).
_OPTION_COERCIONS = {
    "prompt": str,
    "strength": float,
    "steps": int,
    "guidance_scale": float,
    "controlnet_scale": float,
    "style_fidelity": float,
    "reference_attn": bool,
    "reference_adain": bool,
    "seed": int,
    "ref": bool,
    "controlnet": bool,
    "width": int,
    "height": int,
    "negative_prompt": str,
    # TPU-native extensions (not in the reference protocol; unknown keys
    # pass through, so reference clients are unaffected)
    "similarity_threshold": float,
    "warm_alpha": float,
    "jpeg": bool,  # WS transport: server returns JPEG blobs
    "prompt_blend_frames": int,  # crossfade embeddings on prompt change
    # ControlNet evaluation interval (1 = every step, reference parity;
    # k>1 reuses residuals between evals — ~23% of device time at k=4,
    # see FrameSpec.controlnet_interval).  Bucket-keyed: changing it
    # compiles a new program variant (served via nearest-ready fallback
    # meanwhile, like the steps slider).
    "controlnet_interval": int,
    # DeepCache interval (1 = full UNet every step, reference parity;
    # k>1 reuses the deep UNet trunk between evals, recomputing only the
    # shallow high-res blocks — see FrameSpec.deepcache_interval).
    # Bucket-keyed like controlnet_interval: changing it compiles a new
    # program variant, served via nearest-ready fallback meanwhile.
    "deepcache_interval": int,
    # temporal DeepCache cadence (0 = off; N>=1 = refresh the per-step
    # deep-trunk caches every N frames and reuse them in between —
    # cross-FRAME trunk reuse, FrameSpec.deepcache_temporal).  The
    # strongest single-chip turbo lever (reuse frames drop the whole
    # deep trunk); quality decays with distance from the last refresh
    # (tools/temporal_gate.py).  Mutually exclusive with
    # deepcache_interval>1 (temporal wins).
    "deepcache_temporal": int,
    # refresh interval caches on the FINAL denoise step too (quality
    # recovery for interval>1 configs — the last step's freshness
    # dominates output quality, PERF.md round-4 trained-weight gates).
    # No effect when both intervals are 1.
    "interval_refresh_last": bool,
    # named checkpoint from the server's `models:` registry ("" = the
    # config default).  Same-family checkpoints share every compiled
    # program (params are a program ARGUMENT), so switching models live
    # never recompiles — batches simply group per model.  The reference
    # serves exactly one checkpoint per process (videopipeline.py:49-72).
    "model": str,
}

_OPTION_DEFAULTS = {
    "prompt": "portrait of a person, pixar, cg",
    "strength": 0.6,
    "guidance_scale": 5.0,
    "steps": 4,
    "seed": 23,
    "ref": False,
    "style_fidelity": 1.0,
    # independent mechanism toggles (lcm_reference_pipeline.py:426-427);
    # traced as per-mechanism fidelities, so flips never recompile
    "reference_attn": True,
    "reference_adain": True,
    "controlnet": True,
    "controlnet_scale": 2.0,
    "width": 512,
    "height": 512,
    "negative_prompt": "",
}


def default_options() -> dict[str, Any]:
    """Fresh copy of the client-default option dict (index.tsx:35-47)."""
    return dict(_OPTION_DEFAULTS)


def coerce_option(key: str, value: Any) -> Any:
    """Coerce one incoming data-channel value (server.py:171-187).

    Unknown keys pass through untouched, like the reference's generic
    ``options[key] = value`` merge (server.py:194-195).
    """
    fn = _OPTION_COERCIONS.get(key)
    if fn is None:
        return value
    if fn is bool and isinstance(value, str):
        # JSON booleans arrive as bools, but be tolerant of "true"/"false".
        return value.strip().lower() not in ("", "0", "false", "no")
    return fn(value)


def coerce_options(message: dict[str, Any]) -> dict[str, Any]:
    return {k: coerce_option(k, v) for k, v in message.items()}


@dataclasses.dataclass
class StreamOptions:
    """Typed view over the live options dict (for internal use)."""

    prompt: str = _OPTION_DEFAULTS["prompt"]
    negative_prompt: str = ""
    strength: float = 0.6
    steps: int = 4
    guidance_scale: float = 5.0
    controlnet_scale: float = 2.0
    style_fidelity: float = 1.0
    seed: int = 23
    ref: bool = False
    controlnet: bool = True
    width: int = 512
    height: int = 512

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StreamOptions":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: coerce_option(k, v) for k, v in d.items() if k in fields})

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServerConfig:
    """config.yaml schema.

    ``model``/``controlnet``/``gpus``/``compile`` keep the reference's keys
    and meaning (config.yaml:1-5); ``gpus`` counts accelerator devices
    (TPU chips here).  TPU-native extras get defaults that preserve the
    reference behavior when absent.
    """

    model: str = "SimianLuo/LCM_Dreamshaper_v7"
    controlnet: str = "lllyasviel/control_v11p_sd15_canny"
    gpus: int = 1
    compile: bool = False

    # --- TPU-native extensions (absent from the reference) ---
    # model family preset: sd15 | sd21 | sdxl | tiny (tests)
    family: str = "sd15"
    # dtype for model params/compute
    dtype: str = "bfloat16"
    # mesh axis sizes; data * model * pipe must equal `gpus`
    mesh_data: int | None = None
    mesh_model: int = 1
    # pipeline-parallel stages (parallel/pipe.py): 1 = off (default,
    # dp x tp serving), 2 = split the UNet at its waist over two disjoint
    # submeshes of gpus/2 devices each (the capacity lever for
    # SDXL-1024²-class configs).  Single-model serving only.
    mesh_pipe: int = 1
    # diffused-output wire format off the device: "rgb" (u8 NHWC) or
    # "i420" (packed planar 4:2:0, ops.rgb_to_i420).  i420 halves the
    # device->host bytes per frame AND feeds libjpeg / VP8 encoders their
    # native layout, skipping the host colorspace conversion the
    # reference pays inside VideoFrame.from_ndarray (server.py:139).
    # Lossy only in chroma (half-res Cb/Cr) — exactly what every JPEG/VP8
    # consumer of these frames was about to do anyway.  Buckets whose
    # geometry can't pack (h%4 or w%2) transparently serve RGB.
    output_format: str = "rgb"
    # camera-frame upload layout: "rgb" (u8 NHWC) or "i420" (packed
    # planar 4:2:0).  i420 halves the host->device bytes per frame and
    # lets the JPEG decode skip its host colorspace/upsample passes
    # (jpegcodec.decode_i420 raw path) and the WebRTC track hand over the
    # VP8 decoder's native planes untouched; the frame program unpacks on
    # device where the conversion fuses into preprocess.  Input chroma
    # subsampling costs nothing extra: WebRTC video and camera JPEGs are
    # already 4:2:0 at the source.
    input_format: str = "rgb"
    # evaluate TAESD residual blocks in pixel-pair-packed layout (full
    # 128-lane convs instead of half-padded 64-channel ones; see
    # models/taesd.py TAESDConfig.packed_convs).  Output parity with the
    # unpacked program is fp32-reduction-order level, not bit-exact, so
    # this is opt-in; golden tests pin the unpacked path.
    taesd_packed: bool = False
    # evaluate TAESD residual blocks with the Pallas packed-conv kernel
    # (ops/pallas/taesd_conv.py): owns the packed layout end to end —
    # halo-DMA'd strips, lane-full matmuls, fused bias/ReLU/skip.  Same
    # fp32-reduction-order parity caveat as taesd_packed; TPU-only (the
    # engine ignores it on other platforms).
    taesd_pallas: bool = False
    # camera-frame mailbox (h, w): fixed-size per-stream frame buffers.
    # Camera frames up to this size keep their FULL field of view — the
    # on-device crop sees the true extent via a traced source box, so the
    # center-crop matches the reference's full-resolution host crop
    # (videopipeline.py:91-107).  Default covers the client's max
    # negotiated size (768 long side, index.tsx:218-229); larger camera
    # frames are host-center-cropped to the mailbox.
    frame_hw: tuple = (768, 768)
    # static compile buckets: when non-empty, requested stream resolutions
    # snap to the nearest (h, w) bucket — bounds the number of compiled
    # programs (each fresh resolution is a multi-minute XLA compile, a DoS
    # vector the eager GPU reference doesn't have).  Empty = honor exact
    # requested sizes (reference-parity behavior, used by tests).
    resolution_buckets: tuple = ()
    batch_buckets: tuple = (1, 2, 4, 8)
    # max CONCURRENT background bucket compiles.  Compiles run on daemon
    # threads off the dispatch path; unbounded parallelism can starve the
    # serving process on small hosts (measured: 6 parallel compiles on a
    # 1-vCPU rig drove 98% system time and stats timeouts) — queued
    # compiles wait their turn, streams keep getting nearest-ready or
    # passthrough frames meanwhile.
    compile_concurrency: int = 2
    # warm each background bucket through a SUBPROCESS first: a child
    # interpreter (tools/warm_spec.py) builds an engine from this config
    # on the parent's device and runs the spec once, then the serving
    # process warms it in-process (a failed child only costs that
    # fall-through, which runs the same kernels).  In the port the
    # child's CUDA graphs die with it: what persists is the nvcc kernel
    # library under videosd_tpu_torch/_build/ (built once, loaded by
    # every later process) and the proof that the spec builds and runs on
    # that device.  On the card the child loads a second copy of the
    # weights beside the parent's (a few GiB for sd15 bf16), bounded by
    # compile_concurrency; a child asked for a card that finds none exits
    # non-zero and never runs on the CPU.  The JAX package's reason for
    # it, GIL-holding XLA compiles stalling the event loop, is measured
    # on the H100 in chip_smoke.py phase 6k.  Off by default.
    compile_subprocess: bool = False
    # micro-batcher deadline (ms) before a partial batch is cut
    batch_deadline_ms: float = 10.0
    # extended fill window (ms): when MORE recently-active streams exist
    # than frames collected, the cut waits up to this long for them — a
    # synchronous client's next frame lands within its decode time, and
    # coalescing it doubles aggregate throughput at these service times.
    # Streams idle >1 s never extend the wait.
    batch_fill_ms: float = 50.0
    # weight source: HF-style local cache dir or "random" (tests/bench)
    weights: str = "auto"
    # post-training quantization of the denoiser towers: "none" | "int8".
    # int8 rewrites the transformer-block linears to w8a8 (ops/quant.py).
    # On this stack it is a MEMORY lever (halves denoiser weight HBM),
    # not a speed win — measured slower than bf16 at flagship shapes
    # (PERF.md "int8 w8a8 re-probe").  Off by default.
    quant: str = "none"
    # LoRA adapters fused into the loaded checkpoint at startup
    # (BASELINE config 1: "SD-1.5 + LCM-LoRA").  A safetensors path, a
    # list of paths, or a list of {path, scale} dicts; `lora_scale` is
    # the default scale.  Fused load-time (io/lora.py): zero per-step
    # cost, and hot-swapped checkpoints re-fuse the same adapters.
    lora: Any = None
    lora_scale: float = 1.0
    # safety checker seam (the reference's optional
    # StableDiffusionSafetyChecker, lcm_controlnet.py:593-608 — disabled
    # in its shipped deployment, so off by default here too).  true wires
    # the built-in skin-chroma-statistics classifier
    # (pipelines/safety.skin_stats_classifier) through the blackout hook
    # INSIDE every compiled frame program: flagged outputs return black.
    safety: bool = False
    # skin-pixel fraction above which a frame is flagged
    safety_threshold: float = 0.5
    # named EXTRA checkpoints served alongside the default model: a
    # mapping of name -> HF repo/path (or {model, controlnet, lora,
    # lora_scale} for per-entry overrides).  All entries must be the same
    # `family`/`dtype` as the default — their param trees then match the
    # serving bundle tensor-for-tensor, every compiled frame program is
    # REUSED across models (params are an argument, not a constant), and
    # streams pick per-frame via the live "model" option.  Costs one
    # param tree of HBM per entry (~2.7 GB for SD1.5 bf16).  The
    # reference needs one GPU-pinned actor pool per checkpoint.
    models: dict = dataclasses.field(default_factory=dict)
    # server-side overrides of the per-stream option DEFAULTS (merged
    # under each new stream's init options, which still win): lets a
    # deployment default e.g. `controlnet_interval: 4` (turbo) or a house
    # prompt without touching clients.  Keys are coerced with the same
    # table as the data channel; the reference has no equivalent (its
    # defaults are compiled into the client, index.tsx:35-47).
    option_defaults: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        cfg = cls(**known)
        cfg.frame_hw = tuple(int(x) for x in cfg.frame_hw)
        for key in ("output_format", "input_format"):
            val = str(getattr(cfg, key)).lower()
            if val not in ("rgb", "i420"):
                raise ValueError(f"{key} must be 'rgb' or 'i420', got {val!r}")
            setattr(cfg, key, val)
        cfg.quant = str(cfg.quant or "none").lower()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {cfg.quant!r}")
        # validate + normalize the lora spec early (fail at config load,
        # not mid-serving)
        if cfg.lora:
            cfg.lora = normalize_lora_setting(cfg.lora, float(cfg.lora_scale))
        if cfg.option_defaults:
            if not isinstance(cfg.option_defaults, dict):
                raise ValueError("option_defaults must be a mapping")
            cfg.option_defaults = coerce_options(cfg.option_defaults)
        if cfg.models:
            if not isinstance(cfg.models, dict):
                raise ValueError("models must be a mapping of name -> spec")
            norm: dict[str, dict] = {}
            for name, spec in cfg.models.items():
                name = str(name)
                if not name or name.lower() == "default":
                    raise ValueError(
                        "models: entry names must be non-empty and not"
                        f" 'default' (got {name!r}); the default checkpoint"
                        " is the top-level `model` key"
                    )
                if isinstance(spec, str):
                    spec = {"model": spec}
                if not isinstance(spec, dict) or not spec.get("model"):
                    raise ValueError(
                        f"models[{name!r}] must be a repo/path string or a"
                        " mapping with a 'model' key"
                    )
                entry = {
                    "model": str(spec["model"]),
                    # default: the server's controlnet (same conditioning
                    # tower unless the entry overrides it)
                    "controlnet": spec.get("controlnet", cfg.controlnet),
                    "lora": spec.get("lora"),
                }
                if entry["lora"]:
                    entry["lora"] = normalize_lora_setting(
                        entry["lora"],
                        float(spec.get("lora_scale", cfg.lora_scale)),
                    )
                norm[name] = entry
            cfg.models = norm
        pipe = cfg.mesh_pipe
        if pipe not in (1, 2):
            # the PP implementation cuts the UNet at its waist — exactly
            # two stages (parallel/pipe.py); validate the raw value so 0 or
            # negatives fail loudly rather than being coerced to 1
            raise ValueError(f"mesh_pipe must be 1 or 2, got {cfg.mesh_pipe}")
        if pipe > 1 and cfg.models:
            raise ValueError(
                "mesh_pipe serving is single-model: stage params are placed "
                "at engine build, so the `models:` registry's per-batch "
                "param swap cannot apply (drop `models:` or mesh_pipe)"
            )
        if cfg.mesh_data is None:
            cfg.mesh_data = max(1, cfg.gpus // (max(1, cfg.mesh_model) * pipe))
        elif cfg.mesh_data * max(1, cfg.mesh_model) * pipe != max(1, cfg.gpus):
            # a silently-ignored mesh spec would serve on the wrong number
            # of chips; fail loudly at config load
            raise ValueError(
                f"mesh_data ({cfg.mesh_data}) x mesh_model ({cfg.mesh_model})"
                f" x mesh_pipe ({pipe}) must equal gpus ({cfg.gpus})"
            )
        return cfg


def normalize_lora_setting(setting: Any, default_scale: float = 1.0):
    """Coerce the config ``lora`` value to ``[(path, scale), ...]``.

    Accepts a path string, a list of paths, or a list of
    ``{path|file: ..., scale: ...}`` dicts (mixed forms allowed).
    """
    if not setting:
        return []
    if isinstance(setting, (str, os.PathLike)):
        setting = [setting]
    out: list[tuple[str, float]] = []
    for item in setting:
        if isinstance(item, (str, os.PathLike)):
            out.append((os.fspath(item), float(default_scale)))
        elif isinstance(item, dict):
            path = item.get("path") or item.get("file")
            if not path:
                raise ValueError(f"lora entry missing 'path': {item!r}")
            out.append((os.fspath(path), float(item.get("scale", default_scale))))
        else:
            raise ValueError(f"unrecognized lora entry: {item!r}")
    return out


def load_config(path: str = "config.yaml") -> ServerConfig:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return ServerConfig.from_dict(raw)
