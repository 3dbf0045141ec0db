"""Engine: program cache + async multi-stream micro-batcher, over the port.

The port's counterpart of ``videosd_tpu/runtime/engine.py``: ONE process
drives the card with a cache of frame programs (``FrameProgram`` and the
reference-mode program, each a CUDA graph per call signature on the card)
and an asyncio batching loop that coalesces the freshest frame of every
active stream into one padded batch per tick.

Scheduling as in the JAX engine (and the reference it follows):
* latest-frame-wins per stream (frame dropping == passthrough of the last
  output) via the native FrameQueue mailboxes,
* generation-time EMA + admission pacing, kept as telemetry and used for
  deadline-based batch cuts,
* a per-stream live options dict mutated by the data channel with no
  restart,
* fixed batch buckets (1/2/4/8), a cold bucket served by the nearest ready
  one while it warms up and captures on a background thread, a
  prompt-embedding cache, device-resident weights.

Not ported yet: mesh and ``mesh_pipe`` serving (more than one device),
LoRA and int8 weights; each raises.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
from typing import Any

import numpy as np
import torch

from videosd_tpu_torch.config import ServerConfig, default_options
from videosd_tpu_torch.runtime.engine_batcher import BatcherMixin
from videosd_tpu_torch.runtime.engine_framing import FrameIOMixin
from videosd_tpu_torch.runtime.engine_programs import ProgramCacheMixin
from videosd_tpu_torch.runtime.engine_registry import ModelRegistryMixin
from videosd_tpu_torch.runtime.engine_warmup import WarmupMixin
from videosd_tpu_torch.runtime.framequeue import FrameQueue
from videosd_tpu_torch.runtime.telemetry import Telemetry

__all__ = ["Engine", "StreamState"]


class StreamState:
    """Per-stream mutable state (the reference's VideoSDTrack fields:
    options dict, ref frame, last output — server.py:86-102)."""

    def __init__(self, stream_id: int, options: dict[str, Any]):
        self.stream_id = stream_id
        self.options = dict(default_options())
        self.options.update(options or {})
        self.last_output: np.ndarray | None = None
        self.last_latents = None
        # temporal DeepCache state (option "deepcache_temporal" = N):
        # device-resident per-step trunk features [S, h', w', c'] from the
        # last produce frame, the bucket key they were produced under, and
        # frames generated since (refresh when age >= N)
        self.deep_rows = None
        self.deep_rows_key = None
        self.temporal_age = 0
        self.ref_frame: np.ndarray | None = None
        self.last_input: np.ndarray | None = None
        # true (h, w) of the latest camera frame inside the mailbox — the
        # on-device crop must see the REAL extent, not the mailbox shape
        self.in_hw: tuple[int, int] | None = None
        # true extent of ref_frame when it came from a camera frame that
        # already fills the mailbox; None = derive from ref_frame.shape
        self.ref_hw: tuple[int, int] | None = None
        self.last_submit: float = 0.0  # monotonic ts of the latest frame
        self.last_reply: float = 0.0  # monotonic ts of the latest resolve
        self.waiters: list[asyncio.Future] = []
        self.active = True
        # prompt-interpolation state: crossfade in embedding space when the
        # prompt changes (BASELINE config 5; option "prompt_blend_frames")
        self.current_emb = None  # (context, pooled) actually used last tick
        self.blend_from = None  # host-numpy snapshot taken at fade start
        self.blend_left = 0
        self.blend_total = 0  # captured at fade start: a live change to
        # prompt_blend_frames mid-fade must not jump the interpolant
        self._last_prompt: tuple | None = None  # (model, prompt) fade key

    def similar_to_last(self, frame: np.ndarray, threshold: float) -> bool:
        """Stochastic-similarity-style skip (StreamDiffusion idea): when the
        incoming frame barely differs from the last diffused input, reuse
        the last output instead of burning a generation.  ``threshold`` is
        mean |delta| in [0,1] units; 0 disables (default)."""
        if threshold <= 0 or self.last_input is None:
            return False
        if frame.shape != self.last_input.shape:
            return False
        # subsampled mean abs diff — O(pixels/64), negligible host cost
        a = frame[::8, ::8].astype(np.int16)
        b = self.last_input[::8, ::8].astype(np.int16)
        return float(np.abs(a - b).mean()) / 255.0 < threshold




class Engine(
    FrameIOMixin,
    ModelRegistryMixin,
    ProgramCacheMixin,
    WarmupMixin,
    BatcherMixin,
):
    def __init__(
        self,
        config: ServerConfig | None = None,
        *,
        bundle=None,
        max_streams: int = 16,
        max_batch: int = 8,
        deadline_ms: float | None = None,
        frame_hw: tuple[int, int] | None = None,
        device="cuda",
    ):
        """``bundle``: the serving ``ModelBundle`` (its device is the
        engine's); without one the bundle is built from ``config`` on
        ``device`` at first use (the card unless the caller asks for the
        CPU)."""
        self.config = config or ServerConfig()
        if int(self.config.gpus or 1) > 1 or int(self.config.mesh_pipe or 1) > 1:
            raise NotImplementedError(
                "mesh and mesh_pipe serving (gpus > 1) is not ported yet: one card per engine")
        self._bundle = bundle
        self.device = torch.device(bundle.device if bundle is not None else device)
        # provenance of the serving weights (None = random init); set by
        # the bundle resolver and swap_params, surfaced via stats()
        self.weights_source: dict | str | None = None
        self.max_streams = max_streams
        self.max_batch = max_batch
        self.deadline_s = (
            (deadline_ms if deadline_ms is not None else self.config.batch_deadline_ms)
            / 1e3
        )
        # mailbox geometry is config-driven: the mailbox must fit the
        # negotiated camera size
        self.frame_hw = tuple(frame_hw or self.config.frame_hw)
        # camera-frame upload layout (config input_format): "i420" keeps
        # mailboxes/uploads packed planar 4:2:0 — half the host->device
        # bytes; the frame program unpacks on the device
        self.input_format = str(
            getattr(self.config, "input_format", "rgb") or "rgb"
        ).lower()
        if self.input_format == "i420" and (
            self.frame_hw[0] % 4 or self.frame_hw[1] % 2
        ):
            raise ValueError(
                f"input_format=i420 needs frame_hw H%4==0 and W%2==0, "
                f"got {self.frame_hw}"
            )
        self.telemetry = Telemetry()
        # slots sized for RGB (the larger layout) so input_format can flip
        # at runtime: packed i420 puts/takes use fewer bytes of the same slot
        self.queue = FrameQueue(
            max_streams, self.frame_hw[0] * self.frame_hw[1] * 3
        )
        self.streams: dict[int, StreamState] = {}
        # mailbox slots are a fixed pool; closed streams recycle their slot
        self._free_slots = list(range(max_streams))
        self._programs: dict[Any, Any] = {}
        # cold-bucket stall avoidance: (spec, ref_mode) keys that have
        # completed at least one run (warmed up, and on the card captured),
        # and keys warming in the background.  A live option change that
        # lands in a fresh bucket is served with the NEAREST ready program
        # while its own warms up.
        self._ready_specs: set = set()
        # temporal DeepCache specs have TWO call signatures (produce /
        # reuse, each its own CUDA graph); this records keys whose REUSE
        # signature has also completed a run.  A reuse batch whose graph is
        # still cold runs as produce instead of capturing on the dispatch
        # worker and stalling every stream.
        self._ready_reuse: set = set()
        self._compiling: set = set()
        # bound CONCURRENT background warm-ups (config compile_concurrency);
        # their captures are serialized per device anyway
        self._compile_sem = threading.Semaphore(
            max(1, int(getattr(self.config, "compile_concurrency", 2) or 2))
        )
        # device-side output pack (config output_format: "i420"): batches
        # leave the card as packed planar 4:2:0 — half the D2H bytes
        self.output_format = str(
            getattr(self.config, "output_format", "rgb") or "rgb"
        ).lower()
        self._dispatch_threads: dict[str, int] = {}
        # LRU: hits re-insert at the end, eviction pops the oldest entry one
        # at a time — a wholesale clear() would drop every active stream's
        # embeddings at once and trigger a re-encode burst
        self._prompt_cache: collections.OrderedDict[tuple, Any] = (
            collections.OrderedDict()
        )
        self._prompt_cache_max = 256
        # named EXTRA checkpoints (config `models:`) served alongside the
        # default bundle: same family/dtype -> the same state-dict keys,
        # shapes and dtypes, so every program is shared; a batch of another
        # model copies its weights into the serving modules first (see
        # engine_registry.py).  Lazy: loaded on first use or via
        # load_models() at startup.
        self._extra_bundles: dict[str, Any] = {}
        self._extra_lock = threading.Lock()
        # whose weights the serving modules hold ("" = the default), the
        # default's saved copy once another model was swapped in, and the
        # lock that keeps a weight copy from landing inside a dispatch
        self._weights_in_modules = ""
        self._default_weights: dict | None = None
        self._weights_lock = threading.Lock()
        self._encoder = None
        self._loop_task: asyncio.Task | None = None
        # all hot-path program executions go through ONE dispatch thread
        # (runtime/dispatch.py); created lazily so engines that never run
        # don't spawn threads
        self._dispatcher = None
        self._stopped = asyncio.Event()
        self._wake = asyncio.Event()
        self._inflight: set[asyncio.Task] = set()
        # background warm-ups run on dedicated daemon threads, NOT the
        # event loop's default executor: asyncio.run() joins the default
        # executor at teardown, which would hang a graceful shutdown
        self._bg_threads: set[threading.Thread] = set()

    # ------------------------------------------------------------ lifecycle

    @property
    def bundle(self):
        if self._bundle is None:
            import dataclasses as _dc

            from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle

            log = logging.getLogger("videosd_tpu_torch.engine")
            self._check_unported_weights()
            family = self.config.family
            dtype = torch.bfloat16 if self.config.dtype == "bfloat16" else torch.float32
            # config `weights`: "auto" discovers the configured repos in the
            # local HF cache, a path/repo-id is an explicit ask, "random"
            # skips.  Auto falls back to random init LOUDLY.
            resolved = None
            setting = str(getattr(self.config, "weights", "random") or "random")
            if setting.lower() != "random" and not family.startswith("tiny"):
                from videosd_tpu_torch.io.discovery import resolve_weights

                resolved = resolve_weights(
                    getattr(self.config, "model", None),
                    controlnet=getattr(self.config, "controlnet", None),
                    setting=setting,
                )
            if resolved is not None:
                log.info(
                    "loading checkpoint: model=%s controlnet=%s taesd=%s",
                    resolved["model_dir"],
                    resolved["controlnet_dir"],
                    resolved["taesd_dir"],
                )
                bundle = ModelBundle.from_pretrained(
                    resolved["model_dir"],
                    family=family,
                    controlnet_dir=resolved["controlnet_dir"],
                    taesd_dir=resolved["taesd_dir"],
                    dtype=dtype,
                    with_controlnet=True,
                    device=self.device,
                )
                self.weights_source = resolved
            else:
                if setting.lower() == "auto":
                    log.info(
                        "weights: auto found no cached snapshot of %r — "
                        "serving RANDOM-INIT weights",
                        getattr(self.config, "model", None),
                    )
                bundle = ModelBundle.random(family, dtype=dtype, device=self.device)
                self.weights_source = None
            for key, field in (("taesd_packed", "packed_convs"), ("taesd_pallas", "pallas_convs")):
                if bool(getattr(self.config, key, False)):
                    # taesd_pallas: the residual-block convs on kernel K3
                    bundle = _dc.replace(
                        bundle, taesd_cfg=_dc.replace(bundle.taesd_cfg, **{field: True}))
                    log.info("taesd: %s enabled", field)
            if bool(getattr(self.config, "safety", False)):
                # inside every frame program (and its CUDA graph); registry
                # models run through the same programs, so it covers them
                from videosd_tpu_torch.pipelines.safety import default_safety_hook

                bundle.safety_hook = default_safety_hook(
                    float(getattr(self.config, "safety_threshold", 0.5))
                )
                log.info("safety: skin-stats blackout hook enabled")
            self._bundle = bundle
        return self._bundle

    def _check_unported_weights(self, lora=None) -> None:
        """LoRA and int8 weights wait for their port (ROADMAP.md, queue 1)."""
        if lora or getattr(self.config, "lora", None):
            raise NotImplementedError("LoRA weights (config lora, models[...].lora) are not "
                                      "ported yet")
        if str(getattr(self.config, "quant", "none")).lower() == "int8":
            raise NotImplementedError("quant: int8 is not ported yet")

    def swap_params(self, state_dicts: dict, *, source: str | None = None) -> None:
        """Swap the serving weights under live serving — zero dropped
        frames, zero new programs.

        ``state_dicts``: ``{model name: state dict}`` for every model of the
        serving bundle, matching it exactly in keys, shapes and dtypes
        (``ValueError`` otherwise, before anything changes).  The tensors
        are copied into the serving modules in place, so every captured
        graph reads them; the copy takes the weight lock, so it lands
        between two dispatches: the in-flight batch finishes on the old
        weights, the next one reads the new.  The prompt cache clears (the
        text tower changed) and per-stream fades reset.
        """
        self._check_unported_weights()
        self._check_like_serving(state_dicts)
        with self._weights_lock:
            if self._weights_in_modules:  # another model is swapped in
                self._default_weights = self._clone_weights(state_dicts)
            else:
                self._load_weights(state_dicts)
        self._prompt_cache.clear()
        for st in self.streams.values():
            st.current_emb = None
            st.blend_from = None
            st.blend_left = 0
            st._last_prompt = None
        self.weights_source = source

    def start(self):
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(self._batch_loop())

    def _get_dispatcher(self):
        if self._dispatcher is None:
            from videosd_tpu_torch.runtime.dispatch import DispatchWorker

            self._dispatcher = DispatchWorker(depth=2)
        return self._dispatcher

    async def stop(self):
        self._stopped.set()
        self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        if self._dispatcher is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._dispatcher.stop
            )
            self._dispatcher = None
        # bounded drain of background warm-ups: their results are
        # discardable, so shutdown must never hang behind one
        threads = [t for t in self._bg_threads if t.is_alive()]
        if threads:

            def drain():
                deadline = time.monotonic() + 10.0
                for t in threads:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                return sum(t.is_alive() for t in threads)

            leftover = await asyncio.get_running_loop().run_in_executor(
                None, drain
            )
            if leftover:
                logging.getLogger("videosd_tpu_torch.engine").warning(
                    "%d background warm-up(s) still running at shutdown "
                    "(abandoned)", leftover,
                )
        self._bg_threads.clear()

    # ------------------------------------------------------------ streams

    def open_stream(self, options: dict[str, Any] | None = None) -> StreamState:
        if not self._free_slots:
            raise RuntimeError("max_streams exceeded")
        sid = self._free_slots.pop(0)
        # deployment-level default overrides (config option_defaults) sit
        # under the client's init options, which keep priority
        cfg_defaults = getattr(self.config, "option_defaults", None) or {}
        st = StreamState(sid, {**cfg_defaults, **(options or {})})
        self.streams[sid] = st
        return st

    def close_stream(self, sid: int):
        st = self.streams.pop(sid, None)
        if st:
            st.active = False
            for w in st.waiters:
                if not w.done():
                    w.cancel()
            # drain any frame left in the mailbox so the next occupant of
            # this slot doesn't inherit a stale frame, then recycle
            if self.queue.has_fresh(sid):
                buf = np.empty(self._mailbox_shape(), np.uint8)
                self.queue.take(sid, buf)
            self._free_slots.append(sid)

    def update_options(self, sid: int, message: dict[str, Any]):
        """Data-channel option merge with the reference coercion table,
        including the set_ref trigger."""
        from videosd_tpu_torch.config import coerce_options

        st = self.streams[sid]
        msg = coerce_options(message)
        if "set_ref" in msg:
            if st.last_output is not None:
                st.ref_frame = self._as_rgb(st.last_output).copy()
                st.ref_hw = None  # derive extent from the output's shape
            msg.pop("set_ref")
        st.options.update(msg)

    # ------------------------------------------------------------ frames

    async def submit_frame(self, sid: int, frame: np.ndarray) -> np.ndarray:
        """Submit a camera frame; resolves with the freshest generated
        output (which may be an older generation if this frame was
        dropped: output fps == input fps decoupling)."""
        st = self.streams[sid]
        self.telemetry.frames_in += 1
        frame, st.in_hw = self._fit_frame(frame)
        sim_thresh = float(st.options.get("similarity_threshold", 0.0) or 0.0)
        if st.last_output is not None and st.similar_to_last(frame, sim_thresh):
            self.telemetry.frames_dropped += 1
            return st.last_output
        # recency is stamped only when a frame actually enqueues: a
        # similarity-skipped stream (static scene) must not count toward
        # the batch-cut cohort — it will not deliver a frame
        st.last_submit = time.monotonic()
        self.queue.put(sid, frame)
        self._wake.set()
        if st.last_output is None:
            # first frame: black init frame
            h, w = int(st.options["height"]), int(st.options["width"])
            st.last_output = self._black_output(h, w)
            st.ref_frame = self._as_rgb(frame)
            st.ref_hw = st.in_hw
        fut = asyncio.get_running_loop().create_future()
        st.waiters.append(fut)
        try:
            return await fut
        except asyncio.CancelledError:
            return st.last_output

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        s = self.telemetry.snapshot()
        s.update(self.queue.stats())
        s["streams"] = len(self.streams)
        s["programs_compiled"] = len(self._programs)
        s["programs_compiling"] = len(self._compiling)
        # servable buckets (first run done).  _programs registers at BUILD
        # time, so compiled >= ready while warm-ups are in flight
        s["programs_ready"] = len(self._ready_specs)
        s["ready_buckets"] = sorted(
            (
                {
                    "batch": sp.batch,
                    "height": sp.height,
                    "width": sp.width,
                    "steps": sp.steps,
                    "ref_mode": rm,
                }
                for sp, rm in list(self._ready_specs)
            ),
            key=lambda d: (
                d["batch"], d["height"], d["width"], d["steps"], str(d["ref_mode"]),
            ),
        )
        s["dispatch_threads"] = dict(self._dispatch_threads)
        s["devices"] = {"data": 1, "model": 1}
        # CUDA graphs held by the programs, and the card's memory
        s["graphs"] = sum(
            b.graph is not None
            for p in list(self._programs.values()) for b in list(p.buckets.values())
        )
        if self.device.type == "cuda":
            s["memory_gib"] = {
                "allocated": torch.cuda.memory_allocated(self.device) / 2**30,
                "reserved": torch.cuda.memory_reserved(self.device) / 2**30,
            }
        s["weights_source"] = self.weights_source  # None = random init
        if self.model_names:
            s["models"] = {
                name: ("loaded" if name in self._extra_bundles else "cold")
                for name in self.model_names
            }
        return s
