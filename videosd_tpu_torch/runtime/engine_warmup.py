"""Engine mixin: warm-up + background warm-up machinery.

The port's counterpart of ``videosd_tpu/runtime/engine_warmup.py``.  To
warm a bucket is to run its program once with the batcher's exact call
signature: on the card that first call warms up eagerly and captures the
signature's CUDA graph (``FrameProgram``).  Cold buckets warm on daemon
threads while the dispatch thread keeps replaying the ready ones: the
captures run in ``thread_local`` mode on a side stream and make no
device-wide sync, and one device captures one graph at a time
(``pipelines/lcm_img2img.py::_Bucket``).  Also the nearest-ready fallback
ranking.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

__all__ = ["WarmupMixin"]


class WarmupMixin:
    def warmup(
        self, batch_sizes=(1,), steps=(4,), height=512, width=512,
        cn_interval: int | None = None, dc_interval: int | None = None,
        refresh_last: bool | None = None, temporal: bool | None = None,
        ref: bool = False,
    ):
        """Warm the hot buckets ahead of serving.  ``cn_interval``/
        ``dc_interval`` default to the config's option_defaults values so
        the warmed programs match what new streams will actually request.
        ``ref=True`` ADDITIONALLY warms each bucket's reference-attention
        program (its FrameSpec forces use_controlnet=False and intervals 1,
        matching the batcher's ref-mode coercions)."""
        import dataclasses

        from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec

        defaults = getattr(self.config, "option_defaults", None) or {}
        if cn_interval is None:
            cn_interval = int(defaults.get("controlnet_interval", 1) or 1)
        if dc_interval is None:
            dc_interval = int(defaults.get("deepcache_interval", 1) or 1)
        if refresh_last is None:
            refresh_last = bool(defaults.get("interval_refresh_last", False))
        if temporal is None:
            temporal = int(defaults.get("deepcache_temporal", 0) or 0) > 0
        if temporal:
            dc_interval = 1  # mutually exclusive; temporal wins (batcher rule)
        refresh_last = refresh_last and (
            max(1, cn_interval) > 1 or max(1, dc_interval) > 1
        )
        ih, iw = self.frame_hw
        for b in batch_sizes:
            for s in steps:
                spec = FrameSpec(
                    batch=b, height=height, width=width,
                    in_height=ih, in_width=iw, steps=s,
                    in_format=self.input_format,
                    controlnet_interval=max(1, cn_interval),
                    deepcache_interval=max(1, dc_interval),
                    interval_refresh_last=refresh_last,
                    deepcache_temporal=temporal,
                )
                self._warm_spec(spec, ref_mode=False)
                if ref:
                    # mirror the batcher's ref-mode spec exactly
                    # (engine_batcher._process_group: no ControlNet, no
                    # interval/temporal approximations)
                    self._warm_spec(
                        dataclasses.replace(
                            spec,
                            use_controlnet=False,
                            controlnet_interval=1,
                            deepcache_interval=1,
                            interval_refresh_last=False,
                            deepcache_temporal=False,
                        ),
                        ref_mode=True,
                    )

    def _warm_spec(self, spec, *, ref_mode: bool):
        """One dummy run of a spec with the batcher's EXACT call signature
        (it always passes warm latents and source boxes in non-ref mode): a
        warm-up with another signature captures another graph, and the
        first real batch would capture anyway.  Used by both startup warmup
        and background bucket warm-ups."""
        from videosd_tpu_torch.pipelines.lcm_img2img import _latent_hw

        frames, embeds, strength, guidance, cn, seed, pooled = self._dummy_batch(spec)
        warm_lat = np.zeros((spec.batch, *_latent_hw(self.bundle, spec), 4), np.float32)
        warm_alpha = np.zeros((spec.batch,), np.float32)
        box = np.tile(
            np.asarray(self._src_box(None, spec.height, spec.width), np.int32),
            (spec.batch, 1),
        )
        ref_frames = np.zeros((spec.batch, *self.frame_hw, 3), np.uint8)
        if ref_mode:
            # serving packs a [B, 2] (attn, adain) fidelity pair in ref
            # mode — warm with the same signature
            cn = np.ones((spec.batch, 2), np.float32)
        res = self._run_bucket_sync(
            spec, ref_mode, frames, ref_frames, embeds, strength, guidance, cn, seed,
            None if ref_mode else warm_lat,
            None if ref_mode else warm_alpha,
            pooled,
            box,
            box if ref_mode else None,
            warm=True,
        )
        if not ref_mode and spec.deepcache_temporal and len(res) > 2:
            # temporal buckets serve TWO call signatures (produce / reuse);
            # warm the reuse one with the rows the produce run just made,
            # or the first reuse batch would capture on the dispatch worker
            self._run_bucket_sync(
                spec, ref_mode, frames, ref_frames, embeds, strength, guidance,
                cn, seed, warm_lat, warm_alpha, pooled, box, None,
                deep_caches=res[2], warm=True,
            )

    def _nearest_ready_spec(self, spec, ref_mode: bool):
        """A ready program differing from ``spec`` only in steps, output
        resolution, ControlNet interval, and/or DeepCache interval, or
        None if no ready variant can stand in.

        Ranking: same resolution beats same steps (a transitional ladder
        change is invisible; a transitional size change the client just
        renders at the reply's dimensions), then nearest steps, then
        nearest area, then nearest ControlNet/DeepCache interval."""
        import dataclasses

        def normalize(s):
            return dataclasses.replace(
                s, steps=spec.steps, height=spec.height, width=spec.width,
                controlnet_interval=spec.controlnet_interval,
                deepcache_interval=spec.deepcache_interval,
                deepcache_temporal=spec.deepcache_temporal,
            )

        # list() snapshot: warm-up threads add to _ready_specs concurrently
        candidates = [
            s
            for s, rm in list(self._ready_specs)
            if rm == ref_mode and normalize(s) == spec
        ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda s: (
                (s.height, s.width) != (spec.height, spec.width),
                abs(s.steps - spec.steps),
                abs(s.height * s.width - spec.height * spec.width),
                abs(s.controlnet_interval - spec.controlnet_interval),
                abs(s.deepcache_interval - spec.deepcache_interval),
                # a temporal stand-in without caches runs produce mode
                # (parity outputs); prefer same-flag variants anyway
                s.deepcache_temporal != spec.deepcache_temporal,
            ),
        )

    def _compile_spec_background(self, loop, spec, ref_mode: bool):
        """Warm (one dummy run: warm-up and, on the card, capture) a spec
        off the dispatch path."""
        key = (spec, ref_mode)
        if key in self._compiling:
            return

        self._compiling.add(key)
        logging.getLogger("videosd_tpu_torch.engine").info(
            "background warm-up of bucket %s (serving nearest ready variant "
            "meanwhile)", spec,
        )

        def work():
            try:
                # bounded concurrency (config compile_concurrency); waiting
                # threads are idle and the spec stays in _compiling for dedup
                with self._compile_sem:
                    self._warm_spec(spec, ref_mode=ref_mode)
            except Exception:
                logging.getLogger("videosd_tpu_torch.engine").exception(
                    "background warm-up failed for %s", spec
                )
            finally:
                self._compiling.discard(key)

        # dedicated daemon thread, NOT loop.run_in_executor: asyncio.run()
        # joins the default executor at teardown, which would block a
        # graceful shutdown behind a warm-up
        t = threading.Thread(target=work, name="bucket-compile", daemon=True)
        self._bg_threads = {th for th in self._bg_threads if th.is_alive()}
        self._bg_threads.add(t)
        t.start()

    def _dummy_batch(self, spec):
        b = spec.batch
        frames = np.zeros((b, *self._mailbox_shape()), np.uint8)
        emb, _ = self._encode_prompt("warmup")
        return (
            frames,
            torch.cat([emb] * b, dim=0),
            np.full((b,), 0.6, np.float32),
            np.full((b,), 5.0, np.float32),
            np.full((b,), 2.0, np.float32),
            np.arange(b, dtype=np.int32),
            None,  # pooled embeds: SDXL's, not ported yet
        )
