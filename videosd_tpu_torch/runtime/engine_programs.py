"""Engine mixin: program cache + prompt-embedding cache.

The port's counterpart of ``videosd_tpu/runtime/engine_programs.py``: one
program per ``(spec, ref_mode)`` key (a ``FrameProgram``, or the reference
program for a ``ref_mode`` bucket, each holding a CUDA graph per call
signature on the card; over a mesh one of each per data row, behind a
``ShardedProgram``; under ``mesh_pipe`` the pipelined program), and the
per-(model, prompt) embedding cache with its embedding-space crossfade.
"""

from __future__ import annotations

import logging

__all__ = ["ProgramCacheMixin"]


class ProgramCacheMixin:

    async def _between_launches(self, fn, *args):
        """``fn(*args)`` on the dispatch thread, between two batches, holding
        the launch lock and the weight lock: no other thread of the engine
        launches on the card meanwhile (background warm-ups and captures,
        model loads and weight swaps wait for it).  A profiler session
        starts and stops only so: on an H100 the profiler's stop on the
        event loop and a graph replay on the dispatch thread once waited
        on each other for good."""
        import asyncio

        def call():
            with self._launch_lock, self._weights_lock:
                return fn(*args)

        return await self._get_dispatcher().run(
            asyncio.get_running_loop(), call, lambda res: res
        )

    async def start_trace(self, log_dir: str) -> None:
        """``telemetry.start_trace(log_dir)`` between two batches
        (:meth:`_between_launches`)."""
        await self._between_launches(self.telemetry.start_trace, log_dir)

    async def stop_trace(self) -> None:
        """``telemetry.stop_trace()``: the profiler ends between two batches
        (:meth:`_between_launches`) and its trace, many MB, is written off
        the dispatch thread."""
        import asyncio

        await self._between_launches(self.telemetry.end_trace)
        await asyncio.get_running_loop().run_in_executor(None, self.telemetry.write_trace)

    async def kernel_symbols(self) -> dict:
        """``{program signature: [(kernel name, scope), ...]}`` over every
        call signature of every cached program: the counterpart of the JAX
        engine's ``hlo_symbols()``, for ``summarize_trace(symbols=...)``.

        A CUDA graph's replay carries no profiler ranges, so each
        signature's body runs once more, eagerly, under the profiler, and
        the device events it launches are listed in the order they ran,
        each with the ``record_function`` scopes around its launch
        (``unet/down0/tf1``); on the CPU, its outermost operators.  Each
        signature runs between two batches (:meth:`_between_launches`):
        its profiler session must not start or stop beside another
        thread's launches.  Not while a trace is being taken."""
        import asyncio
        import os
        import tempfile

        from videosd_tpu_torch.runtime.telemetry import scoped_events

        loop = asyncio.get_running_loop()
        symbols: dict = {}
        # list() snapshots: background warm-ups insert programs and buckets
        for (spec, ref_mode), prog in list(self._programs.items()):
            for key, bucket in list(prog.buckets.items()):
                if self.device.type == "cuda" and bucket.graph is None:
                    continue  # not captured yet: nothing replays it
                inputs = ",".join(f"{n}{list(shape)}" for n, shape, _ in key)
                name = (f"b{spec.batch} {spec.height}x{spec.width} s{spec.steps}"
                        f"{' ref' if ref_mode else ''} {inputs}")
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "trace.json")
                    await self._between_launches(self._profile_body, bucket, path)
                    symbols[name] = await loop.run_in_executor(
                        None, scoped_events, path, "kernel_symbols"
                    )
        return symbols

    def _profile_body(self, bucket, path: str) -> None:
        """Run one bucket's body eagerly under the profiler, inside a
        ``kernel_symbols`` range, and write the trace to ``path``."""
        import torch

        from videosd_tpu_torch.runtime.telemetry import profiler

        with torch.inference_mode():
            with profiler() as prof:
                with torch.profiler.record_function("kernel_symbols"):
                    bucket.body(**bucket.buffers)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(path)

    def _get_program(self, spec, *, ref_mode: bool = False):
        """The program of a (spec, ref_mode) bucket: single-device, sharded
        over the mesh (``ShardedFrameEngine.program``) or pipelined
        (``PipelinedFrameEngine.serving_program``).  A reference-mode
        bucket has no stage split: under ``mesh_pipe`` it serves
        unpipelined on the engine's device, with a warning."""
        key = (spec, ref_mode)
        prog = self._programs.get(key)
        if prog is None:
            if self.mesh is not None:
                prog = self._sharded.program(spec, ref_mode=ref_mode)
            elif ref_mode:
                from videosd_tpu_torch.pipelines.reference_attn import build_reference_program

                prog = build_reference_program(self.bundle, spec)
                if self.pipe_engine is not None:
                    # loud, once per spec, so ops can see the gap
                    logging.getLogger("videosd_tpu_torch.engine").warning(
                        "ref_mode bucket %s serves UNPIPELINED under "
                        "mesh_pipe (reference-attention has no stage split)",
                        spec,
                    )
            elif self.pipe_engine is not None:
                prog = self.pipe_engine.serving_program(spec)
            else:
                from videosd_tpu_torch.pipelines.lcm_img2img import build_frame_program

                prog = build_frame_program(self.bundle, spec)
            self._programs[key] = prog
        return prog

    def _encode_prompt(self, prompt: str, model: str = ""):
        """-> (context_embeds, pooled_embeds) on the bundle's device, cached
        per (model, prompt): each registry entry's text tower has its own
        weights, so it gets its own cache rows."""
        ck = (model, prompt)
        cached = self._prompt_cache.get(ck)
        if cached is None:
            from videosd_tpu_torch.pipelines.lcm_img2img import build_prompt_encoder

            if model:
                bundle = self._extra_bundle(model)
                encoder = build_prompt_encoder(bundle)
            else:
                bundle = self.bundle
                if self._encoder is None:
                    self._encoder = build_prompt_encoder(bundle)
                encoder = self._encoder
            cached = encoder(bundle.tokenizer([prompt]))
            while len(self._prompt_cache) >= self._prompt_cache_max:
                self._prompt_cache.popitem(last=False)  # LRU-evict oldest
            self._prompt_cache[ck] = cached
        else:
            self._prompt_cache.move_to_end(ck)
        return cached

    def _stream_embeds(self, st):
        """Prompt embeddings for one stream, crossfaded in embedding space
        when the prompt changes and "prompt_blend_frames" > 0 — a smooth
        live-prompt interpolation instead of a hard cut.

        Runs on the EVENT LOOP thread: must not run the encoder (the
        dispatch thread pre-encodes).  Cache lookups only; the crossfade
        math runs on host copies (fp32, cast back)."""
        prompt = str(st.options["prompt"])
        ck = (self._stream_model(st), prompt)
        target = self._prompt_cache.get(ck)
        if target is not None:
            self._prompt_cache.move_to_end(ck)
        elif st.current_emb is not None:
            # prompt mutated between the dispatcher pre-encode and this
            # pack (rare): serve the previous embedding this tick instead
            # of running the encoder on the event loop; the next tick's
            # pre-encode warms the cache and the fade starts then.
            return st.current_emb
        else:
            # brand-new stream whose prompt mutated inside the same window
            # — nothing older to serve; one-off encode.
            target = self._encode_prompt(prompt, ck[0])
        blend = int(st.options.get("prompt_blend_frames", 0) or 0)
        # fade key = (model, prompt): a live model switch crossfades in
        # embedding space exactly like a prompt change
        if st._last_prompt is not None and ck != st._last_prompt and blend > 0:
            prev = st.current_emb if st.current_emb is not None else target
            # host snapshot at fade start (bounded D2H; fades are rare)
            st.blend_from = tuple(None if a is None else a.cpu() for a in prev)
            st.blend_total = blend  # capture: live slider moves mid-fade
            st.blend_left = blend  # must not jump the interpolant
        st._last_prompt = ck
        if st.blend_left > 0 and st.blend_from is not None and st.blend_total:
            t = 1.0 - st.blend_left / st.blend_total
            st.blend_left -= 1
            tgt = tuple(None if a is None else a.cpu() for a in target)
            emb = tuple(
                None
                if b is None
                else ((1.0 - t) * a.float() + t * b.float()).to(b.dtype)
                for a, b in zip(st.blend_from, tgt)
            )
        else:
            emb = target
        st.current_emb = emb
        return emb
