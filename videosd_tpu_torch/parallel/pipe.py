"""Pipeline parallelism: the UNet cut at its waist over two stage submeshes.

Counterpart of ``videosd_tpu/parallel/pipe.py``, with its design:

* **The cut.**  Stage 0 holds ``conv_in``, the time embedding,
  ``add_embedding`` (SDXL) and the down blocks, the ControlNet, and the
  encoders of TAESD and the KL VAE; stage 1 the mid block, the up blocks,
  ``conv_norm_out``/``conv_out`` and the decoders.  Every skip tensor is
  live at the cut, so one transfer a step carries the whole state (the
  waist feature, the skips, ``temb``), each tensor one ``.to(stage-1
  device, non_blocking=True)``; the ControlNet's down residuals are added
  on the stage-0 side, before the transfer.
* **Each stage is a ("data", "model") submesh** over contiguous devices,
  with the same dp x tp placement as single-stage serving
  (``parallel/mesh.py::shard_params``): a stage's weights live only on its
  slots.  Data row i of stage 0 hands its rows to data row i of stage 1.
* **The same block calls**: :func:`unet_encoder_apply` and
  :func:`unet_decoder_apply` are ``UNet2DConditionModel.forward``'s two
  halves (``encode_down``, then ``decode``), called in the same order, so
  on one device the pipelined frame equals the single-device program.
* **Overlap is a dispatch-order property**: :meth:`PipelinedFrameEngine.
  run_pipelined` issues every microbatch's step s before any step s + 1
  (the interleaved 1F order), so with distinct cards stage 0 works on
  microbatch m + 1 while stage 1 finishes m.

The stages run eagerly (no CUDA graph: a graph is one device's, and the
stages are two).  Parity only, as in JAX: the ControlNet and DeepCache
intervals and temporal DeepCache are single-program levers and are
refused; reference mode is served unpipelined by the engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videosd_tpu_torch.models.unet import UNet2DConditionModel
from videosd_tpu_torch.parallel.mesh import Mesh, shard_params
from videosd_tpu_torch.parallel.serving import row_bundle
from videosd_tpu_torch.pipelines.lcm_img2img import (
    FrameSpec,
    ModelBundle,
    _call_inputs,
    _check_spec,
    _cn_keep,
    _finale,
    _nchw,
    _new_buffers,
    _prelude,
    _stage,
    _step_update,
    kernel_launches,
)

__all__ = [
    "PipelinedFrameEngine",
    "PipelinedUNet",
    "split_unet_params",
    "unet_decoder_apply",
    "unet_encoder_apply",
]

# the UNet's top-level children per stage; the split is a partition
_STAGE0_KEYS = ("conv_in", "time_embedding", "add_embedding", "down_blocks")
_STAGE1_KEYS = ("mid_block", "up_blocks", "conv_norm_out", "conv_out")
# what each stage leaves out of the VAEs: stage 0 encodes, stage 1 decodes
_VAE_DROP = {"taesd": (("decoder",), ("encoder",)),
             "vae": (("decoder", "post_quant_conv"), ("encoder", "quant_conv"))}


def split_unet_params(state_dict: dict) -> tuple[dict, dict]:
    """Partition a UNet state dict at the waist (encoder | decoder), by
    top-level name; every key lands in exactly one stage, so ``{**s0,
    **s1}`` is the whole."""
    s0 = {k: v for k, v in state_dict.items() if k.split(".")[0] in _STAGE0_KEYS}
    s1 = {k: v for k, v in state_dict.items() if k.split(".")[0] in _STAGE1_KEYS}
    leftover = {k.split(".")[0] for k in state_dict} - set(_STAGE0_KEYS) - set(_STAGE1_KEYS)
    if leftover:
        raise ValueError(f"unrecognized UNet param keys: {sorted(leftover)}")
    return s0, s1


def unet_encoder_apply(stage0, sample, timesteps, encoder_hidden_states, *, timestep_cond=None,
                       added_cond_kwargs=None):
    """Stage 0 of the UNet (NCHW, as the modules): the time (and
    ``text_time``) embedding, ``conv_in`` and the down blocks.  Returns the
    cut state ``(x, down_res, temb)``."""
    temb = stage0.embed(timesteps, timestep_cond, added_cond_kwargs)
    context = encoder_hidden_states.to(sample.dtype)
    x, down_res = stage0.encode_down(stage0.conv_in(sample), temb, context)
    return x, down_res, temb


def unet_decoder_apply(stage1, x, down_res, temb, encoder_hidden_states, *,
                       mid_block_additional_residual=None):
    """Stage 1 of the UNet: the mid block, the up blocks and the head.
    ``down_res``: the skip stack with any ControlNet down residuals
    already added (elementwise, so adding them before the transfer is the
    single-device pass's add)."""
    context = encoder_hidden_states.to(x.dtype)
    return stage1.decode(x, list(down_res), temb, context, mid_block_additional_residual)


def _submeshes(n_stages: int, devices, *, model_parallel: int = 1) -> list[Mesh]:
    """Contiguous ("data","model") submeshes, one a stage; slots keep their
    numbers in ``devices``."""
    devices = list(devices)
    n = len(devices)
    if n % n_stages:
        raise ValueError(f"{n} devices not divisible by {n_stages} stages")
    per = n // n_stages
    if per % model_parallel:
        raise ValueError(f"{per} devices/stage not divisible by model_parallel={model_parallel}")
    return [Mesh(devices[s * per:(s + 1) * per], model_parallel,
                 slots=range(s * per, (s + 1) * per)) for s in range(n_stages)]


def _to(device, xs):
    return [None if x is None else x.to(device, non_blocking=True) for x in xs]


class PipelinedUNet:
    """The UNet (and the ControlNet) over two stage submeshes, placed once
    at construction: ``stage0[i]``/``stage1[i]`` are data row i's
    :class:`~videosd_tpu_torch.parallel.mesh.Placement` on each stage (the
    encoder half and the ControlNet, the decoder half).  ``__call__`` is
    the UNet's forward (NCHW), its batch split over the data axis."""

    def __init__(self, unet: UNet2DConditionModel, *, controlnet=None, devices=None,
                 model_parallel: int = 1):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.cfg = unet.cfg
        self.mesh0, self.mesh1 = _submeshes(2, devices, model_parallel=model_parallel)
        split_unet_params(unet.state_dict())  # every key in one stage
        self.unet, self.controlnet = unet, controlnet
        models0 = {"unet": unet} if controlnet is None else {"unet": unet,
                                                               "controlnet": controlnet}
        self.stage0 = shard_params(models0, self.mesh0, drop={"unet": _STAGE1_KEYS})
        self.stage1 = shard_params({"unet": unet}, self.mesh1, drop={"unet": _STAGE0_KEYS})

    @property
    def data_size(self) -> int:
        return self.mesh0.shape["data"]

    def refresh_params(self) -> None:
        for p in self.stage0 + self.stage1:
            p.load({"unet": self.unet, "controlnet": self.controlnet})

    def encode(self, row: int, sample, t, context, *, timestep_cond=None,
               added_cond_kwargs=None, ctrl=None, cn_scale=1.0):
        """Stage 0 on data row ``row`` (inputs on its device): the ControlNet
        (where ``ctrl`` is given), then the UNet's encoder half, the
        ControlNet's down residuals added to the skips.  Returns ``(x,
        down_res, temb, mid_res)``."""
        models = self.stage0[row].models
        mid_res = cn_down = None
        if ctrl is not None:
            cn_down, mid_res = models["controlnet"](
                sample, t, context, ctrl, conditioning_scale=cn_scale,
                timestep_cond=timestep_cond, added_cond_kwargs=added_cond_kwargs)
        x, down_res, temb = unet_encoder_apply(models["unet"], sample, t, context,
                                               timestep_cond=timestep_cond,
                                               added_cond_kwargs=added_cond_kwargs)
        down_res = UNet2DConditionModel._add_residuals(down_res, cn_down)
        return x, down_res, temb, mid_res

    def decode(self, row: int, x, down_res, temb, context, mid_res=None):
        """Stage 1 on data row ``row``: the cut state moves to its device
        (one ``.to`` a tensor), then the decoder half."""
        dev = self.stage1[row].device
        x, temb, context, mid_res = _to(dev, (x, temb, context, mid_res))
        return unet_decoder_apply(self.stage1[row].models["unet"], x, _to(dev, down_res), temb,
                                  context, mid_block_additional_residual=mid_res)

    @torch.inference_mode()
    def __call__(self, sample, t, context, *, timestep_cond=None, added_cond_kwargs=None,
                 ctrl=None, cn_scale=1.0):
        d, b = self.data_size, sample.shape[0]
        if b % d:
            raise ValueError(f"batch {b} must be a multiple of data axis {d}")
        per = b // d

        def rows(x, i):
            if x is None or not torch.is_tensor(x) or x.ndim == 0:
                return x
            return x[i * per:(i + 1) * per].to(self.stage0[i].device)

        outs = []
        for i in range(d):
            added = None if added_cond_kwargs is None else {
                k: rows(v, i) for k, v in added_cond_kwargs.items()}
            cut = self.encode(i, rows(sample, i), rows(t, i), rows(context, i),
                              timestep_cond=rows(timestep_cond, i), added_cond_kwargs=added,
                              ctrl=rows(ctrl, i), cn_scale=rows(cn_scale, i))
            outs.append(self.decode(i, *cut[:3], rows(context, i), cut[3]))
        return torch.cat([o.to(outs[0].device) for o in outs])


class _PipeProgram:
    """A pipelined frame program with the engine's calling convention (a
    ``build_frame_program`` program's); it runs eagerly, so it holds no
    bucket and no graph."""

    buckets: dict = {}
    graphs = 0

    def __init__(self, engine: "PipelinedFrameEngine", spec: FrameSpec):
        engine.check(spec)
        self.engine, self.spec = engine, spec
        self.last_launches: dict | None = None

    def __call__(self, frame_u8, prompt_embeds, strength, guidance, cn_scale, seed, noise=None,
                 *, warm_latents=None, warm_alpha=None, pooled_embeds=None, src_box=None):
        before = kernel_launches()
        out = self.engine.run(self.spec, frame_u8, prompt_embeds, strength, guidance, cn_scale,
                              seed, noise, warm_latents=warm_latents, warm_alpha=warm_alpha,
                              pooled_embeds=pooled_embeds, src_box=src_box)
        self.last_launches = {k: n - before[k] for k, n in kernel_launches().items()}
        return out


class PipelinedFrameEngine:
    """The frame chain (preprocess, encode, S denoise steps, decode)
    pipeline-parallel over two stage submeshes.

    Stage 0 runs the preprocess, the Sobel image, the VAE encode, the
    ladders and noising, and each step's ControlNet and UNet encoder half;
    stage 1 each step's decoder half and LCM update, and the VAE decode.
    Per step the cut state goes stage 0 -> 1 and the stepped latents come
    back (tiny, [B, h, w, 4]).  ``run`` has ``build_frame_program``'s call
    and outputs; ``run_pipelined`` overlaps microbatches."""

    def __init__(self, bundle: ModelBundle, *, devices=None, model_parallel: int = 1):
        self.bundle = bundle
        self.pipe = PipelinedUNet(bundle.models["unet"],
                                  controlnet=bundle.models.get("controlnet"),
                                  devices=devices, model_parallel=model_parallel)
        vaes = {k: bundle.models[k] for k in _VAE_DROP if k in bundle.models}
        self.vae0 = shard_params(vaes, self.pipe.mesh0, {k: v[0] for k, v in _VAE_DROP.items()})
        self.vae1 = shard_params(vaes, self.pipe.mesh1, {k: v[1] for k, v in _VAE_DROP.items()})
        # each stage row's bundle: the frame code runs on these as it runs on one device
        self.bundles0 = [row_bundle(bundle, {**p.models, **v.models}, p.device)
                         for p, v in zip(self.pipe.stage0, self.vae0)]
        self.bundles1 = [row_bundle(bundle, {**p.models, **v.models}, p.device)
                         for p, v in zip(self.pipe.stage1, self.vae1)]

    @property
    def data_size(self) -> int:
        return self.pipe.data_size

    def placements(self, stage: int) -> list:
        """A stage's placements, one per data row: the UNet half (and the
        ControlNet), then the VAE half."""
        return (self.pipe.stage0 + self.vae0) if stage == 0 else (self.pipe.stage1 + self.vae1)

    def refresh_params(self) -> None:
        """Copy the bundle's (swapped) weights into every stage's copies, in
        place."""
        self.pipe.refresh_params()
        for p in self.vae0 + self.vae1:
            p.load(self.bundle.models)

    def check(self, spec: FrameSpec) -> None:
        _check_spec(self.bundle, spec)
        if spec.controlnet_interval != 1 or spec.deepcache_interval != 1 or (
                spec.deepcache_temporal):
            raise ValueError(
                "PipelinedFrameEngine is parity-only: controlnet_interval/"
                "deepcache_interval/deepcache_temporal are single-program "
                "turbo levers")
        if spec.batch % self.data_size:
            raise ValueError(f"batch {spec.batch} must be a multiple of data axis "
                             f"{self.data_size}")

    def _start(self, spec, frame_u8, embeds, strength, guidance, cn, seed, noise=None,
               pooled_embeds=None, warm_latents=None, warm_alpha=None, src_box=None) -> list:
        """Stage each data row's share on its stage-0 device and run the
        prelude; returns one state a row."""
        inputs = _call_inputs(self.bundle, spec, frame_u8, embeds, strength, guidance, cn,
                              noise, warm_latents, warm_alpha, pooled_embeds, src_box, None)
        seeds = np.asarray(torch.as_tensor(seed).reshape(spec.batch))
        per = spec.batch // self.data_size
        row_spec = dataclasses.replace(spec, batch=per)
        states = []
        for i, (b0, b1) in enumerate(zip(self.bundles0, self.bundles1)):
            rows = slice(i * per, (i + 1) * per)
            row_in = {k: None if x is None else (x[:, rows] if k == "noise" else x[rows])
                      for k, x in inputs.items()}
            bufs = _new_buffers(b0, row_spec, row_in)
            _stage(bufs, row_in, seeds[rows], per)
            latents, latents0, ctrl, ts, valid, w_emb, added = _prelude(
                b0, row_spec, bufs["frame"], bufs["strength"], bufs["guidance"],
                bufs["noise"][0], bufs["warm_latents"], bufs["warm_alpha"], bufs["src_box"],
                bufs["pooled"])
            dev1 = b1.device
            states.append({
                "row": i, "spec": row_spec, "latents": latents, "ctrl": ctrl, "ts": ts,
                "w_emb": w_emb, "added": added, "context": bufs["context"],
                "cn": bufs["cn_scale"], "denoised": latents0.to(dev1),
                "ts1": ts.to(dev1), "valid1": valid.to(dev1), "noise1": bufs["noise"][1:].to(dev1),
            })
        return states

    def _step(self, st: dict, s: int) -> None:
        """Step ``s`` of one data row: stage 0 (ControlNet, encoder half),
        the transfer, stage 1 (decoder half, LCM update); the stepped
        latents go back to stage 0."""
        spec, row = st["spec"], st["row"]
        S = spec.steps
        ts = st["ts"]
        t = ts[:, s]
        x = _nchw(st["latents"])
        ctrl = st["ctrl"] if spec.use_controlnet and _cn_keep(spec, s) else None
        cut = self.pipe.encode(row, x, t, st["context"], timestep_cond=st["w_emb"],
                               added_cond_kwargs=st["added"], ctrl=ctrl, cn_scale=st["cn"])
        b1 = self.bundles1[row]
        eps = self.pipe.decode(row, *cut[:3], st["context"], cut[3])
        ts1 = st["ts1"]
        latents, st["denoised"] = _step_update(
            b1, spec, s, eps, ts1[:, s], ts1[:, s + 1] if s + 1 < S else ts1[:, s],
            st["valid1"], st["latents"].to(b1.device), st["denoised"],
            st["noise1"][s] if S > 1 else None)
        st["latents"] = latents.to(self.bundles0[row].device)

    def _finish(self, states: list) -> tuple:
        outs = [(_finale(self.bundles1[st["row"]], st["spec"], st["denoised"]), st["denoised"])
                for st in states]
        dev = outs[0][0].device
        return tuple(torch.cat([o[j].to(dev) for o in outs]) for j in range(2))

    def run(self, spec: FrameSpec, frame_u8, embeds, strength, guidance, cn, seed, noise=None,
            *, pooled_embeds=None, warm_latents=None, warm_alpha=None, src_box=None):
        """One batch through the pipelined chain (``build_frame_program``'s
        call and outputs); one batch keeps the two stages in turn, so fill
        both with :meth:`run_pipelined`."""
        return self.run_pipelined(spec, [dict(
            frame_u8=frame_u8, embeds=embeds, strength=strength, guidance=guidance, cn=cn,
            seed=seed, noise=noise, pooled_embeds=pooled_embeds, warm_latents=warm_latents,
            warm_alpha=warm_alpha, src_box=src_box)])[0]

    def serving_program(self, spec: FrameSpec) -> _PipeProgram:
        """The engine's program for ``spec``: ``build_frame_program``'s call
        signature, dispatched through the pipelined chain.  The stages read
        their own placed copies (:meth:`refresh_params` after a swap);
        ``mesh_pipe`` serving is single-model (the config refuses a
        ``models:`` registry with it)."""
        return _PipeProgram(self, spec)

    @torch.inference_mode()
    def run_pipelined(self, spec: FrameSpec, batches: list[dict]) -> list:
        """Several microbatches in the interleaved order: every microbatch's
        step s is issued before any step s + 1, so stage 0 works on
        microbatch m + 1 while stage 1 finishes m.  A device's queue runs
        in order, so the overlap is the dispatch order's."""
        self.check(spec)
        states = [self._start(spec, **b) for b in batches]
        for s in range(spec.steps):
            for rows in states:
                for st in rows:
                    self._step(st, s)
        return [self._finish(rows) for rows in states]
