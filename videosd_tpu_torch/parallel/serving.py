"""Multi-device serving: the frame program over the mesh's data rows.

Counterpart of ``videosd_tpu/parallel/serving.py``.  Where the JAX package
places one jitted program's batch over the ``data`` axis and GSPMD
partitions it, the port runs one program per data row: each row holds its
own copy of the frame's models (``parallel/mesh.py::shard_params``; the
attention and feed-forward split over the row's model slots), takes its
contiguous share of the batch rows and runs the frame program on it, and
the outputs are concatenated in row order on the mesh's first slot.

Every input is per row (frames, embeddings, sliders, seeds, warm latents,
source boxes, deep caches), and so is every reduction of the frame body
(the Sobel maximum over each image, AdaIN over each image's positions), so
a row split changes no result.  Noise is drawn per element from that
element's seed (``lcm_img2img._draw_noise``), so a row sees the noise it
would see alone; the ``noise`` seam [S+1, B, h, w, 4] splits on its batch
dim.

A data row whose slots are all one CUDA device captures its program as CUDA
graphs, as ``FrameProgram`` does (a one-card mesh of repeated ``cuda:0``
slots, tensor-parallel rows included: their cross-slot copies move
nothing).  A row that spans distinct cards runs eagerly: its launches go to
each card's queue in order and the cards overlap, but no graph is captured
across them (``lcm_img2img._graphed``).  The text towers stay on the
engine's device (``mesh.py``); the embeddings move to each row at staging.

Over a mesh that spans processes (``mesh.py::init_distributed``), each
process holds and runs only its own data rows: every process passes the
whole batch to :meth:`ShardedProgram.shards`, which gives the outputs of
this process's rows with their global batch rows (JAX's
``out.addressable_shards``); a plain call, which would return fewer rows
than the batch, raises.  Nothing crosses processes while serving.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videosd_tpu_torch.parallel.mesh import Mesh, data_sharding, make_mesh, shard_params
from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program

__all__ = ["FRAME_MODELS", "ShardedFrameEngine", "ShardedProgram", "row_bundle",
           "shard_program"]

# the models a frame program runs; the text towers stay on the engine's device
FRAME_MODELS = ("unet", "controlnet", "taesd", "vae")


def row_bundle(bundle: ModelBundle, models: dict, device) -> ModelBundle:
    """``bundle`` with its frame models replaced by a row's (or a stage's)
    placed copies, on that row's first slot."""
    return dataclasses.replace(bundle, models=models, device=device,
                               alphas_cumprod=bundle.alphas_cumprod.to(device))


class ShardedProgram:
    """One program per data row behind the calling convention of one
    program: a call splits every batch-leading input by rows (``noise`` on
    its batch dim), runs each row's program, and concatenates each output
    on the first row's device.

    ``programs``: one per data row this process runs (every row of a
    one-process mesh); ``rows``: their slices of the batch.  ``buckets``:
    the first row's (every row has the same signatures); ``last_launches``:
    the kernel launches of the last call over every row.
    """

    def __init__(self, programs: list, mesh: Mesh, batch: int):
        self.programs, self.mesh, self.batch = programs, mesh, batch
        every = data_sharding(mesh, batch)
        self.rows = [every[i] for i in mesh.local_rows()]
        self.device = programs[0].bundle.device

    @property
    def buckets(self) -> dict:
        return self.programs[0].buckets

    @property
    def graphs(self) -> int:
        return sum(b.graph is not None for p in self.programs for b in p.buckets.values())

    @property
    def last_launches(self) -> dict | None:
        rows = [p.last_launches for p in self.programs]
        if any(r is None for r in rows):
            return None
        return {k: sum(r[k] for r in rows) for k in rows[0]}

    def _split(self, x, dim: int = 0) -> list:
        """A tensor's or an array's rows per data row (views)."""
        if x is None:
            return [None] * len(self.rows)
        if not hasattr(x, "shape"):
            x = np.asarray(x)
        if x.ndim <= dim or x.shape[dim] != self.batch:
            return [x] * len(self.rows)  # not batch-leading: every row takes it whole
        return [x[(slice(None),) * dim + (rows,)] for rows in self.rows]

    def shards(self, *args, noise=None, **kwargs) -> list:
        """``[(rows, outputs)]`` for each data row this process runs: its
        slice of the whole batch and its program's outputs on its row's
        device (JAX's ``out.addressable_shards``)."""
        args = [self._split(a) for a in args]
        kwargs = {k: self._split(v) for k, v in kwargs.items()}
        if noise is not None:
            kwargs["noise"] = self._split(noise, 1)
        return [(rows, prog(*(a[i] for a in args), **{k: v[i] for k, v in kwargs.items()}))
                for i, (rows, prog) in enumerate(zip(self.rows, self.programs))]

    def __call__(self, *args, noise=None, **kwargs):
        """The whole batch's outputs, in batch order.  Over a mesh that
        spans processes this process holds only its rows' outputs, so a
        call raises: :meth:`shards` gives them with their batch rows."""
        if self.mesh.spans_processes:
            raise RuntimeError(
                "ShardedProgram: the mesh spans processes and this process runs only its own "
                f"data rows ({self.mesh.local_rows()}); call shards(...) for them with their "
                "batch rows")
        outs = [o for _, o in self.shards(*args, noise=noise, **kwargs)]
        return tuple(torch.cat([o[j].to(self.device) for o in outs]) for j in range(len(outs[0])))


def shard_program(build, row_bundles: list, spec: FrameSpec, mesh: Mesh) -> ShardedProgram:
    """``build(bundle, spec)`` (``build_frame_program`` or
    ``build_reference_program``) for each of this process's data rows'
    bundles (``row_bundles``, :meth:`Mesh.local_rows` order) at its share of
    ``spec.batch``, behind one :class:`ShardedProgram`."""
    rows = data_sharding(mesh, spec.batch)
    row_spec = dataclasses.replace(spec, batch=rows[0].stop - rows[0].start)
    return ShardedProgram([build(b, row_spec) for b in row_bundles], mesh, spec.batch)


class ShardedFrameEngine:
    """Owns mesh-placed models and per-bucket sharded frame programs.

    ``devices``: the mesh's slots (default: every visible CUDA device, the
    first ``n_devices``, or every process's after ``init_distributed``);
    ``mesh``: a mesh made already, in their place.  Batch sizes must be
    multiples of the data-axis size so each row gets equal work."""

    def __init__(self, bundle: ModelBundle, *, n_devices: int | None = None,
                 model_parallel: int = 1, devices=None, mesh: Mesh | None = None):
        self.bundle = bundle
        self.mesh = mesh or make_mesh(n_devices, model_parallel=model_parallel, devices=devices)
        models = {k: bundle.models[k] for k in FRAME_MODELS if k in bundle.models}
        self.placements = shard_params(models, self.mesh)
        self.row_bundles = [row_bundle(bundle, p.models, p.device) for p in self.placements]
        self._programs: dict = {}

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]

    def refresh_params(self) -> None:
        """Copy the bundle's (swapped) weights into every row's copies in
        place: every captured graph keeps reading them."""
        for p in self.placements:
            p.load(self.bundle.models)

    def program(self, spec: FrameSpec, *, ref_mode: bool = False) -> ShardedProgram:
        if spec.batch % self.data_size:
            raise ValueError(
                f"batch {spec.batch} must be a multiple of data axis {self.data_size}")
        prog = self._programs.get((spec, ref_mode))
        if prog is None:
            if ref_mode:
                from videosd_tpu_torch.pipelines.reference_attn import build_reference_program

                build = build_reference_program
            else:
                build = build_frame_program
            prog = self._programs[(spec, ref_mode)] = shard_program(
                build, self.row_bundles, spec, self.mesh)
        return prog

    def run(self, spec: FrameSpec, frame_u8, embeds, strength, guidance, cn, seed, noise=None,
            **kw):
        """``build_frame_program``'s call over the mesh; ``kw``:
        ``warm_latents``/``warm_alpha``, ``pooled_embeds``, ``src_box``,
        ``deep_caches``, each split over the data axis.  Over a mesh that
        spans processes it raises: ``program(spec).shards(...)`` gives this
        process's rows."""
        return self.program(spec)(frame_u8, embeds, strength, guidance, cn, seed, noise=noise,
                                  **kw)
