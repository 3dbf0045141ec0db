"""Device mesh and placement rules: the ("data", "model") mesh over the port.

Counterpart of ``videosd_tpu/parallel/mesh.py``.  The JAX package is one
process driving a ``jax.sharding.Mesh``, with GSPMD inserting the
collectives; the port keeps that shape (one process, one dispatch thread)
and writes the sharding out in PyTorch:

* :class:`Mesh` is a 2-D array of ``torch.device`` with axes ``("data",
  "model")``.  Entries may repeat: the CPU tests pass eight ``cpu``
  entries (as the JAX tests run on eight virtual CPU devices) and a
  one-card machine passes ``cuda:0`` several times.  Each entry is a
  *slot*, numbered in the mesh's device list; placement is recorded by
  slot, since with repeated devices ``tensor.device`` proves nothing.
* ``data``: a batch is split by rows over the data axis, and each data row
  runs its own copy of the models (:func:`shard_params` places one
  :class:`Placement` per row; ``parallel/serving.py`` runs them).
* ``model``: Megatron tensor parallelism inside a data row
  (``parallel/tensor.py``): rank r holds heads/m of every attention's
  ``to_q``/``to_k``/``to_v`` and the matching input slice of ``to_out``,
  and 1/m of every GEGLU feed-forward; the partial outputs are summed on
  the row's first slot.  Convs, norms, embeddings and every other layer
  are replicated.

Placement differences from the JAX package (the numbers are the same):

* the replicated layers live and run on each data row's first model slot
  only (JAX replicates them on every slot of the row, and each runs them);
* a layer is split by whole heads: an attention whose head count does not
  divide by m (sd21's 5 heads at 320 channels when m = 2, the KL VAE's one
  head) stays whole, where JAX splits the weight whenever its dim divides
  and GSPMD copes with a head cut inside;
* an attention or feed-forward any of whose linears is int8
  (``LinearW8A8``) stays whole, as JAX's rules, which match ``.../kernel``,
  leave a w8a8 tree replicated;
* the text towers stay whole on the engine's own device: they run once per
  prompt, and their rules are listed in :data:`PARAM_RULES` only so that
  :func:`param_spec` answers as JAX's does;
* JAX's pre-concatenated ``wqkv``/``wkv`` rules have no counterpart: the
  port concatenates each rank's own slices at run time.

Multi-host serving (``init_distributed`` with more than one process) is
not ported: it would be ``torch.distributed`` across processes, another
design than this single-controller mesh (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import re

import numpy as np
import torch
from torch import nn

__all__ = [
    "Mesh",
    "PARAM_RULES",
    "Placement",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "param_spec",
    "replicated",
    "shard_params",
]


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """The local device count (CUDA devices, else the one CPU).  One
    process drives every local device, as a single-host JAX slice does;
    more processes (or a coordinator) would be multi-host serving, which
    the port does not have yet (ROADMAP.md queue 1, multi-host)."""
    if (num_processes is not None and num_processes > 1) or coordinator_address:
        raise NotImplementedError(
            "multi-host serving (torch.distributed across processes) is not ported: "
            "ROADMAP.md queue 1, multi-host; one process drives the local devices")
    return max(1, torch.cuda.device_count())


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices``: a [data, model] array of ``torch.device``; ``slots``:
    the same shape of slot numbers (positions in the device list the mesh
    was cut from, so a pipeline's two submeshes number their slots apart).
    """

    axis_names = ("data", "model")

    def __init__(self, devices, model_parallel: int = 1, *, slots=None):
        devices = [_device(d) for d in devices]
        n = len(devices)
        if n == 0 or n % model_parallel:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        shape = (n // model_parallel, model_parallel)
        self.devices = np.empty(n, dtype=object)
        self.devices[:] = devices
        self.devices = self.devices.reshape(shape)
        self.slots = np.arange(n).reshape(shape) if slots is None else np.asarray(slots).reshape(
            shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def row(self, i: int) -> tuple[list, list]:
        """Data row ``i``: its devices and slots, model rank order."""
        return list(self.devices[i]), [int(s) for s in self.slots[i]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, *, model_parallel: int = 1, devices=None) -> Mesh:
    """Mesh with ("data","model") axes; data = n_devices // model_parallel.
    ``devices`` defaults to every visible CUDA device (the first
    ``n_devices`` of them); without a card, pass them
    (``[torch.device("cpu")] * 8``)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8)")
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, model_parallel)


# State-dict key regex -> spec over the torch tensor's dims.  JAX's rules
# (``videosd_tpu/parallel/mesh.py::PARAM_RULES``) name [in, out] kernels;
# ``nn.Linear.weight`` is [out, in], so JAX's P(None, "model") (column
# parallel: QKV, FF in) shards dim 0 here and P("model", None) (row
# parallel: the attention and FF outputs) dim 1.  A column-parallel
# linear's bias shards with its rows (JAX replicates it and GSPMD slices it
# at use); a row-parallel one's is replicated and added once, after the sum.
# The GEGLU projection's dim 0 is [a | gate]: rank r takes rows r/m of each
# half (parallel/tensor.py), not a contiguous 1/m of the whole.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight$", ("model", None)),
    (r"(q_proj|k_proj|v_proj)\.bias$", ("model",)),
    (r"(to_out\.0|out_proj)\.weight$", (None, "model")),
    (r"ff\.net\.0\.proj\.weight$", ("model", None)),
    (r"ff\.net\.0\.proj\.bias$", ("model",)),
    (r"ff\.net\.2\.weight$", (None, "model")),
    (r"mlp\.fc1\.weight$", ("model", None)),
    (r"mlp\.fc1\.bias$", ("model",)),
    (r"mlp\.fc2\.weight$", (None, "model")),
    (r"token_embedding\.weight$", (None, None)),
]


def param_spec(name: str) -> tuple:
    """The spec of the state-dict tensor ``name`` over its dims: ``"model"``
    where the rule shards it, else None; ``()`` when no rule matches
    (replicated)."""
    for pat, spec in PARAM_RULES:
        if re.search(pat, name):
            return spec
    return ()


def _tensors(module: nn.Module):
    return itertools.chain(module.named_parameters(), module.named_buffers())


def _meta_copy(module: nn.Module) -> nn.Module:
    """``module``'s structure with every parameter and buffer on the meta
    device (no storage)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        e = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(e, requires_grad=False) if isinstance(t, nn.Parameter) else e
    return copy.deepcopy(module, memo)


@dataclasses.dataclass
class Placement:
    """The models of one data row on their mesh slots.

    ``models``: {name: module}, the row's copies (tensor-parallel layers
    swapped in where the model axis splits them); ``device``: the row's
    first model slot's device, where the replicated layers run and the
    partial sums land; ``slots``: ``"model.tensor"`` -> the slot holding it;
    ``sources``: the same keys -> (model, source tensor, dim, index ranges
    or None), what :meth:`load` copies in."""

    models: dict
    device: torch.device
    slots: dict
    sources: dict

    @torch.no_grad()
    def load(self, models: dict) -> None:
        """Copy every tensor in place from the source ``models`` ({name:
        module}, the whole models on any device): the addresses a CUDA graph
        captured stay valid."""
        src = {name: dict(_tensors(m)) for name, m in models.items() if name in self.models}
        for name, mod in self.models.items():
            for key, dst in _tensors(mod):
                model, sname, dim, index = self.sources[f"{name}.{key}"]
                t = src[model][sname]
                if index is not None:
                    rows = torch.tensor([i for r in index for i in r], device=t.device)
                    t = t.index_select(dim, rows)
                dst.copy_(t)

    def nbytes(self) -> int:
        """Bytes of the tensors this row holds, over all its slots."""
        return sum(t.numel() * t.element_size()
                   for mod in self.models.values() for _, t in _tensors(mod))


def shard_module(module: nn.Module, devices: list, drop=()) -> tuple[nn.Module, dict, dict]:
    """A copy of ``module`` for one data row (``devices``: its model slots'
    devices, rank order), its values not yet loaded.  ``drop``: top-level
    children left out (a pipeline stage's other half).  Returns ``(copy,
    ranks, sources)``: each tensor's model rank and its source (tensor
    name, dim, index ranges or None)."""
    from videosd_tpu_torch.parallel.tensor import split_layer, splittable

    replica = _meta_copy(module)
    for name in drop:
        if name in replica._modules:
            delattr(replica, name)
    m = len(devices)
    targets = [name for name, sub in replica.named_modules() if m > 1 and splittable(sub, m)]
    replica = replica.to_empty(device=devices[0]).eval().requires_grad_(False)
    ranks, sources = {}, {}
    split = {}
    for name in targets:
        parent, _, attr = name.rpartition(".")
        owner = replica.get_submodule(parent)
        layer, local = split_layer(owner.get_submodule(attr), devices)
        owner._modules[attr] = layer
        split[name] = local
    for key, _ in _tensors(replica):
        sources[key], ranks[key] = (key, None, None), 0
        for name, local in split.items():
            if key.startswith(name + "."):
                rank, src = local[key[len(name) + 1:]]
                sources[key], ranks[key] = (f"{name}.{src[0]}", *src[1:]), rank
    return replica, ranks, sources


def shard_params(models: dict, mesh: Mesh, drop: dict | None = None) -> list[Placement]:
    """Place ``models`` ({name: module}) on the mesh: one :class:`Placement`
    per data row, holding a copy of each model whose attention and
    feed-forward layers split over the row's model slots
    (``parallel/tensor.py``) and whose other layers sit on its first slot.
    ``drop``: {name: top-level children to leave out}."""
    drop = drop or {}
    out = []
    # the copies are normal tensors even when placed from inside inference
    # mode (an engine places at its first dispatch): a later swap updates
    # them in place
    with torch.inference_mode(False):
        for i in range(mesh.shape["data"]):
            out.append(_place_row(models, mesh, i, drop))
    return out


def _place_row(models: dict, mesh: Mesh, i: int, drop: dict) -> Placement:
    """Data row ``i``'s :class:`Placement` of ``models``."""
    devices, slots = mesh.row(i)
    copies, where, sources = {}, {}, {}
    for name, module in models.items():
        copies[name], ranks, srcs = shard_module(module, devices, drop.get(name, ()))
        for key, rank in ranks.items():
            where[f"{name}.{key}"] = slots[rank]
            sources[f"{name}.{key}"] = (name, *srcs[key])
    placed = Placement(copies, devices[0], where, sources)
    placed.load(models)
    return placed


def data_sharding(mesh: Mesh, batch: int) -> list[slice]:
    """The rows of a ``batch`` that each data row takes (JAX's
    ``P("data")`` placement): equal contiguous slices in row order."""
    d = mesh.shape["data"]
    if batch % d:
        raise ValueError(f"batch {batch} must be a multiple of data axis {d}")
    b = batch // d
    return [slice(i * b, (i + 1) * b) for i in range(d)]


def replicated(mesh: Mesh) -> list:
    """Where a replicated input goes: each data row's first slot (the
    device its replicated layers run on)."""
    return [mesh.row(i)[0][0] for i in range(mesh.shape["data"])]
