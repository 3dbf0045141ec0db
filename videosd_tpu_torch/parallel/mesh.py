"""Device mesh and placement rules: the ("data", "model") mesh over the port.

Counterpart of ``videosd_tpu/parallel/mesh.py``.  The JAX package is one
process per host driving a ``jax.sharding.Mesh``, with GSPMD inserting the
collectives; the port keeps that shape (one process per host, one dispatch
thread) and writes the sharding out in PyTorch:

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
* training (``train/step.py``) keeps the whole model, its gradients and
  its optimizer state where the caller's model lives (the master), and
  the placements are copies loaded from it before each step; the data
  rows' gradients are reduced into the master (:func:`reduce_grads`) and
  the optimizer steps the whole tensors.  JAX shards the moments like the
  params (an optimizer's statistics over a whole tensor, as Adafactor's,
  are then GSPMD's to form); the port pays one whole copy of the model and
  its optimizer state (about 14 GB for the fp32 sd15 UNet under AdamW);
* across processes (:func:`init_distributed`) a model row lies within one
  process: its slots' partial sums are local copies, and only the
  data-axis reductions cross processes (``torch.distributed``).  JAX's
  8 devices over 2 processes at ``model_parallel=2`` never split a row
  either; a mesh whose row would span processes raises.

More than one process: :func:`init_distributed` joins a
``torch.distributed`` process group (the counterpart of
``jax.distributed.initialize``); :func:`make_mesh` then lays the mesh over
every process's local slots in rank order, each slot recording its
process, and each process places and runs only its own data rows
(:meth:`Mesh.local_rows`).  The data-axis reduction is
:func:`reduce_data` (JAX's ``psum(x, "data")``): the local rows' sum, then
one ``all_reduce`` over the group.  The group's backend is ``nccl`` only
where each process owns cards no other process uses, ``gloo`` otherwise
(the CPU; processes sharing one card, which NCCL refuses).
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import itertools
import logging
import os
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "Mesh",
    "PARAM_RULES",
    "Placement",
    "World",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "param_spec",
    "reduce_data",
    "reduce_grads",
    "replicated",
    "shard_params",
    "shutdown_distributed",
    "world",
]

log = logging.getLogger("videosd_tpu_torch.parallel")

# seconds a process waits for the others: at the group's rendezvous and in
# each collective (a peer that died fails the survivors, it never hangs them)
DIST_TIMEOUT_S = 120.0


@dataclasses.dataclass
class World:
    """The process group :func:`init_distributed` joined: this process's
    ``rank`` of ``size``, its ``local`` slots (``torch.device``), every
    process's slots in rank order (``slots``, device strings), and the
    ``group`` the data-axis reductions run over with its ``backend``."""

    rank: int
    size: int
    local: list
    slots: list
    backend: str
    group: object


_WORLD: World | None = None


def world() -> World | None:
    """The process group joined by :func:`init_distributed`, or None (one
    process)."""
    return _WORLD


def _local_devices() -> list:
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def _card_ids(devices: list) -> list:
    """The cards behind ``devices``' CUDA entries, by UUID (a card shared by
    two processes shows in both lists)."""
    return sorted({str(torch.cuda.get_device_properties(d).uuid)
                   for d in devices if d.type == "cuda"})


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, devices=None,
                     timeout: float = DIST_TIMEOUT_S) -> int:
    """Join the processes of a multi-process mesh; returns the global slot
    count.  Counterpart of JAX's ``jax.distributed.initialize`` wrapper.

    ``devices``: this process's slots (default: every visible CUDA device,
    else the CPU; the CPU tests pass ``[torch.device("cpu")] * 4``, as
    JAX's test forces 4 virtual devices a process).  With ``num_processes
    > 1`` or a ``coordinator_address`` (``host:port``), this process joins
    a ``torch.distributed`` group at ``tcp://<coordinator_address>`` as
    ``process_id`` of ``num_processes``; without ``num_processes``, rank
    and size come from ``RANK`` and ``WORLD_SIZE`` (as ``torchrun`` sets
    them).  Otherwise one process drives its local slots, as a single-host
    JAX slice does, and their count is returned.

    The data-axis reductions run over ``nccl`` where every local slot is
    a card that no other process uses, else over ``gloo`` (the CPU; two
    processes on one card, which NCCL refuses); the choice is logged.  The
    rendezvous and every collective wait at most ``timeout`` seconds; a
    failed join raises and never carries on as one process."""
    global _WORLD
    local = [_device(d) for d in devices] if devices is not None else _local_devices()
    if not ((num_processes is not None and num_processes > 1) or coordinator_address):
        return len(local)
    if not coordinator_address:
        raise ValueError("init_distributed: num_processes > 1 needs coordinator_address "
                         "(host:port of rank 0)")
    if _WORLD is not None:
        raise RuntimeError("init_distributed: this process already joined a group "
                           "(shutdown_distributed() first)")
    try:
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    except KeyError as missing:
        raise ValueError(f"init_distributed: no num_processes/process_id given and {missing} "
                         "is not set") from None
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes, timeout=wait)
    mine = {"slots": [str(d) for d in local], "cards": _card_ids(local),
            "cuda": all(d.type == "cuda" for d in local)}
    every = [None] * num_processes
    dist.all_gather_object(every, mine)
    # one decision on every process: each must take the same collectives
    cards = [c for e in every for c in e["cards"]]
    owned = all(e["cuda"] for e in every) and len(cards) == len(set(cards))
    if owned:
        chosen = "nccl"
        torch.cuda.set_device(local[0])
        group = dist.new_group(backend="nccl", timeout=wait)
    else:
        chosen, group = "gloo", dist.group.WORLD
    _WORLD = World(process_id, num_processes, local, [e["slots"] for e in every], chosen, group)
    log.info("init_distributed: rank %d of %d at tcp://%s, data-axis reductions over %s, "
             "local slots %s", process_id, num_processes, coordinator_address, chosen,
             mine["slots"])
    return sum(len(e["slots"]) for e in every)


def shutdown_distributed() -> None:
    """Leave the group :func:`init_distributed` joined (no-op without one)."""
    global _WORLD
    if _WORLD is not None:
        _WORLD = None
        dist.destroy_process_group()


def _rank() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices``: a [data, model] array of ``torch.device``; ``slots``:
    the same shape of slot numbers (positions in the device list the mesh
    was cut from, so a pipeline's two submeshes number their slots apart);
    ``processes``: the same shape of the rank owning each slot (default:
    this process for every slot).  A data row lies within one process.
    """

    axis_names = ("data", "model")

    def __init__(self, devices, model_parallel: int = 1, *, slots=None, processes=None):
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
        self.processes = (np.full(shape, _rank()) if processes is None
                          else np.asarray(processes).reshape(shape))
        for i, owners in enumerate(self.processes):
            if len(set(owners.tolist())) > 1:
                raise ValueError(
                    f"data row {i} would span processes {sorted(set(owners.tolist()))}: a model "
                    f"row lies within one process (model_parallel={model_parallel} must divide "
                    "each process's slots)")

    @property
    def spans_processes(self) -> bool:
        """Whether the data rows lie in more than one process."""
        return len(set(self.processes.flat)) > 1

    def local_rows(self) -> list:
        """The data rows this process runs, in row order."""
        return [i for i in range(self.devices.shape[0]) if self.processes[i, 0] == _rank()]

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
    (``[torch.device("cpu")] * 8``).  After :func:`init_distributed` joined
    more than one process, the default is every process's slots in rank
    order (each slot recording its process), and a mesh whose model row
    would span processes raises.  Another layout over the processes (one
    row a process, say) is a :class:`Mesh` with ``processes=``."""
    owners = None
    if devices is None and _WORLD is not None:
        devices, owners = [], []
        for rank, slots in enumerate(_WORLD.slots):
            mine = _WORLD.local if rank == _WORLD.rank else slots
            devices += list(mine)
            owners += [rank] * len(mine)
    elif devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8)")
    if n_devices is not None:
        devices = list(devices)[:n_devices]
        owners = None if owners is None else owners[:n_devices]
    return Mesh(devices, model_parallel, processes=owners)


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
    # pre-concatenated QKV/KV weights (models/unet.py::precat_attention_weights),
    # column parallel like their parts: rank r holds its rows of each part
    (r"(wqkv|wkv)$", ("model", None)),
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
    or None), what :meth:`load` copies in; ``row``: the data row."""

    models: dict
    device: torch.device
    slots: dict
    sources: dict
    row: int = 0
    _indices: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def index(self, key: str, device) -> torch.Tensor:
        """The source rows (or columns) of tensor ``key``'s index ranges, as
        an index tensor on ``device``, made once."""
        device = torch.device(device)
        cached = self._indices.get((key, device))
        if cached is None:
            ranges = self.sources[key][3]
            cached = self._indices[(key, device)] = torch.tensor(
                [i for r in ranges for i in r], device=device)
        return cached

    @torch.no_grad()
    def load(self, models: dict) -> None:
        """Copy every tensor in place from the source ``models`` ({name:
        module}, the whole models on any device): the addresses a CUDA graph
        captured stay valid.  Each parameter takes ``requires_grad`` from its
        source: a trained model's copies train, a frozen one's stay frozen."""
        src = {name: dict(_tensors(m)) for name, m in models.items() if name in self.models}
        for name, mod in self.models.items():
            for key, dst in _tensors(mod):
                model, sname, dim, index = self.sources[f"{name}.{key}"]
                t = src[model][sname]
                if isinstance(dst, nn.Parameter):
                    dst.requires_grad_(t.requires_grad)
                if index is not None:
                    t = t.index_select(dim, self.index(f"{name}.{key}", t.device))
                dst.copy_(t)

    def gradients(self):
        """The inverse of :meth:`load`'s reading: for each parameter of the
        row's copies that has a gradient, ``((model, source tensor), grad,
        dim, index or None)``: where in the source tensor the gradient
        belongs (a split tensor's rows or columns along ``dim`` at
        :meth:`index`, the GEGLU projection's two halves as two ranges)."""
        for name, mod in self.models.items():
            for key, p in mod.named_parameters():
                if p.grad is not None:
                    model, sname, dim, index = self.sources[f"{name}.{key}"]
                    if index is not None:
                        index = self.index(f"{name}.{key}", p.grad.device)
                    yield (model, sname), p.grad, dim, index

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
    per data row this process runs (:meth:`Mesh.local_rows`; every row of
    a one-process mesh), holding a copy of each model whose attention and
    feed-forward layers split over the row's model slots
    (``parallel/tensor.py``) and whose other layers sit on its first slot.
    ``drop``: {name: top-level children to leave out}."""
    drop = drop or {}
    out = []
    # the copies are normal tensors even when placed from inside inference
    # mode (an engine places at its first dispatch): a later swap updates
    # them in place
    with torch.inference_mode(False):
        for i in mesh.local_rows():
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
    placed = Placement(copies, devices[0], where, sources, i)
    placed.load(models)
    return placed


def _all_reduce(t: torch.Tensor) -> None:
    """Sum ``t`` in place over the processes of :func:`init_distributed`'s
    group (gloo reduces a copy in host memory)."""
    if _WORLD.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=_WORLD.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=_WORLD.group)


def reduce_data(parts: list, mesh: Mesh) -> torch.Tensor:
    """The sum over the mesh's data axis, JAX's ``psum(x, "data")``:
    ``parts`` are this process's data rows' values (one tensor a row of
    :meth:`Mesh.local_rows`, any devices); they are summed on the first
    one's device, then all-reduced over the processes when the mesh spans
    more than one.  Every process gets the same sum."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part.to(total.device)
    if mesh.spans_processes:
        _all_reduce(total)
    return total


@torch.no_grad()
def reduce_grads(placements: list, models: dict, mesh: Mesh) -> None:
    """Set each parameter of the source ``models`` ({name: module}) that
    got a gradient in any of ``placements`` (this process's data rows) to
    the mean over the mesh's data rows of those gradients, as
    :meth:`Placement.gradients` places them: a replicated tensor's whole
    gradient, a split tensor's slices at their ranges.  The rows' sum is
    formed in one flat buffer per (device, dtype) and all-reduced over the
    processes when the mesh spans more than one, so every process holds
    the same gradients.  Parameters without a gradient anywhere keep
    ``grad`` None."""
    params = {(name, key): p for name, m in models.items() for key, p in m.named_parameters()}
    parts = [g for pl in placements for g in pl.gradients()]
    have = {key for key, *_ in parts}
    order = [key for key in params if key in have]
    buckets: dict = {}
    for key in order:
        p = params[key]
        buckets.setdefault((p.device, p.dtype), []).append(key)
    views = {}
    for (device, dtype), keys in buckets.items():
        flat = torch.zeros(sum(params[k].numel() for k in keys), dtype=dtype, device=device)
        offset = 0
        for k in keys:
            n = params[k].numel()
            views[k] = flat[offset:offset + n].view_as(params[k])
            offset += n
        buckets[(device, dtype)] = flat
    for key, grad, dim, index in parts:
        acc = views[key]
        grad = grad.to(acc.device, acc.dtype)
        if index is None:
            acc += grad
        else:
            acc.index_add_(dim, index.to(acc.device), grad)
    for flat in buckets.values():
        if mesh.spans_processes:
            _all_reduce(flat)
        flat /= mesh.shape["data"]
    for key in order:
        params[key].grad = views[key]


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
