"""Tensor parallelism over a mesh's model axis, as explicit PyTorch.

The JAX package has no file for this: it places the weights by
``parallel/mesh.py::PARAM_RULES`` and GSPMD partitions the program and
inserts the collectives.  The port writes the same Megatron layout out:

* attention (``models/unet.py::Attention``): rank r holds heads
  ``[r*h/m, (r+1)*h/m)``, that is rows ``[r*C/m, (r+1)*C/m)`` of
  ``to_q``/``to_k``/``to_v`` (column parallel) and the same columns of
  ``to_out``'s weight (row parallel).  Its shard is an ``Attention`` of h/m
  heads without output bias, so the fused self-attention QKV GEMM and the
  banked READ pass's fused K/V concatenate the rank's *own* slices, and K1
  runs on the rank's own heads.  A pre-concatenated ``wqkv``/``wkv``
  (``precat_attention_weights``) splits the same way: rank r's is the
  concatenation of its q, k and v rows (not a contiguous cut of the whole),
  gathered once at placement (JAX's GSPMD split of the sharded concat,
  laid out per rank);
* feed-forward (``FeedForward``, GEGLU): ``net.0.proj``'s output is
  ``[a | gate]``, so rank r takes rows ``[r*i/m, (r+1)*i/m)`` of both halves
  (``i`` hidden units; a contiguous 1/m of the whole would hand one rank all
  of ``a`` and another all of ``gate``), and the same columns of
  ``net.2``.

:class:`TensorParallel` runs each shard on its slot and sums the partial
outputs on the first slot (the all-reduce, as ``.to(device)`` and adds, in
fp32), adds the row-parallel bias once, and casts to the input's dtype.
On slots that are one device the ``.to`` moves nothing.
"""

from __future__ import annotations

import torch
from torch import nn

from videosd_tpu_torch.models.unet import Attention, FeedForward

__all__ = ["TensorParallel", "split_layer", "splittable"]


class TensorParallel(nn.Module):
    """``shards[r]`` on ``devices[r]``; ``bias`` (on ``devices[0]``) the
    row-parallel output bias, or None."""

    def __init__(self, shards: list, devices: list, bias):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x, context=None):
        lead = self.devices[0]
        total = None
        for shard, dev in zip(self.shards, self.devices):
            args = [x.to(dev, non_blocking=True)]
            if context is not None:
                args.append(context.to(dev, non_blocking=True))
            part = shard(*args).to(lead, non_blocking=True).float()
            total = part if total is None else total + part
        if self.bias is not None:
            total = total + self.bias.float()
        return total.to(x.dtype)


def _linears(mod: nn.Module) -> list:
    if isinstance(mod, Attention):
        return [mod.to_q, mod.to_k, mod.to_v, mod.to_out[0]]
    return [mod.net[0].proj, mod.net[2]]


def splittable(mod: nn.Module, m: int) -> bool:
    """Whether ``mod`` splits over ``m`` model ranks: an attention whose
    head count divides by m, or a feed-forward whose hidden units do, with
    every linear a plain ``nn.Linear`` (an int8 ``LinearW8A8`` stays
    whole).  Anything else is replicated."""
    if isinstance(mod, Attention):
        width = mod.heads
    elif isinstance(mod, FeedForward):
        width = mod.net[2].in_features
    else:
        return False
    return width % m == 0 and all(type(lin) is nn.Linear for lin in _linears(mod))


def _empty(ctor, like: torch.Tensor, device) -> nn.Module:
    with torch.device("meta"):
        mod = ctor()
    return mod.to(like.dtype).to_empty(device=device).eval().requires_grad_(False)


def split_layer(mod: nn.Module, devices: list) -> tuple[TensorParallel, dict]:
    """``mod``'s tensor-parallel form over ``devices`` (values not loaded),
    and its sources: ``{tensor name in the new layer: (rank, (tensor name
    in mod, dim, index ranges or None))}``."""
    m = len(devices)
    local = {}
    shards = []
    if isinstance(mod, Attention):
        inner = mod.to_q.out_features
        per = inner // m
        out = mod.to_out[0]
        for r, dev in enumerate(devices):
            rows = (range(r * per, (r + 1) * per),)
            shards.append(_empty(lambda: Attention(mod.to_q.in_features, mod.to_k.in_features,
                                                   mod.heads // m, inner_dim=per,
                                                   out_bias=False),
                                 out.weight, dev))
            for name in ("to_q", "to_k", "to_v"):
                local[f"shards.{r}.{name}.weight"] = (r, (f"{name}.weight", 0, rows))
            local[f"shards.{r}.to_out.0.weight"] = (r, ("to_out.0.weight", 1, rows))
            # a fused weight's slice: the rank's rows of each part it stacks
            for name, parts in (("wqkv", 3), ("wkv", 2)):
                fused = getattr(mod, name)
                if fused is not None:
                    setattr(shards[-1], name, nn.Parameter(
                        torch.empty(parts * per, fused.shape[1], dtype=fused.dtype, device=dev),
                        requires_grad=False))
                    own = tuple(range(i * inner + r * per, i * inner + (r + 1) * per)
                                for i in range(parts))
                    local[f"shards.{r}.{name}"] = (r, (name, 0, own))
    else:
        proj, out = mod.net[0].proj, mod.net[2]
        inner = out.in_features
        per = inner // m
        for r, dev in enumerate(devices):
            own = range(r * per, (r + 1) * per)
            halves = (own, range(inner + own.start, inner + own.stop))
            shards.append(_empty(lambda: FeedForward(proj.in_features, inner=per,
                                                     out_bias=False), out.weight, dev))
            local[f"shards.{r}.net.0.proj.weight"] = (r, ("net.0.proj.weight", 0, halves))
            local[f"shards.{r}.net.0.proj.bias"] = (r, ("net.0.proj.bias", 0, halves))
            local[f"shards.{r}.net.2.weight"] = (r, ("net.2.weight", 1, (own,)))
    bias = None
    if out.bias is not None:
        bias = torch.empty_like(out.bias, device=devices[0])
        prefix = "to_out.0" if isinstance(mod, Attention) else "net.2"
        local["bias"] = (0, (f"{prefix}.bias", None, None))
    return TensorParallel(shards, devices, bias), local
