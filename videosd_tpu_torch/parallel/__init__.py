"""More than one device: the ("data","model") mesh, tensor parallelism, the
2-stage UNet pipeline, meshes across processes and their checks
(counterpart of ``videosd_tpu/parallel/``).

* ``mesh.py``: :class:`~videosd_tpu_torch.parallel.mesh.Mesh`,
  ``make_mesh``, ``PARAM_RULES``/``param_spec`` and ``shard_params``
  (placement recorded by mesh slot); ``init_distributed`` (a
  ``torch.distributed`` group: the mesh over every process's slots, each
  process running its own data rows), ``reduce_data`` (JAX's
  ``psum(x, "data")``) and ``reduce_grads`` (the data rows' gradients into
  the whole model, for ``train/step.py``'s sharded step);
* ``tensor.py``: the tensor-parallel attention and feed-forward;
* ``serving.py``: ``ShardedFrameEngine`` and ``shard_program`` (data
  rows, each its own program; across processes, this process's rows);
* ``pipe.py``: the UNet cut at its waist over two stage submeshes;
* ``verify.py``: the sharded and pipelined frames against the
  single-device program.
"""

from videosd_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    init_distributed,
    make_mesh,
    reduce_data,
    reduce_grads,
    replicated,
    shard_params,
    shutdown_distributed,
    world,
)

__all__ = [
    "Mesh",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "reduce_data",
    "reduce_grads",
    "replicated",
    "shard_params",
    "shutdown_distributed",
    "world",
]
