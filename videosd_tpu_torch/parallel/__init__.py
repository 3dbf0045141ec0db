"""More than one device: the ("data","model") mesh, tensor parallelism, the
2-stage UNet pipeline and their checks (counterpart of
``videosd_tpu/parallel/``).

* ``mesh.py``: :class:`~videosd_tpu_torch.parallel.mesh.Mesh`,
  ``make_mesh``, ``PARAM_RULES``/``param_spec`` and ``shard_params``
  (placement recorded by mesh slot);
* ``tensor.py``: the tensor-parallel attention and feed-forward;
* ``serving.py``: ``ShardedFrameEngine`` and ``shard_program`` (data
  rows, each its own program);
* ``pipe.py``: the UNet cut at its waist over two stage submeshes;
* ``verify.py``: the sharded and pipelined frames against the
  single-device program.
"""
