"""The benchmark of the PyTorch and CUDA port (``videosd_tpu_torch``): live
camera streams through its serving engine.  ``python3 benchmark/run.py
--help``; ``benchmark/README.md`` says how cells are made."""
