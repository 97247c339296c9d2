"""The benchmark of velocycle_tpu_torch, the PyTorch and CUDA port.

`run.py` runs one cell of ``BENCHMARK.json`` (at the checkout's root) and
prints its result; everything it runs is found by name (`spec`).  The
yardstick lives here, where the program cannot move it: the input
generator (`inputs`), the operation counts and peaks (`counts`), the
trace's reduction (`trace`), the plain reference (`reference/`) and the
comparison that decides ``correct`` (`check`).  Nothing here imports JAX or
the JAX package.
"""
