"""The plain reference of the benchmark's cells: plain PyTorch written
from the model, importing neither JAX, nor the JAX package, nor the
program (`velocycle_tpu_torch`)."""
