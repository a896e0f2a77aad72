"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions."""
from repro_torch.kernels import ops, ref
