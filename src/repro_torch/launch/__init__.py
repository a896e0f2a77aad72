"""Drivers of the port (serving, training) and its mesh builders."""
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
