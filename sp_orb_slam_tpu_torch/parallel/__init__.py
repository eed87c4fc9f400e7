"""Scale-out over a list of devices: the stream mesh (parallel/mesh.py)."""
