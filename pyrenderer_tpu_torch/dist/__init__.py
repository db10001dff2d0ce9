"""Sharded rendering and training over torch.distributed: the ("dp", "sp")
render and train step (dist/render.py), the world and whole frames
(dist/multihost.py), the worker CLI (dist/worker.py) and the
triangle-sharded "gp" render (dist/geometry.py)."""
