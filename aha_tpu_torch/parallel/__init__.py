"""Tensor and data parallelism (counterpart of aha_tpu/parallel): the mesh
and its sharding rules (mesh.py), the sharded layers (layers.py), the
tp ranks as processes (ranks.py) and the dp replicas (replicas.py)."""
