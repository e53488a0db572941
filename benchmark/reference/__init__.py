"""The plain reference: float64 PyTorch, independent of the port (it
imports nothing of ``mesh_to_sdf_tpu_torch`` and nothing of JAX)."""
