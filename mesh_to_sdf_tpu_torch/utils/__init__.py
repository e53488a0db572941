"""Host-side utilities: procedural meshes."""
