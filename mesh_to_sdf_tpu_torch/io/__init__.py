"""IO: versioned SDF serialization (≙ reference serde.rs) and glTF ingestion
(≙ the client's vendored loader)."""
from .serde import (
    GenericSdf,
    GridSdf,
    SerdeError,
    VERSION,
    dumps,
    loads,
    read_from_file,
    save_to_file,
)
from .gltf import GltfError, MeshData, SceneData, load_mesh, load_scene, save_glb

__all__ = [
    "GenericSdf", "GridSdf", "SerdeError", "VERSION", "dumps", "loads",
    "read_from_file", "save_to_file", "GltfError", "MeshData", "SceneData",
    "load_mesh", "load_scene", "save_glb",
]
