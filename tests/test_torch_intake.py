"""The port's inputs from its environment: the variables it reads are the
documented ones, so no variable switches a path the configuration does not
state."""
import ast
from pathlib import Path

PORT = Path(__file__).resolve().parent.parent / "mesh_to_sdf_tpu_torch"

#: Every environment variable the package may read: the AUTO cost model's
#: overrides and opt-in calibration (README.md), the native library's and
#: the CUDA toolkit's locations, the calibration cache's root, and
#: torch.distributed's launch variables.
ALLOWED = {
    "M2S_AUTO_CALIBRATE", "M2S_AUTO_DENSE_PAIRS_PER_S",
    "M2S_AUTO_CPT_OVERHEAD_S", "M2S_AUTO_CPT_CELLS_PER_S",
    "M2S_NATIVE_LIB", "M2S_NATIVE_BUILD", "CUDA_HOME", "CUDA_PATH",
    "XDG_CACHE_HOME",
    "RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
}


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _names(node) -> list:
    """The string constants ``node`` is, or holds (a tuple or list)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for elt in node.elts for n in _names(elt)]
    return []


def _environment_reads(path: Path) -> list:
    """(name, line) of each variable ``path`` reads through ``os.environ``
    (``.get``/``.pop``, ``[...]``, ``in``; also through a local name bound
    to it) or ``os.getenv``; a read whose name is no string constant gives
    the name ``"<non-literal>"``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    aliases = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
               and _is_os_environ(node.value)
               for t in node.targets if isinstance(t, ast.Name)}

    def env(node) -> bool:
        return _is_os_environ(node) or (isinstance(node, ast.Name)
                                        and node.id in aliases)

    reads, seen = [], set()

    def read(env_node, key_nodes, line):
        seen.add(id(env_node))
        names = [n for k in key_nodes for n in _names(k)]
        reads.extend((n, line) for n in names or ["<non-literal>"])

    loops = {}  # comprehension variable -> the constants it runs over
    for node in ast.walk(tree):
        if isinstance(node, ast.comprehension) and isinstance(
                node.target, ast.Name) and _names(node.iter):
            loops[node.target.id] = node.iter
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if env(f.value) and f.attr in ("get", "pop", "setdefault"):
                read(f.value, node.args[:1], node.lineno)
            elif (f.attr == "getenv" and isinstance(f.value, ast.Name)
                  and f.value.id == "os"):
                read(f, node.args[:1], node.lineno)
        elif isinstance(node, ast.Subscript) and env(node.value):
            read(node.value, [node.slice], node.lineno)
        elif isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) and (
                env(node.comparators[-1])):
            key = node.left
            if isinstance(key, ast.Name) and key.id in loops:
                key = loops[key.id]
            read(node.comparators[-1], [key], node.lineno)
    for node in ast.walk(tree):
        if _is_os_environ(node) and id(node) not in seen and not any(
                isinstance(a, ast.Assign) and a.value is node
                for a in ast.walk(tree)):
            reads.append(("<non-literal>", node.lineno))
    return reads


def test_package_reads_only_listed_environment():
    """Every variable the package reads is listed in :data:`ALLOWED`, and
    every listed one is read: a path switched by an unlisted variable would
    run code that no configuration states."""
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        for name, line in _environment_reads(path):
            found.setdefault(name, []).append(
                f"{path.relative_to(PORT.parent)}:{line}")
    unlisted = {k: v for k, v in found.items() if k not in ALLOWED}
    assert not unlisted, unlisted
    assert set(found) == ALLOWED
