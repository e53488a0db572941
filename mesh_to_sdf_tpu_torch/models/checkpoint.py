"""Checkpoint/resume for DifferentiableSDF training state (PyTorch
counterpart of ``models/checkpoint.py``).

The JAX package's versioned msgpack container, leaf for leaf: a checkpoint
written by either package loads in the other and training resumes there.
Its leaves are the JAX ``SdfFitState`` flattened in optax's order:

    params (V, 3) float32, Adam count () int32, mu (V, 3), nu (V, 3) float32

:func:`fit_state_leaves` and :func:`fit_state_from_leaves` carry the port's
state (the vertices and a ``torch.optim.Adam``, whose ``step``,
``exp_avg`` and ``exp_avg_sq`` are optax's count, mu and nu) to and from
that layout.
"""
from __future__ import annotations

from typing import List, Tuple

import msgpack
import numpy as np
import torch

from .sdf_layer import SdfFitState

_MAGIC = "mesh_to_sdf_tpu.fit"
VERSION = 1


def fit_state_leaves(state: SdfFitState) -> List[np.ndarray]:
    """The state as optax-ordered host arrays: params, count, mu, nu. A
    state that has taken no step has count 0 and zero moments, as
    ``optax.adam(...).init`` gives."""
    params = state.params.detach().cpu().numpy().astype(np.float32)
    adam = state.opt_state.state.get(state.params, {})
    if "step" in adam:
        count = int(adam["step"])
        mu = adam["exp_avg"].detach().cpu().numpy()
        nu = adam["exp_avg_sq"].detach().cpu().numpy()
    else:
        count, mu, nu = 0, np.zeros_like(params), np.zeros_like(params)
    return [params, np.asarray(count, np.int32), mu.astype(np.float32),
            nu.astype(np.float32)]


def fit_state_from_leaves(leaves, like: SdfFitState) -> SdfFitState:
    """A new state from optax-ordered ``leaves``, on the device of
    ``like.params`` and with the hyperparameters of ``like.opt_state``."""
    if not isinstance(like, SdfFitState):
        raise ValueError(f"expected an SdfFitState, got {type(like)!r}")
    if len(leaves) != 4:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected 4")
    params, count, mu, nu = leaves
    dev = like.params.device

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    p = tensor(params).requires_grad_(True)
    opt = type(like.opt_state)([p], **like.opt_state.defaults)
    if int(count) > 0:
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": tensor(mu), "exp_avg_sq": tensor(nu)}
    return SdfFitState(params=p, opt_state=opt)


def _pack_leaves(leaves) -> list:
    return [{"dtype": a.dtype.str, "shape": list(a.shape),
             "data": np.ascontiguousarray(a).tobytes()} for a in leaves]


def _unpack_leaves(packed) -> list:
    out = []
    for rec in packed:
        arr = np.frombuffer(rec["data"], np.dtype(rec["dtype"]))
        out.append(arr.reshape(rec["shape"]))
    return out


def save_fit_state(path, state: SdfFitState, step: int = 0) -> None:
    """Serialize an :class:`..models.sdf_layer.SdfFitState` (params + opt)."""
    env = {
        "magic": _MAGIC,
        "version": VERSION,
        "step": int(step),
        "leaves": _pack_leaves(fit_state_leaves(state)),
    }
    with open(path, "wb") as f:
        f.write(msgpack.packb(env, use_bin_type=True))


def load_fit_state(path, like: SdfFitState) -> Tuple[SdfFitState, int]:
    """Restore a state shaped like ``like`` (its device and optimizer
    settings). Returns (state, step)."""
    with open(path, "rb") as f:
        env = msgpack.unpackb(f.read(), raw=False)
    if not isinstance(env, dict) or env.get("magic") != _MAGIC:
        raise ValueError("not a fit-state checkpoint")
    if env.get("version") != VERSION:
        raise ValueError(
            f"unsupported checkpoint version {env.get('version')!r}")
    state = fit_state_from_leaves(_unpack_leaves(env["leaves"]), like)
    return state, int(env.get("step", 0))
