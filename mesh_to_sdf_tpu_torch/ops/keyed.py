"""Order-independent ``compare_distances`` reduction (PyTorch counterpart of
``ops/keyed.py``).

The reference folds signed distances with a fuzzy comparator
(`mesh_to_sdf/src/lib.rs:242-259`): approximately equal magnitudes (2 ulps
or 1e-6) prefer the **positive** distance, otherwise the smaller magnitude
wins. Here, as in the JAX package, two champions — the smallest positive and
the smallest negative magnitude — are plain ``min`` reductions, and the fuzzy
rule is applied once between them.
"""
from __future__ import annotations

import torch

from ..types import F32_MAX

#: ``float_cmp::approx_eq!`` parameters used by the reference (`lib.rs:248`).
ULPS = 2
EPSILON = 1e-6


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def approx_eq_f32(a, b):
    """``float_cmp::approx_eq!(f32, a, b, ulps=2, epsilon=1e-6)`` for
    non-negative finite floats: |a-b| <= eps OR within 2 representable
    steps."""
    a, b = torch.broadcast_tensors(_f32(a), _f32(b))
    eps_ok = torch.abs(a - b) <= EPSILON
    ulp_ok = torch.abs(a.contiguous().view(torch.int32)
                       - b.contiguous().view(torch.int32)) <= ULPS
    return eps_ok | ulp_ok


def signed_champions(signed_dist, axis=None, where=None):
    """Reduce signed distances to ``(min_pos, min_neg)``; a missing side
    yields ``F32_MAX`` (the reference's fold init, `default.rs:45`)."""
    signed_dist = _f32(signed_dist)
    neg = torch.signbit(signed_dist)
    pos_vals = torch.where(neg, F32_MAX, signed_dist)
    neg_vals = torch.where(neg, -signed_dist, F32_MAX)
    if where is not None:
        pos_vals = torch.where(where, pos_vals, F32_MAX)
        neg_vals = torch.where(where, neg_vals, F32_MAX)
    if axis is None:
        return pos_vals, neg_vals
    return torch.amin(pos_vals, dim=axis), torch.amin(neg_vals, dim=axis)


def combine_champions(min_pos, min_neg):
    """Final ``compare_distances`` decision between the two champions
    (`lib.rs:248-258`)."""
    min_pos, min_neg = _f32(min_pos), _f32(min_neg)
    prefer_pos = approx_eq_f32(min_pos, min_neg) | (min_pos <= min_neg)
    return torch.where(prefer_pos, min_pos, -min_neg)


def merge_champion_pairs(pos_a, neg_a, pos_b, neg_b):
    """Associative merge of two champion pairs (tree/shard reductions)."""
    return torch.minimum(pos_a, pos_b), torch.minimum(neg_a, neg_b)


def compare_distances(a, b):
    """Pairwise reference `compare_distances` (`lib.rs:242-259`): the winner
    of two signed distances."""
    a, b = _f32(a), _f32(b)
    eq = approx_eq_f32(torch.abs(a), torch.abs(b))
    pick_a = torch.where(eq, a >= b, torch.abs(a) < torch.abs(b))
    return torch.where(pick_a, a, b)
