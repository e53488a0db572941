"""The CULLED gather engine's widen round at its static size, as the JAX
package runs it: the first ``k_wide`` flagged queries, padded with query
Q−1 to ``k_wide`` rows (``nonzero(size=k_wide, fill_value=Q)``), through
the port's gather pass, and written back through the boolean masks.

Tests patch it in for ``culling._widen`` and hold the port's widen round,
which runs on the flagged queries alone, to it bit for bit. It imports no
JAX, so the card tests use it too.
"""
import torch

from mesh_to_sdf_tpu_torch.ops import culling


def static_widen(queries, bi, inside3, grid, signed, flag):
    """(signed, flag) after the static-size widen round."""
    Q = queries.shape[0]
    k_wide = min(max(culling.K_WIDE_MIN, Q // 3), culling.K_WIDE_MAX)
    idxw = torch.nonzero(flag).reshape(-1)[:k_wide]
    idxw = torch.cat([idxw, idxw.new_full((k_wide - idxw.numel(),), Q)])
    s2, f2, _ = culling._culled_gather_signed_impl(
        queries[torch.clamp_max(idxw, Q - 1)], bi, inside3, grid, st=16,
        kg=culling.DEFAULT_KG_WIDE)
    real = idxw < Q
    signed = signed.clone()
    signed[idxw[real]] = s2[real]
    widened = flag & (torch.cumsum(flag, 0) <= k_wide)
    newf = torch.zeros_like(flag)
    newf[idxw[real]] = f2[real]
    return signed, torch.where(widened, newf, flag)
