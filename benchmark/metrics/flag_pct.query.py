"""Share of queries CULLED's certificate flagged, over every call of the
window that launched the culled kernel (``culling.LAST_CULLED_STATS``
``n_flagged`` over ``queries``), %."""


def read(ctx):
    notes = [n for n in ctx.notes if n.get("n_flagged") is not None]
    if not notes:
        return None
    return 100.0 * sum(n["n_flagged"] for n in notes) / sum(
        n["queries"] for n in notes)
