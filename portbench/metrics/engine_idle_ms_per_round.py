"""Milliseconds a round in which the device runs nothing while the host
is inside the engine's own spans (``mc.round``, ``mc.sweep``) but inside
no ``link.*`` span: generator seeding, the tallies' read-back, the
stopping decision.  The intersection of the intervals, over the
``mc.round`` spans; the benchmark's loop between rounds is outside it."""
from portbench.trace import _union

ENGINE = ("mc.round", "mc.sweep")


def _uncovered(spans, cover):
    """Length of the merged ``spans`` that no interval of the merged
    ``cover`` overlaps."""
    total = 0.0
    for a, b in spans:
        left = b - a
        for c, d in cover:
            if d > a and c < b:
                left -= min(b, d) - max(a, c)
        total += left
    return total


def read(ctx):
    host = [e for e in ctx.trace.host if e["cat"] == "user_annotation"]
    rounds = sum(e["name"] == "mc.round" for e in host)
    if not rounds:
        return None

    def intervals(keep):
        return _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in host if keep(e["name"]))
    engine = intervals(lambda n: n in ENGINE)
    busy_or_link = _union(ctx.trace.busy
                          + intervals(lambda n: n.startswith("link.")))
    return _uncovered(engine, busy_or_link) * 1e-3 / rounds
