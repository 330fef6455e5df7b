"""Share of the expert rows the pod's forward computed that its router
picked, per round, in %: counter ``moe.routed_rows`` (token-expert pairs
routed, ties included) over ``moe.computed_rows`` (pairs the expert
products ran; every token for every expert under dense dispatch)."""

from . import mean


def _share(rnd):
    routed = rnd["counters"].get("moe.routed_rows")
    computed = rnd["counters"].get("moe.computed_rows", 0)
    if routed is None or computed <= 0:
        return None
    return 100.0 * routed / computed


def read(run):
    return mean(_share(r) for r in run.rounds)
