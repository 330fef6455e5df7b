"""Share of the traced round (the ``bench.run_pod`` span) in which a card
runs neither kernel nor copy nor memset, averaged over the cell's
cards."""


def read(run):
    if run.trace is None or run.window is None or not run.cards:
        return None
    t0, t1 = run.window
    idle = [1 - run.trace.busy_s(c, t0, t1) / ((t1 - t0) / 1e6)
            for c in run.cards]
    return sum(idle) / len(idle) * 100
