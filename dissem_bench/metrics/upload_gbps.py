"""Host-to-device upload rate in the traced round: the bytes of the
card's host-to-device copies over the time in which at least one of them
ran (device trace).  The port's own ``fabric_upload`` phase sums the
uploading threads' waits, which overlap, so it reads far lower."""


def read(run):
    if run.trace is None or run.window is None:
        return None
    nbytes, secs = run.trace.copy_rate("HtoD", *run.window)
    if not nbytes or secs <= 0:
        return None
    return nbytes / secs / 1e9
