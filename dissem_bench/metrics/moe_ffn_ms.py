"""Device time of the experts' FFN in the pod's forward of the traced
round, in ms: the kernels, copies and memsets launched from inside the
port's ``dld.moe_ffn`` spans (one a layer, ``models.llama.moe_ffn``)
that open within the benchmark's ``bench.pod_forward`` span, matched to
their launches by the trace's correlation ids.  None where the forward
has no such span (a dense model, or a program without it)."""

SPAN = "dld.moe_ffn"
LAUNCHES = ("cuda_runtime", "cuda_driver")


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    fwd = tr.span("bench.pod_forward")
    if fwd is None:
        return None
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in tr.events
             if e.get("name") == SPAN and fwd[0] <= e["ts"] < fwd[1]]
    if not spans:
        return None
    launched = {_correlation(e) for e in tr.events
                if e.get("cat") in LAUNCHES and _correlation(e) is not None
                and any(a <= e["ts"] < b for a, b in spans)}
    ran = [e["dur"] for e in tr.device if _correlation(e) in launched]
    if not ran:
        return None
    return sum(ran) / 1e3
