"""K1's prefill kernel in the pod's forward of the traced round: the
least time of its launches (``yardstick.prefill_attention_work`` at the
forward's shape) over their device time.  The launches are the
``prefill_wgmma_kernel`` kernels that start inside the benchmark's
``bench.pod_forward`` span (the forward synchronises before the span
ends); there has to be one per layer."""

from ..yardstick import least_time, prefill_attention_work

KERNEL = "prefill_wgmma_kernel"


def read(run):
    if run.trace is None:
        return None
    span = run.trace.span("bench.pod_forward")
    if span is None:
        return None
    ks = run.trace.kernels(KERNEL, *span)
    s = run.shape
    if len(ks) != s.n_layers:
        return None
    flops, nbytes = prefill_attention_work(1, s.n_heads, s.n_kv_heads,
                                           run.tokens, s.head_dim)
    spent = sum(k["dur"] for k in ks) / 1e6
    return len(ks) * least_time(flops, nbytes) / spent * 100
