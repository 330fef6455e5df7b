"""Both packages side by side, for the receive-path parity mirrors.

A mirror runs one scenario through the JAX package and through the port
and compares what does not depend on thread timing.  ``mod(pkg, path)``
imports ``<pkg>.<path>`` for ``pkg`` in ``PKGS``, so one scenario
function serves both packages; ``both`` runs one through each and holds
the results equal; ``clean(pkg)`` resets a package's transport registry
and run-scoped counters.
"""

import importlib

JAX = "distributed_llm_dissemination_tpu"
TORCH = "distributed_llm_dissemination_tpu_torch"
PKGS = (JAX, TORCH)


def mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


def clean(pkg: str) -> None:
    mod(pkg, "transport").reset_registry()
    mod(pkg, "utils.trace").reset_counters()
    mod(pkg, "utils.telemetry").reset_run()


def both(scenario, *args):
    """``scenario(pkg, *args)`` in each package; the port's result must
    equal the JAX package's.  Returns the port's."""
    out = {pkg: scenario(pkg, *args) for pkg in PKGS}
    assert out[TORCH] == out[JAX], out
    return out[TORCH]


def layer_bytes(layer_id: int, size: int) -> bytes:
    return bytes([(layer_id * 37 + i) % 256 for i in range(size)])


def mem_layer(pkg: str, layer_id: int, size: int):
    """``layer_bytes`` as an in-memory holding of ``pkg``."""
    t = mod(pkg, "core.types")
    data = bytearray(layer_bytes(layer_id, size))
    return t.LayerSrc(inmem_data=data, data_size=len(data),
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                                       source_type=t.SourceType.MEM))


def fragment(pkg: str, data, offset: int, size: int):
    """A fragment ``LayerSrc`` of ``pkg`` carrying ``data`` (None for a
    fragment the sink already placed)."""
    t = mod(pkg, "core.types")
    return t.LayerSrc(inmem_data=data, data_size=size, offset=offset,
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM))


def tcp_transports(pkg: str, ids):
    tcp = mod(pkg, "transport")
    ts = {i: tcp.TcpTransport("127.0.0.1:0") for i in ids}
    registry = {i: ts[i].get_address() for i in ids}
    for t in ts.values():
        t.addr_registry.update(registry)
    return ts


def inmem_transports(pkg: str, ids):
    tr = mod(pkg, "transport")
    registry = {i: f"n{i}" for i in ids}
    return {i: tr.InmemTransport(registry[i], addr_registry=registry)
            for i in ids}


def transports(pkg: str, kind: str, ids):
    return (tcp_transports if kind == "tcp" else inmem_transports)(pkg, ids)


def close_all(*closables) -> None:
    """Close nodes and transports (dicts of transports too), in order."""
    for c in closables:
        for x in (c.values() if isinstance(c, dict) else
                  c if isinstance(c, (list, tuple)) else [c]):
            x.close()
