"""One runner per delivery path, named by a traffic file's ``"path"``.

A runner module exposes ``Runner(cell, seed, device)`` with ``setup()``,
``round(prompt, traced) -> dict``, ``release()``, ``check_delivery() ->
dict``, ``reference_inputs() -> (layer_leaves, head_leaves, device)``,
``close()`` and the attributes ``cards`` (the card indices the cell uses),
``seeders_in_hbm`` and ``probe_gbps``.
"""
