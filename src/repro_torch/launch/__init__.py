"""Command-line entry points of the port.

``python -m repro_torch.launch.sweep --spec spec.json`` plans and runs
specs from JSON; ``python -m repro_torch.launch.serve --spec spec.json``
streams, trains and serves in one process; ``python -m
repro_torch.launch.trace summarize PATH`` prints the per-category table of
a trace file (``repro_torch.obs.export``). The first two take ``--device``
(default: the CUDA device).
"""
