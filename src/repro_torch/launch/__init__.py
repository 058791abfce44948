"""Command-line entry points of the port.

``python -m repro_torch.launch.trace summarize PATH`` prints the
per-category table of a trace file (``repro_torch.obs.export``).
"""
