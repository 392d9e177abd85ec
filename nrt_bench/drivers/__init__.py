"""One driver per kind of traffic, named by a mix's ``driver`` key: a class
``Driver(cfg, mix, seed, device, variant)`` with ``setup``, ``window``,
``release``, ``check`` and ``trace_context``."""
