"""One module per kind of traffic: ``setup(ctx)``, ``window(state,
seconds, trace)`` and ``check(state)``."""
