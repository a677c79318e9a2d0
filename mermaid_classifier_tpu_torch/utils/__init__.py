"""Section profiling and system-metrics sampling (stdlib, ``/proc``)."""
