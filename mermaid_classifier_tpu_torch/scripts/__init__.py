"""The port's command-line entry points, run with ``python -m``."""
