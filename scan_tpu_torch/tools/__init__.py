"""The port's command-line entry points (counterparts of ``tools/``)."""
