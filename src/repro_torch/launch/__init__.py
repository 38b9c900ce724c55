"""Command-line entry points of the port's training, and the rank mesh of
the multi-process runtime (``mesh``)."""
