"""CPU tests of the benchmark (card-only cases carry the ``cuda`` marker)."""
