"""What the per-layer metrics are measured against: the card's published
peaks (``peaks.json``), the model's operation counts (``counts.py``) and the
reduction of the profiler's trace (``trace.py``)."""
