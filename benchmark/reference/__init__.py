"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy in float32 (TF32 off), importing nothing of the
program: it derives again from the raw sessions, the edges and the seed what
the program derived itself (the bucketed batches and their negatives, the
duplicate-row sums, the dropout keep bits, the optimizer's trajectory) and
judges the program's outputs against its own.
"""
