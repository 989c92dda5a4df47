"""ms a training batch waits for the batch engine, as its consumer (the
Trainer's prefetch thread) sees each ``next()`` on ``iterate_batches``:
the mean over the traced window's batches."""


def read(obs):
    waits = obs["waits"]
    return 1e3 * sum(waits) / len(waits) if waits else None
