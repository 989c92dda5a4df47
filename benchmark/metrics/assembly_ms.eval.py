"""ms a validation batch waits for the batch engine, as ``evaluate`` (which
consumes ``val_batches()`` inline) sees each ``next()``: the mean over the
traced window's batches."""


def read(obs):
    waits = obs["waits"]
    return 1e3 * sum(waits) / len(waits) if waits else None
