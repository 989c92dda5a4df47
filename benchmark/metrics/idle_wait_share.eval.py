"""% of the measured evaluation window in which the card idles while
``evaluate`` waits for its next group of validation batches (its inline
``next()``, a ``wait`` span): ``idle_share.eval`` (the untraced window's
rate) times the part of the traced window's idle time (window_s - busy_s)
that falls inside those spans, put on the trace's clock by their graph
replays (``yardstick/spans.py``)."""

from benchmark.yardstick import spans


def read(obs):
    return spans.idle_share_under(obs, ("wait",), spans.untraced_idle_share(obs, "eval"))
