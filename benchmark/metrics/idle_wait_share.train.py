"""% of the measured training window in which the card idles while the
stepping thread waits for the feed: ``idle_share.train`` (the untraced
window's rate) times the part of the traced window's idle time (window_s -
busy_s) that falls inside the stepping thread's ``wait`` spans, the spans
put on the trace's clock by their graph replays (``yardstick/spans.py``).
The idle time between device activities only: the window's edges count in
the denominator and in no span."""

from benchmark.yardstick import spans


def read(obs):
    return spans.idle_share_under(obs, ("wait",), spans.untraced_idle_share(obs, "train"))
