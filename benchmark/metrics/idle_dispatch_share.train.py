"""% of the measured training window in which the card idles while the
stepping thread dispatches a step: as ``idle_wait_share.train``, for the
stepping thread's ``block``, ``chained`` and ``single`` spans (the replays
and captures inside them included). The tracer slows each graph launch, so
the traced window's split leans to dispatch: this reads above, and
``idle_wait_share.train`` below, what an untraced window would show."""

from benchmark.yardstick import spans


def read(obs):
    return spans.idle_share_under(obs, ("block", "chained", "single"), spans.untraced_idle_share(obs, "train"))
