"""ms the stepping thread spends dispatching a training step: the program's
``block`` (the step block), ``chained`` and ``single`` spans on the stepping
thread, with the graph replays and captures inside them, over the steps the
traced window's dispatches carried. The tracer slows each graph launch, so
this reads above what a step takes untraced."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    return spans.ms_per(rec, ("block", "chained", "single"), spans.dispatched(rec, "step"))
