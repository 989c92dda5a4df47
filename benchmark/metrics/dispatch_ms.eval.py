"""ms ``evaluate`` spends dispatching a validation batch: the program's
``copy`` (stacking a group and its copy to the card), ``chained`` and
``single`` spans on the stepping thread, over the batches the traced
window's dispatches carried."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    return spans.ms_per(rec, ("copy", "chained", "single"), spans.dispatched(rec, "batch"))
