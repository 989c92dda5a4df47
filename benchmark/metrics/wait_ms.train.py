"""ms a training step's stepping thread waits for the feed's next item: the
program's ``wait`` spans on the stepping thread (``prefetch_to_device``'s
queue, the transfer's future and the copy's event, and the end of the feed)
over the steps the traced window's dispatches carried."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    return spans.ms_per(rec, ("wait",), spans.dispatched(rec, "step"))
