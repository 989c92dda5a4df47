"""ms the transfer threads work on a training step: the program's
``transfer`` spans (the GradIndex, stacking a chained group and the copies'
calls) on every thread, over the steps the traced window's dispatches
carried. Busy time, which two threads can overlap."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    return spans.ms_per(rec, ("transfer",), spans.dispatched(rec, "step"), on_stepping=False)
