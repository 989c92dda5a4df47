"""ms an assembly thread works on a training batch: the program's
``assemble`` spans (``iterate_batches``'s build, the C++ engine's call
included) on every thread, over the batches assembled in the traced window.
``assembly_ms.train`` is the wait for them as the feed's consumer sees it."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    n = 0 if rec is None else sum(s.name == "assemble" for s in rec.spans)
    return spans.ms_per(rec, ("assemble",), n, on_stepping=False)
