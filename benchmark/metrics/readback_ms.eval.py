"""ms a validation pass spends on its readback and metrics: the program's
``readback`` (the top-k ids to the host, which waits for the card) and
``metrics`` (recall and NDCG on the host) spans, over the traced window's
passes (its ``eval.pass`` spans)."""

from benchmark.yardstick import spans


def read(obs):
    rec = spans.recorded()
    n = 0 if rec is None else sum(s.name == "eval.pass" for s in rec.spans)
    return spans.ms_per(rec, ("readback", "metrics"), n)
