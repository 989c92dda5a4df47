"""% of the traced window's validation batches scored inside chained eval
dispatches: ``Trainer.chained_eval_dispatches`` times the chain over the
batches. Partial groups are scored one batch at a time."""


def read(obs):
    batches = obs["eval_batches"]
    return 100.0 * obs["chained_eval_dispatches"] * obs["traffic"]["chain"] / batches if batches else None
