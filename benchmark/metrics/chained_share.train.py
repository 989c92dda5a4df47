"""% of the traced window's training steps that ran inside chained
dispatches (CUDA-graph replays on the card): the steps that the Trainer's
chained step carried, counted around its calls (a full group of ``chain``
steps, or a partial group's sub-chain), over the steps run. The rest of a
partial group at a bucket boundary runs as single steps."""


def read(obs):
    steps = obs["steps"]
    return 100.0 * obs["chained_steps"] / steps if steps else None
