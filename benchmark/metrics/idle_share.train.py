"""% of the measured training window in which the card is idle: 1 - (the
card's busy time a session) x (the untraced window's sessions a second).
The busy time is the union of the card's kernels, copies and memsets in
the traced window's whole epochs, over their sessions; the rate is the
untraced window's, since the tracer slows the host and would stretch the
idle gaps with its own cost."""


def read(obs):
    trace, plain = obs["trace"], obs.get("untraced")
    if trace is None or plain is None or not obs["window"]["sessions"] or plain["seconds"] <= 0:
        return None
    busy_per_session = trace.busy_s / obs["window"]["sessions"]
    return 100.0 * (1.0 - busy_per_session * plain["sessions"] / plain["seconds"])
