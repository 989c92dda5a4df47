"""The evaluation check: every top-k list the window's passes returned,
judged by the reference's own scores.

The reference scores each validation session over the full catalog in
float32 (eval-mode forward, then the dot product with every item row, the
padded tail masked). For a returned list it reads the widest gap by which
the i-th returned item's score lies below the reference's i-th best, over
the session's spread of scores (the standard deviation over the catalog):
an exact top-k reads rounding, a wrong or misplaced item the size of its
miss. A list with an id out of the catalog or an id twice is malformed.
"""

from __future__ import annotations

import torch

from benchmark.reference import batches as rb
from benchmark.reference import model as rm

FAULTS = ("half_batch", "altered_answer")


def val_schedule(cfg: dict, traffic: dict, data: dict):
    sessions = rb.Sessions.from_columns(*data["val"], cfg["max_session_length"])
    return sessions, rb.schedule(sessions, traffic["batch_size"], 0, shuffle=False)


@torch.no_grad()
def judge(cfg: dict, traffic: dict, data: dict, seed: int, device, passes: list, variant: str = "exact") -> dict:
    """Judge `passes` (each a list of the program's [slots, k] id arrays, one
    per validation batch in order; None: the reference's own lists in
    `variant` precision or with a fault, standing in for the program) and
    return {"score_gap", "malformed", "answers", "worst"}."""
    sessions, sched = val_schedule(cfg, traffic, data)
    graph = rb.csr(*data["edges"], cfg["num_items"])
    weights = rm.draw_weights(cfg, seed, device)
    exact = rm.Precision(device=device)
    k = max(traffic["k_values"])
    V, B = cfg["num_items"], traffic["batch_size"]
    stand_in = rm.Precision(tf32=variant == "tf32", device=device) if passes is None else None
    table_in = None if stand_in is None else stand_in.r(weights["item_embedding"])
    worst, malformed, answers, where = 0.0, 0, 0, None
    for pos, (chunk, n, bi) in enumerate(sched):
        b = rb.assemble(sessions, graph, chunk, B, n, 0, bi, V, 0)
        batch = {key: torch.from_numpy(v).to(device) for key, v in b.items()}
        valid = batch["sample_mask"]
        with exact:
            scores = exact.lin(rm.forward(weights, cfg, batch, exact, train=False), weights["item_embedding"])[:, :V]
        best = torch.topk(scores, k, dim=1).values
        spread = scores.std(dim=1).clamp_min(1e-30)
        if passes is None:
            with stand_in:
                sess = rm.forward(weights, cfg, batch, stand_in, train=False)
                mine = stand_in.r(sess) @ table_in.T
            mine[:, V:] = -float("inf")
            ids = torch.topk(mine, k, dim=1).indices
            if variant == "half_batch":
                rows = torch.nonzero(valid).flatten()
                ids[rows[len(rows) // 2:]] = 0
            elif variant == "altered_answer" and pos == 0:
                ids[0, 0] = (ids[0, 0] + 1) % V
            lists = [ids]
        else:
            lists = [torch.as_tensor(p[pos], device=device) for p in passes]
        for ids in lists:
            ids = ids[valid].long()
            bad = (ids < 0) | (ids >= V)
            sorted_ids = torch.sort(ids, dim=1).values
            twice = (sorted_ids[:, 1:] == sorted_ids[:, :-1]).any(dim=1)
            malformed += int((bad.any(dim=1) | twice).sum())
            got = torch.gather(scores[valid], 1, ids.clamp(0, V - 1))
            gap = ((best[valid] - got) / spread[valid][:, None]).masked_fill(bad, float("inf"))
            answers += int(ids.shape[0])
            if gap.numel() and float(gap.max()) > worst:
                worst, where = float(gap.max()), (pos, int(gap.max(dim=1).values.argmax()))
    return {"score_gap": worst, "malformed": malformed, "answers": answers, "worst": where}
