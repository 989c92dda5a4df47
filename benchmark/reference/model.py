"""The Graph Transformer, plainly: its weights by name, their seeded draw,
the forward in train and eval mode, and the dual loss.

The equations are those of the configurations' source
(``etpgt/model/graph_transformer.py``) as the program states them:

    x = E[nodes] + W_pe PE[nodes] + b_pe
    per layer: out = attention(q, k, v) over the session's edges (softmax over
        sources, rows without sources 0, attention dropout after the softmax),
        beta = sigmoid(W_beta [out, x_r, out - x_r]), x_r = W_skip x + b_skip,
        x = BN(beta x_r + (1 - beta) out) + x, node dropout,
        with the FFN: x = drop(W_down drop(GELU(W_up x))) + x
    session = mean of the valid nodes
    loss = 0.7 * softmax CE over [target | negatives] + 0.3 * BPR

BatchNorm normalizes over the valid nodes with the biased variance in train
mode and with its running statistics in eval mode. The names and shapes of
the weights are the program's state dict (``<module>.<tensor>``), so the same
drawn tensors can be handed to both sides. ``Precision`` routes every
product through one place: float32 as it stands, or with its operands
rounded to TF32 (10 bits of mantissa) for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import hashing

NEG_FILL = -1e30


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even on TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding of an operand, and of the gradient that flows back to it."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Precision:
    """Every product of the reference: float32 with TF32 off, or the control's
    TF32. On the card TF32 is the card's own (``allow_tf32`` while the
    reference runs, forward and backward products alike); elsewhere it is
    emulated by rounding each product's operands, and the gradients that
    flow back into them, to TF32."""

    def __init__(self, tf32: bool = False, device="cpu"):
        self.tf32 = tf32
        self.native = tf32 and torch.device(device).type == "cuda"

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.native
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundTF32.apply(t) if self.tf32 and not self.native else t

    def lin(self, x, w, b=None):
        y = self.r(x) @ self.r(w).T
        return y if b is None else y + b

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


def table_rows(cfg: dict) -> int:
    m = cfg["table_pad_multiple"]
    return -(-cfg["num_items"] // m) * m


def spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, how it is drawn, bound) of every tensor of the state
    dict, in a fixed order. Kinds: "uniform" U(-bound, bound); "zeros";
    "ones"; "table" (U(-bound, bound) with row 0 and the padded tail zero);
    "pe" (the positional encodings drawn from the seed, same zero rows)."""
    D, H, hidden, L = cfg["embedding_dim"], cfg["num_heads"], cfg["hidden_dim"], cfg["num_layers"]
    HD = H * (hidden // H)
    rows = table_rows(cfg)
    out = [("item_embedding", (rows, D), "table", math.sqrt(6.0 / (cfg["num_items"] - 1 + D)))]
    if cfg["use_laplacian_pe"]:
        k = cfg["laplacian_k"]
        out += [("cached_pe", (rows, k), "pe", cfg["pe_bound"]),
                ("lap_projection.weight", (D, k), "uniform", math.sqrt(6.0 / (k + D))),
                ("lap_projection.bias", (D,), "zeros", 0.0)]
    for layer in range(L):
        d_in = D if layer == 0 else hidden
        c = f"convs.{layer}"
        for part in ("query", "key", "value", "skip"):
            out += [(f"{c}.{part}.weight", (HD, d_in), "uniform", 1.0 / math.sqrt(d_in)),
                    (f"{c}.{part}.bias", (HD,), "uniform", 1.0 / math.sqrt(d_in))]
        out.append((f"{c}.beta.weight", (1, 3 * HD), "uniform", 1.0 / math.sqrt(3 * HD)))
        bn = f"batch_norms.{layer}"
        out += [(f"{bn}.scale", (hidden,), "ones", 0.0), (f"{bn}.bias", (hidden,), "zeros", 0.0),
                (f"{bn}.mean", (hidden,), "zeros", 0.0), (f"{bn}.var", (hidden,), "ones", 0.0),
                (f"{bn}.count", (), "zeros", 0.0)]
        if cfg["use_ffn"]:
            wide = hidden * cfg["ffn_expansion"]
            f = f"ffns.{layer}"
            out += [(f"{f}.up.weight", (wide, hidden), "uniform", 1.0 / math.sqrt(hidden)),
                    (f"{f}.up.bias", (wide,), "uniform", 1.0 / math.sqrt(hidden)),
                    (f"{f}.down.weight", (hidden, wide), "uniform", 1.0 / math.sqrt(wide)),
                    (f"{f}.down.bias", (hidden,), "uniform", 1.0 / math.sqrt(wide))]
    return out


BUFFERS = ("cached_pe", ".mean", ".var", ".count")


def is_parameter(name: str) -> bool:
    return not any(name == b or (b.startswith(".") and name.endswith(b)) for b in BUFFERS)


@torch.no_grad()
def draw_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every tensor of the state dict, float32 on `device`, from `seed`
    through a generator on that device: the table and the encodings one
    draw each, all other drawn tensors one flat draw cut into pieces."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & hashing.M64)
    entries = spec(cfg)
    out = {}
    for name, shape, kind, bound in entries:
        if kind in ("table", "pe"):
            t = torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)
            t[0] = 0.0
            t[cfg["num_items"]:] = 0.0
            out[name] = t
    drawn = [(n, s, b) for n, s, kind, b in entries if kind == "uniform"]
    flat = torch.empty(sum(math.prod(s) for _, s, _ in drawn), device=device).uniform_(-1.0, 1.0, generator=gen)
    at = 0
    for name, shape, bound in drawn:
        size = math.prod(shape)
        out[name] = (flat[at:at + size] * bound).view(shape).clone()
        at += size
    for name, shape, kind, _ in entries:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
    return {name: out[name] for name, *_ in entries}


def _dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    if rate <= 0.0:
        return x
    keep = hashing.keep_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x * hashing.keep_scale(rate), torch.zeros_like(x))


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    neg = torch.where(mask, scores, torch.full_like(scores, NEG_FILL))
    m = neg.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_FILL / 2, torch.zeros_like(m), m)
    e = torch.exp(neg - m) * mask.to(scores.dtype)
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-16)


def _batch_norm(x, mask, scale, bias, mean, var, train: bool, eps: float = 1e-5):
    if train:
        m = mask.to(x.dtype)[..., None]
        n = m.sum().clamp_min(1.0)
        mean = (x * m).sum(dim=(0, 1)) / n
        var = ((x - mean).square() * m).sum(dim=(0, 1)) / n
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def forward(P: dict, cfg: dict, batch: dict, prec: Precision, train: bool, step_seed: int = 0) -> torch.Tensor:
    """Session embeddings [B, hidden] of a batch of device tensors."""
    rate = cfg["dropout"] if train else 0.0
    H, L = cfg["num_heads"], cfg["num_layers"]
    nodes, mask, adj = batch["node_ids"], batch["node_mask"], batch["adj"]
    B, N = nodes.shape
    x = P["item_embedding"][nodes]
    if cfg["use_laplacian_pe"]:
        x = x + prec.lin(P["cached_pe"][nodes], P["lap_projection.weight"], P["lap_projection.bias"])
    for layer in range(L):
        c = f"convs.{layer}"
        seeds = [hashing.mix_seed(step_seed, layer, j) for j in range(4 if cfg["use_ffn"] else 2)]
        q, k, v = (prec.lin(x, P[f"{c}.{p}.weight"], P[f"{c}.{p}.bias"]) for p in ("query", "key", "value"))
        HD = q.shape[-1]
        d = HD // H
        q, k, v = (t.reshape(B, N, H, d) for t in (q, k, v))
        alpha = _masked_softmax(prec.ein("bihd,bjhd->bhij", q, k) / math.sqrt(d), adj[:, None])
        alpha = _dropout(alpha, rate, seeds[0])
        out = prec.ein("bhij,bjhd->bihd", alpha, v).reshape(B, N, HD)
        x_r = prec.lin(x, P[f"{c}.skip.weight"], P[f"{c}.skip.bias"])
        beta = torch.sigmoid(prec.lin(torch.cat([out, x_r, out - x_r], dim=-1), P[f"{c}.beta.weight"]))
        bn = f"batch_norms.{layer}"
        h = beta * x_r + (1.0 - beta) * out
        x = _batch_norm(h, mask, P[f"{bn}.scale"], P[f"{bn}.bias"], P[f"{bn}.mean"], P[f"{bn}.var"], train) + x
        x = _dropout(x, rate, seeds[1])
        if cfg["use_ffn"]:
            f = f"ffns.{layer}"
            h = _dropout(F.gelu(prec.lin(x, P[f"{f}.up.weight"], P[f"{f}.up.bias"])), rate, seeds[2])
            x = _dropout(prec.lin(h, P[f"{f}.down.weight"], P[f"{f}.down.bias"]), rate, seeds[3]) + x
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def dual_loss(cfg: dict, P: dict, sess: torch.Tensor, batch: dict, prec: Precision) -> torch.Tensor:
    table = P["item_embedding"]
    target, negs = table[batch["targets"]], table[batch["negatives"]]
    pos = (sess * target).sum(dim=-1)
    neg = prec.ein("bkd,bd->bk", negs, sess)
    valid = batch["sample_mask"].to(sess.dtype)
    count = valid.sum().clamp_min(1.0)
    listwise = -F.log_softmax(torch.cat([pos[:, None], neg], dim=1) / cfg["temperature"], dim=1)[:, 0]
    bpr = -torch.log(torch.sigmoid(pos[:, None] - neg) + 1e-8).mean(dim=1)
    a = cfg["alpha"]
    return a * (listwise * valid).sum() / count + (1.0 - a) * (bpr * valid).sum() / count
