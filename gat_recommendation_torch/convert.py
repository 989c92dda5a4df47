"""Carry Graph Transformer weights from the JAX package's pytrees to the port.

The caller turns the JAX ``params``/``state`` pytrees into numpy first
(``jax.tree.map(np.asarray, ...)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gat_recommendation_torch.models.graph_transformer import GraphTransformerConfig


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(params: dict, state: dict, cfg) -> tuple[dict, dict]:
    """Map JAX Graph Transformer params/state (numpy leaves) to the port's names.

    JAX keeps a linear weight ``w`` as ``[in, out]`` (apply ``x @ w + b``);
    the port uses ``nn.Linear``, whose weight is ``[out, in]``, so every
    ``w`` is TRANSPOSED. The item table, the BatchNorm ``scale``/``bias``
    and running ``mean``/``var``/``count``, and ``cached_pe`` keep their
    shapes. `cfg` is a ``GraphTransformerConfig`` or a mapping of its fields
    (e.g. ``dataclasses.asdict`` of the JAX config).

    Returns (parameters, buffers), both keyed by ``GraphTransformer``'s
    ``state_dict`` names; load with ``model.load_state_dict({**parameters,
    **buffers})``.
    """
    if not isinstance(cfg, GraphTransformerConfig):
        cfg = GraphTransformerConfig(**dict(cfg))
    if cfg.use_ffn:
        raise NotImplementedError("FFN weights are not ported yet (ROADMAP.md, queue A)")
    if len(params["convs"]) != cfg.num_layers:
        raise ValueError(f"{len(params['convs'])} conv layers in params, config says {cfg.num_layers}")

    out: dict[str, torch.Tensor] = {"item_embedding": _tensor(params["item_embedding"])}

    def linear(prefix: str, p: dict) -> None:
        out[f"{prefix}.weight"] = _tensor(p["w"]).T.contiguous()
        if "b" in p:
            out[f"{prefix}.bias"] = _tensor(p["b"])

    if cfg.readout_type == "attention":
        linear("readout", params["readout"]["attention"])
    if cfg.use_laplacian_pe:
        linear("lap_projection", params["lap_projection"])
    for layer, conv in enumerate(params["convs"]):
        for name in ("query", "key", "value", "skip", "beta"):
            linear(f"convs.{layer}.{name}", conv[name])
    for layer, bn in enumerate(params["batch_norms"]):
        out[f"batch_norms.{layer}.scale"] = _tensor(bn["scale"])
        out[f"batch_norms.{layer}.bias"] = _tensor(bn["bias"])

    buffers: dict[str, torch.Tensor] = {}
    if cfg.use_laplacian_pe:
        buffers["cached_pe"] = _tensor(state["cached_pe"])
    for layer, bn in enumerate(state["batch_norms"]):
        for name in ("mean", "var", "count"):
            buffers[f"batch_norms.{layer}.{name}"] = _tensor(bn[name])
    return out, buffers
