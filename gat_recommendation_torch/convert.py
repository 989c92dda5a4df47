"""Carry Graph Transformer weights and optimizer state from the JAX package's pytrees to the port.

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
    cfg = _config(cfg)
    out = _named_params(params, cfg)
    buffers: dict[str, torch.Tensor] = {}
    if cfg.use_laplacian_pe:
        buffers["cached_pe"] = _tensor(state["cached_pe"])
    for layer, bn in enumerate(state["batch_norms"]):
        for name in ("mean", "var", "count"):
            buffers[f"batch_norms.{layer}.{name}"] = _tensor(bn[name])
    return out, buffers


def _config(cfg) -> GraphTransformerConfig:
    return cfg if isinstance(cfg, GraphTransformerConfig) else GraphTransformerConfig(**dict(cfg))


def _named_params(params: dict, cfg: GraphTransformerConfig) -> dict[str, torch.Tensor]:
    """A params-shaped tree (the params, or a tree of their moments) under the
    port's parameter names; the item table only if the tree holds one."""
    if cfg.use_ffn:
        raise NotImplementedError("FFN weights are not ported yet (ROADMAP.md, queue A)")
    if len(params["convs"]) != cfg.num_layers:
        raise ValueError(f"{len(params['convs'])} conv layers in params, config says {cfg.num_layers}")

    out: dict[str, torch.Tensor] = {}
    if "item_embedding" in params:
        out["item_embedding"] = _tensor(params["item_embedding"])

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
    return out


def opt_state_from_jax(opt_state: dict, cfg) -> dict:
    """Map the JAX ``FusedEmbeddingAdamW`` state (numpy leaves) to what the
    port's ``FusedEmbeddingAdamW.load_state`` takes, so that both packages
    can start from the same mid-training state.

    ``emb_mu``, ``emb_nu`` and ``count`` keep their meaning. ``opt_state["rest"]``
    is the ``optax.adamw`` state of every other leaf: its ``ScaleByAdamState``
    holds ``mu`` and ``nu`` trees shaped like the params, which map to
    ``rest_mu`` / ``rest_nu`` keyed by the port's parameter names (every
    linear ``w`` transposed, as in ``from_jax_params``).
    """
    adam = next(s for s in opt_state["rest"] if hasattr(s, "mu") and hasattr(s, "nu"))
    cfg = _config(cfg)
    return {
        "emb_mu": _tensor(opt_state["emb_mu"]),
        "emb_nu": _tensor(opt_state["emb_nu"]),
        "count": int(opt_state["count"]),
        "rest_mu": _named_params(adam.mu, cfg),
        "rest_nu": _named_params(adam.nu, cfg),
    }
