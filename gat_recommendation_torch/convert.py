"""Carry model weights and optimizer state from the JAX package's pytrees to the port.

Every model of the registry: the Graph Transformers (with or without the
FFN), GAT and GraphSAGE (mean, max, lstm). The JAX model's name (its
``Model.name``) says which, since a dict config cannot tell GAT from
GraphSAGE; without a name the Graph Transformer is meant. The caller turns the
JAX ``params``/``state`` pytrees into numpy first
(``jax.tree.map(np.asarray, ...)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gat_recommendation_torch.models.gat import GATConfig
from gat_recommendation_torch.models.graph_transformer import GraphTransformerConfig
from gat_recommendation_torch.models.graphsage import GraphSAGEConfig

_CONFIGS = {"gat": GATConfig, "graphsage": GraphSAGEConfig}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(params: dict, state: dict, cfg, model_name: str | None = None) -> tuple[dict, dict]:
    """Map JAX params/state (numpy leaves) of the model `model_name` (None:
    a Graph Transformer) to the port's names.

    JAX keeps a linear weight ``w`` as ``[in, out]`` (apply ``x @ w + b``);
    the port uses ``nn.Linear``, whose weight is ``[out, in]``, so every
    ``w`` is TRANSPOSED, and so are the LSTM aggregator's ``w_ih``/``w_hh``
    (``[D, 4D]`` there, ``torch.nn.LSTMCell``'s ``[4D, D]`` here). The item
    table, GAT's ``att_src``/``att_dst`` ([heads, out] parameters) and every
    ``bias``, the BatchNorm ``scale``/``bias`` and running
    ``mean``/``var``/``count``, and ``cached_pe`` keep their shapes. `cfg`
    is the model's config or a mapping of its fields (e.g.
    ``dataclasses.asdict`` of the JAX config).

    Returns (parameters, buffers), both keyed by the port model's
    ``state_dict`` names; load with ``model.load_state_dict({**parameters,
    **buffers})``.
    """
    cfg = _config(cfg, model_name)
    out = _named_params(params, cfg, model_name)
    buffers: dict[str, torch.Tensor] = {}
    if getattr(cfg, "use_laplacian_pe", False):
        buffers["cached_pe"] = _tensor(state["cached_pe"])
    for layer, bn in enumerate(state["batch_norms"]):
        for name in ("mean", "var", "count"):
            buffers[f"batch_norms.{layer}.{name}"] = _tensor(bn[name])
    return out, buffers


def _config(cfg, model_name: str | None):
    config_class = _CONFIGS.get(model_name, GraphTransformerConfig)
    return cfg if isinstance(cfg, config_class) else config_class(**dict(cfg))


def _named_params(params: dict, cfg, model_name: str | None) -> dict[str, torch.Tensor]:
    """A params-shaped tree (the params, or a tree of their moments) under the
    port's parameter names; the item table only if the tree holds one."""
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
    if getattr(cfg, "use_laplacian_pe", False):
        linear("lap_projection", params["lap_projection"])
    for layer, conv in enumerate(params["convs"]):
        prefix = f"convs.{layer}"
        if model_name == "gat":
            linear(f"{prefix}.lin", conv["lin"])
            for name in ("att_src", "att_dst", "bias"):
                out[f"{prefix}.{name}"] = _tensor(conv[name])
        elif model_name == "graphsage":
            linear(f"{prefix}.lin_l", conv["lin_l"])
            linear(f"{prefix}.lin_r", conv["lin_r"])
            if "lstm" in conv:
                lstm = conv["lstm"]
                out[f"{prefix}.lstm.weight_ih"] = _tensor(lstm["w_ih"]).T.contiguous()
                out[f"{prefix}.lstm.weight_hh"] = _tensor(lstm["w_hh"]).T.contiguous()
                out[f"{prefix}.lstm.bias_ih"] = _tensor(lstm["b_ih"])
                out[f"{prefix}.lstm.bias_hh"] = _tensor(lstm["b_hh"])
        else:
            for name in ("query", "key", "value", "skip", "beta"):
                linear(f"{prefix}.{name}", conv[name])
    for layer, ffn in enumerate(params.get("ffns", ())):
        linear(f"ffns.{layer}.up", ffn["up"])
        linear(f"ffns.{layer}.down", ffn["down"])
    for layer, bn in enumerate(params["batch_norms"]):
        out[f"batch_norms.{layer}.scale"] = _tensor(bn["scale"])
        out[f"batch_norms.{layer}.bias"] = _tensor(bn["bias"])
    return out


def opt_state_from_jax(opt_state: dict, cfg, model_name: str | None = None) -> dict:
    """Map the JAX ``FusedEmbeddingAdamW`` state (numpy leaves) to the flat
    dict the port's ``FusedEmbeddingAdamW.load_state`` takes (the layout of
    its ``export_state``), so that both packages can start from the same
    mid-training state.

    ``emb_mu``, ``emb_nu``, ``count`` and, for the lazy optimizer,
    ``last_step`` keep their meaning. ``opt_state["rest"]`` is the
    ``optax.adamw`` state of every other leaf: its ``ScaleByAdamState`` holds
    ``mu`` and ``nu`` trees shaped like the params, which map to
    ``rest.<name>.exp_avg`` / ``.exp_avg_sq`` under the port's parameter
    names (every linear ``w`` transposed, as in ``from_jax_params``), with
    ``rest.<name>.step`` = ``count``. `model_name` as in ``from_jax_params``.
    """
    adam = next(s for s in opt_state["rest"] if hasattr(s, "mu") and hasattr(s, "nu"))
    cfg = _config(cfg, model_name)
    count = int(opt_state["count"])
    out = {
        "emb_mu": _tensor(opt_state["emb_mu"]),
        "emb_nu": _tensor(opt_state["emb_nu"]),
        "count": torch.tensor(count, dtype=torch.int64),
    }
    if "last_step" in opt_state:
        out["last_step"] = torch.from_numpy(np.array(opt_state["last_step"], dtype=np.int32, copy=True))
    for name, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        for param, value in _named_params(getattr(adam, key), cfg, model_name).items():
            out[f"rest.{param}.{name}"] = value
            out[f"rest.{param}.step"] = torch.tensor(float(count))
    return out
