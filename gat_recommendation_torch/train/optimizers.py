"""Hybrid optimizer: the fused AdamW kernels for the embedding table,
``torch.optim.AdamW`` for the rest.

The embedding table dominates the optimizer's cost (466,865 x 256 float32).
Its update goes through one hand-written pass, ``ops/sparse_adamw.py`` from
the pre-reduced row gradients of the sparse train step or
``ops/embedding_adamw.py`` from a dense gradient; every other parameter goes
through ``torch.optim.AdamW`` with the same learning rate, betas, eps and
decoupled weight decay. The math is AdamW over the whole model.

The model's parameters and the moments are updated IN PLACE. The state is a
plain dict: ``emb_mu``, ``emb_nu`` (the table's moments), ``count`` (a Python
int: nothing is read back from the device per step) and ``rest`` (the
``torch.optim.AdamW`` of the other parameters). On CUDA tensors the table
update launches the kernel, on CPU tensors it runs the plain version; there
is no switch.
"""

from __future__ import annotations

import torch
from torch import nn

from gat_recommendation_torch.ops.embedding_adamw import embedding_adamw
from gat_recommendation_torch.ops.sparse_adamw import sparse_adamw

EMBEDDING_KEY = "item_embedding"


def rest_parameters(model: nn.Module) -> dict[str, nn.Parameter]:
    """Every parameter of `model` but the item table, by name."""
    return {k: p for k, p in model.named_parameters() if k != EMBEDDING_KEY}


class FusedEmbeddingAdamW:
    """AdamW with the embedding-table update fused into one pass."""

    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        moment_dtype=None,
        stochastic_rounding: bool | None = None,
        lazy: bool = False,
    ):
        """moment_dtype: storage dtype of the table's mu/nu buffers. None
        keeps float32 (exact AdamW). ``torch.bfloat16`` halves the moments'
        memory traffic (the arithmetic stays float32, the store rounds). A
        ``(mu_dtype, nu_dtype)`` tuple sets the two buffers independently.

        stochastic_rounding: how bfloat16 moments are stored. None resolves
        to True whenever a moment is narrower than float32: round-to-nearest
        stalls the second moment (its per-step increment is 0.1 % of the
        running value, below a bfloat16 ulp); unbiased stochastic rounding
        does not. Pass False only to reproduce the stall.

        lazy: the lazy catch-up update of only the touched rows is not
        ported yet.
        """
        if lazy:
            raise NotImplementedError(
                "lazy catch-up AdamW is not ported yet (ROADMAP.md, queue A item 2b); use lazy=False"
            )
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        if isinstance(moment_dtype, tuple):
            self.mu_dtype, self.nu_dtype = moment_dtype
        else:
            self.mu_dtype = self.nu_dtype = moment_dtype
        if stochastic_rounding is None:
            stochastic_rounding = any(
                d is not None and d != torch.float32 for d in (self.mu_dtype, self.nu_dtype)
            )
        self.stochastic_rounding = stochastic_rounding

    @property
    def _hparams(self) -> dict:
        return dict(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay)

    def init(self, model: nn.Module) -> dict:
        """Fresh state for `model`: zero moments on the table's device."""
        table = model.get_parameter(EMBEDDING_KEY)
        rest = list(rest_parameters(model).values())
        return {
            "emb_mu": torch.zeros_like(table, dtype=self.mu_dtype or table.dtype),
            "emb_nu": torch.zeros_like(table, dtype=self.nu_dtype or table.dtype),
            "count": 0,
            "rest": torch.optim.AdamW(
                rest, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
                weight_decay=self.weight_decay,
            ),
        }

    def _step_rest(self, g_rest: dict, state: dict, model: nn.Module) -> None:
        for name, p in rest_parameters(model).items():
            g = g_rest.get(name)
            # A parameter the loss does not reach still decays, as under
            # optax.adamw, whose gradient tree holds zeros for it.
            p.grad = torch.zeros_like(p) if g is None else g
        state["rest"].step()
        state["rest"].zero_grad(set_to_none=True)

    def _stochastic(self, state: dict) -> bool:
        return self.stochastic_rounding and torch.bfloat16 in (
            state["emb_mu"].dtype, state["emb_nu"].dtype
        )

    @torch.no_grad()
    def update_full(self, grads: dict, state: dict, model: nn.Module) -> dict:
        """Apply one step from dense gradients (`grads`: parameter name ->
        gradient, the table's under ``item_embedding``). Returns `state`."""
        state["count"] += 1
        embedding_adamw(
            model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
            grads[EMBEDDING_KEY].contiguous(), state["count"],
            stochastic_rounding=self._stochastic(state), **self._hparams,
        )
        self._step_rest(grads, state, model)
        return state

    @torch.no_grad()
    def update_sparse(
        self, g_rest: dict, uid: torch.Tensor, summed: torch.Tensor, state: dict, model: nn.Module
    ) -> dict:
        """Apply one step with the table gradient pre-reduced as (uid, summed):
        ascending unique row ids with a sentinel tail, and their summed
        gradient rows, instead of a dense [V, D] gradient. Returns `state`."""
        state["count"] += 1
        sparse_adamw(
            model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
            uid, summed, state["count"],
            stochastic_rounding=self._stochastic(state), **self._hparams,
        )
        self._step_rest(g_rest, state, model)
        return state

    def load_state(self, state: dict, model: nn.Module, saved: dict) -> dict:
        """Fill `state` (from ``init``) with saved values: ``emb_mu``,
        ``emb_nu``, ``count``, and ``rest_mu`` / ``rest_nu`` (parameter name ->
        tensor), e.g. from ``convert.opt_state_from_jax``. Returns `state`."""
        with torch.no_grad():
            state["emb_mu"].copy_(saved["emb_mu"])
            state["emb_nu"].copy_(saved["emb_nu"])
        state["count"] = int(saved["count"])
        rest = state["rest"]
        for name, p in rest_parameters(model).items():
            rest.state[p] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": saved["rest_mu"][name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": saved["rest_nu"][name].to(p.device, p.dtype).clone(),
            }
        return state
