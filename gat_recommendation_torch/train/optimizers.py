"""Hybrid optimizer: the fused AdamW kernels for the embedding table,
``torch.optim.AdamW`` for the rest.

The embedding table dominates the optimizer's cost (466,865 x 256 float32).
Its update goes through one hand-written pass, ``ops/sparse_adamw.py`` from
the pre-reduced row gradients of the sparse train step or
``ops/embedding_adamw.py`` from a dense gradient; every other parameter goes
through ``torch.optim.AdamW`` with the same learning rate, betas, eps and
decoupled weight decay. The math is AdamW over the whole model.

With ``lazy=True`` (the JAX package's main training path) a sparse step
touches only the rows it gathered: ``gather_catch_up`` applies each row's
skipped decay and momentum tail in closed form, ``update_sparse_lazy`` steps
and scatters those rows, and ``materialize`` catches every row up before the
table is read outside training (``ops/lazy_adamw.py``, three row kernels).

The model's parameters and the moments are updated IN PLACE. The state is a
plain dict: ``emb_mu``, ``emb_nu`` (the table's moments), ``count`` (a Python
int: nothing is read back from the device per step), ``rest`` (the
``torch.optim.AdamW`` of the other parameters) and, when lazy, ``last_step``
(int32 [V], the step of each row's last update). On CUDA tensors the table
update launches the kernel, on CPU tensors it runs the plain version; there
is no switch. ``export_state`` and ``load_state`` carry the state as a flat
dict of tensors (the checkpoint's optimizer file).

Under a mesh the model holds a row shard of the table (``parallel/mesh.py``,
``model.table_offset`` its first global row) and the moments and
``last_step`` are that shard's: every table kernel runs on the shard at that
row offset, the eager sparse step through ``sharded_sparse_adamw`` (B1) with
``update_sparse(mesh=)``; ``init`` sizes the moments by the shard.

The table updates take the step's row of the step block
(``ops/step_block.py``) beside the host count, so that a CUDA graph of the
train step replays every step with its own count; the host count still
advances, by one a step. On the card ``torch.optim.AdamW`` runs with
``capturable=True`` for every step, chained or not: its step counter and bias
corrections live on the device, and the two paths stay bit-equal (the
capturable form rounds its bias corrections differently from the host form,
which the CPU keeps). Its state exists from ``init`` on, zeros at step 0 as
its first ``step()`` would make them, and ``load_state`` fills it in place:
a captured graph holds its addresses.
"""

from __future__ import annotations

import torch

# The first torch.optim optimizer of a process imports torch._dynamo, and a
# call made during that import (torch.fx.wrap) keeps its own frame in a
# reference cycle, and with it every frame above it: the function that built
# the optimizer, and the model that function holds, would stay alive (on the
# card too) until a full collection. Imported here, the frames kept are this
# module's import.
import torch._dynamo  # noqa: F401
from torch import nn

from gat_recommendation_torch.ops import lazy_adamw
from gat_recommendation_torch.ops.embedding_adamw import embedding_adamw
from gat_recommendation_torch.ops.sparse_adamw import sharded_sparse_adamw, sparse_adamw

EMBEDDING_KEY = "item_embedding"


def rest_parameters(model: nn.Module) -> dict[str, nn.Parameter]:
    """Every parameter of `model` but the item table, by name."""
    return {k: p for k, p in model.named_parameters() if k != EMBEDDING_KEY}


def _row_offset(model: nn.Module) -> int:
    """The global row of the model's table row 0 (a row shard's first row)."""
    return getattr(model, "table_offset", 0)


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
        lazy_tail_terms: int = lazy_adamw.TAIL_TERMS,
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

        lazy: update only the TOUCHED rows of the table each step and apply
        an untouched row's decay and momentum tail at its next touch,
        O(U·D) a step instead of the eager [V, D] sweep. Equal to dense AdamW
        within the momentum-tail truncation at `lazy_tail_terms` terms (about
        1e-5 of weight). ``materialize`` must run before the table is read
        outside training; the Trainer runs it before every evaluation and
        save. Sparse steps only: a dense step (``update_full``) raises.
        """
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
        self.lazy = lazy
        self.lazy_tail_terms = lazy_tail_terms

    @property
    def _hparams(self) -> dict:
        return dict(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay)

    def init(self, model: nn.Module) -> dict:
        """Fresh state for `model`: zero moments on the table's device."""
        table = model.get_parameter(EMBEDDING_KEY)
        rest = list(rest_parameters(model).values())
        capturable = table.device.type == "cuda"
        rest_opt = torch.optim.AdamW(
            rest, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay, capturable=capturable,
        )
        for p in rest:
            rest_opt.state[p] = {
                "step": torch.zeros((), device=p.device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
        state = {
            "emb_mu": torch.zeros_like(table, dtype=self.mu_dtype or table.dtype),
            "emb_nu": torch.zeros_like(table, dtype=self.nu_dtype or table.dtype),
            "count": 0,
            "rest": rest_opt,
        }
        if self.lazy:
            # Rows start "touched at step 0": zero moments, nothing pending.
            state["last_step"] = torch.zeros(table.shape[0], dtype=torch.int32, device=table.device)
        return state

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
    def update_full(self, grads: dict, state: dict, model: nn.Module,
                    step: torch.Tensor | None = None) -> dict:
        """Apply one step from dense gradients (`grads`: parameter name ->
        gradient, the table's under ``item_embedding``). `step`: this step's
        row of the step block (None: built from the count). Returns `state`."""
        if self.lazy:
            raise ValueError("the lazy optimizer takes sparse steps only (update_sparse_lazy)")
        state["count"] += 1
        embedding_adamw(
            model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
            grads[EMBEDDING_KEY].contiguous(), state["count"] if step is None else step,
            row_offset=_row_offset(model), stochastic_rounding=self._stochastic(state), **self._hparams,
        )
        self._step_rest(grads, state, model)
        return state

    @torch.no_grad()
    def update_sparse(
        self, g_rest: dict, uid: torch.Tensor, summed: torch.Tensor, state: dict, model: nn.Module,
        step: torch.Tensor | None = None, mesh=None,
    ) -> dict:
        """Apply one step with the table gradient pre-reduced as (uid, summed):
        ascending unique row ids with a sentinel tail, and their summed
        gradient rows, instead of a dense [V, D] gradient. `step`: this step's
        row of the step block (None: built from the count). With `mesh` the
        model holds its row shard and the table update is B1,
        ``sharded_sparse_adamw`` on that shard (uid and summed the replicated
        global ones). Returns `state`."""
        if self.lazy:
            raise ValueError("the lazy optimizer steps through gather_catch_up and update_sparse_lazy")
        state["count"] += 1
        args = (model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"], uid, summed,
                state["count"] if step is None else step)
        if mesh is None:
            sparse_adamw(*args, stochastic_rounding=self._stochastic(state), **self._hparams)
        else:
            from gat_recommendation_torch.parallel.mesh import axis_size, coordinates

            shard, n_shards = coordinates(mesh)[1], axis_size(mesh, "model")
            if shard * args[0].shape[0] != _row_offset(model):
                raise ValueError(f"the model's table starts at row {_row_offset(model)}, not at shard {shard}'s")
            sharded_sparse_adamw(*args, shard=shard, n_shards=n_shards,
                                 stochastic_rounding=self._stochastic(state), **self._hparams)
        self._step_rest(g_rest, state, model)
        return state

    # ---- lazy mode (O(touched rows) a step, ops/lazy_adamw.py) ----

    @torch.no_grad()
    def gather_catch_up(self, model: nn.Module, state: dict, uid: torch.Tensor,
                        step: torch.Tensor | None = None):
        """The touched rows with their pending updates applied: float32
        (w_c, mu_c, nu_c) [U, D], what dense AdamW would hold BEFORE this
        step's gradient (step ``count``), so the forward sees the dense
        trajectory's weights. Sentinel slots hold zeros and are never read.
        `step`: this step's row of the step block (None: from the count)."""
        return lazy_adamw.gather_catch_up(
            model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
            state["last_step"], uid, state["count"] + 1 if step is None else step,
            tail_terms=self.lazy_tail_terms, row_offset=_row_offset(model), **self._hparams,
        )

    @torch.no_grad()
    def update_sparse_lazy(
        self, g_rest: dict, uid: torch.Tensor, summed: torch.Tensor, w_c, mu_c, nu_c,
        state: dict, model: nn.Module, step: torch.Tensor | None = None,
    ) -> dict:
        """One step for the touched rows only: (w_c, mu_c, nu_c) from
        ``gather_catch_up`` on the SAME uid, `summed` the per-slot gradient
        (sentinel slots zero). Writes the uid rows of table, moments and
        ``last_step`` (= the new count); steps the other parameters through
        ``torch.optim.AdamW``. `step` as for ``gather_catch_up``. Returns
        `state`."""
        state["count"] += 1
        lazy_adamw.touched_update_scatter(
            model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
            state["last_step"], uid, w_c, mu_c, nu_c, summed,
            state["count"] if step is None else step, row_offset=_row_offset(model),
            stochastic_rounding=self._stochastic(state), **self._hparams,
        )
        self._step_rest(g_rest, state, model)
        return state

    @torch.no_grad()
    def materialize(self, model: nn.Module, state: dict) -> dict:
        """Catch EVERY row up to the current step (one pass over the table,
        in place), so the table equals the dense-AdamW trajectory. Must run
        before the table is read outside training. Idempotent; a no-op when
        not lazy. Returns `state`."""
        if self.lazy:
            lazy_adamw.materialize(
                model.get_parameter(EMBEDDING_KEY).data, state["emb_mu"], state["emb_nu"],
                state["last_step"], state["count"], tail_terms=self.lazy_tail_terms,
                row_offset=_row_offset(model), stochastic_rounding=self._stochastic(state), **self._hparams,
            )
        return state

    # ---- state in and out ----

    def export_state(self, state: dict, model: nn.Module) -> dict[str, torch.Tensor]:
        """The state as a flat dict of tensors (no copies): ``emb_mu``,
        ``emb_nu``, ``count`` (int64 scalar), ``last_step`` when lazy, and for
        every other parameter ``rest.<name>.step`` / ``.exp_avg`` /
        ``.exp_avg_sq`` (zeros before the first step). ``load_state`` takes it."""
        out = {
            "emb_mu": state["emb_mu"],
            "emb_nu": state["emb_nu"],
            "count": torch.tensor(state["count"], dtype=torch.int64),
        }
        if "last_step" in state:
            out["last_step"] = state["last_step"]
        for name, p in rest_parameters(model).items():
            s = state["rest"].state[p]
            out[f"rest.{name}.step"] = torch.tensor(float(s["step"]))
            out[f"rest.{name}.exp_avg"] = s["exp_avg"]
            out[f"rest.{name}.exp_avg_sq"] = s["exp_avg_sq"]
        return out

    def load_state(self, state: dict, model: nn.Module, saved: dict) -> dict:
        """Fill `state` (from ``init``) IN PLACE with the flat dict of
        ``export_state`` (from a checkpoint, or ``convert.opt_state_from_jax``);
        a lazy state needs ``last_step``. Every tensor keeps its device, the
        rest-AdamW step counter too (on the card with ``capturable``).
        Returns `state`."""
        state["count"] = int(saved["count"])
        with torch.no_grad():
            state["emb_mu"].copy_(saved["emb_mu"])
            state["emb_nu"].copy_(saved["emb_nu"])
            if self.lazy:
                state["last_step"].copy_(saved["last_step"])
            for name, p in rest_parameters(model).items():
                s = state["rest"].state[p]
                s["step"].fill_(float(saved[f"rest.{name}.step"]))
                s["exp_avg"].copy_(saved[f"rest.{name}.exp_avg"])
                s["exp_avg_sq"].copy_(saved[f"rest.{name}.exp_avg_sq"])
        return state
