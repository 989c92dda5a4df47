"""The step block and what reads it, on the CPU.

The per-step parameter block (``ops/step_block.py``) carries the step
count, the bias corrections, the rounding seeds and every layer's dropout
seeds in device memory, so that a CUDA graph of the train step replays each
step with its own values. Its fields must EQUAL what the by-value path
computed from the same count and seed; everything that reads a row (the
counter hash with a tensor seed, node dropout, the attention's plain version,
the AdamW wrappers, the model) must give EQUAL results to the int form. Node
dropout keeps 1 - rate of its elements within four binomial standard
deviations, and its gradient is the same mask and scale. The rest-AdamW state round-trips through export and load.
"""

import numpy as np
import pytest
import torch

from gat_recommendation_torch.data import batching
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.ops import lazy_adamw, masked, rounding, step_block
from gat_recommendation_torch.ops import session_attention as sa
from gat_recommendation_torch.ops.embedding_adamw import (
    bias_corrections,
    bias_denominators,
    embedding_adamw,
    moment_seed,
)
from gat_recommendation_torch.ops.node_dropout import node_dropout
from gat_recommendation_torch.ops.sparse_adamw import sparse_adamw
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW, rest_parameters

torch.set_num_threads(1)

HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
SEEDS = [0, 1, 2**63 - 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15, 12345678901234567]


def _bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.int32))


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.8, 0.95)])
def test_step_block_equals_the_by_value_scalars(b1, b2):
    count0, layers = 37, 3
    rows = step_block.host_rows(count0, SEEDS, b1=b1, b2=b2, num_layers=layers, seeds_per_layer=2)
    assert rows.shape == (len(SEEDS), step_block.width(layers, 2)) and rows.dtype == np.int64
    for i, seed in enumerate(SEEDS):
        count = count0 + 1 + i
        row = rows[i]
        assert row[step_block.COUNT] == count
        den, inv = bias_denominators(count, b1, b2), bias_corrections(count, b1, b2)
        assert [row[step_block.BC1], row[step_block.BC2]] == [_bits(d) for d in den]
        assert [row[step_block.IBC1], row[step_block.IBC2]] == [_bits(d) for d in inv]
        for field, buffer in ((step_block.SEED_MU, 0), (step_block.SEED_NU, 1)):
            assert int(row[field]) & (2**64 - 1) == moment_seed(count, buffer)
        for layer in range(layers):
            att, node = step_block.layer_seeds(torch.from_numpy(row), layer, 2)
            assert (int(att) & (2**64 - 1), int(node) & (2**64 - 1)) == step_block.layer_seeds(seed, layer, 2)
            assert step_block.layer_seeds(seed, layer, 2) == (rounding.mix_seed(seed, layer, 0),
                                                           rounding.mix_seed(seed, layer, 1))
    one = step_block.one_row(count0 + 1, b1=b1, b2=b2, device="cpu")
    assert torch.equal(one, torch.from_numpy(rows[0, :step_block.LAYER_FIELDS]))
    assert step_block.count_of(one) == count0 + 1 == step_block.count_of(count0 + 1)


def test_a_step_row_must_be_an_int64_row_on_the_device():
    with pytest.raises(ValueError, match="step row"):
        step_block.row_on(torch.zeros(7, dtype=torch.int32), b1=0.9, b2=0.999, device="cpu")
    with pytest.raises(ValueError, match="step row"):
        step_block.row_on(torch.zeros(3, dtype=torch.int64), b1=0.9, b2=0.999, device="cpu")
    row = step_block.one_row(5, b1=0.9, b2=0.999, device="cpu")
    assert step_block.row_on(row, b1=0.9, b2=0.999, device="cpu") is row


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_hash_of_a_tensor_seed_equals_the_int_seed_form(seed):
    idx = torch.cat([torch.arange(5000), torch.tensor([2**32 - 1, 2**32, 2**40 + 17, 2**62])])
    held = torch.tensor(step_block.as_int64(seed))
    got = rounding.counter_hash(held, idx)
    assert torch.equal(got, rounding.counter_hash(seed, idx))
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_node_dropout_keep_rate_is_binomial_and_the_seed_fixes_the_mask(rate):
    x = torch.ones(64, 56, 32)
    n = x.numel()
    masks = []
    for seed in (11, 2**63 + 5):
        y = masked.dropout(x, rate, True, seed)
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
        assert torch.equal(y[kept], torch.full_like(y[kept], rounding.keep_scale(rate)))
        assert torch.equal(kept, rounding.keep_mask(x.shape, rate, seed, "cpu"))
        assert torch.equal(masked.dropout(x, rate, True, torch.tensor(step_block.as_int64(seed))), y)
        assert torch.equal(masked.dropout(x, rate, True, seed), y)
        assert torch.equal(node_dropout(x, rate, seed), y)  # the wrapper's plain path
        masks.append(kept)
    assert not torch.equal(*masks)
    assert masked.dropout(x, rate, False, 11) is x and node_dropout(x, 0.0, 11) is x


def test_node_dropout_gradient_is_the_same_mask_and_scale():
    """What the kernel's backward launches: the forward's function applied to
    the output gradient."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 7, 12)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((5, 7, 12)).astype(np.float32))
    (grad,) = torch.autograd.grad(node_dropout(x, 0.3, 2**63 + 9), x, g)
    assert torch.equal(grad, masked.dropout(g, 0.3, True, 2**63 + 9))


def test_attention_with_a_tensor_seed_equals_the_int_seed():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 9, 16)).astype(np.float32)) for _ in range(3))
    adj = torch.from_numpy(rng.random((3, 9, 9)) < 0.5)
    for seed in SEEDS[2:5]:
        want = sa.session_attention(q, k, v, adj, 2, 0.3, seed)
        got = sa.session_attention(q, k, v, adj, 2, 0.3, torch.tensor(step_block.as_int64(seed)))
        assert torch.equal(got, want)


def _table(seed=0, rows=64, D=8, U=16):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(rows, D, generator=gen)
    mu, nu = 0.01 * torch.randn(rows, D, generator=gen), torch.rand(rows, D, generator=gen) * 1e-4
    last = torch.randint(0, 5, (rows,), generator=gen, dtype=torch.int32)
    uid = torch.full((U,), int(batching.UID_SENTINEL), dtype=torch.int32)
    uid[:10] = torch.randperm(rows, generator=gen)[:10].sort().values.int()
    summed = 1e-3 * torch.randn(U, D, generator=gen)
    return (table, mu, nu, last), uid, summed


@pytest.mark.parametrize("count", [1, 7, 250])
def test_adamw_wrappers_read_a_step_row_as_they_read_the_count(count):
    (table, mu, nu, last), uid, summed = _table()
    row = step_block.build(count - 1, [3], b1=0.9, b2=0.999, num_layers=2, device="cpu", seeds_per_layer=2)[0]
    got = lazy_adamw.gather_catch_up(table, mu, nu, last, uid, row, **HYPER)
    want = lazy_adamw.gather_catch_up(table, mu, nu, last, uid, count, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    by_row = [t.clone() for t in (table, mu, nu, last)]
    by_int = [t.clone() for t in (table, mu, nu, last)]
    lazy_adamw.touched_update_scatter(*by_row, uid, *got, summed, row, **HYPER)
    lazy_adamw.touched_update_scatter(*by_int, uid, *want, summed, count, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(by_row, by_int))
    by_row, by_int = [t.clone() for t in (table, mu, nu)], [t.clone() for t in (table, mu, nu)]
    sparse_adamw(*by_row, uid, summed, row, **HYPER)
    sparse_adamw(*by_int, uid, summed, count, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(by_row, by_int))
    grad = 1e-3 * torch.randn(table.shape, generator=torch.Generator().manual_seed(count))
    by_row, by_int = [t.clone() for t in (table, mu, nu)], [t.clone() for t in (table, mu, nu)]
    embedding_adamw(*by_row, grad, row, **HYPER)
    embedding_adamw(*by_int, grad, count, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(by_row, by_int))


def _model(dropout=0.2, seed=3):
    return registry.create_model("graph_transformer_optimized", 120, embedding_dim=16, hidden_dim=16,
                                 laplacian_k=4, dropout=dropout, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))


def _batches(n=3, seed=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 9, 60)
    sid = np.repeat(np.arange(60), lengths)
    items = rng.integers(1, 120, int(lengths.sum()))
    ds = batching.SessionDataset((sid, np.arange(len(sid)), items),
                                 (rng.integers(1, 120, 2000), rng.integers(1, 120, 2000)), num_items=120)
    return list(batching.iterate_batches(ds, 12))[:n]


def test_the_model_reads_its_layer_seeds_from_a_step_row():
    model = _model().train()
    batch = _batches(1)[0]
    block = step_block.build(0, [99], b1=0.9, b2=0.999, num_layers=model.config.num_layers, device="cpu",
                             seeds_per_layer=model.seeds_per_layer)
    want = model(batch, seed=99)
    got = model(batch, seed=block[0])
    assert torch.equal(got, want) and not torch.equal(got, model(batch, seed=98))


@pytest.mark.parametrize("lazy", [True, False])
def test_chained_step_equals_single_steps_and_advances_the_count(lazy):
    batches = _batches(3)
    seeds = [41, 42, 43]
    results = []
    for chained in (False, True):
        model = _model()
        opt = FusedEmbeddingAdamW(1e-2, weight_decay=1e-4, lazy=lazy)
        state = opt.init(model)
        loss_fn = create_loss_function("dual")
        if chained:
            gidxs = batching.stack_grad_indices([batching.make_grad_index(b) for b in batches])
            block = port_trainer.next_steps_block(model, opt, state, seeds, "cpu")
            step = port_trainer.make_chained_sparse_train_step(model, loss_fn, opt, state)
            losses = step(batching.stack_batches(batches), batching.to_device(gidxs, "cpu"), block)
        else:
            step = port_trainer.make_sparse_train_step(model, loss_fn, opt, state)
            losses = torch.stack([step(b, seed=s) for b, s in zip(batches, seeds)])
        assert state["count"] == 3 and losses.shape == (3,)
        results.append((losses, [*model.state_dict().values(), state["emb_mu"], state["emb_nu"]]))
    (a, ta), (b, tb) = results
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_rest_adamw_state_exists_from_init_and_round_trips():
    batches = _batches(2)
    model = _model(dropout=0.0)
    opt = FusedEmbeddingAdamW(1e-2, weight_decay=1e-4, lazy=True)
    state = opt.init(model)
    rest = rest_parameters(model)
    for p in rest.values():  # what the first step() would create: zeros at step 0
        s = state["rest"].state[p]
        assert float(s["step"]) == 0.0 and not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    assert not state["rest"].param_groups[0]["capturable"]  # the CPU keeps the host form
    step = port_trainer.make_sparse_train_step(model, create_loss_function("dual"), opt, state)
    step(batches[0], seed=1)
    saved = {k: v.clone() for k, v in opt.export_state(state, model).items()}
    twin = _model(dropout=0.0)
    twin.load_state_dict(model.state_dict())
    twin_state = opt.init(twin)
    identity = {name: [t for t in twin_state["rest"].state[p].values()] for name, p in rest_parameters(twin).items()}
    opt.load_state(twin_state, twin, saved)
    for name, p in rest_parameters(twin).items():  # filled in place: a graph's addresses stay valid
        assert all(a is b for a, b in zip(twin_state["rest"].state[p].values(), identity[name]))
    got = opt.export_state(twin_state, twin)
    assert set(got) == set(saved) and all(torch.equal(got[k], saved[k]) for k in saved)
    twin_step = port_trainer.make_sparse_train_step(twin, create_loss_function("dual"), opt, twin_state)
    assert torch.equal(step(batches[1], seed=2), twin_step(batches[1], seed=2))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), twin.state_dict().values()))


def test_the_optimized_graph_transformers_rows_keep_their_layout():
    """[C, 11] for 2 layers, the fields where they were before other models
    took rows: 7 leading fields, then per layer the attention-dropout seed
    mix_seed(seed, layer, 0) and the node-dropout seed mix_seed(seed, layer, 1)."""
    model = _model()
    assert model.name == "graph_transformer_optimized" and model.seeds_per_layer == 2
    opt = FusedEmbeddingAdamW(1e-3)
    state = opt.init(model)
    state["count"] = 12
    block = port_trainer.next_steps_block(model, opt, state, SEEDS[:4], "cpu")
    assert block.shape == (4, 11) and block.dtype == torch.int64
    for i, seed in enumerate(SEEDS[:4]):
        count = 13 + i
        want = [count, *(_bits(d) for d in bias_denominators(count, 0.9, 0.999)),
                *(_bits(d) for d in bias_corrections(count, 0.9, 0.999)),
                step_block.as_int64(moment_seed(count, 0)), step_block.as_int64(moment_seed(count, 1))]
        for layer in range(2):
            want += [step_block.as_int64(rounding.mix_seed(seed, layer, j)) for j in (0, 1)]
        assert block[i].tolist() == want


@pytest.mark.parametrize("name,kw,seeds", [
    ("gat", {}, 2),
    ("graphsage", {"aggregator": "lstm"}, 1),
    ("graph_transformer", {"laplacian_k": 4}, 4),
])
def test_every_model_reads_its_seeds_per_layer_from_a_step_row(name, kw, seeds):
    """A model states how many seeds a layer takes; its rows are 7 + seeds *
    layers wide, field 7 + seeds * layer + j holding mix_seed(seed, layer, j),
    and its train-mode forward from a row EQUALS the one from the int seed."""
    model = registry.create_model(name, 120, embedding_dim=16, hidden_dim=16, dropout=0.3, device="cpu",
                                  generator=torch.Generator().manual_seed(1), **kw).train()
    assert model.seeds_per_layer == seeds
    opt = FusedEmbeddingAdamW(1e-3)
    block = port_trainer.next_steps_block(model, opt, opt.init(model), [77], "cpu")
    assert block.shape == (1, step_block.width(3, seeds)) == (1, 7 + 3 * seeds)
    for layer in range(3):
        assert step_block.layer_seeds(77, layer, seeds) == tuple(rounding.mix_seed(77, layer, j) for j in range(seeds))
        held = step_block.layer_seeds(block[0], layer, seeds)
        assert [int(t) & (2**64 - 1) for t in held] == list(step_block.layer_seeds(77, layer, seeds))
    batch = _batches(1)[0]
    want = model(batch, seed=77)
    assert torch.equal(model(batch, seed=block[0]), want) and not torch.equal(model(batch, seed=78), want)
