"""Seeded weights come from a CPU generator, whatever the model's device.

Every parameter draw of the port fills a host tensor from a CPU
``torch.Generator`` and copies it onto the model's device, so one seed gives
the same weights on the card as on the CPU (as one ``jax.random.key`` gives
the same weights on every backend). On the CPU the draws are the ones the port
made before the draws moved to the host: a digest of each model's state,
taken then, is pinned below. Everything here is compared bit for bit.
The card's side (``device="cuda"`` against ``device="cpu"``) is in
``tests/test_torch_kernels_on_card.py``.
"""

import hashlib
import math
import types

import pytest
import torch

from gat_recommendation_torch.models import base
from gat_recommendation_torch.models.registry import MODEL_NAMES, create_model
from gat_recommendation_torch.parallel.mesh import shard_model
from gat_recommendation_torch.train.trainer import Trainer

torch.set_num_threads(1)

NUM_ITEMS, WIDTH = 300, 16  # 512 padded rows, 212 of them phantom
CASES = [
    ("graph_transformer_optimized", {}),
    ("graph_transformer", {}),
    ("graph_transformer", {"readout_type": "attention", "use_laplacian_pe": False, "use_ffn": False}),
    ("gat", {}),
    ("gat", {"concat_heads": True, "readout_type": "attention"}),
    ("graphsage", {"aggregator": "mean"}),
    ("graphsage", {"aggregator": "max"}),
    ("graphsage", {"aggregator": "lstm"}),
]
CASE_IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in fields.items()) or 'defaults'}" for name, fields in CASES]

# sha256 of each state (sorted keys, then the tensor's bytes) at 1,000 items,
# widths 16, seed 5, drawn by the port when it still drew from a generator of
# the model's device (here the CPU); the last with no generator (seed 0).
PINNED = {
    ("graph_transformer_optimized", ()): "ec85836d5bf96cff8934470ccba27213ce402b40faa7503946264edd4667b9ee",
    ("graph_transformer", ()): "59061f5fe42dc88e0355803cf93d13c9462cfe1a9ade676766721c68670101a3",
    ("gat", ()): "165a3f22a5ade918adcc64f75e0c2d1d79f665b3bf0f2e3425cb74e019ac7d53",
    ("graphsage", (("aggregator", "mean"),)): "69f2f3eccbe698ebf3385db0d174acfbb7ee86f6546c67e8cd2e5fb9ac44a5f6",
    ("graphsage", (("aggregator", "lstm"),)): "6edb94960cae247891245604da4d31f660629a292033b636ae4c17e2486df08a",
}
PINNED_DEFAULT_SEED = "1385b39f9e173497f5ea231b809368c2b71cddb4da61c04aa06f2873b24b663d"


def _model(name, fields, seed, num_items=NUM_ITEMS):
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    return create_model(name, num_items, embedding_dim=WIDTH, hidden_dim=WIDTH, device="cpu",
                        generator=generator, **fields)


def _digest(model) -> str:
    h = hashlib.sha256()
    for key, value in sorted(model.state_dict().items()):
        h.update(key.encode())
        h.update(value.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _assert_states_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


def _draw_plan(model) -> list[tuple[str, float]]:
    """(state key, bound a of U(-a, a)) of every drawn tensor, in the order
    the models document: the table, the attention readout, then the layers
    (the Graph Transformer: the PE projection, then per layer query, key,
    value, skip, beta and the FFN's up and down; GAT: per layer lin, att_src,
    att_dst; GraphSAGE: per layer lin_l, lin_r and the LSTM's four)."""
    cfg = model.config
    plan = [("item_embedding", math.sqrt(6.0 / (cfg.num_items - 1 + model.item_embedding.shape[1])))]

    def linear(prefix: str, layer: torch.nn.Linear, xavier: bool = False) -> None:
        if xavier:  # the bias stays zero
            plan.append((f"{prefix}.weight", math.sqrt(6.0 / (layer.in_features + layer.out_features))))
            return
        bound = 1.0 / math.sqrt(layer.in_features)
        plan.append((f"{prefix}.weight", bound))
        if layer.bias is not None:
            plan.append((f"{prefix}.bias", bound))

    if model.readout is not None:
        linear("readout", model.readout, xavier=True)
    for i, conv in enumerate(model.convs):
        if model.name.startswith("graph_transformer"):
            if i == 0 and model.lap_projection is not None:
                linear("lap_projection", model.lap_projection, xavier=True)
            for part in ("query", "key", "value", "skip", "beta"):
                linear(f"convs.{i}.{part}", getattr(conv, part))
            if model.ffns is not None:
                linear(f"ffns.{i}.up", model.ffns[i].up)
                linear(f"ffns.{i}.down", model.ffns[i].down)
        elif model.name == "gat":
            for part in ("lin.weight", "att_src", "att_dst"):
                t = model.get_parameter(f"convs.{i}.{part}")
                plan.append((f"convs.{i}.{part}", math.sqrt(6.0 / (t.shape[-2] + t.shape[-1]))))
        else:
            linear(f"convs.{i}.lin_l", conv.lin_l)
            linear(f"convs.{i}.lin_r", conv.lin_r)
            if conv.lstm is not None:
                bound = 1.0 / math.sqrt(conv.lstm.weight_hh.shape[1])
                plan += [(f"convs.{i}.lstm.{p}", bound) for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    return plan


def _expected_state(model, generator: torch.Generator) -> dict:
    """The state drawn here from `generator` in the documented order; what is
    not drawn is at its fixed value (BatchNorm at identity, the biases of
    xavier linears and GAT's conv bias and the positional encodings zero)."""
    state = model.state_dict()
    fixed = {k: (torch.ones_like(v) if k.rsplit(".", 1)[-1] in ("scale", "var") and "batch_norms" in k
                 else torch.zeros_like(v)) for k, v in state.items()}
    for key, a in _draw_plan(model):
        fixed[key] = torch.empty(state[key].shape).uniform_(-a, a, generator=generator)
    table = fixed["item_embedding"]
    table[0] = 0.0
    table[model.config.num_items:] = 0.0
    return fixed


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("name,fields", CASES, ids=CASE_IDS)
def test_the_cpu_state_is_the_documented_draw_from_the_cpu_generator(name, fields, seed):
    gen = torch.Generator().manual_seed(seed)
    model = create_model(name, NUM_ITEMS, embedding_dim=WIDTH, hidden_dim=WIDTH, device="cpu", generator=gen,
                         **fields)
    want_gen = torch.Generator().manual_seed(seed)
    _assert_states_equal(model.state_dict(), _expected_state(model, want_gen))
    # and the model took from the generator exactly what the documented draws take
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=want_gen))


@pytest.mark.parametrize("key", list(PINNED), ids=[name for name, _ in PINNED])
def test_the_cpu_bits_are_the_ones_drawn_before_the_draws_moved_to_the_host(key):
    name, fields = key
    model = create_model(name, 1000, embedding_dim=WIDTH, hidden_dim=WIDTH, device="cpu",
                         generator=torch.Generator().manual_seed(5), **dict(fields))
    assert _digest(model) == PINNED[key]


def test_without_a_generator_the_weights_are_seed_0_of_a_cpu_generator():
    model = _model("graph_transformer_optimized", {}, None, num_items=1000)
    assert _digest(model) == PINNED_DEFAULT_SEED
    _assert_states_equal(model.state_dict(), _model("graph_transformer_optimized", {}, 0, num_items=1000).state_dict())


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("name,fields", [CASES[0], CASES[3], CASES[5]], ids=[CASE_IDS[0], CASE_IDS[3], CASE_IDS[5]])
def test_row_shards_put_together_are_the_whole_table(name, fields, n_model):
    whole = _model(name, fields, 3)
    shards = []
    for rank in range(n_model):
        mesh = types.SimpleNamespace(shape=(1, n_model), get_local_rank=lambda axis, r=rank: {"data": 0, "model": r}[axis])
        model = shard_model(_model(name, fields, 0), mesh)  # other weights first, then drawn anew
        gen = torch.Generator().manual_seed(3)
        model.reset_parameters(gen)
        assert model.table_offset == rank * whole.item_embedding.shape[0] // n_model
        state = model.state_dict()
        shards.append(state.pop("item_embedding"))
        want = whole.state_dict()
        want.pop("item_embedding")
        if "cached_pe" in want:  # shaped like the table: the rank holds its rows
            state.pop("cached_pe")
            want.pop("cached_pe")
        _assert_states_equal(state, want)
        # each rank took from the generator what one GPU takes
        assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=_consumed(whole, 3)))
    assert torch.equal(torch.cat(shards), whole.item_embedding.detach())


def _consumed(model, seed: int) -> torch.Generator:
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    return gen


@pytest.mark.parametrize("chunk_bytes", [1, 7 * 48, 64 * 48, 512 * 48, 10_000 * 48, 50 * 48 + 5])
@pytest.mark.parametrize("first_row,rows,total_rows", [(0, 512, 520), (0, 128, 512), (128, 128, 512),
                                                        (384, 128, 512), (5, 3, 9)])
def test_a_chunked_table_draw_equals_the_one_piece_draw(chunk_bytes, first_row, rows, total_rows, monkeypatch):
    dim = 12  # 48 bytes a row: chunks of 1, 7, 64, 512, 10,000 and 50 rows
    monkeypatch.setattr(base, "DRAW_CHUNK_BYTES", chunk_bytes)
    one = torch.empty(total_rows, dim).uniform_(-0.3, 0.3, generator=(want_gen := torch.Generator().manual_seed(9)))
    table = torch.full((rows, dim), float("nan"))
    gen = torch.Generator().manual_seed(9)
    base.draw_rows_uniform_(table, -0.3, 0.3, gen, total_rows=total_rows, first_row=first_row)
    assert torch.equal(table, one[first_row:first_row + rows])
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=want_gen))


def test_the_whole_table_on_the_cpu_is_drawn_in_place_as_before():
    table = torch.empty(512, 16)
    base.draw_rows_uniform_(table, -0.1, 0.1, torch.Generator().manual_seed(2))
    assert torch.equal(table, torch.empty(512, 16).uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name,fields", [CASES[0], CASES[1], CASES[4], CASES[7]],
                         ids=[CASE_IDS[0], CASE_IDS[1], CASE_IDS[4], CASE_IDS[7]])
def test_trainer_init_state_draws_what_create_model_draws_from_the_seed(name, fields, seed, tmp_path):
    model = _model(name, fields, 123)
    trainer = Trainer(model, lambda epoch: iter(()), lambda: iter(()), output_dir=tmp_path, seed=seed, device="cpu")
    trainer.init_state()
    _assert_states_equal(model.state_dict(), _model(name, fields, seed).state_dict())


def test_a_generator_on_another_device_raises():
    elsewhere = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="CPU torch.Generator.*cuda:0"):
        base.draw_uniform_(torch.empty(3), -1.0, 1.0, elsewhere)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        base.draw_rows_uniform_(torch.empty(4, 2), -1.0, 1.0, elsewhere)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        create_model("gat", NUM_ITEMS, embedding_dim=WIDTH, hidden_dim=WIDTH, device="cpu", generator=elsewhere)
    model = _model("graphsage", {}, 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        model.reset_parameters(elsewhere)
    _assert_states_equal(model.state_dict(), before)  # raised before anything was drawn


def test_nothing_is_drawn_on_the_meta_device():
    gen = torch.Generator().manual_seed(4)
    model = create_model("graph_transformer_optimized", NUM_ITEMS, embedding_dim=WIDTH, hidden_dim=WIDTH,
                         device="meta", generator=gen)
    assert model.item_embedding.device.type == "meta"
    base.draw_uniform_(torch.empty(3, device="meta"), -1.0, 1.0, gen)
    base.draw_rows_uniform_(torch.empty(4, 2, device="meta"), -1.0, 1.0, gen, total_rows=8)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=torch.Generator().manual_seed(4)))


def test_every_model_of_the_registry_is_covered():
    assert {name for name, _ in CASES} == set(MODEL_NAMES)
