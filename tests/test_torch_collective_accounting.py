"""The port's collective accounting (``scripts/pipeline/collective_accounting.py``) on gloo.

At 1x1, 2x1, 1x2 and 2x2 (one spawned CPU process a rank, the lazy step at
tiny widths; 2x2 also through ``main`` at the reference widths, the eager
step, over a small catalog) the collectives each case issues equal, by op
and axis, in count and in bytes, what the sharded steps' design says
(``parallel/steps.py``; PERF.md §3): a sparse step sums over 'model' the
uid rows (the lazy step its caught-up rows and both moments, three [U, D]
tensors) and the positional-encoding rows, and over 'data' the BatchNorm
count, sum and squared deviations of each layer, two of their gradients a
layer, the dual loss's two sample counts, the summed [U, D] rows, the other
gradients in one tensor and the loss: 2 + 15 = 17. An eval step sums the
node and encoding rows over 'model' and gathers the top-k values and ids.
A group that spans every rank is named ``all``, as the JAX script names it.
The chained case issues its step's collectives once a slot, so its
``per_step_bytes`` is the unchained step's bytes. The JSON has the JAX
script's keys (``outputs/collective_accounting.json`` holds its output),
and the script imports no JAX.

Against the JAX script itself (``scripts/pipeline/collective_accounting.py``
run in this process on the conftest's 8 virtual CPU devices), at 4x2, the lazy
step, the reference widths over a 1,000-item catalog, chain 2: over 'model'
each case moves the bytes the JAX program moves. Where the packages differ
by design the test names it: XLA's combiner merges the two 'model' sums of a
step (and of an eval step) into one all-reduce, so the JAX counts are lower;
the HLO holds a scan's body once, so the JAX chained case's total is one
slot's; the port's top-k ids are int64 (the JAX script's int32), so its
two-phase all-gathers move half as much again; and the 'data' axis is not
compared (GSPMD sums the batch statistics and gathers per-sample rows where
the port all-reduces the summed rows and the other gradients, PERF.md §3).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gat_recommendation_torch.bench import make_batches
from gat_recommendation_torch.data.batching import make_grad_index
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.scripts.pipeline import collective_accounting
from gat_recommendation_torch.train.optimizers import rest_parameters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_items=300, chain=3, dim=16, batch=16)
MAIN_ITEMS, MAIN_CHAIN = 1000, 2
JAX_SHAPE = (4, 2)  # the JAX script meshes every device: the conftest's 8
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
FLOAT, LONG = 4, 8


def design(shape, num_items: int, dim: int, batch: int, lazy: bool, top_k: int = collective_accounting.TOP_K) -> dict:
    """by_op_axis of the sparse step and of an eval step, by the design."""
    n_data, n_model = shape
    model = create_model("graph_transformer_optimized", num_items, embedding_dim=dim, hidden_dim=dim, device="cpu")
    cfg = model.config
    hb = make_batches(num_items, batch, 1, seed=0)[0]
    U, N = make_grad_index(hb).uid.shape[0], hb.node_ids.shape[1]
    b = batch // n_data
    rest = sum(p.numel() for p in rest_parameters(model).values())
    rows = (3 if lazy else 1) * U * dim * FLOAT + b * N * cfg.laplacian_k * FLOAT
    data = [cfg.num_layers * 3, cfg.num_layers * (1 + 2 * cfg.hidden_dim) * FLOAT]  # BatchNorm count, sum, squares
    data = [data[0] + 2 + cfg.num_layers * 2 + 3,  # the loss's counts, BatchNorm gradients, summed, rest, loss
            data[1] + 2 * FLOAT + cfg.num_layers * 2 * cfg.hidden_dim * FLOAT + U * dim * FLOAT + rest * FLOAT + FLOAT]
    model_axis = "all" if n_data == 1 else "model"
    data_axis = "all" if n_model == 1 else "data"
    train, evaluate = {}, {}

    def add(into, key, count, nbytes):
        entry = into.setdefault(key, {"count": 0, "bytes": 0})
        entry["count"] += count
        entry["bytes"] += nbytes

    add(train, f"all-reduce/{model_axis}", 2, rows)
    add(train, f"all-reduce/{data_axis}", *data)
    add(evaluate, f"all-reduce/{model_axis}", 2, b * N * (dim + cfg.laplacian_k) * FLOAT)
    add(evaluate, f"all-gather/{model_axis}", 2, n_model * b * top_k * (FLOAT + LONG))
    return {"train": train, "eval": evaluate}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def accounted(request):
    shape = request.param
    return shape, collective_accounting.account(*shape, lazy=True, threads=1, timeout=240, **SMALL)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """``main`` at 2x2 with its defaults but the catalog and the chain: the
    eager step at batch 512, D = 256."""
    out = tmp_path_factory.mktemp("accounting") / "accounting.json"
    assert collective_accounting.main(["--mesh", "2x2", "--num-items", str(MAIN_ITEMS), "--chain", str(MAIN_CHAIN),
                                       "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_the_sparse_step_issues_what_the_design_says(accounted):
    shape, got = accounted
    want = design(shape, SMALL["num_items"], SMALL["dim"], SMALL["batch"], lazy=True)
    step = got["steps"]["sparse_train_step"]
    assert step["by_op_axis"] == want["train"]
    assert step["n_collectives"] == 17
    assert step["total_bytes"] == sum(e["bytes"] for e in want["train"].values())


def test_the_chained_case_issues_the_unchained_steps_collectives_a_slot(accounted):
    _, got = accounted
    chain = SMALL["chain"]
    step, chained = got["steps"]["sparse_train_step"], got["steps"][f"chained_sparse_step_C{chain}"]
    assert chained["per_step_bytes"] == step["total_bytes"]
    assert chained["n_collectives"] == chain * step["n_collectives"]
    assert chained["by_op_axis"] == {k: {"count": chain * e["count"], "bytes": chain * e["bytes"]}
                                     for k, e in step["by_op_axis"].items()}
    one = [(c["op"], c["axis"], c["shape"]) for c in got["calls"]["sparse_train_step"]]
    assert [(c["op"], c["axis"], c["shape"]) for c in got["calls"][f"chained_sparse_step_C{chain}"]] == one * chain


def test_both_eval_steps_issue_what_the_design_says(accounted):
    shape, got = accounted
    want = design(shape, SMALL["num_items"], SMALL["dim"], SMALL["batch"], lazy=True)["eval"]
    for case in ("eval_step_gspmd", "eval_step_v2_twophase"):
        assert got["steps"][case]["by_op_axis"] == want, case
        assert got["steps"][case]["n_collectives"] == 4


def test_main_writes_the_jax_scripts_schema(main_run):
    """The keys of the JAX script's output, ``per_step_bytes`` on the chained
    case alone, and the mesh and config it ran."""
    jax_out = json.loads((REPO / "outputs" / "collective_accounting.json").read_text())
    assert set(main_run) == set(jax_out)
    assert set(main_run["config"]) == set(jax_out["config"]) and set(main_run["mesh"]) == set(jax_out["mesh"])
    names = {k.replace(f"C{MAIN_CHAIN}", "C8") for k in main_run["steps"]}
    assert names == set(jax_out["steps"])
    for name, entry in main_run["steps"].items():
        assert set(entry) == set(jax_out["steps"][name.replace(f"C{MAIN_CHAIN}", "C8")]), name
        for by in entry["by_op_axis"].values():
            assert set(by) == {"count", "bytes"}
    assert main_run["mesh"] == {"data": 2, "model": 2}
    assert main_run["config"] == {"num_items": MAIN_ITEMS, "batch": 512, "dim": 256, "bucket_n": 8}


def test_main_at_the_reference_widths_follows_the_design_for_the_eager_step(main_run):
    want = design((2, 2), MAIN_ITEMS, 256, 512, lazy=False)
    assert main_run["steps"]["sparse_train_step"]["by_op_axis"] == want["train"]
    assert main_run["steps"]["eval_step_gspmd"]["by_op_axis"] == want["eval"]
    assert main_run["steps"][f"chained_sparse_step_C{MAIN_CHAIN}"]["per_step_bytes"] == \
        main_run["steps"]["sparse_train_step"]["total_bytes"]


def test_the_script_imports_no_jax():
    probe = ("import sys; import gat_recommendation_torch.scripts.pipeline.collective_accounting; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'optax', 'orbax', 'gat_recommendation_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """The JAX script's JSON and the port's, both at JAX_SHAPE, lazy, the
    reference widths over MAIN_ITEMS items, chain MAIN_CHAIN."""
    out = tmp_path_factory.mktemp("jax_accounting") / "jax.json"
    spec = importlib.util.spec_from_file_location("jax_collective_accounting",
                                                  REPO / "scripts" / "pipeline" / "collective_accounting.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    mesh = f"{JAX_SHAPE[0]}x{JAX_SHAPE[1]}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["collective_accounting.py", "--mesh", mesh, "--num-items", str(MAIN_ITEMS),
                                 "--chain", str(MAIN_CHAIN), "--lazy", "--out", str(out)])
        script.main()
    port = collective_accounting.account(*JAX_SHAPE, num_items=MAIN_ITEMS, chain=MAIN_CHAIN, lazy=True, threads=2,
                                         timeout=600)
    return json.loads(out.read_text()), port


@pytest.mark.parametrize("case", ["sparse_train_step", f"chained_sparse_step_C{MAIN_CHAIN}", "eval_step_gspmd",
                                  "eval_step_v2_twophase"])
def test_the_model_axis_moves_the_bytes_of_the_jax_script(against_jax, case):
    jax_out, port = against_jax
    assert port["config"] == jax_out["config"] and port["mesh"] == jax_out["mesh"]
    want, got = jax_out["steps"][case]["by_op_axis"], port["steps"][case]["by_op_axis"]
    slots = MAIN_CHAIN if case.startswith("chained") else 1  # the HLO holds the scan's body once
    sums = got["all-reduce/model"]
    assert sums["bytes"] == slots * want["all-reduce/model"]["bytes"] > 0
    assert sums["count"] == 2 * slots and want["all-reduce/model"]["count"] == 1  # XLA's combiner merges two
    if case == "eval_step_v2_twophase":  # the top-k values and ids of each shard
        gathers, jax_gathers = got["all-gather/model"], want["all-gather/model"]
        assert gathers["count"] == jax_gathers["count"] == 2
        assert 2 * gathers["bytes"] == 3 * jax_gathers["bytes"]  # float32 values beside int64 ids, not int32
    if slots > 1:
        assert port["steps"][case]["per_step_bytes"] == port["steps"]["sparse_train_step"]["total_bytes"]
        assert jax_out["steps"][case]["per_step_bytes"] * MAIN_CHAIN == jax_out["steps"][case]["total_bytes"]
