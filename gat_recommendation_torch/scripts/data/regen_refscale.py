"""Regenerate the reference-scale corpus from its manifest, without pandas.

    python3 -m gat_recommendation_torch.scripts.data.regen_refscale [--check] [--force]

``data_refscale/MANIFEST.json`` records the generator parameters of corpus v3
and the sha256 of every derived file. This rebuilds them with the port's
pipeline (the structured generator, sessionize, the temporal split, the
co-occurrence graph with window 5) and the stage boundaries of the JAX
package's script pipeline, each a CSV written and read back
(``data/csv_io.roundtrip``): a CSV round trip is not the identity on dtypes
(``transactionid`` comes back float64 and is written as ``11533.0``), so the
bytes depend on replaying each one. ``--check`` verifies every listed sha256
and exits 1 on drift; ``--data-dir`` writes elsewhere than the repo's
``data_refscale/``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

from gat_recommendation_torch.data import csv_io
from gat_recommendation_torch.data.graph import build_co_event_graph, save_edges
from gat_recommendation_torch.data.sessionize import sessionize_events
from gat_recommendation_torch.data.splits import create_temporal_splits
from gat_recommendation_torch.data.synthetic import generate_structured_events

DATA_DIR = Path(__file__).resolve().parents[3] / "data_refscale"
MANIFEST = DATA_DIR / "MANIFEST.json"


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def generate(params: dict, out_dir: Path) -> dict:
    """Write ``processed/`` (the split CSVs, ``split_info.json``, the graph's
    CSV, npz and stats) under `out_dir`; return the seconds of each stage."""
    out_dir = Path(out_dir)
    seconds = {}
    t0 = time.perf_counter()
    events = csv_io.roundtrip(generate_structured_events(**params))
    seconds["generate"] = time.perf_counter() - t0
    print(f"[{seconds['generate']:.1f}s] generated {len(events['itemid'])} events", flush=True)

    t = time.perf_counter()
    sessions = csv_io.roundtrip(sessionize_events(events))
    seconds["sessionize"] = time.perf_counter() - t

    t = time.perf_counter()
    (out_dir / "interim").mkdir(parents=True, exist_ok=True)
    processed = out_dir / "processed"
    processed.mkdir(parents=True, exist_ok=True)
    train, val, test, info = create_temporal_splits(sessions)
    for name, part in (("train", train), ("val", val), ("test", test)):
        csv_io.write_csv(part, processed / f"{name}.csv")
    (processed / "split_info.json").write_text(json.dumps(info, indent=2))
    seconds["split"] = time.perf_counter() - t
    print(f"[{time.perf_counter() - t0:.1f}s] splits written", flush=True)

    # The graph stage reads train.csv from disk: that boundary too.
    t = time.perf_counter()
    edges, stats = build_co_event_graph(csv_io.read_csv(processed / "train.csv"))
    out = processed / "graph_edges.csv"
    save_edges(edges, out, out.with_suffix(".npz"))
    with open(processed / "graph_stats.json", "w") as f:
        json.dump(stats, f, indent=2)
    seconds["graph"] = time.perf_counter() - t
    print(f"[{time.perf_counter() - t0:.1f}s] graph built ({stats['num_edges']} edges)", flush=True)
    return seconds


def check(manifest: dict, data_dir: Path) -> list[tuple[str, str, str]]:
    """(file, manifest sha256, file's sha256) of every listed file that differs."""
    bad = []
    for f, want in manifest["files"].items():
        got = sha256(data_dir / f) if (data_dir / f).exists() else "missing"
        if got != want:
            bad.append((f, want, got))
    return bad


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true", help="verify sha256s")
    p.add_argument("--force", action="store_true", help="regenerate even if present")
    p.add_argument("--data-dir", type=str, default=str(DATA_DIR),
                   help="where processed/ is written (default: the repo's data_refscale/)")
    args = p.parse_args(argv)

    manifest = json.loads(MANIFEST.read_text())
    data_dir = Path(args.data_dir)
    missing = [f for f in manifest["files"] if not (data_dir / f).exists()]
    if missing or args.force:
        print(f"regenerating (missing: {missing or 'forced'})")
        generate(manifest["generator_params"], data_dir)
    else:
        print("all files present, skipping generation")

    if args.check:
        bad = check(manifest, data_dir)
        for f, want, got in bad:
            print(f"DRIFT {f}: manifest {want[:12]}.. got {got[:12]}..")
        if bad:
            return 1
        print(f"{len(manifest['files'])} files verified against manifest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
