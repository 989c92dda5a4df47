"""The temporal 70/15/15 split with blackout windows (stage 03 of the data pipeline).

    python3 -m gat_recommendation_torch.scripts.data.temporal_split [--input-file ...] ...

The port of ``scripts/data/03_temporal_split.py``: the same flags, defaults
and files (train/val/test.csv and split_info.json, which carries
``num_items``), without pandas; it warns, as that script does, where the
splits overlap in time.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gat_recommendation_torch.data.csv_io import read_csv, write_csv
from gat_recommendation_torch.data.splits import create_temporal_splits
from gat_recommendation_torch.utils.logging import get_logger


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Create temporal splits")
    p.add_argument("--input-file", type=str, default="data/interim/sessions.csv")
    p.add_argument("--output-dir", type=str, default="data/processed")
    p.add_argument("--train-ratio", type=float, default=0.70)
    p.add_argument("--val-ratio", type=float, default=0.15)
    p.add_argument("--test-ratio", type=float, default=0.15)
    p.add_argument("--blackout-days", type=int, default=2)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    sessions = read_csv(args.input_file)
    train, val, test, info = create_temporal_splits(
        sessions, train_ratio=args.train_ratio, val_ratio=args.val_ratio,
        test_ratio=args.test_ratio, blackout_days=args.blackout_days,
    )
    out_dir = Path(args.output_dir)
    for name, part in (("train", train), ("val", val), ("test", test)):
        write_csv(part, out_dir / f"{name}.csv")
    with open(out_dir / "split_info.json", "w") as f:
        json.dump(info, f, indent=2)

    logger.info(
        f"train/val/test sessions: {info['train_sessions']:,}/{info['val_sessions']:,}/"
        f"{info['test_sessions']:,} (blackouts dropped: "
        f"{info['blackout_1_sessions'] + info['blackout_2_sessions']:,}); num_items={info['num_items']:,}"
    )
    for (a, x), (b, y) in ((("train", train), ("val", val)), (("val", val), ("test", test))):
        if len(x["timestamp"]) and len(y["timestamp"]) and x["timestamp"].max() >= y["timestamp"].min():
            logger.warning(f"Potential temporal leakage: {a} overlaps {b}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
