"""Convert YooChoose (RecSys Challenge 2015) clicks and buys to the events schema.

    python3 -m gat_recommendation_torch.scripts.data.convert_yoochoose \\
        --clicks-file yoochoose-clicks.dat [--buys-file yoochoose-buys.dat] [--output-file data/raw/events.csv]

The port of ``scripts/data/01b_convert_yoochoose.py``, without pandas: the
same flags and the same ``events.csv`` bytes, which ``scripts.data.sessionize``
reads. Each click is a ``view`` and each buy a ``transaction``; the clicks
come first, then the buys, sorted by time with a stable sort. Times are
ISO-8601 in UTC (``2014-04-07T10:51:09.277Z``), written as epoch
milliseconds, floored where a time has finer digits. A YooChoose session
becomes the visitor ``yc_<session>`` (sessionization derives the sessions
again with its 30-minute rule), and ``transactionid`` is empty for a view and
the session id for a buy.

The JAX script takes the milliseconds as pandas' datetime integers
floor-divided by 10^6, which are nanoseconds where pandas parses to
nanoseconds (pandas 2); pandas 3 parses these strings to microseconds, and
the same expression then gives seconds. The port writes milliseconds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from gat_recommendation_torch.data.csv_io import read_csv, write_csv
from gat_recommendation_torch.utils.logging import get_logger

CLICK_COLS = ["session", "ts", "itemid", "category"]
BUY_COLS = ["session", "ts", "itemid", "price", "quantity"]


def epoch_ms(times: np.ndarray) -> np.ndarray:
    """ISO-8601 UTC times (``Z`` or no zone) as int64 epoch milliseconds,
    floored (numpy parses to nanoseconds; an offset other than Z raises)."""
    text = np.char.strip(np.asarray(times, dtype=str))
    text = np.where(np.char.endswith(text, "Z"), np.char.replace(text, "Z", ""), text)
    return text.astype("datetime64[ns]").astype(np.int64) // 1_000_000


def convert(clicks_path: Path, buys_path: Path | None) -> dict:
    """The events' columns (timestamp, visitorid, event, itemid, transactionid)."""
    frames = [(read_csv(clicks_path, names=CLICK_COLS), "view")]
    if buys_path is not None and buys_path.exists():
        frames.append((read_csv(buys_path, names=BUY_COLS), "transaction"))
    session = np.concatenate([f["session"] for f, _ in frames])
    ts = np.concatenate([f["ts"] for f, _ in frames])
    itemid = np.concatenate([f["itemid"] for f, _ in frames])
    event = np.concatenate([np.full(len(f["session"]), name) for f, name in frames])

    timestamp = epoch_ms(ts)
    order = np.argsort(timestamp, kind="stable")
    session_text = session.astype(str)
    transaction = np.where(event == "transaction", session_text, "").astype(object)
    transaction[event != "transaction"] = None
    return {
        "timestamp": timestamp[order],
        "visitorid": np.char.add("yc_", session_text)[order],
        "event": event[order],
        "itemid": itemid[order],
        "transactionid": transaction[order],
    }


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="YooChoose -> events schema")
    p.add_argument("--clicks-file", type=str, required=True)
    p.add_argument("--buys-file", type=str, default=None)
    p.add_argument("--output-file", type=str, default="data/raw/events.csv")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    out = Path(args.output_file)
    events = convert(Path(args.clicks_file), Path(args.buys_file) if args.buys_file else None)
    write_csv(events, out)
    logger.info(f"Wrote {len(events['timestamp']):,} events -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
