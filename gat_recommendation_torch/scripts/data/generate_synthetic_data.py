"""Generate synthetic RetailRocket-like events (stage 00 of the data pipeline).

    python3 -m gat_recommendation_torch.scripts.data.generate_synthetic_data [--structured] ...

The port of ``scripts/data/00_generate_synthetic_data.py``: the same flags
and defaults, the same events file (``data/synthetic.py``, written by
``data/csv_io.py``). ``--structured`` switches to the discriminative corpus
(random walks on a hidden clustered Markov item graph).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from gat_recommendation_torch.data.csv_io import write_csv
from gat_recommendation_torch.data.synthetic import generate_structured_events, generate_synthetic_events
from gat_recommendation_torch.utils.logging import get_logger


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate synthetic event data")
    p.add_argument("--output-file", type=str, default="data/raw/events.csv")
    p.add_argument("--num-sessions", type=int, default=20_000)
    p.add_argument("--num-items", type=int, default=5_000)
    p.add_argument("--mean-session-length", type=int, default=8)
    p.add_argument("--zipf-exponent", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--structured", action="store_true",
                   help="discriminative corpus: latent clustered-Markov item graph, "
                        "sessions = random walks + distractor noise")
    p.add_argument("--num-active", type=int, default=None,
                   help="(structured) live-item count inside the id space (default num_items // 6)")
    p.add_argument("--num-clusters", type=int, default=None,
                   help="(structured) latent interest clusters (default num_active // 100)")
    p.add_argument("--noise-prob", type=float, default=0.15, help="(structured) distractor probability")
    p.add_argument("--repeat-prob", type=float, default=0.25, help="(structured) walk revisit probability")
    p.add_argument("--successors-per-item", type=int, default=8,
                   help="(structured) out-degree of the latent Markov chain")
    p.add_argument("--cross-cluster-successors", type=int, default=2,
                   help="(structured) successors into the linked clusters")
    p.add_argument("--dirichlet-alpha", type=float, default=0.4,
                   help="(structured) transition-weight concentration (lower = sharper)")
    p.add_argument("--pop-exponent", type=float, default=1.05,
                   help="(structured) start/distractor popularity Zipf")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    if args.structured:
        events = generate_structured_events(
            num_sessions=args.num_sessions, num_items=args.num_items, seed=args.seed,
            num_active=args.num_active, num_clusters=args.num_clusters, noise_prob=args.noise_prob,
            repeat_prob=args.repeat_prob, successors_per_item=args.successors_per_item,
            cross_cluster_successors=args.cross_cluster_successors,
            dirichlet_alpha=args.dirichlet_alpha, pop_exponent=args.pop_exponent,
            mean_session_length=args.mean_session_length,
        )
    else:
        events = generate_synthetic_events(
            num_sessions=args.num_sessions, num_items=args.num_items, seed=args.seed,
            mean_session_length=args.mean_session_length, zipf_exponent=args.zipf_exponent,
        )
    out = Path(args.output_file)
    write_csv(events, out)
    logger.info(f"Wrote {len(events['itemid']):,} events ({args.num_sessions:,} sessions, "
                f"{args.num_items:,} items) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
