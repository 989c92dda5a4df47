"""Cross-cutting utilities: seeding, JSON and config IO, logging, timers and
roofline accounting (the JAX package's ``utils`` without its XLA cache)."""
