"""The port's command-line entry points, laid out as the repo's ``scripts/``
(``python3 -m gat_recommendation_torch.scripts.<path>``)."""
