"""Serving: request validation, the Recommender and the HTTP app."""
