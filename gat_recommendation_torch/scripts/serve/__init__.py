"""The dev server and the Vertex-style server: the mean-embedding
approximation of a session, not the GNN (that is ``serving/app.py``)."""
