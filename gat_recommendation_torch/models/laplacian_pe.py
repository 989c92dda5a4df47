"""Laplacian positional encodings: a host-side eigensolve with numpy and scipy.

The k smallest non-trivial eigenvectors of the symmetric-normalized Laplacian
of the item co-occurrence graph, in absolute value (sign invariance), one row
per item id; the Graph Transformer projects a node's row and adds it to the
node's embedding (``GraphTransformer.precompute_pe`` fills its
``cached_pe`` buffer once). The same function as the JAX package's module,
so both return the same array:

- the adjacency is symmetrized and made binary first (the co-occurrence
  graph is undirected; its edge list is canonical (min, max) pairs);
- the eigensolve runs on the connected subgraph only, and ids without an
  edge get zero rows (over the full id space most ids are isolated, and the
  null space would have no meaningful basis);
- small graphs (n < 64, or asking for every eigenvector) go through a dense
  ``numpy.linalg.eigh``; larger ones through Lanczos on the spectral
  complement 2I - L, whose largest eigenpairs are L's smallest, with a fixed
  starting vector, so the result is deterministic.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def compute_laplacian_pe(
    item_i: np.ndarray,
    item_j: np.ndarray,
    num_nodes: int,
    k: int = 16,
    normalization: str = "sym",
) -> np.ndarray:
    """Return the PE matrix [num_nodes, k] (float32); rows of isolated ids are zero."""
    src = np.asarray(item_i, dtype=np.int64)
    dst = np.asarray(item_j, dtype=np.int64)

    # Undirected binary adjacency (symmetrized, self-loops kept once).
    data = np.ones(len(src), dtype=np.float64)
    A = sp.coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes)).tocsr()
    A = A.maximum(A.T)
    A.data[:] = 1.0

    deg_full = np.asarray(A.sum(axis=1)).ravel()
    connected = np.flatnonzero(deg_full > 0)
    n = len(connected)
    out = np.zeros((num_nodes, k), dtype=np.float32)
    if n == 0:
        return out

    Ac = A[connected][:, connected]
    deg = np.asarray(Ac.sum(axis=1)).ravel()

    if normalization == "sym":
        dinv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        D = sp.diags(dinv_sqrt)
        L = sp.identity(n) - D @ Ac @ D
    elif normalization == "rw":
        dinv = 1.0 / np.maximum(deg, 1e-12)
        L = sp.identity(n) - sp.diags(dinv) @ Ac
    else:
        raise ValueError(f"Unknown normalization: {normalization}")

    want = min(k + 1, n)
    vecs = _smallest_eigenvectors(L.tocsc(), want, n)

    # Drop the trivial eigenvector; abs() for sign invariance.
    pe = np.abs(vecs[:, 1 : k + 1]).astype(np.float32)
    out[connected, : pe.shape[1]] = pe
    return out


def _smallest_eigenvectors(L: sp.spmatrix, want: int, n: int) -> np.ndarray:
    """Eigenvectors of the `want` smallest eigenvalues, in ascending order.

    The normalized Laplacian's spectrum lies in [0, 2], so L's smallest
    eigenpairs are the largest of C = 2I - L, and ``eigsh(C, which='LA')``
    needs only sparse products. Shift-invert, the usual route to the
    smallest eigenpairs, factorizes L + |sigma| I, and the factor of an
    expander-like co-occurrence graph fills in densely. ``v0`` is fixed:
    abs() downstream absorbs sign flips, but not a rotation of the basis of
    a repeated eigenvalue (a graph of several components). If ARPACK fails,
    the smallest-magnitude mode, then a dense solve.
    """
    if want >= n or n < 64:
        vals, vecs = np.linalg.eigh(L.toarray())
        return vecs[:, :want]
    C = (2.0 * sp.identity(n, format="csr") - L).tocsr()
    v0 = np.random.default_rng(0).standard_normal(n)
    try:
        vals, vecs = spla.eigsh(C, k=want, which="LA", tol=1e-7, v0=v0)
        vals = 2.0 - vals
    except (spla.ArpackNoConvergence, spla.ArpackError):
        try:
            vals, vecs = spla.eigsh(L, k=want, which="SM", v0=v0)
        except (spla.ArpackNoConvergence, spla.ArpackError):
            vals, vecs = np.linalg.eigh(L.toarray())
            vals, vecs = vals[:want], vecs[:, :want]
    order = np.argsort(vals)
    return vecs[:, order]
