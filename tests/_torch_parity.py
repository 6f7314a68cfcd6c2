"""Helpers shared by the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays; only numpy crosses between JAX and torch.
"""
import numpy as np
import torch


def T(x, dtype=None):
    """numpy -> CPU torch tensor."""
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def N(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_np(tree):
    """NamedTuple/tuple of arrays -> same structure of numpy arrays."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_np(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_np(v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return N(tree) if hasattr(tree, "shape") else tree


def random_rotations(rng, n, scale=1.0):
    """(n, 3) rotation vectors with angles up to ~scale*pi."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return (w * rng.uniform(0, scale * np.pi, size=(n, 1))).astype(np.float32)
