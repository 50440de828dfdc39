"""Row-wise vector math on (..., 3) ray bundles (torch tensors).

Counterpart of ``optrace_tpu/ops/vector.py``.
"""

import torch


def rdot(a, b, dim: int = -1):
    """Row-wise dot product of vector bundles."""
    return torch.sum(a * b, dim=dim)


def cross(a, b):
    """Row-wise cross product for (..., 3) bundles."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(a, dim: int = -1):
    """Euclidean norm along ``dim``."""
    return torch.sqrt(torch.sum(a * a, dim=dim))


def normalize(a, dim: int = -1):
    """Normalize vector bundles; zero-length rows produce nan."""
    return a / norm(a, dim=dim).unsqueeze(dim)


def normalize_safe(a, dim: int = -1, fallback: float = 0.0):
    """Normalize, mapping zero-length rows to ``fallback`` instead of nan.
    Gradient-safe: the sqrt argument is pushed away from 0 first."""
    n2 = torch.sum(a * a, dim=dim)
    ok = n2 > 0
    n = torch.sqrt(torch.where(ok, n2, 1.0))
    out = a / n.unsqueeze(dim)
    return torch.where(ok.unsqueeze(dim), out, fallback)


def masked_assign(where, a, b):
    """Returns ``a`` with ``b`` where ``where`` is True."""
    while where.ndim < a.ndim:
        where = where.unsqueeze(-1)
    return torch.where(where, b, a)
