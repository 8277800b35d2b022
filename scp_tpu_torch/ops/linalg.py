"""Plain PyTorch versions of the batched dense linear algebra of the IPM
(counterpart of ``scp_tpu/ops/linalg.py`` and of the semantics of
``scp_tpu/ops/pallas_linalg.py``'s ``cholesky_lane`` / ``cho_solve_lane`` /
``gmv_lane`` / ``gtmv_lane``).

Instance-major tensors with a leading batch axis, float32 or float64, any
device. These are the oracles the CUDA kernels of ``ops/linalg_kernel.py``
are held against and what the wrappers there run for CPU tensors. The
blocked / masked factorizations of ``scp_tpu/ops/linalg.py`` are remedies
for one compiler's lowering and have no counterpart here.
"""
from __future__ import annotations

import torch


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of ``K (B, n, n)``; the upper triangle is zero.

    A matrix that is not positive definite gives an all-NaN factor for that
    instance only (never an exception), so that the callers' finite checks
    freeze the instance."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cho_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` for ``L (B, n, n)`` lower, ``b (B, n)``. Only
    the lower triangle of ``L`` is read."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def gmv_plain(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[b] = G_b @ x_b`` for ``G (B, m, n)``, ``x (B, n)``."""
    return torch.bmm(G, x[..., None])[..., 0]


def gtmv_plain(G: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[b] = G_b^T @ v_b`` for ``G (B, m, n)``, ``v (B, m)``."""
    return torch.bmm(v[:, None, :], G)[:, 0, :]
