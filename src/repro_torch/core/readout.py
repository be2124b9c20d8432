"""Linear readout training (paper Section III.A.3, Eq. (3)).

Port of ``repro/core/readout.py``: the host-side float64 trainer.  Only
W_out is trained.  ``method="pinv"`` is the paper's Moore–Penrose solve;
``method="ridge"`` (default) solves (G + λ·tr(G)/n·I)w = c, with λ chosen
by generalised cross-validation when a tuple of λs is given.
``use_kernel=True`` accumulates G and c with the port's Gram op
(``kernels/ridge_gram``: the CUDA kernel for CUDA states, its plain version
for CPU states) and solves on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Readout:
    """Trained readout: y = [states, 1] @ w  (bias folded as last row)."""

    w: torch.Tensor  # [N + 1, C]

    def __call__(self, states: torch.Tensor) -> torch.Tensor:
        y = _with_bias(states) @ self.w
        return y[..., 0] if y.shape[-1] == 1 else y


def _with_bias(states: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((*states.shape[:-1], 1), dtype=states.dtype, device=states.device)
    return torch.cat([states, ones], dim=-1)


def _canon_targets(targets) -> np.ndarray:
    if isinstance(targets, torch.Tensor):
        targets = targets.detach().cpu().numpy()
    t = np.asarray(targets, dtype=np.float64)
    return t[:, None] if t.ndim == 1 else t


def fit_readout(
    states: torch.Tensor,
    targets,
    *,
    l2: float | tuple = 1e-6,
    method: str = "ridge",
    use_kernel: bool = False,
) -> Readout:
    """Solve for W_out from states [T, N] and targets [T] or [T, C].

    The weights come back in the states' dtype, on the states' device.
    """
    t = _canon_targets(targets)
    if states.ndim != 2 or states.shape[0] != t.shape[0]:
        raise ValueError(f"states {tuple(states.shape)} vs targets {t.shape}")

    def as_w(w):
        return Readout(w=torch.as_tensor(w, dtype=states.dtype, device=states.device))

    x = _with_bias(states).detach().cpu().numpy().astype(np.float64)
    if method == "pinv":
        return as_w(np.linalg.pinv(x) @ t)
    if method != "ridge":
        raise ValueError(f"unknown method {method!r}")

    if use_kernel:
        from ..kernels.ridge_gram import ops as gram_ops

        g, c = gram_ops.gram_accumulate(
            _with_bias(states), torch.as_tensor(t, dtype=states.dtype, device=states.device))
        g = g.cpu().numpy().astype(np.float64)
        c = c.cpu().numpy().astype(np.float64)
    else:
        g = x.T @ x
        c = x.T @ t

    n = g.shape[0]
    eye = np.eye(n)

    def solve(lam):
        return np.linalg.solve(g + lam * np.trace(g) / n * eye, c)

    if not isinstance(l2, (tuple, list)):
        return as_w(solve(l2))

    # λ by generalised cross-validation (a held-out tail of one Markov
    # trajectory does not work; see the reference module):
    #     GCV(λ) = T·‖y − ŷ_λ‖² / (T − dof(λ))²,  dof = Σ s²/(s² + λ')
    u, s, _vt = np.linalg.svd(x, full_matrices=False)
    uty = u.T @ t
    uy2 = np.sum(uty * uty, axis=1)
    t_norm2 = float(np.sum(t * t))
    big_t = x.shape[0]
    best, best_gcv = None, np.inf
    for lam in l2:
        lamp = lam * np.trace(g) / n
        shrink = (s * s) / (s * s + lamp)
        dof = float(np.sum(shrink))
        rss = t_norm2 - float(np.sum((2.0 * shrink - shrink**2) * uy2))
        gcv = big_t * max(rss, 0.0) / max(big_t - dof, 1.0) ** 2
        if gcv < best_gcv:
            best, best_gcv = lam, gcv
    return as_w(solve(best))
