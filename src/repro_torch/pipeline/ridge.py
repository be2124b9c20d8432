"""Ridge readout from Gram statistics with GCV λ selection.

Port of the materialized part of ``repro/pipeline/ridge.py``.  The readout
solves (G + λ'·I)w = c with G = XᵀX, c = Xᵀy and λ' = λ·tr(G)/F, choosing λ
by generalised cross-validation

    GCV(λ) = T·‖y − ŷ_λ‖² / (T − dof(λ))²,   dof(λ) = Σ λᵢ/(λᵢ + λ')

from the eigendecomposition G = QΛQᵀ (``solve_gcv``) or from the SVD of X
(``solve_gcv_svd``, the default: its conditioning is √cond(G)).  The JAX
reference vmaps single-instance solves; here every solve takes leading
batch dimensions, so B instances are one batched ``eigh``/``svd`` call.

``fit_ridge_batched(use_kernel=True)`` accumulates the Gram of all B
instances with ONE launch of the CUDA Gram kernel (kernels/ridge_gram),
then solves in f32 with ``torch.linalg.eigh``.  The streaming fits
(``fit_ridge_streaming*``) are ROADMAP Queue 1 items 5, 6 and 10.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .stages import stage


def with_bias(states: torch.Tensor) -> torch.Tensor:
    """Append the constant-1 bias feature: [..., T, N] -> [..., T, N + 1]."""
    ones = torch.ones((*states.shape[:-1], 1), dtype=states.dtype, device=states.device)
    return torch.cat([states, ones], dim=-1)


def gram(x: torch.Tensor, y: torch.Tensor, *, use_kernel: bool = False):
    """(G = XᵀX [F, F], c = Xᵀy [F, C]) in f32 from X [T, F], y [T, C].

    ``use_kernel=True`` goes through the Gram op (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors); else two matmuls.
    """
    if use_kernel:
        from ..kernels.ridge_gram import ops as gram_ops

        return gram_ops.gram_accumulate(x, y)
    from ..kernels.ridge_gram.ref import gram_ref

    return gram_ref(x, y)


def _pick(ws: torch.Tensor, gcvs: torch.Tensor):
    """Per instance, the weights [..., F, C] of the λ with the least GCV."""
    idx = torch.argmin(gcvs, dim=-1)                        # [...]
    w = torch.take_along_dim(ws, idx[..., None, None, None], dim=-3).squeeze(-3)
    return w, idx


def _weights(basis: torch.Tensor, proj: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """basis [..., F, R] @ (proj [..., R, C] scaled by coef [..., L, R]) for
    every λ at once -> [..., L, F, C], as one batched matmul."""
    *lead, r, cols = proj.shape
    n_lam = coef.shape[-2]
    scaled = proj[..., :, None, :] * coef.mT[..., :, :, None]   # [..., R, L, C]
    w = basis @ scaled.reshape(*lead, r, n_lam * cols)
    return w.reshape(*lead, basis.shape[-2], n_lam, cols).movedim(-2, -3)


def solve_gcv(g: torch.Tensor, c: torch.Tensor, y2: torch.Tensor, n_samples: int,
              lambdas: tuple[float, ...]):
    """Ridge solve (G + λ·tr(G)/F·I)w = c with GCV-selected λ.

    ``g`` [..., F, F], ``c`` [..., F, C], ``y2`` [...] (‖y‖²).  Returns
    (w [..., F, C], lam_idx [...]) — ``lam_idx`` indexes ``lambdas``.
    """
    f = g.shape[-1]
    evals, q = torch.linalg.eigh(g.to(torch.float32))     # ascending
    evals = torch.clamp(evals, min=0.0)                   # f32 round-off negatives
    qc = q.mT @ c.to(torch.float32)                       # [..., F, C]
    # Rank truncation at 4·eps·λmax, calibrated on NARMA10 in the reference
    # (ridge.py there): below it, eigenvalues are f32 noise, not signal.
    tol = evals[..., -1:] * (4 * torch.finfo(torch.float32).eps)
    valid = evals > tol                                   # [..., F]
    qc = torch.where(valid[..., None], qc, 0.0)
    qc2 = torch.sum(qc * qc, dim=-1)                      # [..., F]
    lams = torch.tensor(lambdas, dtype=torch.float32, device=g.device)
    lamp = lams * (torch.sum(evals, dim=-1, keepdim=True) / f)        # [..., L]
    ev = evals[..., None, :]                              # [..., 1, F]
    ok = valid[..., None, :]
    inv = torch.where(ok, 1.0 / (ev + lamp[..., :, None]), 0.0)      # [..., L, F]
    ws = _weights(q, qc, inv)
    dof = torch.sum(ev * inv, dim=-1)                     # [..., L]
    # ‖y − ŷ‖² in the eigenbasis: the naive y2 − 2cᵀw + wᵀGw cancels
    # catastrophically in f32 once cond(G) nears 1/eps.
    fit_energy = torch.sum(
        qc2[..., None, :] * torch.where(ok, (ev + 2.0 * lamp[..., :, None]) * inv * inv, 0.0),
        dim=-1)
    rss = torch.clamp(torch.as_tensor(y2, device=g.device)[..., None] - fit_energy, min=0.0)
    gcv = n_samples * rss / torch.clamp(n_samples - dof, min=1.0) ** 2
    return _pick(ws, gcv)


def solve_gcv_svd(x: torch.Tensor, y: torch.Tensor, lambdas: tuple[float, ...]):
    """GCV ridge from the SVD of X [..., T, F] with y [..., T, C].

    The default solve: it works on X, so its conditioning is √cond(G).
    Returns (w [..., F, C], lam_idx [...]).
    """
    x32 = x.to(torch.float32)
    y32 = y.to(torch.float32)
    u, s, vt = torch.linalg.svd(x32, full_matrices=False)
    uty = u.mT @ y32                                      # [..., R, C]
    uy2 = torch.sum(uty * uty, dim=-1)                    # [..., R]
    y2 = torch.sum(y32 * y32, dim=(-2, -1))
    s2 = s * s
    n_samples = x.shape[-2]
    lams = torch.tensor(lambdas, dtype=torch.float32, device=x.device)
    lamp = lams * (torch.sum(s2, dim=-1, keepdim=True) / x.shape[-1])   # [..., L]
    denom = s2[..., None, :] + lamp[..., :, None]         # [..., L, R]
    shrink = s2[..., None, :] / denom
    ws = _weights(vt.mT, uty, s[..., None, :] / denom)
    dof = torch.sum(shrink, dim=-1)
    rss = torch.clamp(
        y2[..., None] - torch.sum((2.0 * shrink - shrink * shrink) * uy2[..., None, :], dim=-1),
        min=0.0)
    gcv = n_samples * rss / torch.clamp(n_samples - dof, min=1.0) ** 2
    return _pick(ws, gcv)


def fit_ridge(states, targets, *, lambdas: tuple[float, ...] = (1e-6,),
              use_kernel: bool = False, device=None):
    """One-shot readout fit: states [T, N] -> (w [N + 1, C], lam_idx).

    Default: the SVD-of-X solve.  ``use_kernel=True``: the Gram op + eigh.
    Runs on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    states = torch.as_tensor(states, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    y = targets[:, None] if targets.ndim == 1 else targets
    x = with_bias(states)
    if use_kernel:
        g, c = gram(x, y.to(x.dtype), use_kernel=True)
        y2 = torch.sum(y.to(torch.float32) ** 2)
        return solve_gcv(g, c, y2, x.shape[0], tuple(lambdas))
    return solve_gcv_svd(x, y, tuple(lambdas))


def fit_ridge_batched(states, targets, *, lambdas: tuple[float, ...] = (1e-6,),
                      use_kernel: bool = False, block_t: int = 512, device=None):
    """Batched fit: states [B, T, N] -> (w [B, N + 1, C], lam_idx [B]).

    ``use_kernel=True`` runs ONE Gram launch over the whole instance stack
    and one batched eigh/GCV solve; ``block_t`` is the fold tile of the
    Gram's plain version (kernels/ridge_gram/ops.py).  Runs on ``device``
    (default ``cuda``).
    """
    dev = resolve_device(device)
    states = torch.as_tensor(states, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    y = targets[..., None] if targets.ndim == 2 else targets
    with stage("bias", dev):
        x = with_bias(states)
    if use_kernel:
        from ..kernels.ridge_gram import ops as gram_ops

        with stage("gram", dev):
            g, c = gram_ops.gram_accumulate_batched(x, y.to(x.dtype), block_t=block_t)
        with stage("solve", dev):
            y32 = y.to(torch.float32)
            y2 = torch.sum(y32 * y32, dim=(1, 2))
            return solve_gcv(g, c, y2, x.shape[1], tuple(lambdas))
    with stage("solve", dev):
        return solve_gcv_svd(x, y, tuple(lambdas))


def guard_readout(w_new: torch.Tensor, idx_new: torch.Tensor,
                  w_last: torch.Tensor, idx_last: torch.Tensor):
    """Last-good-readout fallback for batched solves: rows of ``w_new``
    [B, F, C] with any non-finite weight keep (``w_last``, ``idx_last``);
    finite rows pass through bitwise unchanged."""
    ok = torch.all(torch.isfinite(w_new.reshape(w_new.shape[0], -1)), dim=1)
    w = torch.where(ok[:, None, None], w_new, w_last)
    idx = torch.where(ok, idx_new.to(idx_last.dtype), idx_last)
    return w, idx


def apply_readout(states: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = [states, 1] @ w; squeezes a single output channel."""
    y = with_bias(states) @ w
    return y[..., 0] if y.shape[-1] == 1 else y
