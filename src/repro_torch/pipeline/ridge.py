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
then solves in f32 with ``torch.linalg.eigh``.

The streaming fits (``fit_ridge_streaming``, ``fit_ridge_streaming_wdm``,
``fit_ridge_streaming_shared``; DESIGN.md §8/§9) never hold the [B, K, N]
state tensor: a Python loop over K-chunks runs the reservoir for one chunk
(resuming bit-exactly from the carried f32 state), masks washout and
padding rows to zero, appends the bias column and folds the chunk into
running per-instance f32 stacks G [B, F, F] and c [B, F, C] — in place,
through the accumulate-into Gram kernel (``use_kernel=True``) or a plain
matmul.  The reference's ``lax.scan`` becomes that loop: chunk offsets are
host ints, and the loop reads nothing back from the device.  Composed
topologies (``fit_ridge_streaming_composed``) are ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.reservoir import generate_channel_states, generate_states
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
    return _pick(*gcv_path(g, c, y2, n_samples, lambdas))


def gcv_path(g: torch.Tensor, c: torch.Tensor, y2: torch.Tensor, n_samples: int,
             lambdas: tuple[float, ...]):
    """The weights [..., L, F, C] and GCV scores [..., L] of every λ, from
    which ``solve_gcv`` picks the least score."""
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
    return ws, gcv


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


def _chunk_layout(k_total: int, chunk_k: int) -> int:
    """The number of ``chunk_k``-period chunks that cover a K-long stream
    (the last one ragged when chunk_k does not divide K)."""
    if chunk_k < 1:
        raise ValueError(f"chunk_k must be >= 1, got {chunk_k}")
    return -(-k_total // chunk_k)


def _chunk_axis(x: torch.Tensor, chunk_k: int):
    """The chunks [B, chunk_k, ...] of x [B, K, ...], in order; the last is
    zero-padded to ``chunk_k``.  Only the padded last chunk is a copy: no
    padded copy of the whole stream is made."""
    for i in range(_chunk_layout(x.shape[1], chunk_k)):
        x_c = x[:, i * chunk_k:(i + 1) * chunk_k]
        short = chunk_k - x_c.shape[1]
        if short:
            pad = torch.zeros((x.shape[0], short, *x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            x_c = torch.cat([x_c, pad], dim=1)
        yield x_c


def _canon_stream(j, targets, device):
    """Canonicalise a (j, targets) stream pair to f32 ([B, K], [B, K, C])."""
    j = torch.as_tensor(j, device=device).to(torch.float32)
    if j.ndim == 1:
        j = j[None, :]
    y = torch.as_tensor(targets, device=device).to(torch.float32)
    if y.ndim == 1:
        y = y[None, :]
    if y.ndim == 2:
        y = y[..., None]
    if tuple(y.shape[:2]) != tuple(j.shape[:2]):
        raise ValueError(f"targets {tuple(y.shape)} do not match inputs {tuple(j.shape)}")
    return j, y


@dataclasses.dataclass(frozen=True)
class _FoldPlan:
    """Layout and op of one chunk -> Gram fold, decided once, before the
    first chunk, for the streaming fits and the online sessions.

    The carried stacks are exactly [B, F, F] and [B, F, C]: the CUDA Gram
    kernel masks ragged edges itself, so neither F nor the chunk is padded
    (the reference pads both to its TPU tiles).  ``use_kernel`` selects the
    fold op: the accumulate-into Gram op (K3 on CUDA tensors) or a plain
    matmul.  ``block_t`` is the fold tile of the Gram's plain version (CPU
    tensors).
    """

    f: int            # features = N + 1 (bias folded)
    chunk_k: int      # periods per chunk
    use_kernel: bool  # accumulate-into Gram op, else a plain matmul
    block_t: int


def _plan_fold(f: int, chunk_k: int, *, use_kernel: bool, block_t: int,
               n_cols: int = 1, batch: int | None = None) -> _FoldPlan:
    """The fold layout for (F, chunk) under the chosen op.

    With ``use_kernel`` the fold is K3's, so a stack it cannot take raises
    ValueError here, before any chunk runs: more than ``C_MAX`` target
    columns (``n_cols``) or more than ``MAX_INSTANCES`` instances
    (``batch``; None when not known yet).
    """
    if chunk_k < 1:
        raise ValueError(f"chunk_k must be >= 1, got {chunk_k}")
    if isinstance(block_t, bool) or not isinstance(block_t, int) or block_t < 1:
        raise ValueError(f"block_t must be a positive int, got {block_t!r}")
    if use_kernel:
        from ..kernels.ridge_gram.ops import C_MAX, MAX_INSTANCES

        if not 1 <= n_cols <= C_MAX:
            raise ValueError(f"the accumulate-into Gram fold takes 1..{C_MAX} target "
                             f"columns, got {n_cols}")
        if batch is not None and batch > MAX_INSTANCES:
            raise ValueError(f"the accumulate-into Gram fold takes at most "
                             f"{MAX_INSTANCES} instances, got {batch}")
    return _FoldPlan(f=f, chunk_k=chunk_k, use_kernel=use_kernel, block_t=block_t)


def _fold_chunk(plan: _FoldPlan, g, cvec, y2, x, yv, *, forgetting: float = 1.0):
    """Fold one washout/padding-masked chunk into the running statistics.

    ``x`` [B, chunk, F] (bias column appended, invalid rows zeroed; f32 or
    bf16) and ``yv`` [B, chunk, C] f32 (invalid rows zeroed) update G
    [B, F, F] and c [B, F, C] in place and return (G, c, ‖y‖² [B]).  The
    targets stay f32 beside a bf16 chunk.  ``forgetting`` < 1 scales the
    *carried* statistics by λ before this chunk accumulates, so after n
    chunks chunk i carries weight λ^(n-1-i); at λ = 1.0 no scaling op runs
    at all, so the fold is bitwise the un-decayed one.
    """
    if forgetting != 1.0:
        g.mul_(forgetting)
        cvec.mul_(forgetting)
        y2 = y2 * forgetting
    y2 = y2 + torch.sum(yv * yv, dim=(1, 2))
    if plan.use_kernel:
        from ..kernels.ridge_gram import ops as gram_ops

        gram_ops.gram_accumulate_batched_into(g, cvec, x, yv, block_t=plan.block_t,
                                              round_y=False)
    else:
        x32 = x.to(torch.float32)
        g.baddbmm_(x32.mT, x32)
        cvec.baddbmm_(x32.mT, yv)
    return g, cvec, y2


def _row_mask(k_start: int, chunk_k: int, washout: int, k_total: int, device):
    """[chunk_k] f32: 1 for the fit rows of this chunk (period ≥ washout and
    < K), 0 for washout and padding rows."""
    tidx = k_start + torch.arange(chunk_k, device=device)
    return ((tidx >= washout) & (tidx < k_total)).to(torch.float32)


def _fit_streaming_core(
    states_fn,             # (j_chunk [B, chunk, ...], carry) -> (states, carry')
    n: int,                # feature nodes per instance
    j: torch.Tensor,       # [B, K] (or [B, K, ...]) canonicalised stream
    y: torch.Tensor,       # [B, K, C] canonicalised f32 targets
    *,
    washout: int,
    chunk_k: int,
    lambdas: tuple[float, ...],
    use_kernel: bool,
    block_t: int,
    noise_rel: float,
    s0,                    # carry matching states_fn (None = dark)
    forgetting: float = 1.0,
    carry_layout: tuple[tuple[int, int], ...] | None = None,
):
    """The chunk loop shared by the streaming fits (DESIGN.md §8/§9).

    ``states_fn`` is the only difference between the single-mask fit, the
    WDM fit (per-channel masks) and the shared readout: washout row
    masking, the bias fold, the Gram fold, noise as a Tikhonov diagonal and
    the GCV solve live here once.  The state chunks may be bf16; the
    reservoir carry, the targets and the Gram stacks stay f32.

    ``noise_rel`` > 0 adds the digitiser noise in expectation: σ²·T_fit on
    the N state-feature diagonal entries of G (not the bias), with σ =
    noise_rel·std of the states over the fit window, from in-loop Σs and
    Σs².  ``forgetting`` < 1 decays the carried statistics per chunk and
    solves with the decayed sample count.  ``carry_layout`` (a tuple of
    (L, N_s)) declares the carry a tuple of [B, L, N_s] tensors that a
    feature row [B, n] slices back into; None keeps one [B, n] carry.

    Returns (w [B, F, C], lam_idx [B], s_end) with ``s_end`` the carry
    after period K - 1: the state row of that period, or the f32 kernel
    carry when the period ends a chunk (with bf16 chunks and a ragged tail
    the row is the rounded one, as in the reference).
    """
    b, k_total = j.shape[0], j.shape[1]
    f = n + 1
    c_cols = y.shape[-1]
    dev = j.device
    if k_total <= washout:
        raise ValueError(f"stream length {k_total} <= washout {washout}")
    if not 0.0 < forgetting <= 1.0:
        raise ValueError(f"forgetting must be in (0, 1], got {forgetting}")
    if noise_rel and forgetting != 1.0:
        raise ValueError(
            "noise_rel as an expected Tikhonov diagonal assumes un-decayed "
            "Gram statistics; forgetting < 1 is not supported with it")
    t_fit = k_total - washout
    plan = _plan_fold(f, chunk_k, use_kernel=use_kernel, block_t=block_t,
                      n_cols=c_cols, batch=b)

    def f32(t):
        return torch.as_tensor(t, device=dev).to(torch.float32)

    if carry_layout is None:
        s = f32(s0) if s0 is not None else torch.zeros((b, n), dtype=torch.float32,
                                                        device=dev)

        def carry_from_row(row):          # the [B, n] feature row IS the carry
            return row
    else:
        if sum(lp * w for lp, w in carry_layout) != n:
            raise ValueError(f"carry_layout {carry_layout} does not cover {n} features")
        s = (tuple(f32(x) for x in s0) if s0 is not None else
             tuple(torch.zeros((b, lp, w), dtype=torch.float32, device=dev)
                   for lp, w in carry_layout))

        def carry_from_row(row):          # [B, n] -> tuple of [B, L, N_s]
            return tuple(part.reshape(b, lp, w) for part, (lp, w) in zip(
                torch.split(row, [lp * w for lp, w in carry_layout], dim=1),
                carry_layout))

    g = torch.zeros((b, plan.f, plan.f), dtype=torch.float32, device=dev)
    cvec = torch.zeros((b, plan.f, c_cols), dtype=torch.float32, device=dev)
    zeros_b = torch.zeros((b,), dtype=torch.float32, device=dev)
    y2, ssum, ssq, tcnt = zeros_b, zeros_b, zeros_b, zeros_b
    s_end = s
    with stage("stream_fit", dev):
        chunks = zip(_chunk_axis(j, chunk_k), _chunk_axis(y, chunk_k))
        for i, (j_c, y_c) in enumerate(chunks):
            k_start = i * plan.chunk_k
            with stage("stream_states", dev):
                states, s_next = states_fn(j_c, s)
            with stage("stream_fold", dev):
                vfit = _row_mask(k_start, plan.chunk_k, washout, k_total, dev)
                x = with_bias(states)
                # keep the mask in the chunk dtype: a bf16 chunk stays bf16
                x.mul_(vfit.to(x.dtype)[None, :, None])
                yv = y_c * vfit[None, :, None]
                if noise_rel:
                    sv = states.to(torch.float32) * vfit[None, :, None]
                    ssum = ssum + torch.sum(sv, dim=(1, 2))
                    ssq = ssq + torch.sum(sv * sv, dim=(1, 2))
                if forgetting != 1.0:
                    tcnt = tcnt * forgetting + torch.sum(vfit)
                g, cvec, y2 = _fold_chunk(plan, g, cvec, y2, x, yv, forgetting=forgetting)
            # the state after period K - 1: past it, a padded tail keeps
            # evolving on zero input, so the carry of a ragged last chunk is
            # not s_end; at a chunk end the f32 carry is (bf16 rows are not)
            last = k_total - 1 - k_start
            if 0 <= last < plan.chunk_k:
                s_end = (s_next if last == plan.chunk_k - 1 else
                         carry_from_row(states[:, last].to(torch.float32)))
            s = s_next

    with stage("solve", dev):
        if noise_rel:
            cnt = float(t_fit * n)
            var = torch.clamp(ssq / cnt - (ssum / cnt) ** 2, min=0.0)
            sig2_t = (noise_rel ** 2) * var * t_fit       # σ²·T_fit per instance
            g.diagonal(dim1=1, dim2=2)[:, :n] += sig2_t[:, None]
        # decayed statistics -> the decayed effective sample count in GCV
        n_samples = tcnt[:, None] if forgetting != 1.0 else t_fit
        w, idx = solve_gcv(g, cvec, y2, n_samples, tuple(lambdas))
    return w, idx, s_end


def fit_ridge_streaming(
    model,
    mask,                  # [N]
    j,                     # [B, K] sample-and-held input stream
    targets,               # [B, K] or [B, K, C]
    *,
    washout: int,
    chunk_k: int,
    lambdas: tuple[float, ...] = (1e-6,),
    state_method: str = "kernel",
    block_s: int | None = None,
    use_kernel: bool = True,
    block_t: int = 512,
    noise_rel: float = 0.0,
    state_dtype=None,
    s0=None,
    forgetting: float = 1.0,
    dev_params=None,
    device=None,
):
    """Streaming fused reservoir -> readout fit: the states never fully exist.

    A loop over ``ceil(K / chunk_k)`` chunks; each runs the reservoir for
    ``chunk_k`` periods (one scan-kernel launch on the kernel path),
    resuming bit-exactly from the carried f32 state, and folds the
    washout-masked, bias-extended chunk into per-instance Gram stacks (one
    in-place accumulate-into Gram launch with ``use_kernel=True``).  Peak
    live state memory is O(B·chunk_k·N).  ``state_dtype`` (e.g.
    ``"bfloat16"``) narrows the emitted state chunks only.

    The solve is the Gram/eigh route (``solve_gcv``): the running (G, c,
    ‖y‖²) are all a streaming fit holds.  ``noise_rel`` > 0 adds the
    digitiser noise as its expected Tikhonov diagonal σ²·T_fit
    (``state_noise_mode="diagonal"``); ``forgetting`` < 1 is RLS-style
    exponential forgetting per chunk, and λ = 1.0 is bitwise the
    un-decayed fit.

    Returns ``(w [B, N + 1, C], lam_idx [B], s_end [B, N])``, ``s_end`` the
    state after period K - 1 (see ``_fit_streaming_core``).  Runs on
    ``device`` (default ``cuda``).
    """
    if dev_params is not None:
        raise NotImplementedError(
            "dev_params (swept device parameters) are ROADMAP Queue 1 item 11")
    dev = resolve_device(device)
    j, y = _canon_stream(j, targets, dev)
    mask = torch.as_tensor(mask, device=dev).to(torch.float32)

    def states_fn(j_c, s):
        return generate_states(model, j_c, mask, s0=s, method=state_method,
                               block_s=block_s, return_final=True,
                               state_dtype=state_dtype, device=dev)

    return _fit_streaming_core(
        states_fn, int(mask.shape[-1]), j, y, washout=washout, chunk_k=chunk_k,
        lambdas=lambdas, use_kernel=use_kernel, block_t=block_t,
        noise_rel=noise_rel, s0=s0, forgetting=forgetting)


def fit_ridge_streaming_wdm(
    model,
    masks,                 # [R, N] — one mask per wavelength channel
    j,                     # [R, K] — one sample-and-held stream per channel
    targets,               # [R, K] or [R, K, C]
    *,
    washout: int,
    chunk_k: int,
    lambdas: tuple[float, ...] = (1e-6,),
    state_method: str = "kernel",
    block_s: int | None = None,
    use_kernel: bool = True,
    block_t: int = 512,
    noise_rel: float = 0.0,
    state_dtype=None,
    s0=None,
    forgetting: float = 1.0,
    device=None,
):
    """Streaming fit for a WDM ensemble: per-channel masks, one chunk loop.

    ``fit_ridge_streaming`` with the per-lane-mask reservoir: each chunk
    runs all R channels as ONE scan-kernel launch (channels are batch lanes
    with their own masks) and folds into per-channel Gram stacks G
    [R, F, F] / c [R, F, C].  Every other knob as ``fit_ridge_streaming``.
    Returns ``(w [R, F, C], lam_idx [R], s_end [R, N])``.
    """
    dev = resolve_device(device)
    j, y = _canon_stream(j, targets, dev)
    masks = torch.as_tensor(masks, device=dev).to(torch.float32)
    if masks.ndim != 2 or masks.shape[0] != j.shape[0]:
        raise ValueError(f"channels mismatch: j {tuple(j.shape)} vs masks "
                         f"{tuple(masks.shape)}")

    def states_fn(j_c, s):
        return generate_channel_states(model, j_c, masks, s0=s, method=state_method,
                                       block_s=block_s, return_final=True,
                                       state_dtype=state_dtype, device=dev)

    return _fit_streaming_core(
        states_fn, int(masks.shape[-1]), j, y, washout=washout, chunk_k=chunk_k,
        lambdas=lambdas, use_kernel=use_kernel, block_t=block_t,
        noise_rel=noise_rel, s0=s0, forgetting=forgetting)


def _shared_chunk_states_fn(model, masks, *, state_method: str = "kernel",
                            block_s: int | None = None, state_dtype=None, device=None):
    """The per-chunk state producer of the shared WDM readout: ``j_c``
    [1, chunk, R] with the carry ``([1, R, N],)`` -> features [1, chunk, R·N]
    (feature r·N + i = channel r, node i) and the next carry.  Shared by the
    fit and the streamed evaluation, so both run the same ops."""
    r, n_nodes = masks.shape

    def states_fn(j_c, carries):
        states, s_next = generate_channel_states(
            model, j_c[0].T, masks, s0=carries[0][0], method=state_method,
            block_s=block_s, return_final=True, state_dtype=state_dtype, device=device)
        feats = states.movedim(0, 1).reshape(j_c.shape[1], r * n_nodes)[None]
        return feats, (s_next[None],)

    return states_fn


def fit_ridge_streaming_shared(
    model,
    masks,                 # [R, N] — one mask per wavelength channel
    j,                     # [R, K] — one sample-and-held stream per channel
    targets,               # [K] or [K, C] — ONE target for the ensemble
    *,
    washout: int,
    chunk_k: int,
    lambdas: tuple[float, ...] = (1e-6,),
    state_method: str = "kernel",
    block_s: int | None = None,
    use_kernel: bool = True,
    block_t: int = 512,
    noise_rel: float = 0.0,
    state_dtype=None,
    s0=None,               # [R, N]
    forgetting: float = 1.0,
    device=None,
):
    """Shared-readout WDM fit: ONE readout over all R channels' features.

    The R channels act as one wide reservoir observing one task: the
    readout sees the concatenation of every channel's N node states, so the
    single Gram is [R·N + 1]² and its off-diagonal blocks carry the
    cross-channel correlations that per-channel fits discard.  The channel
    axis rides the chunk loop as a trailing input dim (stream [1, K, R]);
    each chunk runs all R channels as ONE per-lane-mask scan launch, and
    the carry is one ((R, N),) entry.

    Returns ``(w [F, C], lam_idx, s_end [R, N])``.
    """
    dev = resolve_device(device)
    masks = torch.as_tensor(masks, device=dev).to(torch.float32)
    if masks.ndim != 2:
        raise ValueError(f"masks must be [R, N], got {tuple(masks.shape)}")
    r, n_nodes = masks.shape
    j = torch.as_tensor(j, device=dev).to(torch.float32)
    if j.ndim != 2 or j.shape[0] != r:
        raise ValueError(f"channels mismatch: j {tuple(j.shape)} vs masks "
                         f"{tuple(masks.shape)}")
    y = torch.as_tensor(targets, device=dev).to(torch.float32)
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim != 2 or y.shape[0] != j.shape[1]:
        raise ValueError(f"targets {tuple(y.shape)} do not match stream length "
                         f"{j.shape[1]}")
    states_fn = _shared_chunk_states_fn(model, masks, state_method=state_method,
                                        block_s=block_s, state_dtype=state_dtype, device=dev)
    w, idx, s_end = _fit_streaming_core(
        states_fn, r * n_nodes, j.T[None], y[None], washout=washout, chunk_k=chunk_k,
        lambdas=lambdas, use_kernel=use_kernel, block_t=block_t, noise_rel=noise_rel,
        s0=None if s0 is None else (torch.as_tensor(s0, device=dev)[None],),
        forgetting=forgetting, carry_layout=((r, n_nodes),))
    return w[0], idx[0], s_end[0][0]
