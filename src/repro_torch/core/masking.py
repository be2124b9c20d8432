"""Input pre-processing for DFRC: sample-and-hold + binary MLS masking.

Port of ``repro/core/masking.py``.  The mask is built in numpy exactly as
the reference builds it (a Galois-form LFSR over primitive-polynomial taps,
truncated to N nodes), so the masks of the two packages are bitwise equal;
only the container changes to a torch tensor.  Node i of every period sees
input u[k, i] = j[k] * m[i] (paper Eq. (2)).
"""

from __future__ import annotations

import numpy as np
import torch

# Primitive polynomial taps for register lengths 2..16 (Xilinx XAPP052 /
# Golomb), applied as the XOR mask of a Galois LFSR — see the reference
# module for why the reciprocal polynomial keeps every m-sequence property.
_PRIMITIVE_TAPS: dict[int, tuple[int, ...]] = {
    2: (2, 1),
    3: (3, 2),
    4: (4, 3),
    5: (5, 3),
    6: (6, 5),
    7: (7, 6),
    8: (8, 6, 5, 4),
    9: (9, 5),
    10: (10, 7),
    11: (11, 9),
    12: (12, 11, 10, 4),
    13: (13, 12, 11, 8),
    14: (14, 13, 12, 2),
    15: (15, 14),
    16: (16, 15, 13, 4),
}


def mls_sequence(m: int, *, init_state: int = 1) -> np.ndarray:
    """One full period (2**m - 1) of a maximum-length ±1 sequence (int8)."""
    if m not in _PRIMITIVE_TAPS:
        raise ValueError(f"no primitive taps tabulated for m={m}")
    if not 0 < init_state < 2**m:
        raise ValueError("init_state must be a nonzero m-bit value")
    mask = 0
    for t in _PRIMITIVE_TAPS[m]:
        mask |= 1 << (t - 1)
    state = init_state
    out = np.empty(2**m - 1, dtype=np.int8)
    for i in range(out.shape[0]):
        lsb = state & 1
        out[i] = 1 if lsb else -1
        state >>= 1
        if lsb:
            state ^= mask
    return out


def make_mask(
    n_nodes: int,
    *,
    levels: tuple[float, float] = (0.0, 1.0),
    seed: int = 1,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Binary MLS mask [n_nodes] with values ``levels = (lo, hi)``.

    The MLS -1 maps to ``lo`` and +1 to ``hi``; ``seed`` rotates the MLS.
    ``device=None`` leaves the mask on the CPU (like ``torch.zeros``);
    the entry points move it to their own device.
    """
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    m = 2
    while 2**m - 1 < n_nodes:
        m += 1
    seq = mls_sequence(m, init_state=(seed % (2**m - 1)) + 1)
    seq = np.roll(seq, seed // (2**m - 1))[:n_nodes]
    lo, hi = levels
    vals = np.where(seq > 0, hi, lo).astype(np.float32)
    return torch.as_tensor(vals, dtype=dtype, device=device)


def sample_and_hold(series: torch.Tensor) -> torch.Tensor:
    """Identity for discrete-time tasks: each sample j[k] is held for one τ."""
    return torch.as_tensor(series)


def masked_input(j: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """u[..., k, i] = j[..., k] * m[i]  (paper Eq. (2)); [..., K] -> [..., K, N]."""
    return j[..., :, None] * mask[None, :]
