"""IIR filtering as a blocked closed form (counterpart of sdr_tpu/ops/iir.py).

A linear recurrence of order p,

    y[n] = b[n] + sum_{k=1..p} a_k * y[n-k],

is an affine map on the state s[n] = (y[n], ..., y[n-p+1]):
s[n] = C s[n-1] + e_0 b[n], with C the companion matrix.  The JAX package
evaluates it with ``lax.associative_scan`` (an XLA op, no Pallas kernel);
here it is matrix products in true f32, with no per-sample loop:

* cut each row into chunks of L samples; inside a chunk the output is one
  ``[L, L]`` lower-triangular impulse-response product on the drive plus
  the response to the state entering the chunk (``C^(i+1)``, row 0);
* the states entering the chunks obey the same recurrence one level up,
  ``S_j = C^L S_(j-1) + v_j`` (``v_j`` a chunk's final state from zero),
  solved by the same closed form on chunks of L chunks, recursively.

The powers of C come from float64 on the host, cast to f32, built once
per (filter, length, device) and kept on the device.  ``sosfilt``
applies cascaded biquad sections (scipy ``sos`` layout), each section one
order-2 recurrence.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.utils.graphs import keep

__all__ = ["linear_recurrence", "biquad", "sosfilt", "deemphasis_taps"]

CHUNK = 128


def companion(coeffs) -> np.ndarray:
    """float64 companion matrix of ``y[n] = b[n] + sum_k coeffs[k] y[n-k-1]``
    acting on the state (y[n-1], ..., y[n-p])."""
    coeffs = np.asarray(coeffs, dtype=np.float32).astype(np.float64)
    p = coeffs.shape[0]
    M = np.zeros((p, p))
    M[0, :] = coeffs
    M[1:, :-1] = np.eye(p - 1)
    return M


def _key(M: np.ndarray) -> tuple:
    return tuple(float(v) for v in M.ravel())


def _constants(M: tuple, n: int, device: torch.device):
    """:func:`_made_constants`, each tensor held by a graph being
    captured (``utils.graphs.keep``)."""
    out = _made_constants(M, n, device)
    for t in out[:4]:
        keep(t)
    return out


@functools.lru_cache(maxsize=64)
def _made_constants(M: tuple, n: int, device: torch.device):
    """The closed form's constants for n steps of the p x p state map M
    (a row-major tuple of float64), built in float64 and held on
    ``device`` in f32, so a call moves nothing from the host:

    * ``G [n*p, n*p]``: block lower-triangular, block (i, k) = M^(i-k);
    * ``P [n, p, p]``: M^(i+1), the response to the entering state;
    * ``T [n, n]`` and ``R [n, p]``: their first rows, for a scalar drive;
    * ``Mn``: M^n, a float64 tuple (the next level's map)."""
    p = int(round(len(M) ** 0.5))
    pw = np.empty((n + 1, p, p))
    pw[0] = np.eye(p)
    for i in range(n):
        pw[i + 1] = np.array(M).reshape(p, p) @ pw[i]
    i, k = np.tril_indices(n)
    G = np.zeros((n, p, n, p))
    G[i, :, k, :] = pw[i - k]
    T = np.zeros((n, n))
    T[i, k] = pw[i - k, 0, 0]
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(G.reshape(n * p, n * p), **f32),
            torch.as_tensor(pw[1:], **f32), torch.as_tensor(T, **f32),
            torch.as_tensor(pw[1:, 0, :], **f32), _key(pw[n]))


def companion_power(coeffs: tuple, n: int, device: torch.device):
    """``C^n`` of :func:`companion` from float64, as an f32 tensor on
    ``device``, made once (and held by a graph being captured)."""
    return keep(_companion_power(coeffs, n, device))


@functools.lru_cache(maxsize=64)
def _companion_power(coeffs: tuple, n: int, device: torch.device):
    return torch.as_tensor(np.linalg.matrix_power(companion(coeffs), n),
                           dtype=torch.float32, device=device)


def _state_scan(M: tuple, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """States of ``s[k] = M s[k-1] + u[k]`` for ``u [..., n, p]``, entering
    state ``s0 [..., p]``: ``[..., n, p]``."""
    n, p = u.shape[-2], u.shape[-1]
    L = CHUNK
    if n <= L:
        G, P = _constants(M, n, u.device)[:2]
        s = (u.reshape(u.shape[:-2] + (n * p,)) @ G.T).reshape(u.shape)
        return s + (P @ s0[..., None, :, None])[..., 0]
    nc = -(-n // L)
    if nc * L != n:
        u = torch.nn.functional.pad(u, (0, 0, 0, nc * L - n))
    uc = u.reshape(u.shape[:-2] + (nc, L, p))
    z = _state_scan(M, uc, torch.zeros_like(uc[..., 0, :]))
    _, P, _, _, ML = _constants(M, L, u.device)
    ends = _state_scan(ML, z[..., -1, :], s0)
    enter = torch.cat([s0[..., None, :], ends[..., :-1, :]], dim=-2)
    s = z + (P @ enter[..., None, :, None])[..., 0]
    return s.reshape(u.shape[:-2] + (nc * L, p))[..., :n, :]


def linear_recurrence(coeffs, b: torch.Tensor,
                      y0: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate ``y[n] = b[n] + sum_k coeffs[k] * y[n-k-1]``.

    ``coeffs``: [p] feedback coefficients (a_1..a_p).  ``b``: [..., N]
    f32 drive.  ``y0``: [..., p] entering state (y[-1], ..., y[-p]), zeros
    by default.  Returns y [..., N]."""
    M = _key(companion(coeffs))
    p = int(round(len(M) ** 0.5))
    lead, n = b.shape[:-1], b.shape[-1]
    s0 = torch.zeros(lead + (p,), dtype=torch.float32, device=b.device) \
        if y0 is None else y0.to(torch.float32).expand(lead + (p,))
    if n == 0:
        return b.clone()
    L = CHUNK                 # >= p: a chunk holds a whole state
    nc = -(-n // L)
    if nc * L != n:
        b = torch.nn.functional.pad(b, (0, nc * L - n))
    bc = b.reshape(lead + (nc, L))
    _, _, T, R, ML = _constants(M, L, b.device)
    # zero-state response inside each chunk: y = T @ b, T[i, k] = h[i - k]
    yz = bc @ T.T                                            # [..., nc, L]
    # each chunk's final state from zero, (y[L-1], ..., y[L-p]), and the
    # states entering the chunks
    v = yz[..., L - p:].flip(-1)
    ends = _state_scan(ML, v, s0)
    enter = torch.cat([s0[..., None, :], ends[..., :-1, :]], dim=-2)
    # response to the entering state: y[i] += (C^(i+1))[0, :] @ s
    y = yz + enter @ R.T
    return y.reshape(lead + (nc * L,))[..., :n]


def biquad(b, a, x: torch.Tensor, zi: torch.Tensor | None = None):
    """One second-order section: scipy-convention coefficients
    (b0, b1, b2) / (a0, a1, a2), a0 normalised to 1.  ``zi`` is the
    entering output state (y[-1], y[-2]).  Returns y [..., N]."""
    b = np.asarray(b, dtype=np.float32)
    a = np.asarray(a, dtype=np.float32)
    b = b / a[0]
    a = a / a[0]
    x = x.to(torch.float32)
    xp = torch.nn.functional.pad(x, (2, 0))
    drive = (float(b[0]) * xp[..., 2:] + float(b[1]) * xp[..., 1:-1]
             + float(b[2]) * xp[..., :-2])
    return linear_recurrence(np.array([-a[1], -a[2]], dtype=np.float32),
                             drive, zi)


def sosfilt(sos, x: torch.Tensor) -> torch.Tensor:
    """Cascade of second-order sections (scipy ``sos`` array [S, 6])."""
    sos = np.asarray(sos, dtype=np.float32)
    for s in range(sos.shape[0]):
        x = biquad(sos[s, :3], sos[s, 3:], x)
    return x


def deemphasis_taps(fs: float, tau: float = 75e-6):
    """FM broadcast de-emphasis (single-pole RC): (b, a) for biquad.

    tau = 75 us in the Americas, 50 us in Europe."""
    # bilinear transform of H(s) = 1 / (1 + s*tau)
    c = 2 * fs
    b0 = 1.0 / (1 + c * tau)
    a1 = (1 - c * tau) / (1 + c * tau)
    return (np.array([b0, b0, 0.0], dtype=np.float32),
            np.array([1.0, a1, 0.0], dtype=np.float32))
