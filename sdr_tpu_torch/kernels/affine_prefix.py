"""K15: the exclusive affine prefix over rows (csrc/affine_prefix.cu).

No TPU kernel has this role: the JAX package composes the shards' affine
maps with one ``all_gather`` and one ``lax.scan`` inside its jitted
program (sdr_tpu/parallel/halo.py:71 ``exclusive_affine_prefix``, :99
``exclusive_matrix_affine_prefix``).  Here the "shards" are the rows of a
block-parallel batch, one map a row and a lane, in two forms:

* scalar: ``y -> a*y + b``, ``a`` and ``b`` ``[B, *lanes]``;
* matrix: ``s -> M @ s + v``, ``M [B, *lanes, p, p]``, ``v [B, *lanes,
  p]`` (the form is read from the shapes: ``a.shape == b.shape`` is the
  scalar one).

Row b gets the composition of the maps of rows ``< b`` (row 0 the
identity) by the doubling (:func:`doubling`): at d = 1, 2, 4, ... < B
every row b >= d takes ``compose(cur[b], cur[b-d])`` of the level before,
then the rows shift by one.  With ``pre`` (R maps, ``[R, *lanes(, p,
p)]``, the whole maps of the ranks before this one in a process group)
every prefix is composed after their composition in order.  The
functions give the prefixes (:func:`exclusive_prefix`), the state
entering each row from a state ``s0`` before row 0
(:func:`entering_state`: ``A*s0 + B``, or ``c + A @ s0``), or the
rows' inclusive total (:func:`inclusive_total`, what a rank gathers).

Each product and sum is one rounded f32 operation: the scalar compose is
``(la*ea, la*eb + lb)``; the matrix compose sums each entry's products
over k left to right from the first (written elementwise here, not with
``@``, whose order is the BLAS's).  The kernel keeps this order, so it
equals the plain versions bitwise, and the scalar form is the port's
eager doubling before K15, bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, ptr

__all__ = ["KERNEL", "compose", "compose_matrix", "doubling",
           "exclusive_prefix", "exclusive_prefix_reference",
           "entering_state", "entering_state_reference", "inclusive_total",
           "inclusive_total_reference", "plan"]

THREADS = 128                   # kThreads: lanes a block of the thread form
SHARED_FLOATS = 8192            # kSharedFloats: a block's workspace
EXTRA = 3                       # kExtra: workspace slots past the rows
WARP_ROWS = 32                  # kWarpRows: rows of the warp form
WARP_LANES = 4                  # kWarpLanes: its lanes (warps) a block
_F32 = torch.float32

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
KERNEL = Kernel("affine_prefix", {
    "launch_affine_prefix": [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _LL, _P,
                             _LL, _LL, _F, _P, _P, _P, _P, _P, _P, _LL,
                             _LL, _LL, _I],
})


def compose(late, early):
    """The scalar maps ``late`` after ``early``, each ``(a, b)``: ``y ->
    a*y + b``."""
    return late[0] * early[0], late[0] * early[1] + late[1]


def compose_matrix(late, early):
    """The matrix maps ``late`` after ``early``, each ``(M [..., p, p], v
    [..., p])``: ``(L E, L ev + lv)``, each entry's products summed over
    k left to right from the first, each operation rounded."""
    (LM, lv), (EM, ev) = late, early
    p = LM.shape[-1]
    M = LM[..., :, :1] * EM[..., :1, :]
    s = LM[..., :, 0] * ev[..., :1]
    for k in range(1, p):
        M = M + LM[..., :, k:k + 1] * EM[..., k:k + 1, :]
        s = s + LM[..., :, k] * ev[..., k:k + 1]
    return M, s + lv


def doubling(a: torch.Tensor, b: torch.Tensor, compose=compose):
    """The inclusive prefix of the maps ``(a, b)`` over the leading axis by
    doubling: ``log2`` whole-batch steps, each composing every map after
    the one ``d`` before it (``compose(later, earlier)``)."""
    cur = (a, b)
    d = 1
    while d < a.shape[0]:
        new = compose(tuple(t[d:] for t in cur), tuple(t[:-d] for t in cur))
        cur = tuple(torch.cat([t[:d], u]) for t, u in zip(cur, new))
        d *= 2
    return cur


def _form(m: torch.Tensor, v: torch.Tensor) -> int:
    """0 for the scalar form, else p; raises for other shapes."""
    if m.shape == v.shape:
        if m.ndim < 1:
            raise ValueError("the maps need a leading row axis")
        return 0
    if (m.ndim == v.ndim + 1 and v.ndim >= 2 and m.shape[:-1] == v.shape
            and m.shape[-2] == m.shape[-1] >= 1):
        return v.shape[-1]
    raise ValueError(f"maps {tuple(m.shape)}, {tuple(v.shape)}: scalar "
                     "[B, ...] twice, or [B, ..., p, p] and [B, ..., p]")


def _check(m, v, pre, s0):
    for name, t in (("m", m), ("v", v)):
        if t.dtype != _F32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != v.device:
            raise ValueError("m and v must share a device")
    p = _form(m, v)
    if m.shape[0] < 1:
        raise ValueError("the maps need at least one row")
    if pre is not None:
        pm, pv = pre
        for t, like in ((pm, m), (pv, v)):
            if (t.dtype != _F32 or t.device != v.device
                    or t.shape[1:] != like.shape[1:]
                    or t.shape[0] != pre[0].shape[0]):
                raise ValueError("pre must be R maps shaped as a row's, "
                                 "float32 on the maps' device")
    if isinstance(s0, torch.Tensor):
        if s0.dtype != _F32 or s0.device != v.device:
            raise ValueError("s0 must be float32 on the maps' device")
        lanes = v.shape[1:]
        if s0.shape not in (lanes, v.shape) and not _broadcasts(s0, lanes):
            raise ValueError(f"s0 {tuple(s0.shape)} must be a row's state "
                             f"{tuple(lanes)} or every row's "
                             f"{tuple(v.shape)}")
    return p


def _broadcasts(t: torch.Tensor, shape) -> bool:
    try:
        return torch.broadcast_shapes(t.shape, shape) == tuple(shape)
    except RuntimeError:
        return False


def _identity(m, v, p):
    """One identity map shaped as a row's."""
    if p == 0:
        return torch.ones_like(m[:1]), torch.zeros_like(v[:1])
    eye = torch.eye(p, dtype=m.dtype, device=m.device)
    return eye.expand(m[:1].shape), torch.zeros_like(v[:1])


def _local(m, v, p, pre):
    """The exclusive prefixes, after the entering map of ``pre``."""
    comp = compose if p == 0 else compose_matrix
    cur = doubling(m, v, comp)
    local = tuple(torch.cat([i, t[:-1]])
                  for i, t in zip(_identity(m, v, p), cur))
    if pre is None or pre[0].shape[0] == 0:
        return local
    enter = (pre[0][0], pre[1][0])
    for r in range(1, pre[0].shape[0]):
        enter = comp((pre[0][r], pre[1][r]), enter)
    return comp(local, enter)


def exclusive_prefix_reference(m, v, pre=None):
    """Plain PyTorch version of :func:`exclusive_prefix`."""
    p = _check(m, v, pre, None)
    return _local(m, v, p, pre)


def entering_state_reference(m, v, s0, pre=None):
    """Plain PyTorch version of :func:`entering_state`."""
    p = _check(m, v, pre, s0)
    A, c = _local(m, v, p, pre)
    if p == 0:
        return A * s0 + c
    if not isinstance(s0, torch.Tensor):
        s0 = torch.full(v.shape[1:], s0, dtype=_F32, device=v.device)
    s = A[..., :, 0] * s0[..., :1]
    for k in range(1, p):
        s = s + A[..., :, k] * s0[..., k:k + 1]
    return c + s


def inclusive_total_reference(m, v):
    """Plain PyTorch version of :func:`inclusive_total`."""
    p = _check(m, v, None, None)
    cur = doubling(m, v, compose if p == 0 else compose_matrix)
    return cur[0][-1], cur[1][-1]


def plan(B: int, L: int, p: int):
    """(threads a block, scratch floats) of a launch over ``B`` rows of
    ``L`` lanes of order ``p`` (1 for the scalar form), as the source
    plans it: up to WARP_ROWS rows at p <= 2 a warp a lane (WARP_LANES a
    block), else a thread a lane, its ``(B + 3) (p p + p)`` floats in
    shared memory while a block's fit, else in a scratch buffer."""
    if B <= WARP_ROWS and p <= 2:
        return 32 * min(L, WARP_LANES), 0
    per_lane = (B + EXTRA) * (p * p + p)
    want = min(L, THREADS)
    fit = SHARED_FLOATS // per_lane
    if fit >= 1:
        return min(want, fit), 0
    return want, per_lane * L


def _flat(t: torch.Tensor, lead: int, lanes, inner: int):
    """``t`` ``[*lead_dims, *lanes, *inner_dims]`` as (tensor, lead
    stride, lane stride) with the lanes read as one axis and the inner
    block contiguous; a copy only where the strides do not allow that."""
    def strides(u):
        st = u.stride()
        inner_ok = True
        size = 1
        for d in range(u.ndim - 1, u.ndim - 1 - inner, -1):
            if u.shape[d] > 1 and st[d] != size:
                inner_ok = False
            size *= u.shape[d]
        dims = [(u.shape[d], st[d]) for d in range(lead, lead + len(lanes))
                if u.shape[d] > 1]
        lane = dims[-1][1] if dims else 0
        span = 1
        for n, s in reversed(dims):
            if s != lane * span:
                return None
            span *= n
        return (st[0] if lead else 0, lane) if inner_ok else None

    got = strides(t)
    if got is None:
        t = t.contiguous()
        got = strides(t)
    return (t,) + got


def _ptr(t):
    """A tensor's data pointer, or a null one for None."""
    return None if t is None else ptr(t)


def _launch(m, v, pre=None, s0=None, maps=True, state=False, total=False):
    """K15 over the maps ``(m, v)``: the prefixes (``maps``), the entering
    states from ``s0`` (``state``) and the inclusive total (``total``),
    each None unless asked for."""
    p = _check(m, v, pre, s0)
    B, lanes = v.shape[0], tuple(v.shape[1:] if p == 0 else v.shape[1:-1])
    q = max(p, 1)
    if p == 0:                          # the scalar form as p = 1
        m, v = m[..., None, None], v[..., None]
        pre = None if pre is None else (pre[0][..., None, None],
                                        pre[1][..., None])
        if isinstance(s0, torch.Tensor):
            s0 = s0[..., None]
    L = 1
    for n in lanes:
        L *= n
    dev = v.device
    shape = lambda *extra: (B,) + lanes + extra    # noqa: E731
    A = c = st = tm = tv = None
    if maps:
        A = torch.empty(shape(q, q), dtype=_F32, device=dev)
        c = torch.empty(shape(q), dtype=_F32, device=dev)
    if state:
        st = torch.empty(shape(q), dtype=_F32, device=dev)
    if total:
        tm = torch.empty(lanes + (q, q), dtype=_F32, device=dev)
        tv = torch.empty(lanes + (q,), dtype=_F32, device=dev)
    if L > 0:
        m, m_row, m_lane = _flat(m, 1, lanes, 2)
        v, v_row, v_lane = _flat(v, 1, lanes, 1)
        R, pm, pv = 0, None, None
        if pre is not None and pre[0].shape[0] > 0:
            R = pre[0].shape[0]
            pm, pv = pre[0].contiguous(), pre[1].contiguous()
        s0p, s0_row, s0_lane, s0_value = None, 0, 0, 0.0
        if isinstance(s0, torch.Tensor):
            rows = s0.ndim == 1 + len(lanes) + 1 and s0.shape[0] == B
            if not rows:
                s0 = s0.expand(lanes + (q,))
            s0p, s0_row, s0_lane = _flat(s0, int(rows), lanes, 1)
        elif s0 is not None:
            s0_value = float(s0)
        _, floats = plan(B, L, q)
        scratch = (torch.empty(floats, dtype=_F32, device=dev) if floats
                   else None)
        KERNEL.launch("launch_affine_prefix", dev, ptr(m), m_row, m_lane,
                      ptr(v), v_row, v_lane, _ptr(pm), _ptr(pv), R,
                      _ptr(s0p), s0_row, s0_lane, s0_value, _ptr(A),
                      _ptr(c), _ptr(st), _ptr(tm), _ptr(tv), _ptr(scratch),
                      floats, B, L, q)
    if p == 0:                          # back to the scalar shapes
        A = None if A is None else A[..., 0, 0]
        c = None if c is None else c[..., 0]
        st = None if st is None else st[..., 0]
        tm = None if tm is None else tm[..., 0, 0]
        tv = None if tv is None else tv[..., 0]
    return (A, c), st, (tm, tv)


def _device(v: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); any other device raises."""
    if v.device.type == "cpu":
        return False
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    return True


def exclusive_prefix(m: torch.Tensor, v: torch.Tensor, pre=None):
    """The exclusive prefixes ``(A, c)`` of the rows' maps ``(m, v)`` over
    the leading axis, shaped as the maps: row b the composition of rows
    ``< b`` (the identity for row 0), after the composition of ``pre``'s
    R maps in order when given.  Launches K15 for CUDA tensors; CPU
    tensors take the plain version."""
    if not _device(v):
        return exclusive_prefix_reference(m, v, pre)
    return _launch(m, v, pre)[0]


def entering_state(m: torch.Tensor, v: torch.Tensor, s0, pre=None):
    """The state entering each row from ``s0`` (a tensor of a row's state,
    or every row's, or a number): ``A*s0 + B`` (scalar form) or ``c + A
    @ s0`` (matrix form) of :func:`exclusive_prefix`'s prefixes, in one
    launch of K15 for CUDA tensors; CPU tensors take the plain
    version."""
    if not _device(v):
        return entering_state_reference(m, v, s0, pre)
    return _launch(m, v, pre, s0, maps=False, state=True)[1]


def inclusive_total(m: torch.Tensor, v: torch.Tensor):
    """The composition of all the rows' maps, shaped as a row's: the
    doubling's last row.  Launches K15 for CUDA tensors; CPU tensors take
    the plain version."""
    if not _device(v):
        return inclusive_total_reference(m, v)
    return _launch(m, v, maps=False, total=True)[2]
