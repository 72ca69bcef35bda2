"""K15 (the exclusive affine prefix over rows) and K16 (AM's planar
envelope) on the CPU, where their wrappers take the plain versions; their
CUDA sources compiled for the host with ``g++`` under
tests/torch_host_shim.py; and the ``shard_carry`` of the four ops that
compose prefixes (``Agc``, ``DcBlocker``, ``StereoDecode``, ``Iir``)
against the JAX package's.

* The plain prefixes against ``sdr_tpu.parallel.halo``'s two prefixes
  under ``jax.vmap(..., axis_name="b")`` (jitted), at B in {1, 2, 3, 5, 8,
  32, 33}, lanes ``()``, ``(3,)`` and ``(2, 3)``, the scalar form and p in
  {1, 2, 3}, within 1e-6 (the JAX package composes left to right, the
  port by doubling).  The maps are those of stable recurrences: ``a``
  uniform in (-1, 1), ``M``'s entries in (-1/p, 1/p), so no prefix grows
  past a few units.
* The scalar plain version bitwise the port's eager doubling before K15
  (copied here as ``parent_prefix``), with and without the ranks before,
  and its entering state bitwise ``A * s0 + B``.
* The process group's order (H14): with ``gather_ranks`` and the rank
  stood in for, four ranks' prefixes bitwise the earlier group path in
  the scalar form and within 1e-6 of one process over all the rows; two
  gathers a composition (``m`` then ``v``), none without a group.
* ``csrc/affine_prefix.cu`` and ``csrc/am_envelope.cu`` built for the host
  and run through the wrappers' own launch code: bitwise their plain
  versions, K15 with and without the entering state and the ranks
  before, a map read at a row stride of 0, signed zeros, the workspace
  in shared memory and in scratch; K16 at n in {1, 3, 4, 5, 4,097}, bases
  0-3 floats off 16-byte alignment, leading dims ``[]``, ``[3]``, ``[2,
  3]``.
* ``shard_carry`` of the four ops, with and without ``initial``, against
  the JAX ops' under vmap (1e-5; the stereo lock equal), and their
  routing: one prefix launch a composition, ``AmDemod`` on K16.
* An edit to ``affine.cuh`` renames K12's, K15's and K16's libraries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_host_shim as host_shim

from sdr_tpu.parallel import halo as jhalo
from sdr_tpu.stream import Agc as JaxAgc
from sdr_tpu.stream import AmDemod as JaxAmDemod
from sdr_tpu.stream import DcBlocker as JaxDcBlocker
from sdr_tpu.stream import Iir as JaxIir
from sdr_tpu.stream import StereoDecode as JaxStereoDecode

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.kernels import (KERNELS, _build, affine_prefix,
                                   agc_linear, am_envelope)
from sdr_tpu_torch.parallel import halo
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import (Agc, AmDemod, DcBlocker, Iir,
                                  StereoDecode)
from sdr_tpu_torch.stream import ops as stream_ops

ATOL = 1e-6                     # the prefixes against the JAX package
OP_ATOL = 1e-5                  # an op's carries (the IIR: H7)
FS = 160_000.0
BS = (1, 2, 3, 5, 8, 32, 33)
LANES = ((), (3,), (2, 3))
FORMS = ("scalar", 1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(got, want):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, want))


def _maps(rng, B, lanes, form):
    """Seeded maps of stable recurrences: (m, v) in the scalar form or of
    order p."""
    if form == "scalar":
        a = rng.uniform(-1, 1, (B,) + lanes).astype(np.float32)
        b = rng.uniform(-1, 1, (B,) + lanes).astype(np.float32)
        return torch.from_numpy(a), torch.from_numpy(b)
    p = form
    M = rng.uniform(-1, 1, (B,) + lanes + (p, p)) / p
    v = rng.uniform(-1, 1, (B,) + lanes + (p,))
    return (torch.from_numpy(M.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)))


def _jax_prefix(m, v, form):
    fn = (jhalo.exclusive_affine_prefix if form == "scalar"
          else jhalo.exclusive_matrix_affine_prefix)
    return jax.jit(jax.vmap(lambda x, y: fn(x, y, "b"), axis_name="b"))(
        jnp.asarray(m.numpy()), jnp.asarray(v.numpy()))


# -- the plain versions against the JAX package ---------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("B", BS)
def test_plain_prefixes_match_jax(rng, B, lanes, form):
    m, v = _maps(rng, B, lanes, form)
    want = _jax_prefix(m, v, form)
    got = (halo.exclusive_affine_prefix(m, v) if form == "scalar"
           else halo.exclusive_matrix_affine_prefix(m, v))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    # the entering state from a seeded state before row 0
    A, c = (np.asarray(w) for w in want)
    s0 = rng.uniform(-1, 1, v.shape[1:]).astype(np.float32)
    state = halo.entering_state(m, v, torch.from_numpy(s0)).numpy()
    ref = (A * s0 + c if form == "scalar"
           else np.einsum("...ij,...j->...i", A, s0) + c)
    np.testing.assert_allclose(state, ref, rtol=0, atol=ATOL)


# -- the scalar form: the earlier eager doubling, bitwise -----------------


def parent_prefix(a, b, totals=None, rank=0):
    """The port's scalar prefixes before K15 (parallel/halo.py's
    ``_exclusive_scan``): the doubling over the rows, the shift, and with
    the gathered ``totals`` the ranks before ``rank`` composed in rank
    order, then every local prefix after them."""
    def compose(late, early):
        return late[0] * early[0], late[0] * early[1] + late[1]

    cur, d = (a, b), 1
    while d < cur[0].shape[0]:
        new = compose(tuple(t[d:] for t in cur), tuple(t[:-d] for t in cur))
        cur = tuple(torch.cat([t[:d], n]) for t, n in zip(cur, new))
        d *= 2
    one = torch.ones((1,) + a.shape[1:])
    local = tuple(torch.cat([i.expand_as(t[:1]), t[:-1]])
                  for i, t in zip((one, torch.zeros_like(one)), cur))
    if totals is None:
        return local, cur
    enter = None
    for r in range(rank):
        m = tuple(t[r] for t in totals)
        enter = m if enter is None else compose(m, enter)
    return (local if enter is None else compose(local, enter)), cur


@pytest.mark.parametrize("B", (1, 2, 3, 31, 32, 33, 64, 1000))
def test_scalar_plain_is_the_earlier_doubling_bitwise(rng, B):
    for lanes in ((), (2, 3)):
        a, b = _maps(rng, B, lanes, "scalar")
        b[rng.random(b.shape) < 0.2] = -0.0        # signed zeros
        want, cur = parent_prefix(a, b)
        assert _same(affine_prefix.exclusive_prefix(a, b), want)
        assert _same(affine_prefix.inclusive_total(a, b),
                     (cur[0][-1], cur[1][-1]))
        s0 = torch.from_numpy(rng.uniform(-1, 1, lanes).astype(np.float32))
        assert _same(affine_prefix.entering_state(a, b, s0),
                     want[0] * s0 + want[1])
        assert _same(affine_prefix.entering_state(a, b, 0.5),
                     want[0] * 0.5 + want[1])
        # a map the same on every row, at a row stride of 0
        one = torch.full((), 0.997 ** 77, dtype=torch.float32)
        same = one.expand_as(b)
        assert _same(affine_prefix.exclusive_prefix(same, b),
                     parent_prefix(torch.full_like(b, 0.997 ** 77), b)[0])


# -- the process group ----------------------------------------------------


RANKS = 4


def _fake_group(monkeypatch, totals, rank, sent):
    """Stand in for a group of RANKS ranks at ``rank``: ``gather_ranks``
    answers with ``totals`` (each rank's whole map, m then v) and records
    what this rank sent."""
    def gather(t, group):
        k = len(sent)
        sent.append(t)
        return totals[k % 2][:, None]
    monkeypatch.setattr(halo, "gather_ranks", gather)
    monkeypatch.setattr(halo.dist, "get_rank", lambda group=None: rank)


@pytest.mark.parametrize("form", FORMS)
def test_group_prefixes_compose_the_ranks_before(rng, monkeypatch, form):
    B = 5
    m, v = _maps(rng, RANKS * B, (3,), form)
    parts = [(m[r * B:(r + 1) * B], v[r * B:(r + 1) * B])
             for r in range(RANKS)]
    totals = [torch.stack(t) for t in zip(
        *(affine_prefix.inclusive_total(*p) for p in parts))]
    whole = halo.exclusive_matrix_affine_prefix(m, v) if form != "scalar" \
        else halo.exclusive_affine_prefix(m, v)
    s0 = torch.from_numpy(rng.uniform(-1, 1, v.shape[1:]).astype(np.float32))
    for r in range(RANKS):
        sent = []
        _fake_group(monkeypatch, totals, r, sent)
        got = halo.exclusive_affine_prefix(*parts[r], group="g")
        assert len(sent) == 2
        assert _same(sent[0][0], totals[0][r])
        assert _same(sent[1][0], totals[1][r])
        for g, w in zip(got, whole):
            np.testing.assert_allclose(
                g.numpy(), w[r * B:(r + 1) * B].numpy(), rtol=0, atol=ATOL)
        state = halo.entering_state(*parts[r], s0, group="g")
        assert len(sent) == 4
        want = affine_prefix.entering_state_reference(
            *parts[r], s0, pre=(totals[0][:r], totals[1][:r]))
        assert _same(state, want)
        if form == "scalar":
            old, _ = parent_prefix(*parts[r], totals=[t[:, None]
                                                      for t in totals],
                                   rank=r)
            assert _same(got, old)
            assert _same(state, old[0] * s0 + old[1])
        if r == 0:       # nothing before rank 0: the one-process rows
            assert _same(got, tuple(t[:B] for t in whole))


def test_no_gather_without_a_group(rng, monkeypatch):
    sent = []
    monkeypatch.setattr(halo, "gather_ranks",
                        lambda t, group: sent.append(t))
    a, b = _maps(rng, 8, (), "scalar")
    halo.exclusive_affine_prefix(a, b)
    halo.entering_state(a, b, 1.0)
    assert sent == []


def test_refusals():
    a = torch.ones(4)
    with pytest.raises(ValueError, match="at least one row"):
        affine_prefix.exclusive_prefix(a[:0], a[:0])
    with pytest.raises(ValueError, match="scalar"):
        affine_prefix.exclusive_prefix(torch.ones(4, 2, 3), torch.ones(4, 2))
    with pytest.raises(ValueError, match="float32"):
        affine_prefix.exclusive_prefix(a.double(), a.double())
    with pytest.raises(ValueError, match="s0"):
        affine_prefix.entering_state(torch.ones(4, 3), torch.ones(4, 3),
                                     torch.ones(5))
    with pytest.raises(ValueError, match="unsupported device"):
        affine_prefix.exclusive_prefix(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        am_envelope.am_envelope(torch.ones(3, 2, 8, device="meta"))
    with pytest.raises(ValueError, match="planar"):
        am_envelope.am_envelope(torch.ones(3, 8))


# -- the CUDA sources, built for the host -----------------------------------


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_affine")
    libs = {}
    for mod in (affine_prefix, am_envelope):
        lib = host_shim.build_source(d, mod.KERNEL.name)
        for fn, types in mod.KERNEL.functions.items():
            getattr(lib, fn).argtypes = [*types, host_shim.ctypes.c_void_p]
        libs[mod.KERNEL.name] = lib
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' own launch code run on CPU tensors through the host
    builds (each launch counted)."""
    calls = []

    def launch(fn, device, *args):
        calls.append(fn)
        lib = host_libs[fn[len("launch_"):]]
        assert getattr(lib, fn)(*args, None) == 0, fn
    for mod in (affine_prefix, am_envelope):
        monkeypatch.setattr(mod.KERNEL, "launch", launch)
    return calls


# K15 at rows about a power of two and past the shared workspace (1,000
# rows of order 4: scratch), for each form and lane shape
K15_BS = (1, 2, 3, 31, 33, 200, 1000)


@pytest.mark.parametrize("form", ("scalar", 1, 2, 3, 4))
@pytest.mark.parametrize("B", K15_BS)
def test_k15_source_on_the_host_equals_plain_bitwise(rng, on_host, B,
                                                      form):
    lanes_list = ((), (3,), (64, 2)) if B <= 200 else ((), (3,))
    for lanes in lanes_list:
        m, v = _maps(rng, B, lanes, form)
        v[torch.from_numpy(rng.random(v.shape) < 0.1)] = -0.0
        q = 1 if form == "scalar" else form
        pre = _maps(rng, 3, lanes, form)
        s0 = torch.from_numpy(rng.uniform(-1, 1, v.shape[1:]).astype(
            np.float32))
        for pre_ in (None, pre, tuple(t[:1] for t in pre)):
            (A, c), st, (tm, tv) = affine_prefix._launch(
                m, v, pre_, s0, maps=True, state=True, total=True)
            assert _same((A, c), affine_prefix.exclusive_prefix_reference(
                m, v, pre_)), (B, lanes, form)
            assert _same(st, affine_prefix.entering_state_reference(
                m, v, s0, pre_))
            assert _same((tm, tv),
                         affine_prefix.inclusive_total_reference(m, v))
        # the state from a number, and from every row's own state
        st = affine_prefix._launch(m, v, None, 0.25, maps=False,
                                   state=True)[1]
        assert _same(st, affine_prefix.entering_state_reference(m, v, 0.25))
        rows = torch.from_numpy(rng.uniform(-1, 1, v.shape).astype(
            np.float32))
        st = affine_prefix._launch(m, v, pre, rows, maps=False,
                                   state=True)[1]
        assert _same(st, affine_prefix.entering_state_reference(m, v, rows,
                                                                pre))
        # a map the same on every row and lane, read at a row stride of 0
        same = m[:1].clone().expand_as(m)
        assert B == 1 or same.stride(0) == 0
        (A, c), _, _ = affine_prefix._launch(same, v, pre)
        assert _same((A, c), affine_prefix.exclusive_prefix_reference(
            same.contiguous(), v, pre))
        assert q >= 1
    threads, floats = affine_prefix.plan(B, 128, q)
    assert (floats > 0) == ((B + 3) * (q * q + q) > 8192)
    assert threads >= 1


def test_k15_plan_takes_scratch_past_the_shared_workspace():
    assert affine_prefix.plan(32, 1, 1) == (32, 0)        # a warp a lane
    assert affine_prefix.plan(32, 128, 2) == (128, 0)
    assert affine_prefix.plan(33, 128, 1) == (113, 0)     # a thread a lane
    assert affine_prefix.plan(32, 2, 3) == (2, 0)
    assert affine_prefix.plan(1000, 2, 4) == (2, 1003 * 20 * 2)
    assert affine_prefix.plan(1000, 128, 1) == (4, 0)


@pytest.mark.parametrize("lead", ((), (3,), (2, 3)))
@pytest.mark.parametrize("n", (1, 3, 4, 5, 4097))
def test_k16_source_on_the_host_equals_plain_bitwise(rng, on_host, n, lead):
    for off in range(4):
        x = host_shim.offset(torch.from_numpy(
            rng.uniform(-2, 2, lead + (2, n)).astype(np.float32)), off)
        x[..., :, :1] = -0.0                     # signed zeros
        got = am_envelope._launch(x)
        assert _same(got, agc_linear.envelope(x)), (n, lead, off)
    assert on_host == ["launch_am_envelope"] * 4


# -- the ops' shard_carry against the JAX package's ----------------------


ROWS, N = 6, 2048


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [u for x in t for u in _leaves(x)]
    return [np.asarray(t)]


def _jax_carry(op, xb, initial):
    """The JAX op's ``shard_carry`` over the rows ``xb`` under vmap,
    jitted."""
    init = (None if initial is None else
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), initial))
    return jax.jit(jax.vmap(lambda x: op.shard_carry(x, "b", init),
                            axis_name="b"))(jnp.asarray(xb.numpy()))


def _composite(rng):
    """Rows of the stereo multiplex (L = 1 kHz, R = 400 Hz, a 10 %
    pilot), rows 2 and 3 without the pilot: the lock holds, drops and
    locks again."""
    t = np.arange(ROWS * N) / FS
    pilot = 0.1 * np.cos(2 * np.pi * 19_000 * t)
    pilot[2 * N:4 * N] = 0.0
    comp = (0.25 * (np.sin(2 * np.pi * 1e3 * t) + np.sin(2 * np.pi * 400 * t))
            + pilot + 0.01 * rng.standard_normal(t.shape))
    return torch.from_numpy(comp.astype(np.float32).reshape(ROWS, N))


def _carry_case(name, rng):
    """(the port's op, the JAX op, the rows, an initial carry)."""
    u = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, s).astype(np.float32))
    if name == "agc_planar":
        return (Agc(0.005, 1.0, planar=True, device="cpu"),
                JaxAgc(0.005, 1.0, planar=True), u(ROWS, 2, N),
                torch.tensor(1.3))
    if name == "agc_complex":
        x = torch.complex(u(ROWS, 3, N), u(ROWS, 3, N))
        return (Agc(0.005, 1.0, device="cpu"), JaxAgc(0.005, 1.0), x,
                torch.full((3,), 0.7))
    if name == "dc_blocker":
        return (DcBlocker(device="cpu"), JaxDcBlocker(), u(ROWS, N) + 0.5,
                (torch.tensor(0.25), torch.tensor(-0.5)))
    if name == "stereo":
        op = StereoDecode(FS, device="cpu")
        return (op, JaxStereoDecode(FS), _composite(rng),
                (u(op.H), torch.tensor(1.0)))
    sos = np.array([[0.2, 0.3, 0.1, 1.0, -1.2, 0.5],
                    [0.5, 0.0, 0.0, 1.0, -0.9, 0.0]], np.float32)
    return (Iir(sos, device="cpu"), JaxIir(sos), u(ROWS, 2, N),
            (u(2, 2, 2), u(2, 2, 2)))


CARRY_CASES = ("agc_planar", "agc_complex", "dc_blocker", "stereo", "iir")


@pytest.fixture
def prefix_calls(monkeypatch):
    """Count the calls of K15's and K16's wrappers, wherever the ops reach
    them."""
    calls = {}
    for mod, name in ((affine_prefix, "exclusive_prefix"),
                      (affine_prefix, "entering_state"),
                      (affine_prefix, "inclusive_total"),
                      (stream_ops, "am_envelope")):
        real = getattr(mod, name)

        def wrapper(*a, _name=name, _real=real, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    return calls


@pytest.mark.parametrize("with_initial", (False, True))
@pytest.mark.parametrize("name", CARRY_CASES)
def test_shard_carry_matches_jax(rng, prefix_calls, name, with_initial):
    op, jop, xb, initial = _carry_case(name, rng)
    initial = initial if with_initial else None
    got = _leaves(op.shard_carry(xb, initial))
    sections = op.sos.shape[0] if name == "iir" else 1
    # one K15 launch a composition, and its entering state in it
    assert sum(prefix_calls.values()) == sections
    assert "inclusive_total" not in prefix_calls
    want = _leaves(_jax_carry(jop, xb, initial))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if name == "stereo":
            np.testing.assert_array_equal(g[-ROWS:], w[-ROWS:])
        np.testing.assert_allclose(g, w, rtol=0, atol=OP_ATOL)
    if name == "stereo":     # locked, held over row 2, dropped after
        # row 3, locked again by row 4
        assert got[-1].tolist() == ([1.0 if with_initial else 0.0, 1.0,
                                     1.0, 1.0, 0.0, 1.0])


def test_am_envelope_plain_matches_jax_and_k12(rng):
    x = torch.from_numpy(rng.uniform(-2, 2, (3, 2, 4099)).astype(np.float32))
    got = AmDemod(planar=True, device="cpu").apply((), x)[1]
    assert _same(got, agc_linear.envelope(x))
    assert _same(got, am_envelope.am_envelope(x))
    want = jax.jit(lambda v: JaxAmDemod(planar=True).apply((), v)[1])(
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _am_raw(n_bytes, seed=7):
    """u8 IQ of an AM carrier at a quarter of the rate, 40 % modulated."""
    n = n_bytes // 2
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    iq = (0.5 + 0.4 * np.sin(2 * np.pi * 0.001 * t)) * np.exp(
        2j * np.pi * 0.25 * t) + 0.01 * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 128), 0, 255)
    return raw


def test_am_chain_reaches_k15_twice_and_k16_once(prefix_calls):
    y = run_time_batched(chains.am_chain(device="cpu"), _am_raw(4 << 15), 4,
                         device="cpu")
    assert torch.isfinite(y).all()
    assert prefix_calls == {"entering_state": 1, "exclusive_prefix": 1,
                            "am_envelope": 1}


# -- the registry and the build digest -----------------------------------


def test_kernels_hold_k15_and_k16():
    assert KERNELS[14] is affine_prefix.KERNEL
    assert KERNELS[15] is am_envelope.KERNEL
    assert affine_prefix.KERNEL.source == _build.CSRC / "affine_prefix.cu"
    assert am_envelope.KERNEL.source == _build.CSRC / "am_envelope.cu"
    for name in ("agc_linear", "affine_prefix", "am_envelope"):
        assert '#include "affine.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()


def test_build_digest_covers_the_shared_affine_header(tmp_path, monkeypatch):
    """An edited ``affine.cuh`` renames the three libraries that include
    it."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_text(f.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    kernels = [_build.Kernel(name, {}) for name in ("agc_linear",
                                                    "affine_prefix",
                                                    "am_envelope")]
    for k in kernels:
        k.source = tmp_path / f"{k.name}.cu"
    before = [k.library_path() for k in kernels]
    header = tmp_path / "affine.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(k.library_path() != b for k, b in zip(kernels, before))
