"""The benchmark's AM airband configuration (``portbench/configs/
am_airband.json``, cell ``am_airband.bulk``) on the CPU at small sizes:

* its plain float64 reference (``portbench/reference/am_airband.py``)
  against the port's plain CPU ``am_chain`` run block-parallel across
  eleven seams, with a key-up and a key-down on seams and interferers on,
  and the same reference in bfloat16 (the control) coming out not
  correct;
* the reference against per-sample float64 loops of every stage, so the
  chunked closed form of ``agcPipe`` is held to the literal recurrence;
* the reference's premise check firing on a stream that breaks it;
* the signal's seam anchors, raster, levels and clipping guard;
* the two per-layer readers on made-up device records, split at each
  call's first K12 launch, with their arithmetic written out."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, timing
from portbench.reference import am_airband as ref_mod
from portbench.signals import am_airband as sig
from sdr_tpu_torch.parallel.sharded import compile_time_batched

ROOT = Path(run.__file__).resolve().parent
CELL = "am_airband.bulk"
# 12 blocks of 20,480 samples (16 ms of air): keying scaled so that every
# anchor falls inside the recording
SMALL = {"blocks": 12, "block_bytes": 40_960,
         "keying": "bursts 0.003-0.02 s, gaps 0.003-0.02 s"}
SEEDS = [2_147_483_659, 7, 123_456_789_012]
FS = 1_280_000


def small_cell(**extra):
    cell = run.Cell(CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(SMALL, **extra)
    return cell


def anchors(spans, block, total):
    """(key-ups on a seam, key-downs on a seam, blocks wholly unkeyed)."""
    ups = [s for s, _ in spans if 0 < s < total and s % block == 0]
    downs = [e for _, e in spans if 0 < e < total and e % block == 0]
    key = np.zeros(total, dtype=bool)
    for s, e in spans:
        key[s:min(e, total)] = True
    dark = [b for b in range(total // block)
            if not key[b * block:(b + 1) * block].any()]
    return ups, downs, dark


def program(cell, seed):
    x = cell.make_input(seed, device="cpu")
    call = compile_time_batched(cell.build("cpu"), x,
                                cell.traffic["blocks"], device="cpu")
    call()
    return x, call().clone()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_agrees_with_the_ports_plain_am_chain(seed):
    cell = small_cell()
    block = cell.block // 2
    total = cell.traffic["blocks"] * block
    carriers = sig.stations(cell.traffic, cell.cfg, seed)
    ups, downs, dark = anchors(carriers[0]["keying"], block, total)
    assert ups and downs and dark
    on = [anchors(c["keying"], block, total) for c in carriers[1:]]
    assert any(len(d) < cell.traffic["blocks"] for _, _, d in on)
    x, y = program(cell, seed)
    ref = cell.expected(seed, x)
    assert y.shape == ref.shape == (total // 16,)
    g = run.gap(y, ref)
    assert g < 1e-5, g
    assert g < cell.spec["limits"]["out_gap"]


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
def test_a_broken_timed_path_comes_out_not_correct(fault, monkeypatch):
    """Every block's filter and DC blocker from rest (the state carried
    across the seams left out), half of the blocks left out, or one
    output altered by 1 % of the peak where it is produced."""
    from sdr_tpu_torch.stream import ops as stream_ops
    cell = small_cell()
    if fault == "state":
        def halo(xb, h, fill=0, group=None):
            return torch.full(xb.shape[:-1] + (h,), fill, dtype=xb.dtype)
        monkeypatch.setattr(stream_ops, "left_halo", halo)
    x, y = program(cell, SEEDS[0])
    if fault == "half":
        y[y.shape[-1] // 2:] = 0
    elif fault == "answer":
        y[y.numel() // 3] += 0.01 * float(y.abs().max())
    g = run.gap(y, cell.expected(SEEDS[0], x))
    assert g > cell.spec["limits"]["out_gap"], (fault, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_comes_out_not_correct(seed):
    cell = small_cell()
    x = cell.make_input(seed, device="cpu")
    ref = cell.expected(seed, x)
    low = cell.expected(seed, x, dtype=torch.bfloat16)
    line, checks = run.combine(cell, [{
        "rank": 0, "calls": 1, "t0": 0.0, "t1": 1.0, "t_first": 0.0,
        "spans_ms": [1.0], "peak_bytes": 0, "kind": "cpu",
        "gaps": {"0": run.gap(low, ref)}}], False, 0.0)
    assert line["correct"] is False
    assert checks["out_gap"]["value"] > 10 * checks["out_gap"]["limit"]


def _loops(raw: np.ndarray, cfg: dict) -> np.ndarray:
    """The receiver sample by sample in float64: the literal recurrences
    of ``agcPipe`` and the DC blocker."""
    v = (raw.astype(np.float64) - 128) / 128
    z = (v[0::2] + 1j * v[1::2]) * (-1j) ** np.arange(v.size // 2)
    cf = cfg["channel_filter"]
    h = ref_mod.taps(cfg).astype(np.float64)
    K, f = len(h), cf["factor"]
    zp = np.concatenate([np.zeros(K - f, complex), z])
    d = np.array([np.dot(h, zp[g * f:g * f + K])
                  for g in range(z.size // f)])
    spec = cfg["agc"]
    g, env = spec["initial"], np.empty(d.size)
    for n, s in enumerate(d):
        y = g * s
        env[n] = abs(y)
        g = g + spec["mu"] * (spec["reference"] - abs(y))
    alpha = cfg["dc_blocker"]["alpha"]
    out, px, py = np.empty(env.size), 0.0, 0.0
    for n, e in enumerate(env):
        py = e - px + alpha * py
        px = e
        out[n] = py
    return out * cfg["volume"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_reference_is_the_per_sample_recurrences(seed):
    """The whole reference against loops over samples (the chunked closed
    form crosses several of its 1,024-sample chunks here)."""
    cell = small_cell(blocks=12)
    x = cell.make_input(seed, device="cpu")
    got = cell.reference.run(cell.cfg, cell.programme, x, cell.block)
    want = _loops(x.numpy(), cell.cfg)
    assert got.shape[-1] > 4 * ref_mod.CHUNK
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-12, err


def test_the_agc_closed_form_is_the_literal_recurrence():
    """Gains over an envelope that holds still, drops to noise and jumps
    (a key-up), across chunks, against the loop."""
    rng = np.random.default_rng(5)
    m = np.concatenate([0.3 + 0.1 * rng.random(3000),
                        0.004 * rng.random(2500),
                        0.6 * rng.random(1700)])
    got = ref_mod.agc_gains(torch.from_numpy(m), 0.005, 1.0, 1.0).numpy()
    g, want = 1.0, np.empty(m.size)
    for n, e in enumerate(m):
        want[n] = g
        g = g + 0.005 * (1.0 - abs(e * g))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    assert got.max() > 5 * got[:3000].max()      # the gain climbed


@pytest.mark.parametrize("peak", [200.0, 250.0, 1e4])
def test_the_reference_refuses_a_broken_premise(peak):
    m = torch.full((3000,), 0.5, dtype=torch.float64)
    m[1500] = peak                  # mu * |x| >= 1 at one sample
    with pytest.raises(ValueError, match="premise|closed form"):
        ref_mod.agc_gains(m, 0.005, 1.0, 1.0)
    ref_mod.agc_gains(m[:1500], 0.005, 1.0, 1.0)


@pytest.mark.parametrize("seed", [1, 2, 3, 2_147_483_659, 987_654_321_987])
def test_the_cells_keying_raster_and_levels(seed):
    cell = run.Cell(CELL)
    tr = cell.traffic
    block = tr["block_bytes"] // 2
    total = tr["blocks"] * block
    carriers = sig.stations(tr, cell.cfg, seed)
    ups, downs, dark = anchors(carriers[0]["keying"], block, total)
    assert ups and downs and dark
    (b_lo, b_hi), (g_lo, g_hi) = sig._keying_spec(tr["keying"], FS)
    for c in carriers:
        spans = c["keying"]
        for (s, e), nxt in zip(spans, spans[1:] + [None]):
            assert b_lo <= e - s <= b_hi
            if nxt is not None:
                assert g_lo <= nxt[0] - e <= g_hi
    wanted = carriers[0]
    assert wanted["freq"] == sig.WANTED and wanted["amp"] == 0.3
    assert 0.3 <= wanted["depth"] <= 0.9
    assert len(wanted["programme"][0]) == tr["tones"] + tr["band"]
    assert np.all((wanted["programme"][1] >= 300)
                  & (wanted["programme"][1] <= 3000))
    assert len(carriers) == 1 + tr["interferers"]
    for c in carriers[1:]:
        off = float(c["freq"] - sig.WANTED) * FS
        assert abs(off) >= 100_000 and off % 25_000 == 0
        assert abs(float(c["freq"])) <= 0.45
        assert 0.02 <= c["amp"] <= 0.04 and 0 <= c["depth"] <= 0.5
    worst = sum(c["amp"] * (1 + c["depth"]) for c in carriers) \
        + 4 * tr["noise"]
    assert worst <= sig.FULL_SCALE


def test_a_ranks_span_is_its_part_of_the_joined_recording():
    """Noise off: rank 1 of 2 makes the second half of one recording of
    twice the blocks, sample for sample."""
    cell = small_cell(noise=0.0)
    joined = small_cell(noise=0.0, blocks=2 * SMALL["blocks"])
    part = cell.make_input(SEEDS[0], 1, 2, "cpu")
    whole = joined.make_input(SEEDS[0], device="cpu")
    assert torch.equal(part, whole[whole.numel() // 2:])


def test_the_signal_refuses_to_clip_and_blocks_too_long():
    with pytest.raises(ValueError, match="clip"):
        small_cell(amplitude=0.7).make_input(SEEDS[0], device="cpu")
    with pytest.raises(ValueError, match="longer than"):
        small_cell(block_bytes=2 * 40_960).make_input(SEEDS[0], device="cpu")
    raw = small_cell().make_input(SEEDS[0], device="cpu")
    assert raw.dtype == torch.uint8 and 0 < int(raw.min()) and \
        int(raw.max()) < 255


# -- the two readers ------------------------------------------------------

PORT = timing.port_kernel_names(ROOT.parent / "sdr_tpu_torch" / "csrc")


def _k(name):
    return f"void (anonymous namespace)::{name}<float>(...)"


# one call: the front (K10, K8, the halo copy, K3), then the back (K12,
# K15, K12, K16, the DC blocker's halo copy, K13, K15, K13, the volume)
CALL = [(_k("iq_planar_kernel"), 58.0), (_k("mix_planar_kernel"), 94.0),
        ("Memcpy DtoD (Device -> Device)", 2.0), (_k("fird_kernel"), 54.0),
        (_k("reduce_kernel"), 4.5), (_k("prefix_warp_kernel"), 0.5),
        (_k("scan_kernel"), 11.0), (_k("envelope_kernel"), 4.0),
        ("Memcpy DtoD (Device -> Device)", 1.0), (_k("section_kernel"), 3.0),
        (_k("prefix_warp_kernel"), 0.5), (_k("section_kernel"), 6.0),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 2.0)]
FRONT_US, BACK_US = 208.0, 32.5


def _record(calls=2, device=None):
    cell = run.Cell(CELL)
    if device is None:
        device, t = [], 10.0
        for _ in range(calls):
            for name, us in CALL:
                device.append((name, t, t + us))
                t += us + 1.0
    return {"profile": {"calls": calls, "device": device,
                        "host": [], "window": (0.0, 1e6)},
            "port_kernels": PORT,
            "geometry": {"traffic": cell.traffic, "config": cell.cfg}}


def _read(name, rec):
    return run.load_module("metrics", name).read(rec)


def test_the_readers_split_each_call_at_its_first_k12_launch():
    front = run.load_module("metrics", "am_front_roofline")
    assert front.split(_record()) == (2 * FRONT_US, 2 * BACK_US)
    # PyTorch's own reduce_kernel opens nothing
    torch_reduce = [("void at::native::reduce_kernel<512, 1>(...)", 0.0,
                     5.0)] + [(n, s + 10, e + 10) for n, s, e in
                              _record(1)["profile"]["device"]]
    assert front.split(_record(1, torch_reduce)) == (FRONT_US + 5.0,
                                                    BACK_US)
    # a record cut by the window's edge is left out
    rec = _record()
    rec["profile"]["window"] = (11.0, 1e6)
    assert front.split(rec) == (2 * FRONT_US - 58.0, 2 * BACK_US)
    no_back = [(n, s, e) for n, s, e in _record()["profile"]["device"]
               if "reduce" not in n and "scan" not in n]
    assert front.split(_record(2, no_back)) is None
    assert _read("am_front_roofline", _record(2, no_back)) is None
    assert _read("am_back_roofline", _record(2, no_back)) is None


def test_the_readers_arithmetic():
    # 32 blocks of 10,485,760 bytes: 335,544,320 bytes, 167,772,160
    # complex samples, 10,485,760 outputs after the decimate-by-16
    front_bytes = 335_544_320 + 8 * 10_485_760          # 419,430,400
    front_ops = 6 * 167_772_160 + 2 * 64 * 2 * 10_485_760
    assert front_bytes / 3.35e12 == pytest.approx(1.2520310e-4)
    assert front_ops / 67e12 == pytest.approx(5.5087e-5, rel=1e-4)
    back_bytes = 12 * 10_485_760                         # 125,829,120
    assert back_bytes / 3.35e12 == pytest.approx(3.7561e-5, rel=1e-4)
    assert 18 * 10_485_760 / 67e12 < back_bytes / 3.35e12
    rec = _record()
    assert _read("am_front_roofline", rec) == pytest.approx(
        100 * 1.2520310e-4 / (FRONT_US * 1e-6))
    assert _read("am_back_roofline", rec) == pytest.approx(
        100 * back_bytes / 3.35e12 / (BACK_US * 1e-6))


def test_the_cell_lists_both_readers():
    spec = json.loads((ROOT / "workloads" / f"{CELL}.json").read_text())
    assert {"am_front_roofline", "am_back_roofline"} <= set(spec["metrics"])
    assert spec["chips"] == 1 and spec["limits"]["out_gap"] == 3e-3
