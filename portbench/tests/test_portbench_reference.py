"""The plain references against the port's plain CPU path at small sizes,
the control (a reference in bfloat16 in the program's place), and a run
with the timed path broken underneath: each must come out not correct.

The runs here are the benchmark's own steps (recording from the seed, the
cell's chain compiled, its output held against the reference by
``run.combine``) with the search for a card and the timing left out, at
4 blocks of a few thousand samples instead of 32 of millions."""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run

SMALL = {"fm_broadcast.mono": {"blocks": 4, "block_bytes": 64_000},
         "fm_broadcast.stereo": {"blocks": 4, "block_bytes": 64_000,
                                 "mono_blocks": 1},
         "channelizer_64.wideband": {"blocks": 4, "block_len": 204_800},
         "fm_broadcast.mono_x4": {"blocks": 4, "block_bytes": 64_000,
                                  "halo": 64_000}}
ONE_CARD = [c for c in SMALL if not c.endswith("_x4")]
SEED = 2_147_483_659            # past 32 signed bits


def small_cell(name):
    cell = run.Cell(name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(SMALL[name])
    return cell


def rank_record(gaps):
    return {"rank": 0, "calls": 2, "t0": 0.0, "t1": 1.0, "t_first": 0.0,
            "spans_ms": [1.0, 1.0], "peak_bytes": 0, "kind": "cpu",
            "gaps": {str(i): g for i, g in enumerate(gaps)}}


def judged(cell, gaps):
    line, checks = run.combine(cell, [rank_record(gaps)], False, 0.0)
    return line["correct"], checks["out_gap"]["value"]


def program_output(cell, seed, fault=None, monkeypatch=None):
    """The cell's compiled call on the CPU over the seed's recording, its
    second call's output; ``fault`` breaks the timed path underneath."""
    from sdr_tpu_torch.parallel.sharded import compile_time_batched
    from sdr_tpu_torch.stream import ops as stream_ops
    if fault == "state":
        # every block enters from rest: the state carried across the
        # block seams is left unchanged
        def halo(xb, h, fill=0, group=None):
            return torch.full(xb.shape[:-1] + (h,), fill, dtype=xb.dtype)
        monkeypatch.setattr(stream_ops, "left_halo", halo)
    x = cell.make_input(seed, device="cpu")
    call = compile_time_batched(cell.build("cpu"), x,
                                cell.traffic["blocks"], device="cpu")
    call()
    y = call().clone()
    if fault == "half":         # half of the blocks left out
        y[..., y.shape[-1] // 2:] = 0
    elif fault == "answer":     # one output altered where it is produced
        y.view(-1)[y.numel() // 3] += 0.01 * float(y.abs().max())
    return x, y


@pytest.mark.parametrize("name", ONE_CARD)
def test_the_reference_agrees_with_the_ports_plain_path(name):
    cell = small_cell(name)
    x, y = program_output(cell, SEED)
    ref = cell.expected(SEED, x)
    correct, g = judged(cell, [run.gap(y, ref)])
    assert correct and g < 1e-5, g


@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_comes_out_not_correct(name):
    cell = small_cell(name)
    rank = 1 if name.endswith("_x4") else 0
    x = cell.make_input(SEED, rank, cell.chips, "cpu")
    ref = cell.expected(SEED, x, rank, cell.chips)
    low = cell.expected(SEED, x, rank, cell.chips, torch.bfloat16)
    correct, g = judged(cell, [run.gap(low, ref)])
    assert not correct and g > 3e-3, g


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_broken_timed_path_comes_out_not_correct(name, fault,
                                                   monkeypatch):
    cell = small_cell(name)
    x, y = program_output(cell, SEED, fault, monkeypatch)
    correct, g = judged(cell, [run.gap(y, cell.expected(SEED, x))])
    assert not correct, (fault, g)


def test_a_ranks_reference_is_its_span_of_the_joined_stream():
    cell = small_cell("fm_broadcast.mono_x4")
    xs = [cell.make_input(SEED, r, 4, "cpu") for r in range(4)]
    whole = cell.reference.run(cell.cfg, cell.programme, torch.cat(xs),
                               cell.block)
    n = whole.shape[-1] // 4
    for r in range(4):
        got = cell.expected(SEED, xs[r], r, 4)
        assert torch.equal(got, whole[..., r * n:(r + 1) * n]) or \
            run.gap(got, whole[..., r * n:(r + 1) * n]) < 1e-12, r


WORKER = Path(__file__).with_name("sharded_worker.py")


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_the_sharded_cell_over_four_cpu_ranks(tmp_path, fault):
    """Four gloo ranks on the CPU run the sharded cell's compiled call
    (``compile_time_sharded``); with the exchange between ranks left out
    (each rank's first block from rest) it comes out not correct."""
    env = dict(os.environ, PYTHONPATH=str(Path(run.ROOT).parent),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(tmp_path), str(SEED),
         json.dumps(SMALL["fm_broadcast.mono_x4"]), fault or "none"],
        env=env) for r in range(4)]
    for p in procs:
        assert p.wait(timeout=600) == 0
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text())["gap"]
            for r in range(4)]
    cell = small_cell("fm_broadcast.mono_x4")
    correct, g = judged(cell, gaps)
    assert correct is (fault is None), gaps


@pytest.mark.chip
def test_a_cell_runs_on_the_card(card):
    """A short run of the first cell at its full size (the card only)."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "fm_broadcast.mono", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=Path(run.ROOT).parent, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
