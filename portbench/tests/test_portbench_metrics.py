"""The per-layer readers over a made-up profiled window: what each counts,
and that a reader that finds nothing returns nothing."""

import pytest

from portbench import run, timing

PORT = {"u8_front_demod_kernel", "resample_kernel", "fir1_kernel",
        "power_kernel", "cascade_kernel", "prefix_warp_kernel",
        "branch_dft_kernel", "reduce_kernel"}
K1 = "void (anonymous namespace)::u8_front_demod_kernel<4, false>(...)"


def record(device, calls=2, window=(0.0, 100.0), traffic=None, cfg=None):
    cell = run.Cell("fm_broadcast.mono")
    return {"profile": {"calls": calls, "device": sorted(
                device, key=lambda r: r[1]), "host": [("wait", 40.0, 50.0)],
                        "window": window},
            "enqueue_ms": [0.1, 0.3, 0.2], "kernel_count": {K1: 2, "x": 12},
            "port_kernels": PORT,
            "geometry": {"bytes_in": 335_544_320, "bytes_out": 25_165_824,
                         "traffic": traffic or cell.traffic,
                         "config": cfg or cell.cfg}}


DEVICE = [(K1, 0.0, 30.0), ("Memcpy DtoD (Device -> Device)", 30.0, 32.0),
          ("void at::native::reduce_kernel<512, 1>(...)", 32.0, 35.0),
          ("void (anonymous namespace)::fir1_kernel(...)", 35.0, 40.0),
          ("ncclDevKernel_AllGather_RING_LL(...)", 50.0, 54.0),
          (K1, 60.0, 90.0)]


def read(name, rec):
    return run.load_module("metrics", name).read(rec)


def test_glue_counts_neither_the_ports_kernels_nor_nccl():
    # the copy and at::native's reduce_kernel (a port name too), per call
    assert read("glue_ms", record(DEVICE)) == pytest.approx(5e-3 / 2)
    assert read("collective_ms", record(DEVICE)) == pytest.approx(4e-3 / 2)
    assert read("collective_ms", record(DEVICE[:4])) is None


def test_busy_idle_and_the_kernel_count():
    rec = record(DEVICE)
    busy = timing.busy_us(rec["profile"]["device"], 0.0, 100.0)
    assert busy == 30 + 2 + 3 + 5 + 4 + 30
    assert read("idle_share", rec) == pytest.approx(100 - busy)
    assert timing.idle_gaps(rec["profile"]["device"], 0.0, 100.0) == [
        (40.0, 50.0), (54.0, 60.0), (90.0, 100.0)]
    assert read("kernels_per_call", rec) == 14.0
    assert read("enqueue_ms", rec) == pytest.approx(0.2)


def test_roofline_shares_divide_the_least_time_by_the_device_time():
    rec = record(DEVICE)
    per_call_s = 30e-6                     # K1: 60 us over 2 calls
    n_out = 335_544_320 // 16
    least = (335_544_320 + 4 * n_out) / 3.35e12
    assert read("front_demod_roofline", rec) == pytest.approx(
        100 * least / per_call_s)
    busy_s = 74e-6 / 2
    assert read("call_roofline", rec) == pytest.approx(
        100 * (335_544_320 + 25_165_824) / 3.35e12 / busy_s)
    assert read("front_demod_roofline", record(DEVICE[1:5])) is None


def test_the_stereo_stage_runs_from_its_power_to_its_cascade_kernel():
    stereo = run.Cell("fm_broadcast.stereo")
    dev = [("void (anonymous namespace)::power_kernel(...)", 0.0, 10.0),
           ("void (anonymous namespace)::prefix_warp_kernel(...)", 10.0, 11.0),
           ("void (anonymous namespace)::power_kernel(...)", 11.0, 21.0),
           ("Memset (Device)", 21.0, 22.0),
           ("void (anonymous namespace)::cascade_kernel(...)", 22.0, 52.0),
           ("void (anonymous namespace)::prefix_warp_kernel(...)", 60.0, 61.0)]
    rec = record(dev, calls=1, traffic=stereo.traffic, cfg=stereo.cfg)
    n_c = 335_544_320 // 16
    least = max(12 * n_c / 3.35e12, (5 * 2 * 65 + 13) * n_c / 67e12)
    assert read("stereo_decode_roofline", rec) == pytest.approx(
        100 * least / 51e-6)
