#!/usr/bin/env python3
"""Drive sdr_tpu_torch's FM, AM, waterfall, channelizer and transmitter
paths, their sharded forms and the FM receiver's live input, on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --s1-tree DIR [--s1-backend nccl]

The second form times only phase 11's NCCL world-1 calls of the port in
another checkout ``DIR`` (e.g. the parent commit's, unpacked with ``git
archive``) over the given process-group backend, to compare two trees'
spans on one card in one run.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It builds the CUDA kernels K1-K16 from ``sdr_tpu_torch/csrc`` (one
nvcc per source, all at once), then:

1. prints the toolchain and the card's name and power limit, and
   measures the card's ceilings (``measure_ceilings``: the probes of
   ``csrc/ceilings.cu``, built with the kernels; device memory, f32, int8,
   the SM clock and the instruction latencies of K6's step, each rate at
   most 1.05 times the data sheet's), which the FMA and no-FMA floors, K6's
   latency bound and phase 14 read;
2. the mono path, ``fm_chain()`` (K1, K2, K3): holds each kernel against
   its plain PyTorch version on the card at the path's shapes (32 rows of
   10,485,760 u8 bytes -> 655,360 demod samples -> 196,671 resampled ->
   196,608 audio samples per row) and at extra geometries (all three
   bitwise: row bases off 16-byte alignment, histories of 86, 2 and 30
   bytes, f in {1, 4, 8} and K in {16, 51, 63} with s8 and s16 taps for
   K1; I/D in {3/10, 2/3, 5/4} and the transmitter's 10/3 and 8/1 with
   every offset, starts 0, 37 and 5 and
   histories of 5, 86 and 12,000 floats for K2; f in {1, 2, 3, 4, 5, 8,
   16}, K in {1, 51, 64, 65, 200}, starts 0 to 7 and one output below and
   above a tile multiple for K3; the most outputs a stream holds, reads
   past its end, outputs not a multiple of the tiles, and 1) and
   times the kernel (device
   time of back-to-back launches), the plain version and, where one
   PyTorch call computes the same function, that call (``library_ms``,
   timed only; for K1's decimation and K4 a grouped ``conv1d`` over the
   (u8 - 128) planes); each row carries ``bound_fraction`` (bound / time)
   and K2's, K3's and K5's printouts their no-FMA instruction floors
   (computed, not measured); checks that K2, K3 and K5 raise for tables
   or taps that do not fit their shared memory and run at the most that
   do, and that K3 runs on both sides of its switch from the staged
   f > 1 branch to one thread an output (found from the kernel's own
   plan, printed); runs the block-parallel chain
   (``run_time_batched``) on a synthetic 1 kHz broadcast with every
   launch counter set to 0 just before one call, checks the tone, the
   launch counts and agreement with the plain CPU run on a small input,
   times 20 more calls by CUDA events (median, min and max) and 5 calls
   each queued behind a device-side sleep (the device's time without host
   gaps, and the host's time to enqueue a call), and checks
   that the streamed ``Pipeline.run`` at 1,310,720-byte blocks gives the
   same samples; runs the CLI;
3. the stereo path, ``fm_chain(front='quantized', stereo=True,
   deemphasis=75e-6)`` (K4, FmDemod, StereoDecode on K14, K2 -> K3 over
   the L/R planes, the de-emphasis IIR, the volume) on a synthetic stereo
   broadcast (L = 1 kHz, R = 400 Hz, a 10 % pilot, 75 kHz deviation) at
   the same 32 x 10,485,760 bytes: K4 (bitwise, K1's geometries plus byte
   offsets 0, 1 and 10 and leading dims [B, C]) and K5 (bitwise, K2's
   geometries with 64 and 33 FIR taps) against their plain versions; K11
   over K4's [32, 2, 655,360] planes with the halo's carries and seeded
   ones, the polynomial bitwise and atan2f bitwise its plain
   ``torch.atan2`` (or within an ulp of pi, recorded), and at 540 extra
   geometries in its three forms (n in {0, 1, 7, 8, 9, 1,023, 1,025,
   2,053, 65,537}, leading dims [], [3], [2, 3], bases 0-3 floats or 0-1
   complex samples off 16-byte alignment, zero and random carries; the
   complex form within 2e-6 rad of angular distance), timed beside
   ``torch.angle`` on the product made beforehand and ``fast_atan2``
   alone; K14 over the composite [32, 655,360] with the history its
   ``shard_carry`` gives: launch A as ``shard_carry`` runs it (a, b) and as
   ``apply`` runs it (the lock from the path's entering lock, writing the
   squared pilot) and launch B gated by that lock from that sq, all
   bitwise their plain versions (the lock and r's decisions included;
   the plain versions take each FMA exactly), two launches of each
   bitwise equal, and at 378 extra geometries (n in {1, 100, 191, 2,944,
   3,001, 6,145} at rows [1], [3] and [2, 3], one streamed block of
   81,920; bases 0 and 1 float off 16-byte alignment; signals that lock,
   unlock and hold in the band from lock 0 and 1, each decision checked;
   without the pilot lock; and 36 with the history a view of the block
   before, as ``StereoDecode.apply`` carries it), timed (launch A within
   ``shard_carry`` and ``apply``, launch B, both, the op alone) beside
   its bound, its FMA floor (its FFMA, the boxcar's adds and the glue as
   one instruction each), the former design's recorded times (printed
   beside them, not in the kernels line) and a
   ``conv1d`` of the five filters over the composite (five output
   channels; a yardstick, not the same function); K2 over the [32, 2] L/R
   planes (bitwise), and the K2 -> K3 pair K5 replaces (``pair_ms``); K13
   as the
   de-emphasis ``Iir`` runs over the back half's [32, 2, 196,608] output,
   from the entering states its ``shard_carry`` gives and from seeded
   ones, within 1e-5 of each row's peak |y| of its plain version (the
   worst row printed), its final-state launch bitwise the full launch's
   state, timed beside ``torch.cumsum`` over the same rows (a one-pass
   scan, not the same function); K15 as ``StereoDecode``'s and the
   de-emphasis ``Iir``'s ``shard_carry`` launch it (the lock's scalar
   prefixes and state over [32] rows, the IIR's order-2 prefixes over
   [32, 2]; see phase 5); the block-parallel chain with the
   counters read around one call ({u8_front: 1, fir: 1, resample: 1,
   fm_demod: 1, iir: 2, stereo_decode: 3, affine_prefix: 2}), its L/R
   separation, the
   pilot lock of every row, 20 timed calls and peak memory; the same chain
   with ``ResampleFirScale(fused=True)`` (K5; {u8_front: 1, backhalf: 1,
   fm_demod: 1, iir: 2, stereo_decode: 3, affine_prefix: 2}) against it;
   the streamed run
   (K4, K11 and K13 once a block, K14 twice) against the block-parallel
   one and the plain CPU
   chain; and the stereo CLI;
4. the exact mono path, ``fm_chain(front='exact')`` (the complex f32
   front the JAX package runs off a TPU: IqConvertU8 on K10, the 51-tap
   decimate-by-8 ``Fir`` on K3's complex form, which reads the complex
   batch in place, split at the seam into one output, the complex demod
   on K11, K2 -> K3)
   on the mono broadcast: K10 at [32, 10,485,760] u8 -> planar f32 and
   complex64, and seeded int16 of the same shape both ways, bitwise its
   plain version, and at 1,152 extra geometries (n in {0, 1, 7, 8, 9,
   2,047, 2,049, 65,537} pairs, leading dims [], [3], [2, 3], bases 0-15
   bytes or 0-7 int16 off 16-byte alignment), timed beside the cast
   ``x.to(float32)`` alone; K3's complex form at f = 8 over the [32,
   5,242,880] rows (the seam launch into ``y[..., :mb]``, the main one
   into ``y[..., mb:]``, each bitwise its plain version and the planar
   route it replaced: planes, the real form, ``torch.complex``; two
   launches bitwise equal), timed beside its plain version, that planar
   route, the real form alone and a grouped ``conv1d`` over
   ``view_as_real`` (groups 2; its reshape's copy included), and at 790
   extra geometries (rows at f in {1, 2, 3, 8, 16} x K in {1, 7, 51, 64,
   200}, bases 0 and 2 floats off 16-byte alignment, starts, outputs
   around a tile multiple, strided rows, ``out=`` rows; channel-major at
   C in {1, 5, 31, 32, 33, 64, 100} x f in {1, 2, 8, 16}; 70,000 rows
   and 66,000 channel rows past the grid), both sides of each staged
   branch's switch and 58,112 taps (58,113 raising); K11 complex at
   [32, 655,360] within 2e-6
   rad of its plain version (the largest distance and the samples that
   differ printed); the block-parallel chain (launches {fir: 3, resample:
   1, iq_convert: 1, fm_demod: 1}, no complex block copied to another
   layout before K3, the tone, peak memory, 20 timed
   calls), the streamed run (equal; K10 and K11 once a block), the plain
   CPU chain and the fused mono chain; ``planar=True``,
   ``fuse_back=False`` and the FIR de-emphasis at 4 blocks against the
   plain CPU chain; and the CLI with ``--front exact``;
5. the AM path, ``am_chain()`` (planar: convert, Mix on K8, the 64-tap
   decimate-by-16 channel ``Fir`` on K3, Agc, AmDemod, DcBlocker, volume)
   on a synthetic AM carrier at 0.25 cycles/sample carrying a 500 Hz
   tone: K8 bitwise against its plain version at [32, 2, 5,242,880] with
   a seeded phasor a row and at 48 extra geometries (n not a multiple of
   4, bases 0-3 floats off 16-byte alignment, leading dims [3] and [2,
   3]), timed with its bound (no library call computes it); K3 at f = 16
   (bitwise) with its ``conv1d`` yardstick; K12 over the channel
   filter's [32, 2, 327,680] planes in both modes (the reduce of
   ``Agc.shard_carry``, the scan of ``Agc.apply`` from the path's and
   from seeded entering gains) and over the complex form's envelopes
   ``|x|``, bitwise its plain version, and at 156 extra geometries (rows
   1-5 and 32, n in {0, 1, 2, 127, 128, 129, 255} and 2*128*k +- 1 for k
   in {1, 4, 20}, bases 0-3 floats off 16-byte alignment, seeded gains,
   ``mu*|x|`` typical and near 1); K13 as the ``DcBlocker`` runs over the
   envelope [32, 327,680], within 1e-5 of each row's peak, and at 236
   extra geometries (the DC blocker's, a de-emphasis and an a_2 != 0
   section at rows 1-5 and 32, n in {0, 1, 2, 31, 32, 33, 4,095, 4,096,
   4,097} and 2*4,096*k +- 1 for k in {1, 3}, misaligned bases, seeded
   entering inputs and states; a two-section ``Iir`` streamed and
   block-parallel against the CPU); each timed with its bound beside
   ``torch.cumsum``; K15 as ``Agc.shard_carry`` (the prefixes and the
   state ``A * g0 + B``) and ``DcBlocker.shard_carry`` (alpha^n read at a
   row stride of 0) launch it over [32] rows: each launch's outputs
   (prefixes, states from the op's and a seeded state, total; with and
   without 3 maps composed before) bitwise its plain version, two
   launches equal, the scalar form bitwise the parent's eager doubling
   and epilogue (the stereo IIR's order-2 form within 1e-6 of a lane's
   peak of the parent's cuBLAS composition), each op's device kernels by
   ``torch.profiler`` (its K15 launches and no elementwise multiply or
   add: no eager doubling), and at 200 extra geometries (B in {1, 2, 3,
   31, 32, 33, 64, 1,000} x lanes [1], [2], [3], [128], [64, 2] x the
   scalar form and p in {1, 2, 3, 4}, with and without the state and the
   maps before, signed zeros, a row stride of 0), timed beside its plain
   version, the parent's composition and an empty launch
   (``torch.cuda._sleep(0)``; its bound is far below a launch); K16 over
   the gained planes [32, 2, 327,680] bitwise its plain version and
   compared with the parent's ``torch.sqrt(re**2 + im**2)``, and at 60
   extra geometries (n in {1, 3, 4, 5, 4,097} x bases 0-3 floats off
   16-byte alignment x leading dims [], [3], [2, 3]), timed with its bound
   beside ``torch.linalg.vector_norm(x, dim=-2)``; the block-parallel
   chain (launches {fir: 2, mix: 1, iq_convert: 1, agc_linear: 2, iir: 2,
   affine_prefix: 2, am_envelope: 1}, the tone at 80 kS/s, peak memory,
   20 timed calls), the streamed run at 1,048,576-byte blocks (K12, K13
   and K16 once a block, K15 never; within 1e-4) and the plain CPU
   chain; and ``apps.am``;
6. the AM path with the sequential AGC, ``am_chain(agc_approx=1)`` (the
   complex form; the 64-tap decimate-by-16 ``Fir`` on K3's complex form
   (its row as exact's, at [32, 5,242,880] -> 327,677), then K6 twice:
   one sweep for each row's entering gain, then the AGC itself) on the
   same capture: K8's complex form (the complex ``Mix``) bitwise
   against its plain version at [32, 5,242,880] complex64 with a seeded
   phasor a row and at 48 extra geometries (n not a multiple of 4, bases 0
   and 1 complex sample off 16-byte alignment, leading dims [3] and [2,
   3]), timed with its bound beside ``x * lo`` alone (one pass, not the
   same function); K6 bitwise against its plain version over the first
   4,096 samples of all 32 rows (card), two whole rows of 327,680 (their
   CPU copy) and the whole batch (card), with its bytes and latency
   bounds and the linear form's time beside it; the block-parallel chain
   (launches {fir: 2, agc_scan: 2, iq_convert: 1, iir: 2, mix: 1,
   affine_prefix: 1}, no layout copy before K3, the tone,
   peak memory, 20 timed calls), the streamed run at 1,048,576-byte
   blocks (K8 and K13 once a block; within 1e-3) and the linear complex
   chain (within 1e-4);
7. the transmitter, ``apps.fm_tx`` (10/3 and 8/1 ``Fir`` resamplers on
   K2, ``FmMod``) on a 60 s, 1 kHz WAV: K2 at both stages on a streamed
   block and on the whole recording as one block (bitwise, timed beside
   ``conv_transpose1d``); the CLI's entry point in this process (its
   compiled step running the first block eagerly, captured at the second
   and replayed 61 times; the eager block and the capture's calls
   launching K2 8 times), the chain streamed op by op (launches
   {resample: 124}) and the CLI as a command (its wall time, the same
   file); the streamed output against one block over the whole
   recording (the resampled stream bitwise, the modulated one within
   1e-3); and the round trip, its i16 IQ as u8 through ``fm_chain()``
   block-parallel in 32 blocks (K1, K2, K3): the tone within 5 Hz;
8. the waterfall path, ``waterfall_chain()`` (planar convert, then
   ``FftStream``: Blackman-windowed 1,024-point frames at hop 512 on K9,
   which frames, windows, transforms and writes ``|X|`` with the shift
   in one pass) on the mono broadcast: K9 at the path's [32, 2,
   5,242,880] planes with each row's carry and over the same samples as
   complex64, within 1e-5 of each frame's peak of its plain version
   (cuFFT; the max printed), the two forms bitwise equal, peak memory of
   a call of each beside the plain version's, a size outside its plan
   (96, 32,768) raising, and 85 extra geometries (sizes 64 to 16,384 x
   four hops, one odd, x histories 0 and size - hop, both forms, bases
   1-3 samples off 16-byte alignment, leading dims [3] and [2, 3],
   ``magnitude`` and ``shift`` on and off; a block of one frame's span),
   timed with its bound, cuFFT alone on frames made beforehand
   (``library_ms``) and ``torch.stft`` -> ``abs`` -> ``fftshift`` (three
   calls); then the chain: the rows' shape, the mean row's power inside
   Carson's band, launches {fft_stream: 1, iq_convert: 1}, the streamed
   run (K10 and K9 once a block) at the
   CLI's 1,048,576-byte blocks bitwise equal to the block-parallel call,
   the plain CPU chain on 4 blocks within 1e-5 of each frame's peak, 20
   timed calls and peak memory; the complex form,
   ``waterfall_chain(planar=False)`` (launches {fft_stream: 1,
   iq_convert: 1}), bitwise
   the planar rows and timed beside them;
9. the wideband channelizer, ``channelizer_chain(64, wideband=True)``
   (``Channelize``, its branch filter and DFT in one launch, K7 + DFT,
   then per channel the 51-tap
   decimate-by-8 ``Fir`` on K3, the complex demod, the 3/10 ``Fir``
   resampler on K2 and the 64-tap audio ``Fir`` on K3 at f = 1, the
   volume) on 32 blocks of 4,096,000 wideband samples carrying 64 FM
   stations made at the wideband rate: K7 at the bank's shape with each
   row's carry as history (max |diff| = 0: the plain version may differ
   in the sign of a zero) and at 194 extra geometries (C in {1, 8, 64,
   100} x P in {1, 5, 12, 16}, ``num`` one below and above its tile,
   histories 0 and (P - 1) C, bases 1-3 samples off 16-byte alignment;
   and at P = 12 the widest row that fits a block, C = 1,383, while
   1,384 raises from its plan), timed with its bound and a grouped
   ``conv1d`` yardstick; K7 + DFT at the bank's shape with the same
   histories within 1e-5 of each output row's peak of its plain version
   (K7's plain stencil, then cuFFT; the worst ratio printed), two
   launches bitwise equal, and at 40 extra geometries (C in {64, 128,
   256} x P in {1, 5, 12}, ``num`` one below and above its tile,
   histories 0 and (P - 1) C, bases 1-3 samples off 16-byte alignment,
   and C = 1,024 at P = 12; C = 2,048 at P = 12 and P = 20 at C = 1,024
   refused by the wrapper and by the launch's own plan, which equals
   ``dft_plan`` at each), timed with its bound and cuFFT alone over
   K7's ``v`` made beforehand; K3's
   complex form at f = 8 reading ``Channelize``'s channel-major [32, 64,
   64,000] view in place (seam and main, as for exact), K2 and K3 at f =
   1 (seam and main) bitwise against their plain versions at the bank's
   shapes, each timed with its bound and its ``conv1d`` yardstick, and
   K11 complex at [32, 64, 8,000] within 2e-6 rad; the launches of one
   call ({fir: 4, resample: 1, channelize: 1, fm_demod: 1}, the
   channelize one K7 + DFT; no layout copy before K3; no cuFFT kernel
   under ``torch.profiler``), every channel's tone inside the audio
   passband, the streamed run bitwise, the plain CPU chain on 4
   blocks within 1e-4, 20 timed calls (wideband complex input
   samples/s) and peak memory;
10. the narrowband channelizer, ``channelizer_chain(64)`` on [64,
   2,621,440] basebands (the CLI's synthetic formula) in 4 blocks: K3's
   complex form at f = 8 over the [4, 64, 655,360] rows (seam and main,
   as for exact), K2 and K3 at f = 1 (seam and main) bitwise
   against their plain versions at the [4, 64] batch the path gives them,
   each timed with its bound and its ``conv1d`` yardstick, and K11
   complex at [4, 64, 81,920] within 2e-6 rad; the launches ({fir: 4,
   resample: 1, fm_demod: 1}; no layout copy before K3),
   the tones, 4 blocks against 1 (the CLI's form) and the streamed run
   over [64, 655,360] blocks within 1e-6, the plain CPU chain within
   1e-5, 20 timed calls; then
   ``apps.channelizer --synthetic`` plain and ``--wideband`` (the WAVs'
   rates and lengths, the plain form's tones).  ``apps.waterfall`` writes
   its PNG through matplotlib, which the card's machine lacks; the CPU
   tests drive it;
11. the sharded paths (``sdr_tpu_torch.parallel``): ``run_time_sharded``
   over a one-rank NCCL group in this process (``cpu:gloo,cuda:nccl``, as
   ``init_distributed`` asks for it) at the paths' full width, the mono
   chain and the stereo chain with K5 (bitwise ``run_time_batched``, the
   same launches, the counted call under
   ``torch.cuda.set_sync_debug_mode('error')``: it never waits for the
   card; each span beside the one-process call's); four gloo ranks sharing
   the card, each reading its span of the recordings through
   ``host_block_iterator`` (``--shard-rank``: this script as a rank;
   each prints its launches and times): mono 8 blocks a rank (bitwise),
   stereo with both back halves (1e-5: the IIR and pilot prefixes
   compose in another order), the wideband bank (1e-4; K7, K3 and K2
   each launched on every rank), the narrowband
   bank channel-sharded 16 channels a rank and on a 2 x 2 grid
   (bitwise), ``am_chain()`` (1e-4: the AGC's and the DC blocker's
   affine prefixes compose across the ranks; K12 and K13 launched on
   every rank, and K13 and K14 in the stereo scenarios, K14 three times
   a rank and K3 once (none with K5)),
   ``am_chain(agc_approx=1)`` (K8's complex form once a rank; through the
   envelope bitwise,
   the R sweeps' gains crossing ranks; the whole chain 1e-4, its
   ``DcBlocker`` prefix); K15's group path on seeded maps of 32 rows in
   both forms (each rank's whole map by K15, gathered, then its prefixes
   and states after the ranks before: 2 launches a composition on every
   rank, each rank bitwise K15 and its plain version given the ranks
   before, within 1e-5 of a lane's peak of one process over all the
   rows; at NCCL world 1 bitwise one process), K15 launched twice a
   composition in every chain that composes (stereo 4, AM 4, AM
   sequential 2) and K16 once on AM; and the channelizer CLI under
   ``torchrun`` (four gloo ranks, ``--wideband``), its WAVs the
   one-process CLI's.  Each sharded call's median span and host time in
   the collectives, labelled as no scaling figure;
12. after phase 13, prints its own run time, ``{"kernels": [...]}``
   (every kernel with its launches on each path, the live ones included),
   the card line again, and last ``{"ok": true, "device": {...}}``;
13. the live path: ``python -m sdr_tpu_torch.apps.fm --in
   rtl_tcp://127.0.0.1:PORT --freq 90.2M --gain 496 --ppm 1`` as a
   command against this script's mock rtl_tcp server (the ``RTL0``
   header, tuner 5, 29 gains; it records the client's commands and sends
   32 blocks of 1,310,720 bytes of the synthetic broadcasts, 16.4 s of
   air, at 8x real time): rc 0, the commands, no dropped block, the WAV
   byte for byte the file CLI's on the same bytes, the tone; ``--batched
   8`` (the same WAV); the stereo chain (the file CLI's WAV, L/R
   separation); ``main`` in this process against an unpaced radio under
   the port's ``Timer`` (samples/s against real time, blocks dropped and
   launches: a figure, not a check) for mono, ``--batched 8`` and
   stereo, each through the compiled call ``prime`` captured at its
   second call on silence (one graph captured: checked; the replays
   printed), the launches those of ``prime``'s eager call and the
   capture's calls (K11, K13
   and the audio FIR launched as often as K4, and K14 twice as often:
   checked); the
   native loader (its g++ build time, ``--native`` giving
   the file CLI's WAV, ``native_file_source(repeat=True)`` the file twice
   over, 64 UDP datagrams of 65,440 bytes through ``fm_chain()`` on the
   card bitwise the same blocks from a file); ``Pipeline.scan`` over
   [8, 1,310,720] (bitwise ``Pipeline.run`` and the eager run, 8 replays
   of the step ``run`` captured and no launch from Python; the eager
   run's launches {u8_front_demod: 8, resample: 8, fir: 8}); ``Timer`` and ``timed`` reading at least the
   CUDA-event time of a block-parallel call queued behind a device-side
   sleep; and ``profile`` writing a trace;
14. the roofline, after phase 10, from the calls phases 2-10 already
   timed (no new timed call): for every block-parallel chain its median
   span, its device time (``queued_split``), ``chain_roofline``'s stage
   sum on the data sheet's and on this run's measured ceilings, the speed
   of light, the io floor (the first stage's input read and the last
   stage's output written, over the memory rate) and each floor's share
   of the device time; no chain's device time may be under its io floor
   (data sheet) divided by 1.05;
15. the compiled calls, after phase 14 (run before 11): for each of the
   ten block-parallel chains of phases 2-10 at their full width,
   ``compile_time_batched`` (a CUDA graph captured on a copy of the
   recording) replayed bitwise the eager ``run_time_batched`` on the
   recording, on a second recording (seed + 1) copied in (one input copy
   counted) and with seeded carries threaded through its static buffers
   (the carries bitwise too), one replay under
   ``torch.cuda.set_sync_debug_mode('error')``, both spans and both
   ``queued_split``s in turns (eager, compiled, compiled, eager), the
   capture's time, the device bytes an eager call and a replay allocate
   and the bytes the graph's pool holds, the device time of a recording
   on the card copied into the call's input, each chain's graphs freed
   before the next; the
   streamed ``Pipeline.run`` (the compiled step) over 8 blocks bitwise the
   eager run op by op on mono, stereo and AM, with one block's split
   eager and compiled, and the pipeline's pool freed as soon as the
   pipeline is dropped (the cyclic collector off); and a ``Map`` calling
   ``.item()`` refused at capture.  Launch counts stay on eager calls (a
   replay counts none): the streamed launch checks of phases 3-10 run op
   by op, and each of those phases then holds ``Pipeline.run`` (the
   first block eager, one capture, the other blocks replays) bitwise the
   eager stream (the exact variants: ``process``); a replay's device
   kernels, read by ``torch.profiler``, are the eager call's name for
   name and count for count (the wideband bank's K7 + DFT and no cuFFT
   kernel); phase 13's live runs, which replay the step ``prime``
   captured, report the graphs captured and replayed.

Every failed check raises, so any failure exits nonzero.  Without a CUDA
GPU it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import wave
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROWS, ROW_BYTES = 32, 10_485_760      # block-parallel batch (bench.py's)
STREAM_BLOCK = 1_310_720              # the CLI's default block
CHAIN_REPS = 20                       # timed block-parallel chain calls
SLEEP_CYCLES = 20_000_000             # ~10 ms: time_ms's queue head start
FS_IN = 1_280_000                     # complex S/s
F_L, F_R = 1_000.0, 400.0             # the stereo broadcast's L and R tones
F_AM, AM_IF = 500.0, 0.25             # the AM tone; carrier, cycles/sample
AM_BLOCK = 1_048_576                  # the AM CLI's default block
AM_RATE = FS_IN // 16                 # AM audio, S/s
WF_BLOCK = 1_048_576                  # the waterfall CLI's default block
WF_SIZE, WF_HOP = 1024, 512           # waterfall_chain()'s frames
CH_C = 64                             # channels of the FM bank
CH_BLOCK = 4_096_000                  # wideband samples a block (bench.py:307)
NB_SAMPLES, NB_BLOCKS = 2_621_440, 4  # narrowband samples a channel, blocks
TONE_CHANNELS = 49                    # tones 200 + 150 c Hz inside the audio
                                      # FIR's 7.5 kHz passband: c <= 48
AGC_PREFIX = 4_096                    # K6's samples checked on the card
IO_SLACK = 1.05                       # a chain under io floor / this fails
# this run's measured Ceilings ("measured"), set by main before any phase
CEILINGS = {}
# time_chain's records, one a timed block-parallel chain (phase 14)
CHAIN_TIMINGS = []
TX_SECONDS, TX_RATE, TX_TONE = 60, 48_000, 1_000.0   # the transmitter's WAV
TX_BLOCK = 46_080                     # fm_tx's default block
# the stereo chain, one call: K4, K11, K14 (launch A in StereoDecode's
# shard_carry, A and B in its apply), the back half (K2 -> K3's audio FIR,
# or K5 fused), K13 (the de-emphasis's final state and output)
STEREO_LAUNCHES = {"u8_front": 1, "fir": 1, "resample": 1, "fm_demod": 1,
                   "iir": 2, "stereo_decode": 3, "affine_prefix": 2}
STEREO_FUSED_LAUNCHES = {"u8_front": 1, "backhalf": 1, "fm_demod": 1,
                         "iir": 2, "stereo_decode": 3, "affine_prefix": 2}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events over ``reps`` calls after warm-up.
    The calls queue up behind a device-side sleep, so the events time the
    device's work back to back, not the host's enqueue (a wrapper's host
    time can exceed a short kernel's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type, on the H100 SXM data
    sheet's ceilings (utils/roofline.py)."""
    from sdr_tpu_torch.utils.roofline import DATASHEET, MEASURED_CEILINGS
    sheet = MEASURED_CEILINGS[DATASHEET]
    t_bytes = nbytes / sheet.hbm_bps * 1e3
    t_ops = ops / {"f32": sheet.f32_flops, "int8": sheet.int8_ops}[kind] \
        * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def synth_broadcast(n_bytes: int, seed: int, device) -> torch.Tensor:
    """u8 interleaved IQ of an FM broadcast carrying a 1 kHz tone at 75 kHz
    deviation, sampled at 1.28 MS/s, with seeded Gaussian noise."""
    n = n_bytes // 2
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / FS_IN
    phase = (75e3 / 1e3) * (1 - torch.cos(2 * np.pi * 1e3 * t))
    del t
    raw = torch.empty(2 * n, dtype=torch.uint8, device=device)
    for c, fn in ((0, torch.cos), (1, torch.sin)):
        v = 0.9 * fn(phase) + 0.01 * torch.randn(
            n, generator=g, dtype=torch.float64, device=device)
        raw[c::2] = torch.clamp(torch.round(v * 128 + 128), 0, 255).to(
            torch.uint8)
    return raw


def tone_hz(y: np.ndarray, rate: int = 48_000) -> float:
    seg = y[2000:2000 + (1 << 20)]
    return float(np.argmax(np.abs(np.fft.rfft(seg))) * rate / len(seg))


def synth_stereo_broadcast(n_bytes: int, seed: int, device) -> torch.Tensor:
    """u8 interleaved IQ of an FM stereo broadcast: the multiplex of
    tests/test_stereo.py (mono (L+R)/2, a 10 % pilot at 19 kHz, (L-R)/2 on
    38 kHz; L a 1 kHz tone, R a 400 Hz tone) at 75 kHz deviation, sampled
    at 1.28 MS/s, with seeded Gaussian noise."""
    n = n_bytes // 2
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / FS_IN
    left = torch.sin(2 * np.pi * F_L * t)
    right = torch.sin(2 * np.pi * F_R * t)
    comp = (0.25 * (left + right) + 0.1 * torch.cos(2 * np.pi * 19e3 * t)
            + 0.25 * (left - right) * torch.cos(2 * np.pi * 38e3 * t))
    del t, left, right
    phase = torch.cumsum(comp, 0).mul_(2 * np.pi * 75e3 / FS_IN)
    del comp
    raw = torch.empty(2 * n, dtype=torch.uint8, device=device)
    for c, fn in ((0, torch.cos), (1, torch.sin)):
        v = 0.9 * fn(phase) + 0.01 * torch.randn(
            n, generator=g, dtype=torch.float64, device=device)
        raw[c::2] = torch.clamp(torch.round(v * 128 + 128), 0, 255).to(
            torch.uint8)
    return raw


def synth_am(n_bytes: int, seed: int, device) -> torch.Tensor:
    """u8 interleaved IQ of an AM carrier at AM_IF cycles/sample (the
    am_chain default), 80 % modulated by a 500 Hz tone, sampled at
    1.28 MS/s, with seeded Gaussian noise (tests/test_io_apps.py's AM
    capture, with noise)."""
    n = n_bytes // 2
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.arange(n, dtype=torch.float64, device=device)
    msg = 0.5 * (1 + 0.8 * torch.sin(2 * np.pi * F_AM / FS_IN * k))
    ang = k.mul_(2 * np.pi * AM_IF)
    raw = torch.empty(2 * n, dtype=torch.uint8, device=device)
    for c, fn in ((0, torch.cos), (1, torch.sin)):
        v = msg * fn(ang) + 0.01 * torch.randn(
            n, generator=g, dtype=torch.float64, device=device)
        raw[c::2] = torch.clamp(torch.round(v * 128 + 128), 0, 255).to(
            torch.uint8)
    return raw


def am_tone_hz(y: np.ndarray, rate: int = AM_RATE) -> float:
    """The AM audio's tone: the Hann-windowed spectrum's peak past the AGC
    and DC blocker's settling."""
    seg = np.asarray(y[10_000:10_000 + (1 << 20)], dtype=np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float((np.argmax(spec[5:]) + 5) * rate / len(seg))


def tone_power(x: np.ndarray, f: float, rate: int = 48_000) -> float:
    """Peak of the Hann-windowed spectrum within 2 bins of ``f``."""
    k = int(round(f * len(x) / rate))
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(spec[max(k - 2, 0): k + 3].max())


def check_separation(left: np.ndarray, right: np.ndarray, what: str):
    """The bound of tests/test_stereo.py: each tone beats its leakage into
    the other channel by 5x."""
    ll, rl = tone_power(left, F_L), tone_power(right, F_L)
    rr, lr = tone_power(right, F_R), tone_power(left, F_R)
    require(ll > 5 * rl, f"{what}: 1 kHz in L {ll} vs R {rl}")
    require(rr > 5 * lr, f"{what}: 400 Hz in R {rr} vs L {lr}")
    return ll / rl, rr / lr


def phase_filters(table, taps, I: int, D: int, offset: int):
    """Filters of the library yardstick for K2 (``taps = [1]``) and K5.

    Output ``I*q + r`` reads the input ``D*q`` samples further than output
    ``r`` at the same phases, so each ``r`` is one fixed filter ``W_r``:
    the FIR taps composed with the resampler phases they read.  Returns
    ``W`` as a conv1d weight ``[I, 1, L]`` and ``lo``, the first input
    sample any filter reads."""
    from sdr_tpu_torch.ops.fir import _resample_positions
    Kp = table.shape[1]
    i, o = _resample_positions(I + len(taps) - 1, I, D, offset)
    lo = int(i.min())
    w = np.zeros((I, 1, int(i.max()) - lo + Kp))
    for r in range(I):
        for j, tap in enumerate(taps):
            s = int(i[r + j]) - lo
            w[r, 0, s:s + Kp] += float(tap) * table[o[r + j]].astype(
                np.float64)
    return w.astype(np.float32), lo


def library_resample(table, taps, I: int, D: int, offset: int, hist, x,
                     num: int):
    """One PyTorch call for K2's (``taps = [1]``) or K5's function over
    ``concat(hist, x)``: a conv1d with ``I`` output channels at stride
    ``D``, then the ``[Q, I] -> [Q*I]`` interleave.  The padded input is
    made here, outside the returned call."""
    w, lo = phase_filters(table, taps, I, D, offset)
    w = torch.as_tensor(w, device=x.device)
    lead, q = x.shape[:-1], -(-num // I)
    v = torch.cat([hist, x], dim=-1)
    v = v.reshape(-1, 1, v.shape[-1])[..., lo:]
    v = torch.nn.functional.pad(
        v, (0, max(0, (q - 1) * D + w.shape[-1] - v.shape[-1])))

    def call():
        z = torch.nn.functional.conv1d(v, w, stride=D)[..., :q]
        return z.transpose(1, 2).reshape(lead + (-1,))[..., :num]

    return call


def misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts ``offset`` elements
    into its buffer (a row base off 16-byte alignment)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[offset: offset + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def front_geometries(raw, taps):
    """K1's and K4's extra geometries over 4 rows of ``raw``: K in {16,
    51, 63} x f in {1, 4, 8} x s8 and s16 taps, each at a row base 1, 6 or
    15 bytes off 16-byte alignment, a history of 86, 2 or 30 bytes, the
    most outputs the stream holds (not a multiple of the tiles) and 1
    output (the halo launch), and for K4 byte offsets 0, 1 and 10.
    Yields ``(args, kwargs)`` for the wrapper, ``start`` among kwargs."""
    from sdr_tpu_torch.ops.quantized import u8_front_plan
    rng = np.random.default_rng(7)
    n = 100_006
    x0 = raw[:4 * n].view(4, n)
    i = 0
    for K in (16, 51, 63):
        src = taps if K == 51 else rng.uniform(-1, 1, K).astype(np.float32)
        for f in (1, 4, 8):
            for precision in ("s8", "s16"):
                tq, scale = u8_front_plan(src, precision)
                tq = torch.as_tensor(tq, device=raw.device)
                H = (86, 2, 30)[i % 3]
                hist = torch.as_tensor(rng.integers(0, 256, (4, H)),
                                       dtype=torch.uint8, device=raw.device)
                x = misaligned(x0, (1, 6, 15)[i % 3])
                start = (0, 1, 10)[i % 3]
                full = (H + n - start - 2 * K) // (2 * f) + 1
                for num in (full, 1):
                    yield (tq, scale, f, x, hist, num), dict(start=start)
                i += 1


def ring_geometries(raw, front):
    """K1's ring at its edges, over rows of ``raw``: with the chain's taps,
    fewer tiles than SMs, one tile a row, rows that end partway into a
    slot (a short last tile), two rows of 162 tiles each, the streamed
    block, ``shard_carry``'s one output a row over
    ``H + 2f`` bytes and a tensor whose last row ends off 16-byte
    alignment (its end byte by byte); and 64 taps at f = 16 (64 samples
    a warp).  Yields ``(case, args, plan)``: the wrapper's args and the
    plan of kernels/u8_front_demod.py:ring_plan."""
    from sdr_tpu_torch.kernels.u8_front_demod import ring_plan
    from sdr_tpu_torch.kernels.u8_front import pack_taps
    from sdr_tpu_torch.ops.quantized import u8_front_plan
    rng = np.random.default_rng(28)
    t64, s64 = u8_front_plan(rng.uniform(-1, 1, 64).astype(np.float32),
                             "s8")
    t64 = torch.as_tensor(t64, device=raw.device)
    # case, rows, outputs a row, row base offset, taps, scale, factor
    chain = (front.tq, front.scale, front.factor)
    cases = (("fewer_tiles_than_sms", 2, 30 * 1016, 3, *chain),
             ("one_tile_a_row", 16, 200, 0, *chain),
             ("short_last_tile", 8, 1016 * 40 + 517, 5, *chain),
             ("two_rows", 2, 163_840, 0, *chain),
             ("streamed", 1, STREAM_BLOCK // (2 * front.factor), 0, *chain),
             ("one_output_a_row", ROWS, 1, 0, *chain),
             ("end_off_16", 3, 1016 * 100 + 7, 1, *chain),
             ("warp_samples_64", 3, 504 * 30 + 11, 7, t64, s64, 16))
    for case, rows, num, shift, tq, scale, f in cases:
        K = tq.numel()
        H = 2 * (K - f)
        n = 2 * ((num - 1) * f + K) - H + (5 if case == "end_off_16" else 0)
        if case == "streamed":
            n = STREAM_BLOCK
        if case == "one_output_a_row":
            n = 2 * f
        x = misaligned(raw[:rows * n].view(rows, n), shift)
        hist = torch.as_tensor(rng.integers(0, 256, (rows, H)),
                               dtype=torch.uint8, device=raw.device)
        liq = torch.as_tensor(rng.normal(size=(rows, 2)).astype(np.float32),
                              device=raw.device)
        nw = pack_taps(tq.cpu().numpy()).shape[-1]
        yield case, (tq, scale, f, x, hist, liq, num), ring_plan(f, K, nw)


def fir_geometries(x0, taps):
    """K3's extra geometries over the rows of ``x0``: f in {1, 2, 3, 4, 5,
    8, 16} x K in {1, 51, 64, 65, 200} x starts 0 to 7, each at a row base
    0 to 3 floats off 16-byte alignment, with the most outputs the row
    holds (not a multiple of the tile) and, at start 0, 1 output; at f > 1
    also one output below and one above the largest multiple of the
    kernel's tile (its own plan's) that the row holds.  Yields the
    wrapper's args."""
    from sdr_tpu_torch.kernels import fir
    rng = np.random.default_rng(8)
    n = x0.shape[-1]
    for f in (1, 2, 3, 4, 5, 8, 16):
        for K in (1, 51, 64, 65, 200):
            t = (taps if K == taps.numel() else torch.as_tensor(
                rng.uniform(-1, 1, K).astype(np.float32), device=x0.device))
            tile = fir.plan(K, f, x0.device)["tile"]
            for start in range(8):
                x = misaligned(x0, (start + f) % 4)
                full = (n - start - K) // f + 1
                nums = [full, 1] if start == 0 else [full]
                if f > 1 and start < 2:
                    m = (full - 1) // tile * tile
                    nums += [m - 1, m + 1]
                for num in nums:
                    yield (t, x, num, f, start)


def resample_geometries(x0, taps):
    """K2's and K5's extra geometries over the 3 rows of ``x0``: I/D in
    {3/10, 2/3, 5/4} and the transmitter's 10/3 (31 taps) and 8/1 (51
    taps) with every phase offset, each at a row base 0 to 3
    floats off 16-byte alignment, a history of 5 (shorter than a phase's
    taps), 86 or 12,000 floats (longer than a tile's span), a start of 0,
    37 or 5, and 1 output, 3073 (one past a tile) and the most the stream
    holds plus 25 (reads past its end).  Yields the K2 wrapper's args and
    the FIR taps for K5: ``taps`` or 33 others, in turns."""
    from sdr_tpu_torch.ops.fir import prepare_phase_table
    rng = np.random.default_rng(10)
    dev = x0.device
    t33 = torch.as_tensor(rng.uniform(-1, 1, 33).astype(np.float32),
                          device=dev)
    i = 0
    for I, D, K in ((3, 10, 31), (2, 3, 17), (5, 4, 40), (10, 3, 31),
                    (8, 1, 51)):
        table = torch.as_tensor(prepare_phase_table(
            rng.uniform(-1, 1, K).astype(np.float32), I), device=dev)
        for offset in range(I):
            H = (5, 86, 12_000)[i % 3]
            hist = torch.as_tensor(rng.uniform(-1, 1, (3, H)).astype(
                np.float32), device=dev)
            x = misaligned(x0, i % 4)
            start = (0, 37, 5)[i % 3]
            most = (H + x0.shape[-1] - start) * I // D + 25
            for num in (1, 3073, most):
                yield ((table, I, D, x, hist, offset, num, start),
                       taps if i % 2 else t33)
            i += 1


def max_err(a, b) -> float:
    return (a - b).abs().max().item()


def print_no_fma_floor(what: str, n_taps: int, outputs: int) -> float:
    """Print and return a kernel's floor in ms under the order it keeps
    (K2, K3, K5, K14), computed from this run's measured SM clock: a
    rounded multiply and a rounded add per tap and output, separate f32
    instructions, at 128 f32 lanes per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = CEILINGS["measured"].clock_hz
    ms = 2 * n_taps * outputs / (sms * 128 * clock) * 1e3
    print(f"{what}: no-FMA floor {ms} ms ({n_taps} taps x {outputs} outputs "
          f"x 2 f32 instructions at {sms} SMs x 128 lanes x {clock / 1e9} "
          "GHz, the measured clock; computed)")
    return ms


def print_fma_floor(what: str, instructions: int) -> float:
    """Print and return a kernel's floor in ms at one f32 instruction (an
    FFMA, an add or a multiply) a lane and cycle (K14), computed from this
    run's measured SM clock at 128 f32 lanes per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = CEILINGS["measured"].clock_hz
    ms = instructions / (sms * 128 * clock) * 1e3
    print(f"{what}: FMA floor {ms} ms ({instructions} f32 instructions at "
          f"{sms} SMs x 128 lanes x {clock / 1e9} GHz, the measured clock; "
          "computed)")
    return ms


def fir_switch(f: int, device) -> int:
    """The most taps K3's staged branch takes at factor ``f`` (its own
    plan's switch to the one-thread-an-output branch)."""
    from sdr_tpu_torch.kernels import fir
    lo, hi = 1, 58_112                # staged at lo, not at hi
    require(fir.plan(lo, f, device)["branch"] == "staged", f"K3 at f = {f}")
    require(fir.plan(hi, f, device)["branch"] == "per output",
            f"K3 at {hi} taps, f = {f}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fir.plan(mid, f, device)["branch"] == "staged":
            lo = mid
        else:
            hi = mid
    return lo


def check_fir_tap_limits(x) -> None:
    """K3 at the most taps its shared memory holds (17,316 at factor 1,
    58,112 above, on an H100) equals its plain version bitwise, and one
    tap more raises; at f in {2, 8, 16}, both sides of the switch between
    the staged branch and the one-thread-an-output branch equal it too."""
    from sdr_tpu_torch.kernels import fir
    rng = np.random.default_rng(9)
    switch = {f: fir_switch(f, x.device) for f in (2, 8, 16)}
    cases = [(1, 17_316, True), (1, 17_317, False), (2, 58_112, True),
             (2, 58_113, False)]
    cases += [(f, K, True) for f, s in switch.items() for K in (s, s + 1)]
    for f, K, fits in cases:
        t = torch.as_tensor(rng.uniform(-1, 1, K).astype(np.float32),
                            device=x.device)
        a = (t, x[:2, :K + 5 * f].contiguous(), 6, f, 0)
        if fits:
            err = max_err(fir.fir_strided(*a),
                          fir.fir_strided_reference(*a))
            require(err == 0, f"K3 at {K} taps, factor {f}: {err} != 0")
        else:
            try:
                fir.fir_strided(*a)
            except RuntimeError as e:
                require("do not fit" in str(e), f"K3 raised {e}")
            else:
                require(False, f"K3 took {K} taps at factor {f}")
    print("K3 tap limits: 17,316 taps at factor 1 and 58,112 at factor 2 "
          "equal the plain version; one more raises")
    print("K3 switch from the staged branch to one thread an output: "
          + ", ".join(f"{s:,} -> {s + 1:,} taps at f = {f}"
                      for f, s in switch.items())
          + "; both sides equal the plain version")


def check_resample_limits(x, back) -> None:
    """K2 at the most taps a phase its shared memory holds (19,364 at 1/1)
    and K5 at the most FIR taps beside the paths' 3/10 table (6,340), on
    an H100, equal their plain versions bitwise, and one tap more
    raises."""
    from sdr_tpu_torch.kernels import backhalf, resample
    rng = np.random.default_rng(11)
    I, D = back.spec.interpolation, back.spec.decimation

    def rand(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32),
                               device=x.device)

    hist = x[:2, :0]
    fits = {"K2": 19_364, "K5": 6_340}
    cases = [("K2", Kp, resample.resample, resample.resample_reference,
              (rand(1, Kp), 1, 1, x[:2, :Kp + 5].contiguous(), hist, 0, 6))
             for Kp in (19_364, 19_365)]
    cases += [("K5", Kf, backhalf.resample_fir,
               backhalf.resample_fir_reference,
               (back._table, I, D, rand(Kf),
                x[:2, :(Kf + 9) * D // I + 20].contiguous(), hist, 0, 6))
              for Kf in (6_340, 6_341)]
    for what, K, fn, ref, a in cases:
        if K == fits[what]:
            err = max_err(fn(*a), ref(*a))
            require(err == 0, f"{what} at {K} taps: {err} != 0")
        else:
            try:
                fn(*a)
            except RuntimeError as e:
                require("do not fit" in str(e), f"{what} raised {e}")
            else:
                require(False, f"{what} took {K} taps")
    print("K2 and K5 limits: 19,364 taps a phase at 1/1 (K2) and 6,340 FIR "
          "taps at 3/10 (K5) equal the plain versions; one more raises")


def library_front(front, x, hist, num: int):
    """One PyTorch call for the u8 front's exact decimation: conv1d with
    groups=2 at stride f over the (u8 - 128) f32 planes of concat(hist,
    x), the integer taps as its [2, 1, K] weight.  Every product and
    partial sum is an integer under 2^24 (51 * 128 * 128 for s8 taps), so
    any summation order is exact.  Returns the call (the planes are made
    here, outside it) and its max abs difference, after the plan's scale,
    from K4 over the same input and taps."""
    from sdr_tpu_torch.kernels.u8_front import u8_front
    v = torch.cat([hist, x], dim=-1)
    planes = torch.stack([v[..., 0::2], v[..., 1::2]], dim=-2).to(
        torch.float32).sub_(128)
    del v
    w = front.tq.to(torch.float32).view(1, 1, -1).expand(2, 1, -1)
    w = w.contiguous()

    def call():
        return torch.nn.functional.conv1d(planes, w, stride=front.factor,
                                          groups=2)[..., :num]

    got = u8_front(front.tq, front.scale, front.factor, x, hist, num)
    diff = max_err(call() * float(np.float32(front.scale)), got)
    return call, diff


def check_kernels(raw, ops):
    """Each kernel vs its plain version at the main path's shapes."""
    from sdr_tpu_torch.kernels import fir, resample, u8_front_demod
    from sdr_tpu_torch.kernels.u8_front import tap_words

    front, back = ops
    rows = []
    x = raw.view(ROWS, ROW_BYTES)

    # K1 at the block-parallel batch, history and carry from the halos
    hist, liq = front.shard_carry(x)
    n1 = front.out_len(ROW_BYTES)
    args = (front.tq, front.scale, front.factor, x, hist, liq, n1)
    y1, iq1 = u8_front_demod.u8_front_demod(*args)
    r1, riq1 = u8_front_demod.u8_front_demod_reference(*args)
    err1 = max(max_err(y1, r1), max_err(iq1, riq1))
    # the extra geometries, bitwise too
    g1 = 0
    liq4 = torch.randn(4, 2, device=x.device)
    for (tq, scale, f, xg, hg, num), gkw in front_geometries(raw,
                                                             front.taps):
        if num > 1:       # K1 has no byte offset: the most it holds
            num = (hg.shape[-1] + xg.shape[-1] - 2 * tq.numel()) // (2 * f) + 1
        a = (tq, scale, f, xg, hg, liq4, num)
        got = u8_front_demod.u8_front_demod(*a)
        want = u8_front_demod.u8_front_demod_reference(*a)
        err1 = max(err1, max_err(got[0], want[0]), max_err(got[1], want[1]))
        g1 += 1
    # the ring's edges
    for case, a, plan in ring_geometries(raw, front):
        got = u8_front_demod.u8_front_demod(*a)
        want = u8_front_demod.u8_front_demod_reference(*a)
        e = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        print(f"K1 ring {case}: rows {a[3].shape[0]}, outputs {a[-1]}, "
              f"plan {plan}, max err {e}")
        err1 = max(err1, e)
        g1 += 1
    torch.cuda.synchronize()
    require(torch.isfinite(y1).all().item(), "K1 output finite")
    require(err1 == 0, f"K1 vs plain {err1} != 0")
    ops1 = 2 * 2 * front.n_taps * n1 * ROWS
    b1, by1 = bound(nbytes(x, hist, liq, tap_words(front.tq), y1, iq1), ops1,
                    "int8")
    # the yardstick for its decimation: conv1d over the (u8 - 128) planes
    lib1, lib_err1 = library_front(front, x, hist, n1)
    ms1 = time_ms(lambda: u8_front_demod.u8_front_demod(*args), 20)
    rows.append(dict(
        name="K1 u8_front_demod", kernel="u8_front_demod", route="cuda",
        source="sdr_tpu_torch/csrc/u8_front_demod.cu",
        replaces="sdr_tpu/kernels/u8_front_demod_pallas.py:135",
        max_abs_err=err1, geometries_checked=g1, ms=ms1,
        plain_ms=time_ms(
            lambda: u8_front_demod.u8_front_demod_reference(*args), 3, 1),
        bound_ms=b1, bound_by=by1, bound_fraction=b1 / ms1,
        library_ms=time_ms(lib1, 20), library_max_abs_diff=lib_err1,
        library_note="decimation only: conv1d(groups=2, stride=8) over "
                     "the (u8 - 128) f32 planes, compared after the scale "
                     "with K4 on the same input; no single call computes "
                     "the demod"))

    # K2 at the chain's 3/10 stage, at rebased phases and starts of the
    # same batch, and at the extra geometries: bitwise
    I, D = back.spec.interpolation, back.spec.decimation
    Kf = back.taps_f.shape[0]
    Kp = back.spec.taps_per_phase
    h2 = back.shard_carry(y1)
    n2 = back.out_len(n1) + Kf - 1
    a2 = (back._table, I, D, y1, h2, back._offset_k, n2, 0)
    cases = [a2, (back._table, I, D, y1, h2, 1, n2 - 20, 37),
             (back._table, I, D, y1, h2, 2, n2 - 3, 5),
             *(a for a, _ in resample_geometries(y1[:3, :20_001],
                                                 back._taps))]
    err2 = 0.0
    for a in cases:
        err2 = max(err2, max_err(resample.resample(*a),
                                 resample.resample_reference(*a)))
    require(err2 == 0, f"K2 vs plain {err2} != 0")
    yr = resample.resample(*a2)
    require(torch.isfinite(yr).all().item(), "K2 output finite")
    check_resample_limits(y1, back)
    lib2 = library_resample(back.spec.phase_table, [1.0], I, D,
                            back._offset_k, h2, y1, n2)
    lib_err2 = (lib2() - yr).abs().max().item()
    b2, by2 = bound(nbytes(y1, h2, back._table, yr), 2 * Kp * n2 * ROWS,
                    "f32")
    ms2 = time_ms(lambda: resample.resample(*a2), 20)
    rows.append(dict(
        name="K2 resample", kernel="resample", route="cuda",
        source="sdr_tpu_torch/csrc/resample.cu",
        replaces="sdr_tpu/kernels/resample_pallas.py:187",
        max_abs_err=err2, geometries_checked=len(cases) - 1, ms=ms2,
        bound_fraction=b2 / ms2,
        plain_ms=time_ms(lambda: resample.resample_reference(*a2), 3, 1),
        bound_ms=b2, bound_by=by2, library_ms=time_ms(lib2, 20),
        library_max_abs_diff=lib_err2))
    print_no_fma_floor("K2 resample", Kp, n2 * ROWS)

    # K3: the audio FIR on the resampled batch, and the extra geometries
    n3 = back.out_len(n1)
    a3 = (back._taps, yr, n3, 1, 0)
    y3 = fir.fir_strided(*a3)
    err3 = max_err(y3, fir.fir_strided_reference(*a3))
    g3 = 0
    for a in fir_geometries(yr[:4, :10_001], back._taps):
        err3 = max(err3, max_err(fir.fir_strided(*a),
                                 fir.fir_strided_reference(*a)))
        g3 += 1
    require(err3 == 0, f"K3 vs plain {err3} != 0")
    require(torch.isfinite(y3).all().item(), "K3 output finite")
    check_fir_tap_limits(yr)
    w3 = back._taps.view(1, 1, -1)

    def lib3():
        return torch.nn.functional.conv1d(yr[:, None, :], w3)[:, 0, :n3]

    lib_err3 = (lib3() - y3).abs().max().item()
    b3, by3 = bound(nbytes(yr, back._taps, y3), 2 * Kf * n3 * ROWS, "f32")
    ms3 = time_ms(lambda: fir.fir_strided(*a3), 20)
    rows.append(dict(
        name="K3 fir", kernel="fir", route="cuda",
        source="sdr_tpu_torch/csrc/fir.cu",
        replaces="sdr_tpu/kernels/fir_pallas.py:145",
        max_abs_err=err3, geometries_checked=g3, ms=ms3,
        plain_ms=time_ms(lambda: fir.fir_strided_reference(*a3), 3, 1),
        bound_ms=b3, bound_by=by3, bound_fraction=b3 / ms3,
        library_ms=time_ms(lib3, 20), library_max_abs_diff=lib_err3))
    print_no_fma_floor("K3 fir", Kf, n3 * ROWS)
    return rows


def run_chain(raw, ops, kernels):
    """The mono block-parallel chain with the launch counters read around
    one call, then the streamed run over the same signal."""
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, raw, kernels)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    for name in ("u8_front_demod", "resample", "fir"):
        require(launches[name] > 0,
                f"kernel {name} not launched on the main path")
    out = y.cpu().numpy()
    per_row = ops[1].out_len(ops[0].out_len(ROW_BYTES))
    require(out.shape == (ROWS * per_row,), f"output shape {out.shape}")
    require(np.isfinite(out).all(), "chain output finite")
    hz = tone_hz(out)
    require(abs(hz - 1000) < 5, f"tone at {hz} Hz")
    print(f"block-parallel chain: {ROWS} x {ROW_BYTES} bytes; peak memory "
          f"{peak} bytes; tone {hz:.2f} Hz; launches in one call "
          f"{launches}")
    time_chain(ops, raw, "block-parallel chain")

    pipe = Pipeline(ops, block_in=STREAM_BLOCK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(pipe.run(raw[i:i + STREAM_BLOCK] for i in
                           range(0, raw.numel(), STREAM_BLOCK)))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    streamed = torch.cat(blocks)
    require(torch.equal(streamed, y),
            "streamed Pipeline.run != block-parallel output (max diff "
            f"{(streamed - y).abs().max().item()})")
    print(f"streamed Pipeline.run at {STREAM_BLOCK}-byte blocks: equal to "
          f"block-parallel; {raw.numel() // 2 / t_stream:.6e} complex input "
          "samples/s")

    # agreement with the plain versions on the CPU, on a small input
    from sdr_tpu_torch.apps.chains import fm_chain
    small = raw[:4 * STREAM_BLOCK].cpu()
    _, ref = Pipeline(fm_chain(device="cpu"), block_in=STREAM_BLOCK,
                      device="cpu").process(small)
    n = ref.shape[-1]
    diff = (streamed[:n].cpu() - ref).abs().max().item()
    require(diff <= 1e-5, f"card vs CPU plain chain {diff} > 1e-5")
    print(f"card vs CPU plain chain on 4 blocks: max abs diff {diff}")
    return launches


def run_cli(raw, stereo: bool, front: str = "auto"):
    """The CLI on a temporary recording of 16 blocks, streamed and with
    ``--batched 4``: the mono chain on ``front``, or the stereo +
    de-emphasis chain on the quantized front."""
    chain = (["--front", "quantized", "--stereo", "--deemphasis", "75e-6"]
             if stereo else ["--front", front])
    wavs = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "capture.u8")
        raw[:16 * STREAM_BLOCK].cpu().numpy().tofile(src)
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for extra in ([], ["--batched", "4"]):
            out = os.path.join(tmp, f"audio{len(wavs)}.wav")
            proc = subprocess.run(
                [sys.executable, "-m", "sdr_tpu_torch.apps.fm", "--in", src,
                 "--out", out, *chain, *extra], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            print(f"cli {' '.join(chain + extra) or '(streamed)'}: rc "
                  f"{proc.returncode} {proc.stdout.strip()}")
            require(proc.returncode == 0, f"cli failed: {proc.stderr}")
            with wave.open(out, "rb") as wf:
                require(wf.getframerate() == 48_000, "WAV rate")
                require(wf.getnchannels() == (2 if stereo else 1),
                        "WAV channels")
                pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
            if stereo:
                pcm = pcm.reshape(-1, 2).astype(np.int32)
                sep = check_separation(pcm[4000:, 0].astype(np.float64),
                                       pcm[4000:, 1].astype(np.float64),
                                       "stereo cli")
            else:
                hz = tone_hz(pcm.astype(np.float64))
                require(abs(hz - 1000) < 5, f"cli tone at {hz} Hz")
            wavs.append(pcm)
    if stereo:
        # the IIR's entering state is rounded otherwise block-parallel
        lsb = int(np.abs(wavs[0] - wavs[1]).max())
        require(lsb <= 1, f"stereo cli streamed vs --batched: {lsb} LSB")
        print(f"stereo cli: {len(wavs[0])} 2-channel frames, separation "
              f"L {sep[0]:.1f}x R {sep[1]:.1f}x, streamed vs batched "
              f"{lsb} LSB")
    else:
        require(np.array_equal(wavs[0], wavs[1]),
                "cli streamed and --batched WAVs differ")
        print(f"cli: {len(wavs[0])} samples, tone {hz:.2f} Hz, streamed == "
              "batched")


def check_stereo_kernels(raw, ops, seed: int):
    """K4, K11 over K4's planes, K14 over the composite, K2 over the L/R
    planes and K5, each vs its plain version at the stereo path's shapes
    and at extra geometries."""
    from sdr_tpu_torch.kernels import backhalf, fir, resample, u8_front
    from sdr_tpu_torch.kernels.u8_front import tap_words
    from sdr_tpu_torch.ops.quantized import u8_front_plan

    front, demod, stereo, back = ops[:4]
    rows = []
    x = raw.view(ROWS, ROW_BYTES)

    # K4 at the block-parallel batch, history from the halo: 86 bytes, not
    # a whole number of 16-byte output steps
    hist = front.shard_carry(x)
    n1 = front.out_len(ROW_BYTES)
    args = (front.tq, front.scale, front.factor, x, hist, n1)
    y4 = u8_front.u8_front(*args)
    err4 = max_err(y4, u8_front.u8_front_reference(*args))
    # s16 taps, a byte offset, leading dims [B] and [B, C], and the extra
    # geometries
    tq16, sc16 = u8_front_plan(front.taps, "s16")
    tq16 = torch.as_tensor(tq16, device=x.device)
    cases = [((tq16, sc16, 8, x[:4], hist[:4], n1), {}),
             ((front.tq, front.scale, 8, x[:4], hist[:4], n1 - 2, 10), {}),
             ((front.tq, front.scale, 8, x[:4].view(2, 2, ROW_BYTES),
               hist[:4].view(2, 2, -1), n1), {}),
             *front_geometries(raw, front.taps)]
    for a, akw in cases:
        err4 = max(err4, max_err(u8_front.u8_front(*a, **akw),
                                 u8_front.u8_front_reference(*a, **akw)))
    torch.cuda.synchronize()
    require(torch.isfinite(y4).all().item(), "K4 output finite")
    require(err4 == 0, f"K4 vs plain {err4} != 0")
    b4, by4 = bound(nbytes(x, hist, tap_words(front.tq), y4),
                    2 * 2 * front.n_taps * n1 * ROWS, "int8")
    lib4, lib_err4 = library_front(front, x, hist, n1)
    require(lib_err4 == 0, f"K4 vs its conv1d yardstick {lib_err4} != 0")
    ms4 = time_ms(lambda: u8_front.u8_front(*args), 20)
    rows.append(dict(
        name="K4 u8_front", kernel="u8_front", route="cuda",
        source="sdr_tpu_torch/csrc/u8_front.cu",
        replaces="sdr_tpu/kernels/u8_front_pallas.py:192",
        max_abs_err=err4, geometries_checked=len(cases), ms=ms4,
        plain_ms=time_ms(lambda: u8_front.u8_front_reference(*args), 3, 1),
        bound_ms=b4, bound_by=by4, bound_fraction=b4 / ms4,
        library_ms=time_ms(lib4, 20), library_max_abs_diff=lib_err4,
        library_note="conv1d(groups=2, stride=8) over the (u8 - 128) f32 "
                     "planes, the scale applied outside the timed call"))

    # K11 over K4's planes: the polynomial (the path's) and atan2f, and
    # its extra geometries
    k11 = check_fm_demod_kernel(
        "K11 fm_demod (stereo planar [32, 2, 655,360])", demod, y4, seed,
        forms=["poly", "exact"])
    count = fm_demod_geometries(x.device, seed)
    for r in k11:
        r["geometries"] = count
    rows += k11
    print(f"K11 fm_demod: the polynomial bitwise its plain version, atan2f "
          f"{'bitwise' if ATAN2F['bitwise'] else 'within an ulp of pi of'} "
          f"torch.atan2 (max {ATAN2F['max_rad']} rad), the complex form "
          f"within {ANGLE} rad, at {count} extra geometries")

    # K14 over the composite, history and lock from StereoDecode's carry
    _, comp = demod.apply(demod.shard_carry(y4), y4)
    rows += check_stereo_decode_kernel(stereo, comp, seed)
    sc = stereo.shard_carry(comp)
    nc = comp.shape[-1]

    # K2 over the L/R planes [32, 2], history from the halo, as the
    # unfused back half runs it: bitwise
    _, lr = stereo.apply(sc, comp)
    h5 = back.shard_carry(lr)
    I, D = back.spec.interpolation, back.spec.decimation
    Kf = back.taps_f.shape[0]
    Kp = back.spec.taps_per_phase
    n5 = back.out_len(nc)
    a2 = (back._table, I, D, lr, h5, back._offset_k, n5 + Kf - 1, 0)
    yr = resample.resample(*a2)
    err2 = max_err(yr, resample.resample_reference(*a2))
    require(err2 == 0, f"K2 over the L/R planes vs plain {err2} != 0")
    lib2 = library_resample(back.spec.phase_table, [1.0], I, D,
                            back._offset_k, h5, lr, n5 + Kf - 1)
    lib_err2 = max_err(lib2(), yr)
    b2, by2 = bound(nbytes(lr, h5, back._table, yr), 2 * Kp * yr.numel(),
                    "f32")
    ms2 = time_ms(lambda: resample.resample(*a2), 20)
    rows.append(dict(
        name="K2 resample (stereo L/R planes [32, 2])", kernel="resample",
        route="cuda", source="sdr_tpu_torch/csrc/resample.cu",
        replaces="sdr_tpu/kernels/resample_pallas.py:187",
        max_abs_err=err2, ms=ms2,
        plain_ms=time_ms(lambda: resample.resample_reference(*a2), 3, 1),
        bound_ms=b2, bound_by=by2, bound_fraction=b2 / ms2,
        library_ms=time_ms(lib2, 20), library_max_abs_diff=lib_err2))
    print_no_fma_floor("K2 resample (stereo, [32, 2])", Kp, yr.numel())

    # K5 over the same planes; rebased offsets and starts of the same
    # batch, and K2's extra geometries: bitwise
    a5 = (back._table, I, D, back._taps, lr, h5, back._offset_k, n5, 0)
    y5 = backhalf.resample_fir(*a5)
    cases = [a5, (back._table, I, D, back._taps, lr, h5, 1, n5 - 21, 37),
             (back._table, I, D, back._taps, lr, h5, 2, n5 - 3, 5)]
    cases += [(t, I2, D2, taps, x2, h2, off, num, start)
              for (t, I2, D2, x2, h2, off, num, start), taps
              in resample_geometries(lr.view(-1, nc)[:3, :20_001],
                                     back._taps)]
    err5 = 0.0
    for a in cases:
        err5 = max(err5, max_err(backhalf.resample_fir(*a),
                                 backhalf.resample_fir_reference(*a)))
    require(torch.isfinite(y5).all().item(), "K5 output finite")
    require(err5 == 0, f"K5 vs plain {err5} != 0")
    ms5 = time_ms(lambda: backhalf.resample_fir(*a5), 20)

    def pair():
        return fir.fir_strided(back._taps, resample.resample(*a2), n5)

    pair_err = max_err(pair(), y5)
    require(pair_err == 0, f"K5 vs the K2 -> K3 pair {pair_err} != 0")
    lib5 = library_resample(back.spec.phase_table, back._taps_scaled, I, D,
                            back._offset_k, h5, lr, n5)
    lib_err5 = (lib5() - y5).abs().max().item()
    require(lib_err5 <= 2e-5, f"K5 vs its conv1d yardstick {lib_err5}")
    b5, by5 = bound(nbytes(lr, h5, back._table, back._taps, y5),
                    2 * (Kp + Kf) * y5.numel(), "f32")
    rows.append(dict(
        name="K5 backhalf", kernel="backhalf", route="cuda",
        source="sdr_tpu_torch/csrc/backhalf.cu",
        replaces="sdr_tpu/kernels/backhalf_pallas.py:240",
        max_abs_err=err5, geometries_checked=len(cases) - 1, ms=ms5,
        bound_fraction=b5 / ms5,
        plain_ms=time_ms(lambda: backhalf.resample_fir_reference(*a5), 3, 1),
        bound_ms=b5, bound_by=by5, library_ms=time_ms(lib5, 20),
        library_max_abs_diff=lib_err5,
        library_note="conv1d with the FIR taps composed with the resampler "
                     "phases, one filter per output phase; the port's "
                     "K2 -> K3 pair on the same input is pair_ms",
        pair_ms=time_ms(pair, 20), pair_max_abs_diff=pair_err))
    print_no_fma_floor("K5 backhalf", Kp + Kf, y5.numel())

    # K13 as the de-emphasis Iir runs over the back half's output
    rows.append(check_iir_kernel(
        "K13 iir (stereo de-emphasis, [32, 2, 196,608])", ops[4], y5, seed))
    # K15 as StereoDecode's and the de-emphasis Iir's shard_carry launch it
    rows += check_affine_prefix_kernel([
        ("stereo StereoDecode lock", lambda: stereo.shard_carry(comp)),
        ("stereo de-emphasis Iir", lambda: ops[4].shard_carry(y5))], seed)
    return rows


K14_REPLACES = ("none: sdr_tpu/stream/ops.py:732-795 (StereoDecode: five "
                "65-tap FIRs through sdr_tpu/ops/fir.py:271-287 _dispatch, "
                "the Pallas fir_strided or XLA's conv, and XLA fusions)")
# K14's former design (a product and a sum rounded apiece, the average a
# fourth filter, a block a tile) at the stereo path's shape, as its last
# reading on an NVIDIA H100 80GB HBM3 at 700 W recorded it (PERF.md §6:
# launch A as apply runs it, as shard_carry runs it, launch B, both, the
# op alone).  Printed for comparison only: the kernels line carries what
# this run measures.
K14_FORMER_MS = {"a": 0.1531, "a_shard_carry": 0.1415, "b": 0.4887,
                 "both": 0.6508, "op": 0.876}
# the boxcar's operations an output: 70 adds and 4 multiplies a quad
K14_BOX_OPS = 74 / 4


def check_stereo_decode_kernel(op, comp, seed: int):
    """K14 over the stereo path's composite ``comp`` [32, 655,360] with the
    history ``StereoDecode.shard_carry`` gives: launch A as ``shard_carry``
    runs it (no entering lock: a, b) and as ``apply`` runs it (the path's
    entering lock, writing the squared pilot) and launch B gated by that
    lock from that sq, all bitwise their plain versions; two launches
    bitwise equal; the extra geometries (:func:`stereo_geometries`).
    Rows for launch A, launch B and both as ``apply`` runs them, each
    timed with its bound, its FMA floor and a ``conv1d`` yardstick, the
    former design's time printed beside it."""
    from sdr_tpu_torch.kernels import stereo_decode as k14
    h, lock0 = op.shard_carry(comp)
    hi, lo = op.lock_hi, op.lock_lo
    n, R = comp.shape[-1], comp.shape[0]
    nq = n + 128
    sq = torch.empty(R, nq, device=comp.device)
    sq_ref = torch.empty(R, nq, device=comp.device)
    a_sc = (op._bp19, h, comp, None, hi, lo)
    a_ap = (op._bp19, h, comp, lock0, hi, lo)
    got = k14.pilot_lock(*a_sc)
    require(got[0] is None and same_bits(
        got[1:], k14.pilot_lock_reference(*a_sc)[1:]),
        "K14 launch A (shard_carry's form) vs plain not bitwise")
    got = k14.pilot_lock(*a_ap, sq=sq)
    require(same_bits(got, k14.pilot_lock_reference(*a_ap, sq=sq_ref))
            and same_bits(sq, sq_ref),
            "K14 launch A (apply's form) vs plain not bitwise")
    lock = got[0]
    require(bool((lock == 1).all()), f"K14: the path's rows lock "
            f"({lock.tolist()})")
    b = (op._taps, h, comp, lock, op.gain, op.pilot_floor)
    y = k14.stereo_decode(*b, sq)
    ref = k14.stereo_decode_reference(*b, sq_ref)
    torch.cuda.synchronize()
    require(torch.isfinite(y).all().item(), "K14 output finite")
    require(same_bits(y, ref), f"K14 launch B vs plain not bitwise (max abs "
            f"diff {max_err(y, ref)})")
    del ref, sq_ref
    check_repeatable(lambda: k14.pilot_lock(*a_ap, sq=sq), "K14 launch A")
    check_repeatable(lambda: k14.pilot_lock(*a_sc)[1:],
                     "K14 launch A (shard_carry's form)")
    check_repeatable(lambda: k14.stereo_decode(*b, sq), "K14 launch B")
    t0 = time.perf_counter()
    count = stereo_geometries(op, comp.device, seed)
    print(f"K14 stereo_decode: launches A and B bitwise their plain versions "
          f"(the lock and r's decisions included) at [{R}, {n}] and at "
          f"{count} extra geometries ({time.perf_counter() - t0:.1f} s)")

    def both():
        return k14.decode(op._taps, h, comp, lock0, op.gain, op.pilot_floor,
                          hi, lo)[0]

    def both_plain():
        s2 = torch.empty_like(sq)
        new, _, _ = k14.pilot_lock_reference(*a_ap, sq=s2)
        return k14.stereo_decode_reference(op._taps, h, comp, new, op.gain,
                                           op.pilot_floor, s2)

    xe = torch.cat([h, comp], dim=-1)
    w5 = torch.stack([op._taps[0], op._taps[1], op._taps[2], op._taps[3],
                      op._taps[3]])[:, None, :]

    def lib5():     # the five filters, each over xe: a yardstick
        return torch.nn.functional.conv1d(xe[:, None, :], w5)

    def lib1():     # the pilot bandpass over xe
        return torch.nn.functional.conv1d(xe[:, None, :], w5[:1])

    # the work of a row: the pilot over nq, car over n + 64, diff and m
    # over n, each 65 taps; the boxcar over n + 64; the elementwise steps
    taps_a, taps_b = nq, (n + 64) + 2 * n
    ew_a, ew_b = nq + 2 * (n + 192), 5 * (n + 64) + 4 * n
    box = int(K14_BOX_OPS * (n + 64))
    small = 4 * 4 * R                       # lock, a, b, the gate
    ms_a = time_ms(lambda: k14.pilot_lock(*a_ap, sq=sq), 20)
    ms_b = time_ms(lambda: k14.stereo_decode(*b, sq), 20)
    ms_both = time_ms(both, 20)
    ms_a_sc = time_ms(lambda: k14.pilot_lock(*a_sc), 20)
    ms_op = time_ms(lambda: op.apply(op.shard_carry(comp), comp), 20)
    was = K14_FORMER_MS
    out = []
    for name, ms, plain, nb, ops_, instr, former, lib, note, extra in (
            ("K14 pilot_lock (launch A, apply's form: writes sq)", ms_a,
             lambda: k14.pilot_lock_reference(*a_ap, sq=torch.empty_like(
                 sq)), nbytes(h, comp, op._bp19, sq) + small,
             2 * 65 * taps_a + ew_a, 65 * taps_a, was["a"], lib1,
             "conv1d of the pilot bandpass alone over [hist | x] (the row "
             "sums and the lock not included)",
             {"ms_shard_carry_form": ms_a_sc}),
            ("K14 stereo_decode (launch B from launch A's sq)", ms_b,
             lambda: k14.stereo_decode_reference(*b, sq),
             nbytes(h, comp, op._taps, sq, y) + small,
             2 * 65 * taps_b + box + ew_b, 65 * taps_b + box + ew_b,
             was["b"], lib5,
             "conv1d with five output channels (bp19, bp38, avg, lp15, "
             "lp15) over [hist | x]: the filters' sums, not the cascade",
             {}),
            ("K14 both launches (A then B, as apply runs them)", ms_both,
             both_plain, nbytes(h, comp, op._taps, y) + small,
             2 * 65 * (taps_a + taps_b) + box + ew_a + ew_b,
             65 * (taps_a + taps_b) + box + ew_b, was["both"], lib5,
             "the same conv1d as launch B's", {
                 "op_ms": ms_op,
                 "op_note": "StereoDecode.shard_carry + apply at the "
                 "path's batch (A, A with sq, B, the carry)"})):
        bms, by = bound(nb, ops_ * R, "f32")
        print(f"{name}: {ms} ms (the former design, recorded: "
              f"{former} ms)")
        out.append(dict(
            name=f"{name} [{R}, {n}]", kernel="stereo_decode",
            route="cuda", source="sdr_tpu_torch/csrc/stereo_decode.cu",
            replaces=K14_REPLACES, max_abs_err=0.0, bitwise=True,
            geometries=count, ms=ms,
            plain_ms=time_ms(plain, 3, 1), bound_ms=bms, bound_by=by,
            bound_fraction=bms / ms,
            fma_floor_ms=print_fma_floor(name, instr * R),
            library_ms=time_ms(lib, 20), library_note=note, **extra))
    print(f"K14 launch A, shard_carry's form: {ms_a_sc} ms (the former "
          f"design, recorded: {was['a_shard_carry']} ms); "
          f"StereoDecode alone: {ms_op} ms (the former design, recorded: "
          f"{was['op']} ms)")
    return out


def _stereo_signal(kind: str, shape, g, device) -> torch.Tensor:
    """A composite at 160 kS/s that locks (the multiplex with a 10 %
    pilot), unlocks (a mono tone) or holds in the hysteresis band (a 5 %
    pilot under a strong tone), each row from its own time, with a little
    noise."""
    n = shape[-1]
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    t0 = torch.randint(0, 160_000, (rows, 1), generator=g, device=device)
    t = (torch.arange(n, device=device, dtype=torch.float64) + t0) / 160e3
    left, right = (torch.sin(2 * np.pi * f * t) for f in (1_000.0, 400.0))
    if kind == "lock":
        c = (0.25 * (left + right) + 0.1 * torch.cos(2 * np.pi * 19e3 * t)
             + 0.25 * (left - right) * torch.cos(2 * np.pi * 38e3 * t))
    elif kind == "unlock":
        c = 0.5 * left
    else:
        c = 0.5 * left + 0.05 * torch.cos(2 * np.pi * 19e3 * t)
    noise = torch.randn(c.shape, generator=g, device=device,
                        dtype=torch.float64)
    return (c + 0.001 * noise).float().view(shape)


def stereo_geometries(op, device, seed: int) -> int:
    """K14 bitwise against its plain versions: n in {1, 100, 191, 2,944,
    3,001, 6,145} (below the history, around launch B's tile, past launch
    A's) at rows [1], [3] and [2, 3], and one streamed block of 81,920
    samples in one row; the block at bases 0 and 1 float off 16-byte
    alignment; signals that lock, unlock and hold, from lock 0 and 1 (the
    decision checked where the block is long enough to make it), launch A
    writing the squared pilot and launch B from it, gated (``apply``'s
    form) and ungated (``pilot_lock=False``'s); then rows [3] of n in
    {2,944, 6,145, 81,920} whose history is a view of the block before
    (at bases 0 and 1, gated and ungated); returns the count."""
    from sdr_tpu_torch.kernels import stereo_decode as k14
    g = torch.Generator(device=device).manual_seed(seed + 3)
    count = 0
    shapes = [(lead, n) for n in (1, 100, 191, 2_944, 3_001, 6_145)
              for lead in ((1,), (3,), (2, 3))] + [((1,), 81_920)]
    for lead, n in shapes:
        for kind in ("lock", "unlock", "hold"):
            full = _stereo_signal(kind, lead + (192 + n,), g, device)
            hist = full[..., :192].contiguous()
            for off in (0, 1):
                x = misaligned(full[..., 192:].contiguous(), off)
                for lock0 in (0.0, 1.0):
                    lock = torch.full(lead, lock0, device=device)
                    a = (op._bp19, hist, x, lock, op.lock_hi, op.lock_lo)
                    sq = torch.empty(lead + (n + 128,), device=device)
                    sq_ref = torch.empty_like(sq)
                    got = k14.pilot_lock(*a, sq=sq)
                    require(same_bits(got, k14.pilot_lock_reference(
                        *a, sq=sq_ref)) and same_bits(sq, sq_ref),
                            f"K14 launch A at {lead}, n {n}, {kind}, offset "
                            f"{off}, lock {lock0}: not bitwise")
                    if n >= 2_944:
                        want = {"lock": 1.0, "unlock": 0.0,
                                "hold": lock0}[kind]
                        require(bool((got[0] == want).all()),
                                f"K14 lock at {lead}, n {n}, {kind} from "
                                f"{lock0}: {got[0].tolist()}")
                    # gated (apply's form), ungated (pilot_lock=False's)
                    for gate in (got[0], None)[:2 - int(lock0)]:
                        b = (op._taps, hist, x, gate, op.gain,
                             op.pilot_floor, sq)
                        y = k14.stereo_decode(*b)
                        require(same_bits(
                            y, k14.stereo_decode_reference(*b)),
                            f"K14 launch B at {lead}, n {n}, {kind}, offset "
                            f"{off}, gated {gate is not None}: not bitwise")
                        count += 1
    # the history a view of the block before, at that block's row stride
    for n in (2_944, 6_145, 81_920):
        for kind in ("lock", "unlock", "hold"):
            for off in (0, 1):
                prev = misaligned(_stereo_signal(kind, (3, n), g, device),
                                  off)
                hist = prev[..., n - 192:]
                x = _stereo_signal(kind, (3, n), g, device)
                for gated in (True, False):
                    sq = torch.empty(3, n + 128, device=device)
                    sq_ref = torch.empty_like(sq)
                    a = (op._bp19, hist, x, torch.zeros(3, device=device),
                         op.lock_hi, op.lock_lo)
                    got = k14.pilot_lock(*a, sq=sq)
                    require(same_bits(got, k14.pilot_lock_reference(
                        *a, sq=sq_ref)) and same_bits(sq, sq_ref),
                            f"K14 launch A, history a view, n {n}, {kind}, "
                            f"offset {off}: not bitwise")
                    b = (op._taps, hist, x, got[0] if gated else None,
                         op.gain, op.pilot_floor, sq)
                    require(same_bits(k14.stereo_decode(*b),
                                      k14.stereo_decode_reference(*b)),
                            f"K14 launch B, history a view, n {n}, {kind}, "
                            f"offset {off}, gated {gated}: not bitwise")
                    count += 1
    return count


def time_chain(ops, raw, what: str, nblocks: int = ROWS,
               samples: int | None = None,
               unit: str = "complex input samples/s") -> dict:
    """Median ms of CHAIN_REPS back-to-back block-parallel calls, each
    between CUDA events: the span on the device's clock from the call's
    first enqueue to its last kernel's end, host gaps included.  Then the
    split of a call into the device's time and the host's enqueue
    (``profile_fm.queued_split``): where the span exceeds the device's
    time, the host's enqueue is what holds the card back.  The rate is
    ``samples`` (default: the u8 input's complex samples) a call.  Returns
    the chain's record (its ops, block geometry, span and split), also
    kept in CHAIN_TIMINGS for phase 14."""
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.profile_fm import queued_split
    samples = raw.numel() // 2 if samples is None else samples
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(CHAIN_REPS)]
    for a, b in ev:
        a.record()
        run_time_batched(ops, raw, nblocks)
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in ev)
    ms = float(np.median(times))
    print(f"{what} over {CHAIN_REPS} calls by CUDA events: median {ms} ms "
          f"(min {times[0]}, max {times[-1]}); "
          f"{samples / (ms * 1e-3):.6e} {unit} (median)")
    split = queued_split(lambda: run_time_batched(ops, raw, nblocks))
    print(f"{what}, each call queued behind a device-side sleep: device "
          f"{split['device_ms']} ms, host enqueue {split['enqueue_ms']} ms "
          f"(max {split['enqueue_max_ms']}) (medians of 5 calls)")
    lead = int(np.prod(raw.shape[:-1], dtype=np.int64))
    rec = dict(chain=what, ops=ops, block_in=raw.shape[-1] // nblocks,
               in_dtype=raw.dtype, batch=nblocks * lead, span_ms=ms,
               span_min_ms=times[0], span_max_ms=times[-1], **split)
    CHAIN_TIMINGS.append(rec)
    return rec


def counted(fn, kernels):
    """``fn()`` once with every launch counter (and ``ops/fir.py``'s count
    of layout copies) set to 0 just before it and read just after."""
    from sdr_tpu_torch.ops import fir as fir_ops
    torch.cuda.synchronize()
    reset_launches(kernels)
    fir_ops.layout_copies = 0
    y = fn()
    torch.cuda.synchronize()
    return y, {k.name: k.launches for k in kernels}


def counted_call(ops, raw, kernels, nblocks: int = ROWS):
    """One block-parallel call, its launches counted (:func:`counted`)."""
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    return counted(lambda: run_time_batched(ops, raw, nblocks), kernels)


def run_stereo_chain(raw, ops, kernels):
    """The stereo path block-parallel (launch counts, separation, lock,
    timing, peak memory), its fused variant (K5), and the streamed run."""
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.parallel.sharded import time_sharded_fn
    from sdr_tpu_torch.stream import Pipeline, ResampleFirScale

    counted_call(ops, raw, kernels)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    require_launches(launches, STEREO_LAUNCHES, "stereo path")
    per_row = ops[3].out_len(ops[0].out_len(ROW_BYTES))
    require(tuple(y.shape) == (2, ROWS * per_row), f"output {y.shape}")
    out = y.cpu().numpy()
    require(np.isfinite(out).all(), "stereo output finite")
    seg = out[:, 4000:4000 + (1 << 20)]
    sep = check_separation(seg[0], seg[1], "stereo block-parallel")
    # the lock state after every row (the stream's carry at each row end)
    xb = raw.view(ROWS, ROW_BYTES)
    cb, _ = time_sharded_fn(ops, return_carries=True)(xb)
    locks = cb[2][1]
    require(bool((locks == 1).all()), f"pilot lock per row {locks.tolist()}")
    print(f"stereo block-parallel chain: {ROWS} x {ROW_BYTES} bytes -> "
          f"{tuple(y.shape)}; peak memory {peak} bytes; separation L "
          f"{sep[0]:.1f}x R {sep[1]:.1f}x; locked on all {ROWS} rows; "
          f"launches in one call {launches}")
    time_chain(ops, raw, "stereo block-parallel chain")

    # the same chain with the fused back half
    require(isinstance(ops[3], ResampleFirScale) and not ops[3].fused,
            "stereo chain's back half")
    fops = stereo_ops(True, ops[0].device)
    counted_call(fops, raw, kernels)                    # warm-up
    yf, launches_f = counted_call(fops, raw, kernels)
    require_launches(launches_f, STEREO_FUSED_LAUNCHES,
                     "stereo path, fused back half")
    dfused = (yf - y).abs().max().item()
    require(dfused <= 2e-5, f"fused vs unfused back half {dfused} > 2e-5")
    print(f"stereo chain, ResampleFirScale(fused=True): max abs diff to "
          f"unfused {dfused}; launches in one call {launches_f}")
    time_chain(fops, raw, "stereo block-parallel chain, fused back half")

    # streamed: within 1e-5, not bitwise -- the IIR's state entering a row
    # comes from C^n and the matrix affine prefix block-parallel, from the
    # recurrence itself streamed, and the two round differently
    pipe = Pipeline(ops, block_in=STREAM_BLOCK)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    blocks = eager_stream(pipe, (raw[i:i + STREAM_BLOCK] for i in
                                 range(0, raw.numel(), STREAM_BLOCK)))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"u8_front": 1, "fm_demod": 1, "iir": 1,
                                "fir": 1, "stereo_decode": 2,
                                "affine_prefix": 0},
                      raw.numel() // STREAM_BLOCK, "stereo streamed")
    streamed = torch.cat(blocks, dim=-1)
    dstream = (streamed - y).abs().max().item()
    require(dstream <= 1e-5, f"stereo streamed vs block-parallel {dstream}")
    print(f"stereo streamed op by op at {STREAM_BLOCK}-byte blocks: max "
          f"abs diff to block-parallel {dstream}; "
          f"{raw.numel() // 2 / t_stream:.6e} complex input samples/s")
    compiled_run(pipe, list(raw.split(STREAM_BLOCK)), streamed, "stereo",
                 raw.numel() // 2)

    small = raw[:4 * STREAM_BLOCK].cpu()
    cpu_ops = fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                       device="cpu")
    _, ref = Pipeline(cpu_ops, block_in=STREAM_BLOCK,
                      device="cpu").process(small)
    n = ref.shape[-1]
    diff = (streamed[:, :n].cpu() - ref).abs().max().item()
    require(diff <= 1e-5, f"stereo card vs CPU plain chain {diff} > 1e-5")
    print(f"stereo card vs CPU plain chain on 4 blocks: max abs diff {diff}")
    return launches, launches_f


def check_decimator_kernel(name: str, fir_op, x):
    """K3 as a decimating ``Fir`` launches it over the block-parallel real
    batch ``x`` (planar f32, or real rows): the seam launch and the main
    launch,
    each bitwise against the plain version over the same real planes;
    the main launch timed beside one strided ``conv1d`` over the same
    planes (timed only), with its bound from the bytes the seam split
    moves (the planes read once, the outputs written once)."""
    from sdr_tpu_torch.kernels import fir
    from sdr_tpu_torch.ops.fir import as_real_batch
    n_in = x.shape[-1]
    hist = fir_op.shard_carry(x)
    mb, seam_x, start = fir_op._seam_plan(hist.shape[-1], n_in,
                                          fir_op.out_len(n_in))
    f, taps = fir_op.spec.decimation, fir_op._taps
    K = taps.numel()
    xr = as_real_batch(x)[0]
    num = fir_op.out_len(n_in) - mb
    a = (taps, xr, num, f, start)
    y = fir.fir_strided(*a)
    err = max_err(y, fir.fir_strided_reference(*a))
    seam = as_real_batch(torch.cat([hist, x[..., :seam_x]], dim=-1))[0]
    sa = (taps, seam.contiguous(), mb, f, 0)
    err = max(err, max_err(fir.fir_strided(*sa),
                           fir.fir_strided_reference(*sa)))
    torch.cuda.synchronize()
    require(torch.isfinite(y).all().item(), f"{name} output finite")
    require(err == 0, f"{name} vs plain {err} != 0")
    xv, w = xr.view(-1, 1, n_in), taps.view(1, 1, -1)

    def lib():
        return torch.nn.functional.conv1d(xv[..., start:], w,
                                          stride=f)[:, 0, :num]

    lib_err = max_err(lib().view_as(y), y)
    b, by = bound(nbytes(xr, taps, y), 2 * K * y.numel(), "f32")
    ms = time_ms(lambda: fir.fir_strided(*a), 20)
    row = dict(
        name=name, kernel="fir", route="cuda",
        source="sdr_tpu_torch/csrc/fir.cu",
        replaces="sdr_tpu/kernels/fir_pallas.py:145",
        shape=f"{list(xr.shape)} -> {list(y.shape)}, {K} taps, factor {f}, "
              f"start {start}; seam launch {list(seam.shape)} -> {mb}",
        plan=fir.plan(K, f, xr.device),
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: fir.fir_strided_reference(*a), 3, 1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        library_ms=time_ms(lib, 20), library_max_abs_diff=lib_err,
        library_note=f"conv1d over the {xv.shape[0]} plane rows, stride {f}")
    print_no_fma_floor(name, K, y.numel())
    return row


def planar_route(taps, x, num: int, f: int, start: int):
    """The route a complex batch took to K3 before its complex form: real
    planes (a copy), the real form, the complex output rebuilt."""
    from sdr_tpu_torch.kernels import fir
    from sdr_tpu_torch.ops.fir import as_real_batch
    xr, rebuild = as_real_batch(x)
    return rebuild(fir.fir_strided(taps, xr, num, f, start))


def check_complex_fir(taps, x, num: int, f: int, start: int, what: str,
                      out=None, planar: bool = True):
    """K3's complex form on ``x`` (into ``out`` if given) bitwise its plain
    version and (``planar``: the real form takes at most 65,535 rows)
    the planar route; returns the output."""
    from sdr_tpu_torch.kernels import fir
    y = fir.fir_strided(taps, x, num, f, start, out=out)
    require(out is None or y.data_ptr() == out.data_ptr(),
            f"{what}: not written into out")
    require(same_bits(y, fir.fir_strided_reference(taps, x, num, f, start)),
            f"{what}: K3's complex form vs its plain version")
    require(not planar or same_bits(y, planar_route(taps, x, num, f, start)),
            f"{what}: K3's complex form vs the planar route")
    return y


def check_complex_decimator_kernel(name: str, fir_op, x):
    """K3's complex form as a decimating ``Fir`` launches it over the
    block-parallel complex batch ``x`` (rows, or the channel-major view
    ``Channelize`` gives), read in place: the seam launch into
    ``y[..., :mb]`` and the main launch into ``y[..., mb:]`` of one
    output, each bitwise its plain version and the planar route; two
    main launches bitwise equal; the main launch timed beside its plain
    version, the planar route (the parent's: planes, the real form,
    ``torch.complex``), the real form alone on planes made beforehand,
    and a grouped ``conv1d`` (groups 2, stride f) over
    ``view_as_real(x).movedim(-1, -2)`` (timed only; the call includes
    the copy its reshape to [rows, 2, n] makes), with its bound."""
    from sdr_tpu_torch.kernels import fir
    from sdr_tpu_torch.ops.fir import as_real_batch
    n_in = x.shape[-1]
    hist = fir_op.shard_carry(x)
    n_out = fir_op.out_len(n_in)
    mb, seam_x, start = fir_op._seam_plan(hist.shape[-1], n_in, n_out)
    f, taps = fir_op.spec.decimation, fir_op._taps
    K = taps.numel()
    layout = fir.complex_layout(x)
    require(layout is not None, f"{name}: x {tuple(x.shape)} at strides "
                                f"{x.stride()} is no complex layout of K3")
    num = n_out - mb
    y = torch.empty(x.shape[:-1] + (n_out,), dtype=torch.complex64,
                    device=x.device)
    ym = y[..., mb:]
    a = (taps, x, num, f, start)
    seam = torch.cat([hist, x[..., :seam_x]], dim=-1)
    check_complex_fir(taps, seam, mb, f, 0, f"{name} seam", y[..., :mb])
    check_complex_fir(*a, f"{name} main", ym)
    torch.cuda.synchronize()
    require(torch.isfinite(torch.view_as_real(y)).all().item(),
            f"{name} output finite")
    err = max_err(y, torch.cat([
        fir.fir_strided_reference(taps, seam, mb, f, 0),
        fir.fir_strided_reference(*a)], dim=-1))
    require(err == 0, f"{name} vs plain {err} != 0")
    require(same_bits(fir.fir_strided(*a), ym), f"{name}: two launches differ")
    xv = torch.view_as_real(x).movedim(-1, -2)          # [..., 2, n] view
    w = taps.view(1, 1, K).expand(2, 1, K).contiguous()

    def lib():
        v = xv.reshape(-1, 2, n_in)
        return torch.nn.functional.conv1d(v[..., start:], w, stride=f,
                                          groups=2)[..., :num]

    lib_err = max_err(lib(), torch.view_as_real(ym).reshape(
        -1, num, 2).movedim(-1, -2))
    b, by = bound(nbytes(x, taps, ym), 4 * K * ym.numel(), "f32")
    ms = time_ms(lambda: fir.fir_strided(*a, out=ym), 20)
    route_ms = time_ms(lambda: planar_route(*a), 20)
    xr = as_real_batch(x)[0]
    real_ms = time_ms(lambda: fir.fir_strided(taps, xr, num, f, start), 20)
    del xr
    row = dict(
        name=name, kernel="fir", route="cuda",
        source="sdr_tpu_torch/csrc/fir.cu",
        replaces="sdr_tpu/kernels/fir_pallas.py:145",
        shape=f"{list(x.shape)} complex64, strides {list(x.stride())} "
              f"({layout[0]}) -> {list(ym.shape)}, {K} taps, factor {f}, "
              f"start {start}; seam launch {list(seam.shape)} -> {mb}, "
              f"both into one [..., {n_out}]",
        layout=layout[0], plan=fir.plan(K, f, x.device, layout=layout[0]),
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: fir.fir_strided_reference(*a), 3, 1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        planar_route_ms=route_ms, planar_kernel_ms=real_ms,
        library_ms=time_ms(lib, 20), library_max_abs_diff=lib_err,
        library_note=f"grouped conv1d (groups 2, stride {f}) over "
                     "view_as_real(x).movedim(-1, -2), the call including "
                     "its reshape's copy to [rows, 2, n]")
    print_no_fma_floor(name, K, 2 * ym.numel())
    print(f"{name}: the parent's planar route {route_ms} ms (the real form "
          f"alone on planes made beforehand {real_ms} ms) against the "
          f"complex form's {ms} ms")
    return row


def complex_fir_geometries(device, seed: int) -> int:
    """K3's complex form at extra geometries, each bitwise its plain
    version and the planar route: rows at f in {1, 2, 3, 8, 16} x K in
    {1, 7, 51, 64, 200}, starts 0, 1 and f + 1, bases 0 and 1 complex
    (0 and 2 floats) off 16-byte alignment, the most outputs a row
    holds and one below and above the largest tile multiple in it, rows
    at a stride, leading dims [2, 3] and ``out=`` rows 5 complex wider;
    channel-major [2, C, n] at C in {1, 5, 31, 32, 33, 64, 100} (groups
    of 32 ragged or not) x f in {1, 2, 8, 16} x K in {7, 51, 64}, starts
    0 and 5, bases 0 and 1 complex off (the 16-byte copies and the 8-byte
    ones); and past the grid: 70,000 rows at factor 1 and 66,000
    channel-major rows of 450 taps, one thread an output."""
    from sdr_tpu_torch.kernels import fir
    g = torch.Generator(device=device).manual_seed(seed + 31)

    def cplx(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.complex64)

    count = 0
    for f in (1, 2, 3, 8, 16):
        for K in (1, 7, 51, 64, 200):
            taps = torch.randn(K, generator=g, device=device)
            tile = fir.plan(K, f, device, layout="rows")["tile"]
            n = 2 * tile * f + K + 40
            for off in (0, 1):
                buf = cplx(2 * 3 * (n + 9) + 8)
                x = buf[off: off + 6 * (n + 9)].view(2, 3, n + 9)[..., :n]
                for start in (0, 1, f + 1):
                    full = (n - start - K) // f + 1
                    m = (full - 1) // tile * tile
                    for num in {full, m - 1, m + 1} - {0, -1}:
                        out = None
                        if off:
                            out = cplx(2, 3, num + 5)[..., 5:]
                        check_complex_fir(taps, x, num, f, start,
                                          f"K3 complex rows f={f} K={K} "
                                          f"off={off} start={start}", out)
                        count += 1
    for C in (1, 5, 31, 32, 33, 64, 100):
        for f in (1, 2, 8, 16):
            for K in (7, 51, 64):
                taps = torch.randn(K, generator=g, device=device)
                tile = fir.plan(K, f, device, layout="channel-major")["tile"]
                n = 3 * tile * f + K + 3
                for off in (0, 1):
                    buf = cplx(2 * n * C + 8)
                    x = buf[off: off + 2 * n * C].view(2, n, C)
                    x = x.transpose(-1, -2)
                    for start in (0, 5):
                        num = (n - start - K) // f + 1
                        check_complex_fir(taps, x, num, f, start,
                                          f"K3 complex channel-major C={C} "
                                          f"f={f} K={K} off={off} "
                                          f"start={start}")
                        count += 1
    taps = torch.randn(7, generator=g, device=device)
    x = cplx(70_000, 40)
    require(fir.plan(7, 1, device, layout="rows")["branch"] == "per output",
            "K3 complex at factor 1")
    check_complex_fir(taps, x, 34, 1, 0, "K3 complex 70,000 rows",
                      planar=False)
    taps = torch.randn(450, generator=g, device=device)
    x = cplx(2, 460, 33_000).transpose(-1, -2)
    require(fir.plan(450, 8, device, layout="channel-major")["branch"]
            == "per output", "K3 complex channel-major at 450 taps")
    check_complex_fir(taps, x, 2, 8, 0, "K3 complex 66,000 channel rows",
                      planar=False)
    return count + 2


def complex_fir_switch(f: int, layout: str, branch: str, device) -> int:
    """The most taps the complex form's ``branch`` takes at factor ``f``
    in ``layout`` (its own plan's switch to one thread an output)."""
    from sdr_tpu_torch.kernels import fir
    lo, hi = 1, 58_112
    require(fir.plan(lo, f, device, layout=layout)["branch"] == branch,
            f"K3 complex {layout} at f = {f}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fir.plan(mid, f, device, layout=layout)["branch"] == branch:
            lo = mid
        else:
            hi = mid
    return lo


def check_complex_fir_limits(device, seed: int) -> None:
    """K3's complex form on both sides of each staged branch's switch to
    one thread an output (rows at f in {2, 8, 16}, channel-major at f =
    8), found through its plan, and at the most taps its shared memory
    holds (58,112), one more raising: bitwise its plain version."""
    from sdr_tpu_torch.kernels import fir
    g = torch.Generator(device=device).manual_seed(seed + 37)
    cases = []
    for f in (2, 8, 16):
        s = complex_fir_switch(f, "rows", "staged", device)
        cases += [("rows", f, s), ("rows", f, s + 1)]
    s = complex_fir_switch(8, "channel-major", "channel tile", device)
    cases += [("channel-major", 8, s), ("channel-major", 8, s + 1),
              ("rows", 2, 58_112), ("channel-major", 2, 58_112)]
    for layout, f, K in cases:
        taps = torch.randn(K, generator=g, device=device)
        shape = (2, K + 5 * f) if layout == "rows" else (2, K + 5 * f, 3)
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.complex64)
        if layout != "rows":
            x = x.transpose(-1, -2)
        check_complex_fir(taps, x, 6, f, 0,
                          f"K3 complex {layout} {K} taps f={f}")
        print(f"K3 complex {layout} at {K:,} taps, f = {f}: "
              f"{fir.plan(K, f, device, layout=layout)['branch']}, bitwise")
    x = torch.randn(2, 58_200, dtype=torch.complex64, device=device)
    try:
        fir.fir_strided(torch.randn(58_113, device=device), x, 6, 2)
    except RuntimeError as e:
        require("do not fit" in str(e), f"K3 complex raised {e}")
    else:
        require(False, "K3's complex form took 58,113 taps")
    print("K3 complex: 58,113 taps raise")


def require_no_layout_copy(what: str) -> None:
    """The last counted call copied no complex block to a layout K3 reads
    (``ops/fir.py``'s count, set to 0 by :func:`counted`)."""
    from sdr_tpu_torch.ops import fir as fir_ops
    require(fir_ops.layout_copies == 0,
            f"{what}: {fir_ops.layout_copies} complex blocks copied to a "
            "layout K3 reads")


PROFILE_LEAD = 32                     # spin kernels before a profiled call
PROFILE_TAIL = 32                     # spin kernels after it
PROFILE_SETTLE_S = 0.02               # host time before the first of them
PROFILE_TRIES = 8                     # sessions until two whole ones agree


def device_kernels(fn, word: str) -> dict:
    """The device kernels of one ``fn()`` under ``torch.profiler`` whose
    names hold ``word`` (any case): {name: launches}.  Late in a long
    process the profiler loses kernels of a session: the first ones (the
    first three of a call, fills and copies and K7 + DFT; once all of 8
    spin kernels launched back to back) and the last ones (8 of a 14-kernel
    graph replay's, its tail).  So a session waits PROFILE_SETTLE_S on the
    host, runs PROFILE_LEAD spin kernels of about 0.25 ms, each waited for,
    then ``fn()``, then PROFILE_TAIL more.  It is whole when, in the order
    the card ran them, a recorded spin kernel comes before the call's
    first kernel and another after its last, with none between; the
    result is the first reading two whole sessions gave alike (a loss only
    takes kernels away), within PROFILE_TRIES sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spin(n):
        for _ in range(n):
            torch.cuda._sleep(SLEEP_CYCLES // 40)
            torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    readings, seen = [], []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S)
            spin(PROFILE_LEAD)
            fn()
            torch.cuda.synchronize()
            spin(PROFILE_TAIL)
        ran = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        spun = ["spin_kernel" in e.name for e in ran]
        if False in spun:
            lead, tail = spun.index(False), spun[::-1].index(False)
        else:           # no kernel of the call: whole only with every spin
            lead, tail = len(spun), 0
            if lead == PROFILE_LEAD + PROFILE_TAIL:
                lead, tail = PROFILE_LEAD, PROFILE_TAIL
        inner = ran[lead:len(ran) - tail]
        seen.append((lead, len(inner), tail))
        if not lead or not tail or any("spin_kernel" in e.name
                                       for e in inner):
            continue
        got = {}
        for e in inner:
            got[e.name] = got.get(e.name, 0) + 1
        if got in readings:
            if len(seen) > 2 or any((a, b) != (PROFILE_LEAD, PROFILE_TAIL)
                                    for a, _, b in seen):
                print(f"profiler: {len(seen)} sessions for one reading "
                      f"(spin kernels before, the call's, spin kernels "
                      f"after: {seen})")
            return {k: n for k, n in got.items() if word in k.lower()}
        readings.append(got)
    raise RuntimeError(f"check failed: in {PROFILE_TRIES} profiler sessions "
                       "no two whole ones agreed (spin kernels before, the "
                       f"call's, spin kernels after: {seen})")


def require_launches(launches: dict, want: dict, what: str) -> None:
    """Each kernel of ``want`` launched exactly so often in one call, and
    every other kernel never."""
    for name, n in launches.items():
        require(n == want.get(name, 0),
                f"{what}: {name} launched {n} times, expected "
                f"{want.get(name, 0)} ({launches})")


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.function_launches = {}


def require_per_block(kernels, want: dict, blocks: int, what: str) -> None:
    """Each kernel of ``want`` launched ``want[name]`` times a block over a
    streamed run of ``blocks`` blocks, its counter set to 0 before it."""
    for k in kernels:
        if k.name in want:
            require(k.launches == want[k.name] * blocks,
                    f"{what}: {k.name} launched {k.launches} times in "
                    f"{blocks} blocks, expected {want[k.name]} a block")


def run_exact_chain(raw, ops, kernels):
    """The exact mono path (complex f32 front) block-parallel (launches,
    tone, peak memory, 20 timed calls), streamed, against the plain CPU
    chain and the fused mono chain, and its planar, unfused and FIR
    de-emphasis variants at 4 blocks against the plain CPU chain."""
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, raw, kernels)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    # the decimator's seam and main launches, the audio FIR; the resampler
    require_launches(launches, {"fir": 3, "resample": 1, "iq_convert": 1,
                                "fm_demod": 1}, "exact mono path")
    require_no_layout_copy("exact mono path")
    out = y.cpu().numpy()
    require(out.shape == (ROWS * ROW_BYTES // 160 * 3,),
            f"output shape {out.shape}")
    require(np.isfinite(out).all(), "exact chain output finite")
    hz = tone_hz(out)
    require(abs(hz - 1000) < 5, f"exact chain tone at {hz} Hz")
    print(f"exact mono block-parallel chain: {ROWS} x {ROW_BYTES} bytes; "
          f"peak memory {peak} bytes; tone {hz:.2f} Hz; launches in one "
          f"call {launches}")
    time_chain(ops, raw, "exact mono block-parallel chain")

    pipe = Pipeline(ops, block_in=STREAM_BLOCK)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        raw[i:i + STREAM_BLOCK] for i in range(0, raw.numel(),
                                               STREAM_BLOCK))))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"iq_convert": 1, "fm_demod": 1},
                      raw.numel() // STREAM_BLOCK, "exact streamed")
    # every kernel's sums and every elementwise op are per sample, so the
    # two agree but for the elementwise ops' rounding where a block edge
    # changes the code path that computes a sample (1 ulp on the CPU)
    dstream = max_err(streamed, y)
    require(dstream <= 1e-6,
            f"exact streamed op by op vs block-parallel {dstream} > 1e-6")
    print(f"exact streamed op by op at {STREAM_BLOCK}-byte blocks: max "
          f"abs diff to block-parallel {dstream} (bitwise equal: "
          f"{torch.equal(streamed, y)}); "
          f"{raw.numel() // 2 / t_stream:.6e} complex input samples/s")
    compiled_run(pipe, list(raw.split(STREAM_BLOCK)), streamed, "exact",
                 raw.numel() // 2)

    device = ops[0].device
    fused = run_time_batched(fm_chain(device=device), raw, ROWS)
    dfused = max_err(fused, y)
    require(dfused <= 1e-4, f"exact vs fused mono chain {dfused} > 1e-4")
    print(f"exact vs fused mono chain (s8 front, polynomial demod): max abs "
          f"diff {dfused}")

    small = raw[:4 * STREAM_BLOCK]
    for kw in ({}, {"planar": True}, {"fuse_back": False},
               {"deemphasis": 75e-6, "deemphasis_mode": "fir"}):
        _, ref = Pipeline(fm_chain(front="exact", device="cpu", **kw),
                          block_in=STREAM_BLOCK, device="cpu").process(
                              small.cpu())
        torch.cuda.synchronize()
        reset_launches(kernels)
        variant = Pipeline(fm_chain(front="exact", device=device, **kw),
                           block_in=STREAM_BLOCK)
        got = torch.cat(eager_stream(variant, small.split(STREAM_BLOCK)))
        torch.cuda.synchronize()
        diff = max_err(got.cpu(), ref)
        require(diff <= 1e-5, f"exact chain {kw}: card vs CPU plain chain "
                              f"{diff} > 1e-5")
        require_per_block(kernels, {"iq_convert": 1, "fm_demod": 1}, 4,
                          f"exact chain {kw} streamed")
        # process, as a user calls it: the compiled step (the first block
        # eager, the second captured, two replays)
        _, proc = variant.process(small)
        require(same_bits(proc, got), f"exact chain {kw}: process "
                "(compiled) != the eager stream")
        print(f"exact chain {kw or '(complex)'} streamed on 4 blocks: card "
              f"vs CPU plain chain max abs diff {diff}; launches op by op "
              f"{ {k.name: k.launches for k in kernels} }; process "
              "(compiled) bitwise the eager stream")
    return launches


def check_mix_kernel(mix_op, x, seed: int):
    """K8 as the planar ``Mix`` launches it over the AM path's planes
    ``x`` [32, 2, 5,242,880] with the op's oscillator table and a
    non-trivial unit phasor a row (seeded angles: the path's own phasors
    are all 1 at this block length and frequency), bitwise against the
    plain version; then at extra geometries (:func:`mix_geometries`).
    Timed with its bound; no single PyTorch call computes the function."""
    from sdr_tpu_torch.kernels import mix
    n = x.shape[-1]
    g = torch.Generator(device=x.device).manual_seed(seed)
    ang = torch.rand(x.shape[:-2], generator=g, dtype=torch.float64,
                     device=x.device) * (2 * np.pi)
    carry = torch.stack([ang.cos(), ang.sin()], dim=-1).float()
    a = (mix_op._table(n), carry, x)
    y = mix.mix_planar(*a)
    ref = mix.mix_planar_reference(*a)
    torch.cuda.synchronize()
    require(torch.isfinite(y).all().item(), "K8 output finite")
    require(torch.equal(y.view(torch.int32), ref.view(torch.int32)),
            f"K8 vs plain not bitwise (max abs diff {max_err(y, ref)})")
    err = max_err(y, ref)
    del ref
    count = mix_geometries(x.device, seed)
    b, by = bound(nbytes(*a, y), 12 * x.numel() // 2, "f32")
    ms = time_ms(lambda: mix.mix_planar(*a), 20)
    print(f"K8 mix_planar: bitwise its plain version at {list(x.shape)} and "
          f"at {count} extra geometries")
    return dict(
        name=f"K8 mix_planar (AM planar Mix, {list(x.shape)} f32)",
        kernel="mix", route="cuda", source="sdr_tpu_torch/csrc/mix.cu",
        replaces="none: sdr_tpu/stream/ops.py:1148-1154 (Mix planar: two "
                 "planar rotations XLA fuses into one pass)",
        shape=f"table [2, {n}], phasors {list(carry.shape)}, "
              f"{list(x.shape)} -> the same",
        max_abs_err=err, bitwise=True, geometries=count, ms=ms,
        plain_ms=time_ms(lambda: mix.mix_planar_reference(*a), 3, 1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms, library_ms=None,
        library_note="none: no single PyTorch call rotates planar I/Q by a "
                     "table and a phasor a row")


def mix_geometries(device, seed: int) -> int:
    """K8 bitwise against its plain version at n in {1, 6, 1,027, 4,099,
    65,539} (none a multiple of 4) and 4,096, leading dims [3] and [2, 3],
    the planes and the table at bases 0-3 floats off 16-byte alignment;
    returns the count."""
    from sdr_tpu_torch.kernels import mix
    g = torch.Generator(device=device).manual_seed(seed + 1)
    count = 0
    for n in (1, 6, 1_027, 4_096, 4_099, 65_539):
        for lead in ((3,), (2, 3)):
            for off in range(4):
                lo = misaligned(torch.randn(2, n, generator=g,
                                            device=device), off)
                ang = torch.rand(lead, generator=g, device=device) * 6.283
                carry = torch.stack([ang.cos(), ang.sin()], dim=-1)
                x = misaligned(torch.randn(lead + (2, n), generator=g,
                                           device=device), off)
                y = mix.mix_planar(lo, carry, x)
                ref = mix.mix_planar_reference(lo, carry, x)
                require(torch.equal(y.view(torch.int32),
                                    ref.view(torch.int32)),
                        f"K8 at n {n}, lead {lead}, offset {off}: not "
                        f"bitwise (max abs diff {max_err(y, ref)})")
                count += 1
    return count


def check_mix_complex_kernel(mix_op, x, seed: int):
    """K8's complex form as the complex ``Mix`` launches it over the AM
    sequential path's rows ``x`` [32, 5,242,880] complex64 with the op's
    table and a seeded unit phasor a row, bitwise against its plain
    version; then at extra geometries (:func:`mix_complex_geometries`).
    Timed with its bound beside ``x * lo`` alone (one pass, not the same
    function)."""
    from sdr_tpu_torch.kernels import mix
    n = x.shape[-1]
    g = torch.Generator(device=x.device).manual_seed(seed)
    ang = torch.rand(x.shape[:-1], generator=g, dtype=torch.float64,
                     device=x.device) * (2 * np.pi)
    carry = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    lo = mix_op._table(n)
    a = (lo, carry, x)
    y = mix.mix_complex(*a)
    ref = mix.mix_complex_reference(*a)
    torch.cuda.synchronize()
    require(torch.isfinite(torch.view_as_real(y)).all().item(),
            "K8 complex output finite")
    require(same_bits(torch.view_as_real(y), torch.view_as_real(ref)),
            f"K8 complex vs plain not bitwise (max abs diff "
            f"{(y - ref).abs().max().item()})")
    del ref
    check_repeatable(lambda: torch.view_as_real(mix.mix_complex(*a)),
                     "K8 complex")
    count = mix_complex_geometries(x.device, seed)
    b, by = bound(nbytes(*a, y), 12 * x.numel(), "f32")
    ms = time_ms(lambda: mix.mix_complex(*a), 20)
    print(f"K8 mix_complex: bitwise its plain version at {list(x.shape)} and "
          f"at {count} extra geometries")
    return dict(
        name=f"K8 mix_complex (AM sequential complex Mix, {list(x.shape)} "
             "complex64)",
        kernel="mix", route="cuda", source="sdr_tpu_torch/csrc/mix.cu",
        replaces="none: sdr_tpu/stream/ops.py:1163 (Mix complex: x * lo * "
                 "carry, one XLA fusion)",
        shape=f"table [{n}], phasors {list(carry.shape)}, {list(x.shape)} "
              "-> the same",
        max_abs_err=0.0, bitwise=True, geometries=count, ms=ms,
        plain_ms=time_ms(lambda: mix.mix_complex_reference(*a), 3, 1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        library_ms=time_ms(lambda: x * lo, 20),
        library_note="x * lo alone: one complex multiply, one pass (not the "
                     "same function); the port's former complex Mix was it "
                     "and a second pass by the phasor",
        former_ms=time_ms(lambda: x * lo * carry[..., None], 20))


def mix_complex_geometries(device, seed: int) -> int:
    """K8's complex form bitwise against its plain version at n in {1, 6,
    1,027, 4,096, 4,099, 65,539}, leading dims [3] and [2, 3], the rows
    and the table at bases 0 and 1 complex sample off 16-byte alignment,
    in both orders (table and rows apart); returns the count."""
    from sdr_tpu_torch.kernels import mix
    g = torch.Generator(device=device).manual_seed(seed + 4)
    count = 0
    for n in (1, 6, 1_027, 4_096, 4_099, 65_539):
        for lead in ((3,), (2, 3)):
            for off_lo, off_x in ((0, 0), (1, 1), (0, 1), (1, 0)):
                lo = misaligned(torch.randn(n, generator=g, device=device,
                                            dtype=torch.complex64), off_lo)
                carry = torch.randn(lead, generator=g, device=device,
                                    dtype=torch.complex64)
                carry = carry / carry.abs()
                x = misaligned(torch.randn(lead + (n,), generator=g,
                                           device=device,
                                           dtype=torch.complex64), off_x)
                y = mix.mix_complex(lo, carry, x)
                ref = mix.mix_complex_reference(lo, carry, x)
                require(same_bits(torch.view_as_real(y),
                                  torch.view_as_real(ref)),
                        f"K8 complex at n {n}, lead {lead}, offsets "
                        f"{off_lo, off_x}: not bitwise")
                count += 1
    return count


ANGLE = 2e-6                          # PERF.md's demod limit, rad
ULP_PI = float(np.spacing(np.float32(np.pi)))   # an ulp of pi in f32
IQ_FORMS = (("u8", True), ("u8", False), ("i16", True), ("i16", False))
# K11's planar atan2f form against the card's torch.atan2: bitwise at
# every sample checked, and the largest distance (set by check_exact)
ATAN2F = {"bitwise": True, "max_rad": 0.0}


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s f32 words as int32 (complex: its real and imaginary
    parts)."""
    return (torch.view_as_real(t) if t.is_complex() else t).contiguous() \
        .view(torch.int32)


def angular(a: torch.Tensor, b: torch.Tensor):
    """(largest angular distance ``|remainder(a - b + pi, 2 pi) - pi|`` in
    float64, where a flip from -pi to +pi is 0; how many samples differ
    at all)."""
    if a.numel() == 0:
        return 0.0, 0
    d = torch.remainder(a.double() - b.double() + np.pi, 2 * np.pi) - np.pi
    return d.abs().max().item(), int((a != b).sum().item())


def check_exact(y, ref, what: str) -> float:
    """K11's planar atan2f form against the plain ``torch.atan2``: bitwise
    where the card's ``torch.atan2`` is ``atan2f``, else within an ulp of
    pi (recorded in ATAN2F); returns the distance."""
    dist, differ = angular(y, ref)
    if differ:
        ATAN2F["bitwise"] = False
        ATAN2F["max_rad"] = max(ATAN2F["max_rad"], dist)
    require(dist <= ULP_PI, f"{what}: K11 atan2f vs torch.atan2 {dist} rad "
                            f"> an ulp of pi ({differ} samples differ)")
    return dist


def iq_int(shape, fmt: str, g, device) -> torch.Tensor:
    """Seeded interleaved IQ: u8 over 0-255, or int16 over its range."""
    lo, hi = (0, 256) if fmt == "u8" else (-32768, 32768)
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32,
                         device=device).to(
        torch.uint8 if fmt == "u8" else torch.int16)


def check_iq_convert_kernel(raw, seed: int):
    """K10 at the paths' batch, u8 [32, 10,485,760] from ``raw``: planar
    [32, 2, 5,242,880] (AM, the waterfall) and complex64 [32, 5,242,880]
    (exact, the complex waterfall, AM sequential); and seeded int16 IQ of
    the same shape both ways (no path reads int16).  Each bitwise its
    plain version, timed with its bound beside the cast ``x.to(float32)``
    alone (no single PyTorch call computes the conversion); then the
    extra geometries (:func:`iq_convert_geometries`).  Returns the u8
    rows."""
    from sdr_tpu_torch.kernels import iq_convert
    g = torch.Generator(device=raw.device).manual_seed(seed + 2)
    inputs = {"u8": raw.view(ROWS, ROW_BYTES),
              "i16": iq_int((ROWS, ROW_BYTES), "i16", g, raw.device)}
    rows = []
    for fmt, planar in IQ_FORMS:
        x = inputs[fmt]
        y = iq_convert.iq_convert(x, planar)
        ref = iq_convert.iq_convert_reference(x, planar)
        torch.cuda.synchronize()
        require(y.shape == ref.shape and y.dtype == ref.dtype,
                f"K10 {fmt} planar={planar}: {y.shape} {y.dtype}")
        require(torch.equal(bits(y), bits(ref)),
                f"K10 {fmt} planar={planar} vs plain not bitwise")
        del ref
        b, by = bound(nbytes(x, y), x.numel(), "f32")
        ms = time_ms(lambda: iq_convert.iq_convert(x, planar), 20)
        row = dict(
            name=f"K10 iq_convert ({fmt} -> "
                 f"{'planar f32' if planar else 'complex64'}, "
                 f"{list(x.shape)} -> {list(y.shape)})",
            kernel="iq_convert", route="cuda",
            source="sdr_tpu_torch/csrc/iq_convert.cu",
            replaces="none: sdr_tpu/stream/ops.py:46 IqConvertU8, :77 "
                     "IqConvertI16 (sdr_tpu/ops/convert.py:30-94, one "
                     "elementwise expression XLA fuses into one pass)",
            max_abs_err=0.0, bitwise=True, ms=ms,
            plain_ms=time_ms(lambda: iq_convert.iq_convert_reference(
                x, planar), 3, 1),
            bound_ms=b, bound_by=by, bound_fraction=b / ms,
            library_ms=time_ms(lambda: x.to(torch.float32), 20),
            library_note="the cast x.to(float32) alone: no single PyTorch "
                         "call converts interleaved IQ")
        del y
        if fmt == "u8":
            rows.append(row)
        else:
            print(f"{row['name']}: bitwise its plain version, {ms} ms, "
                  f"plain {row['plain_ms']} ms, cast alone "
                  f"{row['library_ms']} ms, bound {b} ms ({by}), "
                  f"bound_fraction {b / ms} (not on a path)")
    count = iq_convert_geometries(raw.device, seed)
    for r in rows:
        r["geometries"] = count
    print(f"K10 iq_convert: bitwise its plain version in all four forms at "
          f"{[ROWS, ROW_BYTES]} and at {count} extra geometries")
    return rows


def iq_convert_geometries(device, seed: int) -> int:
    """K10 bitwise against its plain version in its four forms at n in
    {0, 1, 7, 8, 9, 2,047, 2,049, 65,537} pairs, leading dims [], [3] and
    [2, 3], the input's base 0-15 bytes off 16-byte alignment (u8; int16
    0-7 elements); returns the count."""
    from sdr_tpu_torch.kernels import iq_convert
    g = torch.Generator(device=device).manual_seed(seed + 4)
    count = 0
    for fmt, planar in IQ_FORMS:
        for n in (0, 1, 7, 8, 9, 2_047, 2_049, 65_537):
            for lead in ((), (3,), (2, 3)):
                v = iq_int(lead + (2 * n,), fmt, g, device)
                for off in range(16 if fmt == "u8" else 8):
                    x = misaligned(v, off)
                    y = iq_convert.iq_convert(x, planar)
                    ref = iq_convert.iq_convert_reference(x, planar)
                    require(y.shape == ref.shape and torch.equal(
                        bits(y), bits(ref)),
                        f"K10 {fmt} planar={planar} at n {n}, lead {lead},"
                        f" offset {off}: not bitwise")
                    count += 1
    return count


def _demod_call(form: str, plain: bool):
    """K11's wrapper (or its plain version) for ``form``: 'poly' and
    'exact' planar, or 'complex'."""
    from sdr_tpu_torch.kernels import fm_demod
    if form == "complex":
        return (fm_demod.fm_demod_complex_reference if plain
                else fm_demod.fm_demod_complex)
    fn = (fm_demod.fm_demod_planar_reference if plain
          else fm_demod.fm_demod_planar)
    return lambda x, c: fn(x, c, atan2=form)


def _demod_agrees(form: str, y, ref, what: str) -> float:
    """The form's agreement: the polynomial bitwise, atan2f by
    :func:`check_exact`, the complex form within ANGLE."""
    if form == "poly":
        require(torch.equal(bits(y), bits(ref)),
                f"{what}: K11 vs plain not bitwise")
        return 0.0
    if form == "exact":
        return check_exact(y, ref, what)
    dist, differ = angular(y, ref)
    require(dist <= ANGLE, f"{what}: K11 vs plain {dist} rad > {ANGLE} "
                           f"({differ} samples differ)")
    return dist


def check_fm_demod_kernel(name: str, demod_op, x, seed: int, forms=None):
    """K11 as ``FmDemod`` launches it over the batch ``x`` (planar
    [..., 2, n] or complex64 [..., n]) with each row's carry from the
    halo and with seeded random carries, in the op's form (and the planar
    forms in ``forms``): the polynomial bitwise its plain version, atan2f
    bitwise or within an ulp of pi (:func:`check_exact`), the complex
    form within 2e-6 rad of angular distance (H15: the plain product may
    contract to FMA; the largest distance and the samples that differ at
    all are printed); the new carry bitwise.  Timed with its bound,
    beside ``torch.angle`` on the product made beforehand (the yardstick)
    and ``fast_atan2`` alone.  Returns one row a form."""
    from sdr_tpu_torch.ops.demod import fast_atan2
    planar = demod_op.planar
    forms = forms or ([demod_op.atan2] if planar else ["complex"])
    carry = demod_op.shard_carry(x).contiguous()
    g = torch.Generator(device=x.device).manual_seed(seed + 3)
    rnd = torch.randn(carry.shape, generator=g, dtype=carry.dtype,
                      device=x.device)
    # the product x[m] * conj(x[m - 1]) made beforehand, and its parts
    if planar:
        prev = torch.cat([carry[..., None], x[..., :-1]], dim=-1)
        re, im, pre, pim = x[..., 0, :], x[..., 1, :], prev[..., 0, :], \
            prev[..., 1, :]
        bq, a = im * pre - re * pim, re * pre + im * pim
        prod = torch.complex(a, bq)
        del prev
    else:
        prod = x * torch.cat([carry[..., None], x[..., :-1]], dim=-1).conj()
        bq, a = prod.imag.contiguous(), prod.real.contiguous()
    rows = []
    for form in forms:
        run, plain = _demod_call(form, False), _demod_call(form, True)
        err = 0.0
        for c in (carry, rnd):
            y, new = run(x, c)
            ref, rnew = plain(x, c)
            torch.cuda.synchronize()
            require(torch.isfinite(y).all().item(), f"{name} output finite")
            err = max(err, _demod_agrees(form, y, ref, f"{name} {form}"))
            require(torch.equal(bits(new), bits(rnew)),
                    f"{name} {form}: new carry != plain")
            differ = int((y != ref).sum().item())
            del ref
        y, _ = run(x, carry)
        b, by = bound(nbytes(x, carry, y), 28 * y.numel(), "f32")
        ms = time_ms(lambda: run(x, carry), 20)
        lib_ms = time_ms(lambda: torch.angle(prod), 20)
        fast_ms = time_ms(lambda: fast_atan2(bq, a), 3, 1)
        agree = {"poly": "bitwise",
                 "exact": f"atan2f vs torch.atan2: {err} rad, {differ} "
                          "samples differ (random carry)",
                 "complex": f"angular {err} rad, {differ} samples differ "
                            "(random carry)"}[form]
        print(f"{name} {form}: {agree}; {ms} ms; torch.angle on the product "
              f"made beforehand {lib_ms} ms; fast_atan2 alone {fast_ms} ms")
        rows.append(dict(
            name=f"{name} ({form})", kernel="fm_demod", route="cuda",
            source="sdr_tpu_torch/csrc/fm_demod.cu",
            replaces="none: sdr_tpu/stream/ops.py:585-617 FmDemod "
                     "(sdr_tpu/ops/demod.py:29-44, 70-121: shifted views "
                     "through one fusion root, one pass in XLA)",
            shape=f"{list(x.shape)} -> {list(y.shape)}",
            max_abs_err=err, error_metric="angular distance, rad",
            agreement=agree, ms=ms,
            plain_ms=time_ms(lambda: plain(x, carry), 3, 1),
            bound_ms=b, bound_by=by, bound_fraction=b / ms,
            library_ms=lib_ms, fast_atan2_ms=fast_ms,
            library_note="torch.angle on the product x[m] * conj(x[m-1]) "
                         "made beforehand: no single PyTorch call "
                         "demodulates"))
        del y
    del prod, bq, a
    return rows


def fm_demod_geometries(device, seed: int) -> int:
    """K11 in its three forms at n in {0, 1, 7, 8, 9, 1,023, 1,025, 2,053,
    65,537} (a row's later tiles start one sample into their window: H3),
    leading dims [], [3] and [2, 3], bases 0-3 floats (complex 0-1
    samples) off 16-byte alignment, zero and random carries, against its
    plain version as :func:`_demod_agrees` holds it; an empty block
    passes its carry through.  Returns the count."""
    g = torch.Generator(device=device).manual_seed(seed + 5)
    count = 0
    for form in ("poly", "exact", "complex"):
        run, plain = _demod_call(form, False), _demod_call(form, True)
        dt = torch.complex64 if form == "complex" else torch.float32
        for n in (0, 1, 7, 8, 9, 1_023, 1_025, 2_053, 65_537):
            for lead in ((), (3,), (2, 3)):
                shape = lead + ((n,) if form == "complex" else (2, n))
                cshape = lead + (() if form == "complex" else (2,))
                for off in range(2 if form == "complex" else 4):
                    for zero in (True, False):
                        x = misaligned(torch.randn(shape, generator=g,
                                                   dtype=dt, device=device),
                                       off)
                        c = (torch.zeros(cshape, dtype=dt, device=device)
                             if zero else torch.randn(
                                 cshape, generator=g, dtype=dt,
                                 device=device))
                        y, new = run(x, c)
                        what = (f"K11 {form} at n {n}, lead {lead}, offset "
                                f"{off}, {'zero' if zero else 'random'} "
                                "carry")
                        ref, rnew = plain(x, c)
                        require(y.shape == ref.shape, f"{what}: {y.shape}")
                        _demod_agrees(form, y, ref, what)
                        require(torch.equal(bits(new), bits(rnew)),
                                f"{what}: new carry")
                        count += 1
    return count

def run_am_chain(raw, ops, kernels):
    """The AM path block-parallel (launches, tone, peak memory, 20 timed
    calls), streamed at the CLI's blocks, and against the plain CPU
    chain."""
    from sdr_tpu_torch.apps.chains import am_chain
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, raw, kernels)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    # the planar mix; the channel decimator's seam and main launches; K12's
    # reduce (Agc.shard_carry) and scan (Agc.apply); K13's final state
    # (DcBlocker.shard_carry) and output (DcBlocker.apply); K15 in each
    # shard_carry (Agc, DcBlocker); K16 in AmDemod
    require_launches(launches, {"fir": 2, "mix": 1, "iq_convert": 1,
                                "agc_linear": 2, "iir": 2,
                                "affine_prefix": 2, "am_envelope": 1},
                     "AM path")
    out = y.cpu().numpy()
    require(out.shape == (ROWS * ROW_BYTES // 32,), f"AM output {out.shape}")
    require(np.isfinite(out).all(), "AM output finite")
    hz = am_tone_hz(out)
    require(abs(hz - F_AM) < 10, f"AM tone at {hz} Hz")
    print(f"AM block-parallel chain: {ROWS} x {ROW_BYTES} bytes; peak "
          f"memory {peak} bytes; tone {hz:.2f} Hz at {AM_RATE} S/s; "
          f"launches in one call {launches}")
    time_chain(ops, raw, "AM block-parallel chain")

    pipe = Pipeline(ops, block_in=AM_BLOCK)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        raw[i:i + AM_BLOCK] for i in range(0, raw.numel(), AM_BLOCK))))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"iq_convert": 1, "mix": 1, "agc_linear": 1,
                                "iir": 1, "am_envelope": 1,
                                "affine_prefix": 0},
                      raw.numel() // AM_BLOCK, "AM streamed")
    dstream = max_err(streamed, y)
    require(dstream <= 1e-4, f"AM streamed vs block-parallel {dstream}")
    print(f"AM streamed op by op at {AM_BLOCK}-byte blocks: max abs diff "
          f"to block-parallel {dstream}; "
          f"{raw.numel() // 2 / t_stream:.6e} complex input samples/s")
    compiled_run(pipe, list(raw.split(AM_BLOCK)), streamed, "AM",
                 raw.numel() // 2)

    _, ref = Pipeline(am_chain(device="cpu"), block_in=AM_BLOCK,
                      device="cpu").process(raw[:4 * AM_BLOCK].cpu())
    diff = max_err(streamed[:ref.shape[-1]].cpu(), ref)
    require(diff <= 1e-4, f"AM card vs CPU plain chain {diff} > 1e-4")
    print(f"AM card vs CPU plain chain on 4 blocks: max abs diff {diff}")
    return launches


def run_am_cli(raw):
    """``python -m sdr_tpu_torch.apps.am`` on a temporary recording of 16
    blocks of the AM capture: the tone at rate // decim."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "am.u8"), os.path.join(tmp, "am.wav")
        capture = raw[:16 * AM_BLOCK]
        capture.cpu().numpy().tofile(src)
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", "sdr_tpu_torch.apps.am", "--in", src,
             "--out", out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        print(f"am cli: rc {proc.returncode} {proc.stdout.strip()}")
        require(proc.returncode == 0, f"am cli failed: {proc.stderr}")
        with wave.open(out, "rb") as wf:
            rate = wf.getframerate()
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
    require(rate == AM_RATE, f"AM WAV rate {rate}")
    require(len(pcm) == capture.numel() // 32, f"AM WAV samples {len(pcm)}")
    hz = am_tone_hz(pcm.astype(np.float64), rate)
    require(abs(hz - F_AM) < 10, f"am cli tone at {hz} Hz")
    print(f"am cli: {len(pcm)} samples at {rate} Hz, tone {hz:.2f} Hz")


def check_agc_kernel(agc_op, x):
    """K6 at the AM path's shapes: the decimated [32, 327,680] complex64
    rows from the gains its sweep hands them.  Bitwise against the plain
    version on the card over the first AGC_PREFIX samples of every row
    (a prefix of a causal recurrence is an exact check of those samples),
    over two whole rows on their CPU copy, and over the whole batch on
    the card (timed); the stores-off launch gives the same gains.  Timed
    beside the linear form (``scans.agc``, another algorithm with the same
    output while the gain stays positive), with its bytes bound and its
    latency bound (a row's samples times the step's dependent cycles, at
    this run's measured latencies and clock)."""
    from sdr_tpu_torch.kernels import agc
    from sdr_tpu_torch.ops import scans
    mu, ref = agc_op.mu, agc_op.reference
    enter = agc_op.shard_carry(x)
    y, g = agc.agc_scan(x, mu, ref, enter)
    pre = x[:, :AGC_PREFIX].contiguous()
    yp, gp = agc.agc_scan_reference(pre, mu, ref, enter)
    yk, gk = agc.agc_scan(pre, mu, ref, enter)
    err = max(max_err(y[:, :AGC_PREFIX], yp), max_err(yk, yp),
              max_err(gk, gp))
    yc, gc = agc.agc_scan_reference(x[:2].cpu(), mu, ref, enter[:2].cpu())
    err_cpu = max(max_err(yc, y[:2].cpu()), max_err(gc, g[:2].cpu()))
    _, g_off = agc.agc_scan(x, mu, ref, enter, store=False)
    torch.cuda.synchronize()
    require(torch.isfinite(y).all().item(), "K6 output finite")
    require(err == 0, f"K6 vs plain on the card ({AGC_PREFIX}-sample "
                      f"prefix of {x.shape[0]} rows) {err} != 0")
    require(err_cpu == 0, f"K6 vs plain on the CPU (two rows) {err_cpu}")
    require(torch.equal(g_off, g), "K6 with the stores off: other gains")
    out = []                          # the one timed plain run's result
    plain_ms = time_ms(
        lambda: out.append(agc.agc_scan_reference(x, mu, ref, enter)), 1, 0)
    err_full = max(max_err(out[0][0], y), max_err(out[0][1], g))
    require(err_full == 0, f"K6 vs plain on the card, whole batch "
                           f"{err_full} != 0")
    del out

    def lib():
        return scans.agc(x, mu, ref, enter)

    lib_diff = max_err(lib()[0], y)
    n, measured = x.shape[-1], CEILINGS["measured"]
    b, by = bound(nbytes(x, enter, y, g), 9 * x.numel(), "f32")
    latency = n * measured.step_cycles / measured.clock_hz * 1e3
    ms = time_ms(lambda: agc.agc_scan(x, mu, ref, enter), 5)
    ms_off = time_ms(lambda: agc.agc_scan(x, mu, ref, enter, store=False),
                     5)
    print(f"K6 agc_scan: bitwise its plain version over the {AGC_PREFIX}-"
          f"sample prefix of {x.shape[0]} rows (card), two whole rows "
          f"(CPU) and the whole batch (card); {ms} ms a pass, {ms_off} ms "
          f"with the stores off; latency bound {latency} ms ({n} samples x "
          f"{measured.step_cycles} cycles at {measured.clock_hz / 1e9} GHz, "
          "the step's chain at this run's measured latencies and clock)")
    return dict(
        name=f"K6 agc_scan (AM sequential AGC, complex {list(x.shape)})",
        kernel="agc_scan", route="cuda",
        source="sdr_tpu_torch/csrc/agc_scan.cu",
        replaces="none: sdr_tpu/ops/scans.py:146 (lax.scan, the step at "
                 ":139)",
        shape=f"{list(x.shape)} complex64 -> the same and {list(g.shape)} "
              "gains",
        max_abs_err=max(err, err_cpu, err_full), ms=ms, ms_stores_off=ms_off,
        plain_ms=plain_ms, bound_ms=b, bound_by=by, bound_fraction=b / ms,
        latency_bound_ms=latency, latency_fraction=latency / ms,
        library_ms=time_ms(lib, 5), library_max_abs_diff=lib_diff,
        library_note="the linear form (scans.agc, method='linear', chunked "
                     "associative scans): another algorithm, the same "
                     "output while the gain stays positive")


AGC_FORMS = ((0.005, 0.0, 2.0), (0.5, 1.9, 1.999))   # (mu, |x| range)


def peak_err(y, ref) -> tuple:
    """(the largest ``|y - ref|`` over each row's peak ``|ref|``, the row
    it is in): K13's and the waterfall's measure."""
    if ref.numel() == 0:
        return 0.0, 0
    d = (y - ref).abs().reshape(-1, ref.shape[-1]).amax(-1)
    peak = ref.abs().reshape(-1, ref.shape[-1]).amax(-1).clamp_min(1e-30)
    rel = d / peak
    row = int(rel.argmax().item())
    return rel[row].item(), row


def same_bits(a, b) -> bool:
    """Tensors, or tuples of them, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return all(u.shape == v.shape and torch.equal(bits(u), bits(v))
               for u, v in zip(a, b))


def check_repeatable(fn, what: str) -> None:
    """Two launches back to back, bitwise equal: K12's and K13's tickets
    order the blocks, never the arithmetic."""
    first = fn()
    require(same_bits(first, fn()), f"{what}: two launches differ")


def time_steady(fn, reps: int, what: str) -> float:
    """:func:`time_ms` over ``reps`` calls, the last call's result bitwise
    the result of a call made before them."""
    first, held = fn(), {}

    def call():
        held["last"] = fn()

    ms = time_ms(call, reps)
    require(same_bits(first, held["last"]),
            f"{what}: the last of {reps} timed calls differs from the first")
    return ms


def check_agc_linear_kernel(agc_op, x, seed: int):
    """K12 at the AM path's planar batch ``x`` [32, 2, 327,677] (the
    channel filter's output): the reduce mode (each row's map, as
    ``Agc.shard_carry`` runs it) and the scan mode (``Agc.apply``, from
    the path's entering gains and from seeded ones), over the planes and
    over the complex form's envelopes ``|x|``, each bitwise its plain
    version; then the extra geometries (:func:`agc_linear_geometries`).
    Timed with their bounds and ``torch.cumsum`` over the same rows, a
    one-pass scan that is not the same function (no single PyTorch call
    computes a linear recurrence)."""
    from sdr_tpu_torch.kernels import agc_linear as k12
    mu, ref = agc_op.mu, agc_op.reference
    g = torch.Generator(device=x.device).manual_seed(seed + 5)
    enter = agc_op.shard_carry(x)
    seeded = torch.rand(enter.shape, generator=g, device=x.device) * 1.5 \
        + 0.5
    m = torch.complex(x[:, 0], x[:, 1]).abs()
    checks = 0
    for src, planar in ((x, True), (m, False)):
        A, B = k12.agc_affine(src, mu, ref, planar)
        rA, rB = k12.agc_affine_reference(src, mu, ref, planar)
        require(same_bits((A, B), (rA, rB)),
                f"K12 reduce (planar={planar}) vs plain not bitwise")
        for g0 in (enter, seeded):
            call = k12.agc_apply if planar else k12.agc_gains
            plain = (k12.agc_apply_reference if planar
                     else k12.agc_gains_reference)
            y, f = call(src, mu, ref, g0)
            ry, rf = plain(src, mu, ref, g0)
            require(torch.isfinite(y).all().item(), "K12 output finite")
            require(same_bits((y, f), (ry, rf)),
                    f"K12 scan (planar={planar}) vs plain not bitwise "
                    f"(max abs diff {max_err(y, ry)})")
            checks += 1
            del y, ry
    count = agc_linear_geometries(x.device, seed)
    check_repeatable(lambda: k12.agc_apply(x, mu, ref, enter), "K12 scan")
    check_repeatable(lambda: k12.agc_affine(x, mu, ref, True), "K12 reduce")
    y, f = k12.agc_apply(x, mu, ref, enter)
    A, B = k12.agc_affine(x, mu, ref, True)
    yg, fg = k12.agc_gains(m, mu, ref, enter)
    cumsum_ms = time_ms(lambda: torch.cumsum(x, -1), 20)
    rows = []
    # operations a sample: the envelope (4), the map (2), the recurrence
    # (2), the scaling (2); the gains over envelopes made beforehand (the
    # complex AM form) take the map and the recurrence only
    for mode, fn, plain, ins, outs, ops, what in (
            ("scan", lambda: k12.agc_apply(x, mu, ref, enter),
             lambda: k12.agc_apply_reference(x, mu, ref, enter),
             (x, enter), (y, f), 10, f"AM planar {list(x.shape)}"),
            ("reduce", lambda: k12.agc_affine(x, mu, ref, True),
             lambda: k12.agc_affine_reference(x, mu, ref, True),
             (x,), (A, B), 8, f"AM planar {list(x.shape)}"),
            ("gains", lambda: k12.agc_gains(m, mu, ref, enter),
             lambda: k12.agc_gains_reference(m, mu, ref, enter),
             (m, enter), (yg, fg), 4, f"envelopes {list(m.shape)}")):
        b, by = bound(nbytes(*ins, *outs), ops * m.numel(), "f32")
        ms = time_steady(fn, 20, f"K12 {mode}")
        rows.append(dict(
            name=f"K12 agc_linear ({mode}, {what})",
            kernel="agc_linear", route="cuda",
            source="sdr_tpu_torch/csrc/agc_linear.cu",
            replaces="none: sdr_tpu/ops/scans.py:44-61 linear_scan "
                     "(jax.lax.associative_scan) under agc_gains :97-114 "
                     "and agc_affine :83-94",
            max_abs_err=0.0, bitwise=True, checks=checks, geometries=count,
            ms=ms, plain_ms=time_ms(plain, 3, 1), bound_ms=b, bound_by=by,
            bound_fraction=b / ms, library_ms=None, cumsum_ms=cumsum_ms,
            library_note="none: no single PyTorch call computes a linear "
                         "recurrence; cumsum_ms is torch.cumsum over the "
                         "same planes, a one-pass scan, not the same "
                         "function"))
    print(f"K12 agc_linear: bitwise its plain version in both modes over "
          f"the planes and the envelopes at {list(x.shape)} ({checks} scans "
          f"from the path's and seeded gains) and at {count} extra "
          f"geometries; two launches bitwise equal, the last of 20 timed "
          f"calls bitwise the first")
    return rows


def agc_linear_geometries(device, seed: int) -> int:
    """K12 bitwise against its plain version in both modes, over planar
    I/Q and over envelopes, at rows 1-5 and 32, n in {0, 1, 2, 127, 128,
    129, 255} and 2*128*k +- 1 for k in {1, 4, 20}, the input 0-3 floats
    off 16-byte alignment, seeded entering gains, and mu*|x| typical
    (0.005 over |x| < 2) and near 1 (0.5 over |x| in [1.9, 1.999]); then
    more rows than one wave of the scan's tickets ([100, 40,000], 26 rows
    a wave of planes) and rows past the scan's shared-memory doubling
    ([7, 600,001], a row a wave, the doubling in place in scratch);
    returns the count."""
    from sdr_tpu_torch.kernels import agc_linear as k12
    g = torch.Generator(device=device).manual_seed(seed + 6)
    ns = [0, 1, 2, 127, 128, 129, 255] + [2 * 128 * k + d for k in (1, 4, 20)
                                          for d in (-1, 1)]
    count = 0
    shapes = [(rows, n) for rows in (1, 2, 3, 4, 5, 32) for n in ns] + [
        (100, 40_000), (7, 600_001)]
    for rows, n in shapes:
        for mu, lo, hi in AGC_FORMS:
            mag = torch.rand((rows, n), generator=g, device=device) \
                * (hi - lo) + lo
            ang = torch.rand((rows, n), generator=g, device=device) \
                * 6.283
            x = misaligned(torch.stack([mag * ang.cos(), mag * ang.sin()],
                                       dim=-2), (rows + n) % 4)
            mg = misaligned(mag, n % 4)
            g0 = torch.rand(rows, generator=g, device=device) * 1.5 + 0.5
            what = f"K12 at rows {rows}, n {n}, mu {mu}"
            for got, want in (
                    (k12.agc_affine(x, mu, 1.0, True),
                     k12.agc_affine_reference(x, mu, 1.0, True)),
                    (k12.agc_affine(mg, mu, 1.0),
                     k12.agc_affine_reference(mg, mu, 1.0)),
                    (k12.agc_apply(x, mu, 1.0, g0),
                     k12.agc_apply_reference(x, mu, 1.0, g0)),
                    (k12.agc_gains(mg, mu, 1.0, g0),
                     k12.agc_gains_reference(mg, mu, 1.0, g0))):
                require(same_bits(got, want), f"{what}: not bitwise")
            count += 1
    return count


K15_REPLACES = ("none: sdr_tpu/parallel/halo.py:71 exclusive_affine_prefix "
                "and :99 exclusive_matrix_affine_prefix (one all_gather and "
                "one lax.scan in the jitted program)")
K16_REPLACES = ("none: sdr_tpu/stream/ops.py:944 (AmDemod planar, "
                "sqrt(re**2 + im**2), one XLA fusion)")
PREFIX_REL = 1e-6                     # K15's matrix form vs the parent's
GROUP_REL = 1e-5                      # ranks' prefixes vs one process (H7)


def record_prefixes(fn) -> list:
    """The K15 launches ``fn()`` makes, each as the keyword arguments of
    ``kernels/affine_prefix.py:_launch`` (the maps as the op passes
    them)."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    calls, real = [], k15._launch

    def spy(m, v, pre=None, s0=None, maps=True, state=False, total=False):
        calls.append(dict(m=m, v=v, pre=pre, s0=s0, maps=maps, state=state,
                          total=total))
        return real(m, v, pre, s0, maps, state, total)

    k15._launch = spy
    try:
        fn()
    finally:
        k15._launch = real
    return calls


def parent_prefix(m, v, pre=None):
    """The port's prefixes before K15 (parallel/halo.py's eager
    doubling): ``@`` composes the matrix form; with ``pre`` the ranks
    before are composed in rank order, then every local prefix after
    them."""
    if m.shape == v.shape:
        def compose(late, early):
            return late[0] * early[0], late[0] * early[1] + late[1]
        ident = (torch.ones_like(m[:1]), torch.zeros_like(v[:1]))
    else:
        def compose(late, early):
            return (late[0] @ early[0],
                    (late[0] @ early[1][..., None])[..., 0] + late[1])
        p = m.shape[-1]
        ident = (torch.eye(p, dtype=m.dtype, device=m.device).expand(
            m[:1].shape), torch.zeros_like(v[:1]))
    cur, d = (m, v), 1
    while d < cur[0].shape[0]:
        new = compose(tuple(t[d:] for t in cur), tuple(t[:-d] for t in cur))
        cur = tuple(torch.cat([t[:d], n]) for t, n in zip(cur, new))
        d *= 2
    local = tuple(torch.cat([i.expand_as(t[:1]), t[:-1]])
                  for i, t in zip(ident, cur))
    if pre is None or pre[0].shape[0] == 0:
        return local
    enter = (pre[0][0], pre[1][0])
    for r in range(1, pre[0].shape[0]):
        enter = compose((pre[0][r], pre[1][r]), enter)
    return compose(local, enter)


def parent_state(m, v, s0, pre=None):
    """The callers' epilogues before K15: ``A * s0 + B``, ``enter + A @
    s0``."""
    A, c = parent_prefix(m, v, pre)
    if m.shape == v.shape:
        return A * s0 + c
    if not isinstance(s0, torch.Tensor):
        s0 = torch.full(v.shape[1:], s0, dtype=v.dtype, device=v.device)
    return c + (A @ s0[..., None])[..., 0]


def lane_rel(got, want, inner: int) -> float:
    """The largest ``|got - want|`` of a lane over the lane's largest
    ``|want|``: a lane's entries are its rows' (axis 0) and the map's
    ``inner`` trailing dims (2 for a matrix, 1 for a vector, 0 for the
    scalar form)."""
    if want.numel() == 0:
        return 0.0
    dims = (0,) + tuple(range(want.ndim - inner, want.ndim))
    d = (got - want).abs().amax(dim=dims)
    peak = want.abs().amax(dim=dims)
    return (d / peak.clamp_min(1e-30)).max().item()


def k15_outputs(c, s0=None):
    """Every output of one K15 launch over a recorded call (prefixes,
    states from ``s0`` or the call's own, total) and its plain
    versions'."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    s0 = c["s0"] if s0 is None else s0
    got = k15._launch(c["m"], c["v"], c["pre"], s0, True, s0 is not None,
                      True)
    want = (k15.exclusive_prefix_reference(c["m"], c["v"], c["pre"]),
            None if s0 is None else k15.entering_state_reference(
                c["m"], c["v"], s0, c["pre"]),
            k15.inclusive_total_reference(c["m"], c["v"]))
    return got, want


def k15_call(c) -> tuple:
    """One K15 launch over a recorded call: its outputs, flat."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    (A, c_), st, (tm, tv) = k15._launch(**c)
    return tuple(t for t in (A, c_, st, tm, tv) if t is not None)


def k15_work(c) -> tuple:
    """(bytes, f32 operations) of one recorded K15 call: each distinct
    input element read once (a map at a row stride of 0 once), each
    output written once; the doubling's compositions, the entering map's
    and the epilogue's."""
    def distinct(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n
    m, v = c["m"], c["v"]
    B = v.shape[0]
    p = 1 if m.shape == v.shape else v.shape[-1]
    lanes = v.numel() // (B * p)
    comp = p * p * (2 * p - 1) + p * 2 * p         # a composition's ops
    levels, d = 0, 1
    while d < B:
        levels += B - d
        d *= 2
    R = 0 if c["pre"] is None else c["pre"][0].shape[0]
    ops = lanes * comp * (levels + max(R - 1, 0) + (B if R else 0))
    outs = 0
    if c["maps"]:
        outs += B * lanes * (p * p + p)
    if c["state"]:
        outs += B * lanes * p
        ops += lanes * B * 2 * p
    if c["total"]:
        outs += lanes * (p * p + p)
    ins = distinct(m) + distinct(v) + (0 if R == 0 else R * lanes * (
        p * p + p))
    if isinstance(c["s0"], torch.Tensor):
        ins += distinct(c["s0"])
    return 4 * (ins + outs), ops


def require_no_doubling(fn, what: str, launches: int) -> dict:
    """``fn()``'s device kernels under ``torch.profiler``: ``launches``
    K15 kernels and none of the eager doubling's elementwise multiplies
    or adds (the compositions before K15)."""
    names = device_kernels(fn, "")
    k15 = sum(n for k, n in names.items()
              if "prefix_warp_kernel" in k or "prefix_thread_kernel" in k)
    eager = {k: n for k, n in names.items()
             if "MulFunctor" in k or "CUDAFunctor_add" in k}
    require(k15 == launches and not eager,
            f"{what}: K15 launched {k15} times (expected {launches}), "
            f"elementwise multiplies and adds {eager}; kernels {names}")
    return names


def check_affine_prefix_kernel(cases, seed: int):
    """K15 as the ops' ``shard_carry`` launch it at the path's shapes
    (``cases``: (what, the call)): each recorded launch bitwise its plain
    version in all its outputs (the prefixes, the states from the op's
    and from a seeded state, the total; the ranks before composed in too),
    two launches bitwise equal; the scalar form bitwise the parent's eager
    doubling and its epilogue, the matrix form within 1e-6 of each lane's
    largest entry of the parent's (cuBLAS composes it); the op's kernels
    by the profiler, no eager doubling.  Timed beside its plain version,
    the parent's composition and an empty launch (its bound is far below
    any launch)."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    rows = []
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), 100)
    for what, fn in cases:
        calls = record_prefixes(fn)
        require(len(calls) >= 1, f"K15 {what}: no launch")
        names = require_no_doubling(fn, f"K15 {what}", len(calls))
        c = calls[0]
        m, v = c["m"], c["v"]
        g = torch.Generator(device=v.device).manual_seed(seed + 15)
        scalar = m.shape == v.shape
        seeded = torch.rand(v.shape[1:], generator=g, device=v.device) * 2 - 1
        R = 3
        pre = tuple(torch.stack([t[0]] * R) * 0.5 for t in (m, v))
        for s0 in (c["s0"], seeded):
            for pre_ in (c["pre"], pre):
                cc = dict(c, pre=pre_)
                got, want = k15_outputs(cc, s0)
                for u, w in zip(got, want):
                    if w is not None:
                        require(same_bits(u, w), f"K15 {what}: not bitwise "
                                "its plain version")
                former = parent_prefix(m, v, pre_)
                if scalar:
                    require(same_bits(got[0], former), f"K15 {what}: the "
                            "prefixes differ from the parent's doubling")
                    if s0 is not None:
                        require(same_bits(got[1], parent_state(
                            m, v, s0, pre_)), f"K15 {what}: the state "
                            "differs from the parent's")
                else:
                    rel = max(lane_rel(got[0][0], former[0], 2),
                              lane_rel(got[0][1], former[1], 1))
                    require(rel <= PREFIX_REL, f"K15 {what}: {rel} of a "
                            "lane's peak from the parent's prefixes")
        out = k15._launch(**c)
        check_repeatable(lambda: k15_call(c), f"K15 {what}")
        rel = 0.0
        if not scalar:
            ref = parent_state(m, v, c["s0"], c["pre"]) if c["state"] \
                else parent_prefix(m, v, c["pre"])[1]
            mine = out[1] if c["state"] else out[0][1]
            rel = lane_rel(mine, ref, 1)
        ms = time_steady(lambda: k15_call(c), 50, f"K15 {what}")

        def plain():
            return (k15.entering_state_reference(m, v, c["s0"], c["pre"])
                    if c["state"] else
                    k15.exclusive_prefix_reference(m, v, c["pre"]))

        def former():
            return (parent_state(m, v, c["s0"], c["pre"]) if c["state"]
                    else parent_prefix(m, v, c["pre"]))

        nb, ops = k15_work(c)
        b, by = bound(nb, ops, "f32")
        shape = list(v.shape if scalar else v.shape[:-1])
        form = "scalar" if scalar else f"p = {v.shape[-1]}"
        rows.append(dict(
            name=f"K15 affine_prefix ({what} {shape}, {form}"
                 f"{', with the state' if c['state'] else ''})",
            kernel="affine_prefix", route="cuda",
            source="sdr_tpu_torch/csrc/affine_prefix.cu",
            replaces=K15_REPLACES, max_abs_err=0.0, bitwise=True,
            launches_a_call=len(calls), parent_lane_rel=rel,
            ms=ms, plain_ms=time_ms(plain, 10, 1), former_ms=time_ms(
                former, 10, 1), empty_launch_ms=empty_ms, bound_ms=b,
            bound_by=by, bound_fraction=b / ms, library_ms=None,
            library_note="none: no PyTorch call composes affine maps; "
                         "empty_launch_ms is an empty kernel "
                         "(torch.cuda._sleep(0)) back to back",
            op_kernels=names))
        print(f"K15 {what}: {len(calls)} launch(es) in shard_carry, "
              f"bitwise its plain version (prefixes, states, total; with "
              f"and without 3 maps before), "
              f"{'bitwise the parent' if scalar else f'{rel} of a lane peak from the parent'}"
              f"; {ms:.5f} ms against the parent's composition "
              f"{rows[-1]['former_ms']:.5f} and an empty launch "
              f"{empty_ms:.5f}; the op's device kernels {names}")
    return rows


def affine_prefix_geometries(device, seed: int) -> int:
    """K15 bitwise its plain version at B in {1, 2, 3, 31, 32, 33, 64,
    1,000} x lanes [1], [2], [3], [128], [64, 2] x the scalar form and p in
    {1, 2, 3, 4}, each with and without the state and 3 maps before (4
    launches), signed zeros in the maps, and the rows' matrices read at a
    row stride of 0 (a fifth); returns the count."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    g = torch.Generator(device=device).manual_seed(seed + 16)

    def u(*shape):
        t = torch.rand(shape, generator=g, device=device) * 2 - 1
        return torch.where(torch.rand(shape, generator=g, device=device)
                           < 0.05, torch.full_like(t, -0.0), t)

    count = 0
    for B in (1, 2, 3, 31, 32, 33, 64, 1000):
        for lanes in ((1,), (2,), (3,), (128,), (64, 2)):
            for p in (0, 1, 2, 3, 4):
                inner = () if p == 0 else (p,)
                mi = () if p == 0 else (p, p)
                scale = 1.0 if p == 0 else 1.0 / p
                m, v = u(B, *lanes, *mi) * scale, u(B, *lanes, *inner)
                pre = (u(3, *lanes, *mi) * scale, u(3, *lanes, *inner))
                s0 = u(*lanes, *inner)
                for pre_ in (None, pre):
                    for st in (None, s0):
                        got, want = k15_outputs(dict(
                            m=m, v=v, pre=pre_, s0=st), st)
                        for a, b in zip(got, want):
                            if b is not None:
                                require(same_bits(a, b), f"K15 at B {B}, "
                                        f"lanes {lanes}, p {p}: not bitwise")
                same = m[:1].expand_as(m)
                got, want = k15_outputs(dict(m=same, v=v, pre=pre, s0=s0),
                                        s0)
                require(all(same_bits(a, b) for a, b in zip(got, want)),
                        f"K15 at B {B}, lanes {lanes}, p {p}, a row "
                        "stride of 0: not bitwise")
                count += 1
    return count


def check_am_envelope_kernel(x, seed: int):
    """K16 over the AM path's gained planes ``x`` [32, 2, n] (``Agc``'s
    output, ``AmDemod``'s input): bitwise its plain version (K12's
    envelope: an f32 sum, a float64 root rounded once), compared with the
    parent's four eager passes ``torch.sqrt(re**2 + im**2)`` (bitwise or
    by how much), two launches equal, and at extra geometries (n in {1,
    3, 4, 5, 4,097} x bases 0-3 floats off 16-byte alignment x leading
    dims [], [3], [2, 3]).  Timed with its bound, its plain version, the
    parent's passes and ``torch.linalg.vector_norm(x, dim=-2)`` (one call
    of the same function)."""
    from sdr_tpu_torch.kernels import am_envelope as k16
    from sdr_tpu_torch.kernels.agc_linear import envelope

    def former(t):
        return torch.sqrt(t[..., 0, :] ** 2 + t[..., 1, :] ** 2)

    y = k16.am_envelope(x)
    require(torch.isfinite(y).all().item(), "K16 output finite")
    require(same_bits(y, envelope(x)), "K16 vs its plain version not bitwise")
    check_repeatable(lambda: k16.am_envelope(x), "K16")
    old = former(x)
    ndiff = int((bits(y) != bits(old)).sum().item())
    derr = max_err(y, old)
    g = torch.Generator(device=x.device).manual_seed(seed + 17)
    count = 0
    for n in (1, 3, 4, 5, 4097):
        for lead in ((), (3,), (2, 3)):
            for off in range(4):
                t = misaligned(torch.rand(lead + (2, n), generator=g,
                                          device=x.device) * 4 - 2, off)
                require(same_bits(k16.am_envelope(t), envelope(t)),
                        f"K16 at n {n}, lead {lead}, offset {off}")
                count += 1
    lib = torch.linalg.vector_norm(x, dim=-2)
    lib_err = max_err(lib, y)
    ms = time_steady(lambda: k16.am_envelope(x), 20, "K16")
    b, by = bound(nbytes(x, y), 4 * y.numel(), "f32")
    row = dict(
        name=f"K16 am_envelope (AM planar {list(x.shape)})",
        kernel="am_envelope", route="cuda",
        source="sdr_tpu_torch/csrc/am_envelope.cu", replaces=K16_REPLACES,
        max_abs_err=0.0, bitwise=True, geometries=count, ms=ms,
        plain_ms=time_ms(lambda: envelope(x), 3, 1), bound_ms=b,
        bound_by=by, bound_fraction=b / ms,
        library_ms=time_ms(lambda: torch.linalg.vector_norm(x, dim=-2), 20),
        library_max_abs_diff=lib_err,
        library_note="torch.linalg.vector_norm(x, dim=-2), one call",
        former_ms=time_ms(lambda: former(x), 20),
        former_bitwise=ndiff == 0, former_samples_differing=ndiff,
        former_max_abs_diff=derr)
    print(f"K16 am_envelope: bitwise its plain version at {list(x.shape)} "
          f"and at {count} extra geometries; against the parent's "
          f"torch.sqrt(re**2 + im**2): "
          f"{'bitwise' if ndiff == 0 else f'{ndiff} samples differ, max {derr}'}"
          f"; vector_norm max abs diff {lib_err}")
    return row


def section_of(op, x):
    """The first IIR section ``op`` (a ``DcBlocker`` or an ``Iir``) runs
    over the rows ``x`` block-parallel: (feed-forward taps, feedback
    coefficients, each row's entering inputs and entering state, from the
    op's ``shard_carry``)."""
    carry = op.shard_carry(x)
    if hasattr(op, "alpha"):
        last, enter = carry
        xin = torch.stack([torch.zeros_like(last), last], dim=-1)
        return (1.0, -1.0), (op.alpha,), xin, enter[..., None].contiguous()
    b, coeffs = op._section(0)
    return (b, coeffs, carry[0][..., 0, :].contiguous(),
            carry[1][..., 0, :].flip(-1).contiguous())


def check_iir_kernel(name: str, op, x, seed: int):
    """K13 as ``op`` (``DcBlocker``, or ``Iir``'s section) runs over the
    path's rows ``x``, from the entering inputs and states its
    ``shard_carry`` gives and from seeded ones: the outputs and the state
    after each row within 1e-5 of each row's peak |y| of the plain version
    (the worst row printed), the final-state launch (``store=False``)
    bitwise the full launch's state.  Timed, both launches, with the bound
    and ``torch.cumsum`` over the same rows (a one-pass scan, not the same
    function)."""
    from sdr_tpu_torch.kernels import iir
    b, coeffs, xin, s0 = section_of(op, x)
    g = torch.Generator(device=x.device).manual_seed(seed + 7)
    worst = (0.0, 0)
    for xi, si in ((xin, s0), (torch.randn(xin.shape, generator=g,
                                           device=x.device),
                                torch.randn(s0.shape, generator=g,
                                            device=x.device))):
        y, s = iir.iir_section(x, b, coeffs, xi, si)
        ry, rs = iir.iir_section_reference(x, b, coeffs, xi, si)
        _, s_only = iir.iir_section(x, b, coeffs, xi, si, store=False)
        require(torch.isfinite(y).all().item(), f"{name} output finite")
        err = max(peak_err(y, ry), peak_err(
            torch.cat([y, s], -1), torch.cat([ry, rs], -1)))
        require(err[0] <= 1e-5, f"{name} vs plain {err[0]} of row "
                                f"{err[1]}'s peak > 1e-5")
        require(torch.equal(bits(s_only), bits(s)),
                f"{name}: the final-state launch's state differs")
        worst = max(worst, err)
        del y, ry
    check_repeatable(lambda: iir.iir_section(x, b, coeffs, xin, s0), name)
    check_repeatable(lambda: iir.iir_section(x, b, coeffs, xin, s0,
                                             store=False)[1], name)
    y, s = iir.iir_section(x, b, coeffs, xin, s0)
    nb, by = bound(nbytes(x, xin, s0, y, s), 5 * x.numel(), "f32")
    nb_final, _ = bound(nbytes(x, xin, s0, s), 5 * x.numel(), "f32")
    ms = time_steady(lambda: iir.iir_section(x, b, coeffs, xin, s0), 20,
                     name)
    ms_final = time_steady(lambda: iir.iir_section(
        x, b, coeffs, xin, s0, store=False)[1], 20, name + ", final state")
    print(f"{name}: within {worst[0]} of each row's peak |y| of its plain "
          f"version (the worst row {worst[1]}; limit 1e-5); two launches "
          f"bitwise equal, the last of 20 timed calls bitwise the first; "
          f"{ms} ms, the final-state launch {ms_final} ms")
    return dict(
        name=name, kernel="iir", route="cuda",
        source="sdr_tpu_torch/csrc/iir.cu",
        replaces="none: sdr_tpu/ops/iir.py:30-65 linear_recurrence and "
                 "sdr_tpu/ops/scans.py:64-80 dc_blocker "
                 "(jax.lax.associative_scan)",
        shape=f"{list(x.shape)}, b {list(b)}, a {list(map(float, coeffs))}",
        max_abs_err=max_err(y, iir.iir_section_reference(
            x, b, coeffs, xin, s0)[0]),
        max_peak_rel_err=worst[0], worst_row=worst[1], ms=ms,
        ms_final_state=ms_final, bound_ms_final_state=nb_final,
        bound_fraction_final_state=nb_final / ms_final,
        plain_ms=time_ms(lambda: iir.iir_section_reference(
            x, b, coeffs, xin, s0), 3, 1),
        bound_ms=nb, bound_by=by, bound_fraction=nb / ms, library_ms=None,
        cumsum_ms=time_ms(lambda: torch.cumsum(x, -1), 20),
        library_note="none: no single PyTorch call computes a linear "
                     "recurrence; cumsum_ms is torch.cumsum over the same "
                     "rows, a one-pass scan, not the same function")


DEEMPH_75US = ((0.12195122, 0.12195122, 0.0), (0.75609756, 0.0))
IIR_SECTIONS = (((1.0, -1.0), (0.997,)), DEEMPH_75US,
                ((0.2, 0.3, 0.1), (1.2, -0.5)))


def iir_geometries(device, seed: int) -> int:
    """K13 within 1e-5 of each row's peak of its plain version, and its
    final-state launch bitwise the full launch's state, for the DC
    blocker's section (alpha 0.997), a de-emphasis section and one with
    a_2 != 0, at rows 1-5 and 32, n in {0, 1, 2, 31, 32, 33, 4,095, 4,096,
    4,097} and 2*4,096*k +- 1 for k in {1, 3}, the input 0-3 floats off
    16-byte alignment, seeded entering inputs and states, and at more rows
    than one wave of tickets ([300, 40,000]: 52 rows a wave) and rows of
    many tiles' segments ([3, 5,000,000]: a row a wave); then a
    two-section ``Iir`` (the de-emphasis and the a_2 != 0 section) over
    [3, 2, 50,000] in 4 blocks, streamed and block-parallel, against the
    same op on the CPU.  Returns the count."""
    from sdr_tpu_torch.kernels import iir
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Iir, Pipeline
    g = torch.Generator(device=device).manual_seed(seed + 8)
    ns = [0, 1, 2, 31, 32, 33, 4_095, 4_096, 4_097] + [
        2 * 4_096 * k + d for k in (1, 3) for d in (-1, 1)]
    count = 0
    shapes = [(rows, n) for rows in (1, 2, 3, 4, 5, 32) for n in ns] + [
        (300, 40_000), (3, 5_000_000)]
    for b, coeffs in IIR_SECTIONS:
        for rows, n in shapes:
            x = misaligned(torch.randn((rows, n), generator=g,
                                       device=device), (rows + n) % 4)
            xin = torch.randn((rows, 2), generator=g, device=device)
            s0 = torch.randn((rows, len(coeffs)), generator=g,
                             device=device)
            y, s = iir.iir_section(x, b, coeffs, xin, s0)
            ry, rs = iir.iir_section_reference(x, b, coeffs, xin, s0)
            _, s_only = iir.iir_section(x, b, coeffs, xin, s0,
                                        store=False)
            what = f"K13 section {b}/{coeffs} at rows {rows}, n {n}"
            require(y.shape == ry.shape, f"{what}: {y.shape}")
            if n == 0:
                require(torch.equal(s, s0), f"{what}: state")
            else:
                err = peak_err(torch.cat([y, s], -1),
                               torch.cat([ry, rs], -1))
                require(err[0] <= 1e-5, f"{what}: {err[0]} of row "
                                        f"{err[1]}'s peak > 1e-5")
            require(torch.equal(bits(s_only), bits(s)),
                    f"{what}: the final-state launch's state differs")
            count += 1
    sos = np.array([[*DEEMPH_75US[0], 1.0, -DEEMPH_75US[1][0], 0.0],
                    [0.2, 0.3, 0.1, 1.0, -1.2, 0.5]], np.float32)
    x = torch.randn((3, 2, 50_000), generator=g, device=device)
    ops, cpu_ops = [Iir(sos, device=device)], [Iir(sos, device="cpu")]
    par = run_time_batched(ops, x, 4, device=device)
    want = run_time_batched(cpu_ops, x.cpu(), 4, device="cpu")
    _, seq = Pipeline(ops, block_in=12_500, batch_shape=(3, 2),
                      device=device).process(x)
    for got, what in ((par, "block-parallel"), (seq, "streamed")):
        err = peak_err(got.cpu(), want)
        require(err[0] <= 1e-5, f"K13 two-section Iir {what} vs the CPU "
                                f"block-parallel run: {err[0]} of a peak")
    return count + 2


def run_am_approx(raw, ops, kernels):
    """``am_chain(agc_approx=1)`` block-parallel (launches, tone, peak
    memory, 20 timed calls), streamed at the CLI's blocks (within 1e-3,
    the JAX package's bound for the sweeps), and against the linear
    complex chain (within 1e-4)."""
    from sdr_tpu_torch.apps.chains import am_chain
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, raw, kernels)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    # the decimator's seam and main launches; the sweep and the apply; the
    # DcBlocker's final state and output on K13, its prefix on K15
    require_launches(launches, {"fir": 2, "agc_scan": 2, "iq_convert": 1,
                                "iir": 2, "mix": 1, "affine_prefix": 1},
                     "AM path, sequential AGC")
    require_no_layout_copy("AM path, sequential AGC")
    out = y.cpu().numpy()
    require(out.shape == (ROWS * ROW_BYTES // 32,),
            f"AM sequential-AGC output {out.shape}")
    require(np.isfinite(out).all(), "AM sequential-AGC output finite")
    hz = am_tone_hz(out)
    require(abs(hz - F_AM) < 10, f"AM sequential-AGC tone at {hz} Hz")
    print(f"AM sequential-AGC block-parallel chain: {ROWS} x {ROW_BYTES} "
          f"bytes; peak memory {peak} bytes; tone {hz:.2f} Hz at {AM_RATE} "
          f"S/s; launches in one call {launches}")
    time_chain(ops, raw, "AM sequential-AGC block-parallel chain")

    pipe = Pipeline(ops, block_in=AM_BLOCK)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        raw[i:i + AM_BLOCK] for i in range(0, raw.numel(), AM_BLOCK))))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"iq_convert": 1, "iir": 1, "mix": 1,
                                "affine_prefix": 0},
                      raw.numel() // AM_BLOCK, "AM sequential-AGC streamed")
    dstream = max_err(streamed, y)
    require(dstream <= 1e-3,
            f"AM sequential-AGC streamed vs block-parallel {dstream}")
    print(f"AM sequential-AGC streamed op by op at {AM_BLOCK}-byte "
          f"blocks: max abs diff to block-parallel {dstream}; "
          f"{raw.numel() // 2 / t_stream:.6e} complex input samples/s")
    compiled_run(pipe, list(raw.split(AM_BLOCK)), streamed,
                 "AM sequential-AGC", raw.numel() // 2)
    linear = run_time_batched(am_chain(planar=False, device=ops[0].device),
                              raw, ROWS)
    dlin = max_err(linear, y)
    require(dlin <= 1e-4, f"AM sequential vs linear AGC chain {dlin}")
    print(f"AM sequential-AGC vs the linear complex chain: max abs diff "
          f"{dlin}")
    return launches


def write_tone_wav(path, seconds: int, freq: float, rate: int = TX_RATE):
    """A mono 16-bit WAV of a tone at 0.8 (tests/test_io_apps.py's
    transmitter input); returns its samples as fm_tx reads them."""
    audio = 0.8 * np.sin(2 * np.pi * freq * np.arange(seconds * rate)
                         / rate)
    pcm = (audio * 32767).astype("<i2")
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(pcm.tobytes())
    return (pcm / 32768.0).astype(np.float32)


def check_tx_kernels(audio, ops):
    """K2 at the transmitter's two interpolating stages, bitwise against
    its plain version and timed beside ``conv_transpose1d``: one streamed
    block (the launch-bound case) and the whole recording as one block."""
    n = audio.numel() // TX_BLOCK * TX_BLOCK
    rows = []
    for what, x in (("streamed block", audio[:TX_BLOCK].view(1, -1)),
                    ("whole recording", audio[:n].view(1, -1))):
        for op in ops[:2]:
            I, D = op.spec.interpolation, op.spec.decimation
            rows.append(check_resampler_kernel(
                f"K2 resample (transmitter {I}/{D}, {what} "
                f"{list(x.shape)}, {op.spec.n_taps} taps)", op, x,
                interp=True))
            _, x = op.apply(op.shard_carry(x), x)
    return rows


def run_fm_tx(kernels, device):
    """The transmitter on a TX_SECONDS, 1 kHz WAV: ``apps.fm_tx`` in this
    process with the launch counters read around it (its compiled step
    captured once, 2 K2 launches in each of the capture's calls, and
    replayed once a block), the same chain streamed op by op (124 K2
    launches: two a block), and as a user runs it (``python -m``, its wall time as
    IQ samples/s against real time; the same file); its streamed output
    against the same chain run as one block over the whole recording;
    then the round trip, the i16 IQ converted to u8 as
    tests/test_io_apps.py does and received by ``fm_chain()``
    block-parallel in 32 blocks: the tone within 5 Hz.  Returns the
    transmitter's launches and its K2 rows."""
    from sdr_tpu_torch.apps import fm_tx
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.ops.demod import fm_demod
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "tone.wav")
        audio = torch.as_tensor(write_tone_wav(wav, TX_SECONDS, TX_TONE),
                                device=device)
        ops = fm_tx.tx_chain(TX_RATE, 75_000, device=device)
        rows = check_tx_kernels(audio, ops)

        # the CLI's entry point in this process: its compiled step runs the
        # first block eagerly, captures at the second and replays it there
        # and after; the path's launches op by op
        from sdr_tpu_torch.utils import graphs
        ours = os.path.join(tmp, "tx.iq")
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        before = (graphs.captures, graphs.replays)
        t0 = time.perf_counter()
        require(fm_tx.main(["--in", wav, "--out", ours]) == 0,
                "fm_tx in this process")
        torch.cuda.synchronize()
        t_in = time.perf_counter() - t0
        cli = {k.name: k.launches for k in kernels}
        nb = audio.numel() // TX_BLOCK
        replayed = (graphs.captures - before[0], graphs.replays - before[1])
        require(replayed == (1, nb - 1), f"fm_tx: captures and replays "
                f"{replayed}, expected (1, {nb - 1})")
        require_launches(cli, {"resample": 2 * (1 + graphs.WARMUP + 1)},
                         "transmitter CLI (the eager block and the "
                         "capture's calls)")
        _, launches = counted(lambda: eager_stream(
            Pipeline(ops, block_in=TX_BLOCK, in_dtype=torch.float32),
            audio[:nb * TX_BLOCK].split(TX_BLOCK)), kernels)
        require_launches(launches, {"resample": 2 * nb},
                         "transmitter path op by op")
        iq = torch.from_numpy(np.fromfile(ours, np.int16))
        n_iq = nb * TX_BLOCK * 80 // 3
        require(iq.numel() == 2 * n_iq, f"fm_tx wrote {iq.numel()} values")

        # as a user runs it
        theirs = os.path.join(tmp, "tx2.iq")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdr_tpu_torch.apps.fm_tx", "--in", wav,
             "--out", theirs], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        t_cli = time.perf_counter() - t0
        print(f"fm_tx cli: rc {proc.returncode} {proc.stdout.strip()}")
        require(proc.returncode == 0, f"fm_tx cli failed: {proc.stderr}")
        require(np.array_equal(np.fromfile(theirs, np.int16), iq.numpy()),
                "fm_tx cli and fm_tx.main wrote different files")
        print(f"fm_tx: {TX_SECONDS} s at {TX_RATE} Hz in {nb} blocks of "
              f"{TX_BLOCK} -> {n_iq} IQ samples ({2 * iq.numel()} bytes of "
              f"i16); launches {launches} op by op, {cli} in the CLI's "
              f"eager block and capture, {nb - 1} replays; in this process {t_in:.3f} s "
              f"({n_iq / t_in:.6e} IQ samples/s), as a command {t_cli:.3f} "
              f"s ({n_iq / t_cli:.6e} IQ samples/s, "
              f"{n_iq / t_cli / FS_IN:.2f}x real time at {FS_IN} S/s)")

    # streamed against one block over the whole recording: the resampled
    # stream bitwise (per-output sums), the modulated one within the JAX
    # package's streamed-vs-whole bound (the phase sum's order follows
    # the block edges: ROADMAP H12)
    n = nb * TX_BLOCK
    _, up_s = Pipeline(ops[:2], block_in=TX_BLOCK,
                       in_dtype=torch.float32).process(audio[:n])
    _, up_w = Pipeline(ops[:2], block_in=n,
                       in_dtype=torch.float32).process(audio[:n])
    require(torch.equal(up_s, up_w), "transmitter resampled stream: "
            f"streamed vs whole {max_err(up_s, up_w)}")
    del up_s, up_w
    _, y_s = Pipeline(ops, block_in=TX_BLOCK,
                      in_dtype=torch.float32).process(audio[:n])
    _, y_w = Pipeline(ops, block_in=n,
                      in_dtype=torch.float32).process(audio[:n])
    dwhole = max_err(y_s, y_w)
    ddemod = max_err(fm_demod(y_s)[0], fm_demod(y_w)[0])
    require(dwhole <= 1e-3, f"transmitter streamed vs whole {dwhole}")
    require(ddemod <= 2e-3, f"transmitter streamed vs whole, demodulated "
                            f"{ddemod}")
    print(f"transmitter streamed ({nb} blocks) vs one block over the whole "
          f"recording: resampled stream bitwise equal; modulated max abs "
          f"diff {dwhole}; demodulated max abs diff {ddemod} rad")
    del y_s, y_w

    # the round trip through the receiver
    z = iq.to(device).float() / 2048.0
    u8 = torch.clamp(torch.round(z * 128 + 128), 0, 255).to(torch.uint8)
    del z
    rx = fm_chain(device=device)
    blk = u8.numel() // ROWS // 160 * 160
    Pipeline(rx, block_in=blk)                 # a valid block, or raises
    prefix = u8[:ROWS * blk]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    y = run_time_batched(rx, prefix, ROWS)
    torch.cuda.synchronize()
    rx_launches = {k.name: k.launches for k in kernels}
    out = y.cpu().numpy()
    require(np.isfinite(out).all(), "round trip output finite")
    hz = tone_hz(out)
    require(abs(hz - TX_TONE) < 5, f"round trip tone at {hz} Hz")
    print(f"round trip: {prefix.numel()} u8 bytes in {ROWS} blocks of "
          f"{blk} through fm_chain() -> {out.shape[0]} audio samples; tone "
          f"{hz:.2f} Hz; launches {rx_launches}")
    return launches, rows


def peak_rel(a, b) -> float:
    """The largest difference in a frame relative to that frame's peak
    magnitude (the waterfall's limit: cuFFT, pocketfft and K9's own FFT
    round differently)."""
    return peak_err(a, b)[0]


def check_fft_stream_kernel(fft_op, x, seed: int):
    """K9 as ``FftStream`` launches it over the waterfall's planes ``x``
    [32, 2, 5,242,880] with each row's carry from the halo (the previous
    row's last 512 samples; row 0 zeros), and over the same samples as
    complex64 (the CLI's form): within 1e-5 of each frame's peak of the
    plain version (cuFFT), the two forms bitwise equal; peak memory of
    one call of each (above the inputs); a size outside the plan raises;
    then the extra geometries (:func:`fft_stream_geometries`).  Timed with
    its bound; the yardsticks: cuFFT alone on frames made beforehand
    (``library_ms``, the transform only) and ``torch.stft`` -> ``abs`` ->
    ``fftshift`` (three calls)."""
    from sdr_tpu_torch.kernels import fft_stream
    w, hop = fft_op._window, fft_op.hop
    N = w.numel()
    hist = fft_op.shard_carry(x)
    a = (hist, x, w, hop)
    ac = (torch.complex(hist[:, 0], hist[:, 1]),
          torch.complex(x[:, 0], x[:, 1]), w, hop)
    peaks = {}
    for name, fn, args in (("K9", fft_stream.fft_stream, a),
                           ("K9 complex", fft_stream.fft_stream, ac),
                           ("plain", fft_stream.fft_stream_reference, a)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        if name == "K9":
            y = out
        elif name == "K9 complex":
            yc = out
        else:
            ref = out
    require(torch.isfinite(y).all().item(), "K9 output finite")
    require(torch.equal(yc, y), "K9 complex form != planar form bitwise "
                                f"(max abs diff {max_err(yc, y)})")
    err, rel = max_err(y, ref), peak_rel(y, ref)
    require(rel <= 1e-5, f"K9 vs plain {rel} > 1e-5 of a frame's peak")
    refc = fft_stream.fft_stream_reference(*ac)
    relc = peak_rel(yc, refc)
    require(relc <= 1e-5, f"K9 complex vs plain {relc} > 1e-5 of a "
                          "frame's peak")
    del ref, refc, yc
    for bad in (96, 32_768):
        try:
            fft_stream.fft_stream(hist, x[..., :bad], torch.ones(
                bad, device=x.device), bad)
        except ValueError as e:
            require("power-of-two size" in str(e), f"K9 at size {bad}: {e}")
        else:
            require(False, f"K9 at size {bad} ran")
    count = fft_stream_geometries(x.device, seed)
    frames = y.shape[0] * y.shape[1]
    ops = frames * (5 * N * np.log2(N) + 5 * N)   # FFT, window, |X|
    b, by = bound(nbytes(hist, x, w, y), int(ops), "f32")
    ms = time_ms(lambda: fft_stream.fft_stream(*a), 20)
    ms_c = time_ms(lambda: fft_stream.fft_stream(*ac), 20)
    plain_ms = time_ms(lambda: fft_stream.fft_stream_reference(*a), 3, 1)
    z = torch.cat([ac[0], ac[1]], dim=-1)
    pre = (z.unfold(-1, N, hop) * w).contiguous()     # [32, 10,240, N]
    lib_ms = time_ms(lambda: torch.fft.fft(pre), 10)
    del pre

    def stft():
        S = torch.stft(z, N, hop, window=w, center=False, onesided=False,
                       return_complex=True)
        return torch.fft.fftshift(S.abs(), dim=-2)

    stft_diff = peak_rel(stft().transpose(-1, -2), y)
    stft_ms = time_ms(stft, 3, 1)
    del z
    print(f"K9 fft_stream: within {rel} of each frame's peak of its plain "
          f"version (cuFFT; max abs diff {err}) at {list(x.shape)}, the "
          f"complex form bitwise the planar one ({relc} of the peak of its "
          f"plain version), and at {count} extra geometries; peak memory "
          f"above the inputs: K9 {peaks['K9']} bytes (complex "
          f"{peaks['K9 complex']}), plain {peaks['plain']}; K9 {ms} ms "
          f"(complex {ms_c}), cuFFT alone {lib_ms}, stft -> abs -> fftshift "
          f"{stft_ms} ({stft_diff} of a frame's peak from K9)")
    return dict(
        name=f"K9 fft_stream (waterfall, planar {list(x.shape)} f32 + "
             f"carry {list(hist.shape)}, N = {N}, hop = {hop})",
        kernel="fft_stream", route="cuda",
        source="sdr_tpu_torch/csrc/fft_stream.cu",
        replaces="none: sdr_tpu/stream/ops.py:1268-1295 (FftStream: frame, "
                 "window, XLA's FFT or fft_mxu_planar, |X|, fftshift in XLA "
                 "fusions)",
        shape=f"hist {list(hist.shape)}, x {list(x.shape)} -> "
              f"{list(y.shape)} f32",
        plan=fft_stream.plan(N, hop), max_abs_err=err,
        max_peak_rel_err=rel, complex_bitwise_planar=True,
        complex_ms=ms_c, geometries=count, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        peak_bytes_above_inputs=peaks, library_ms=lib_ms,
        library_note=f"torch.fft.fft (cuFFT) on the windowed frames made "
                     f"beforehand, complex64 {list(y.shape)}: the transform "
                     "only",
        stft_ms=stft_ms,
        stft_note="three calls: torch.stft(onesided=False, center=False, "
                  "return_complex=True) -> abs -> fftshift, over the "
                  "complex64 rows with their carry; its [frames, bins] "
                  f"transpose within {stft_diff} of K9's frame peaks")


def fft_stream_geometries(device, seed: int) -> int:
    """K9 within 1e-5 of each frame's peak of its plain version at sizes
    64, 256, 1,024, 4,096 and 16,384 x hops size, size / 2, size / 4 and
    size / 4 + 1 (odd) x histories 0 and size - hop, each in both forms
    (planar and complex64 bitwise equal), the rows 1-3 samples off
    16-byte alignment, leading dims [3] and [2, 3], and ``magnitude`` and
    ``shift`` each on and off in turn; and at each size a block of one
    frame's span; returns the count (each form one)."""
    from sdr_tpu_torch.kernels import fft_stream
    g = torch.Generator(device=device).manual_seed(seed + 3)
    count, i = 0, 0
    for N in (64, 256, 1024, 4096, 16_384):
        w = torch.rand(N, generator=g, device=device)
        for hop in (N, N // 2, N // 4, N // 4 + 1):
            for H in (0, N - hop):
                lead = ((3,), (2, 3))[i % 2]
                mag, shift = ((True, True), (False, True), (True, False),
                              (False, False))[i % 4]
                off = 1 + i % 3
                i += 1
                n = 5 * hop + N
                xc = torch.randn(lead + (n,), generator=g, device=device,
                                 dtype=torch.complex64)
                hc = torch.randn(lead + (H,), generator=g, device=device,
                                 dtype=torch.complex64)
                outs = []
                for planar in (True, False):
                    if planar:
                        xs = misaligned(torch.view_as_real(xc).movedim(
                            -1, -2).contiguous(), off)
                        hs = misaligned(torch.view_as_real(hc).movedim(
                            -1, -2).contiguous(), off)
                    else:
                        xs, hs = misaligned(xc, off), misaligned(hc, off)
                    args = (hs, xs, w, hop, mag, shift)
                    out = fft_stream.fft_stream(*args)
                    rel = peak_rel(out, fft_stream.fft_stream_reference(
                        *args))
                    require(rel <= 1e-5, f"K9 at N {N}, hop {hop}, history "
                                         f"{H}, lead {lead}, offset {off}, "
                                         f"planar {planar}, magnitude {mag}, "
                                         f"shift {shift}: {rel}")
                    outs.append(out)
                    count += 1
                require(torch.equal(outs[0], outs[1]),
                        f"K9 at N {N}, hop {hop}: planar != complex")
        # a block of one frame's span, no carry
        x = misaligned(torch.randn((3, 2, N), generator=g, device=device), 1)
        args = (x.new_empty((3, 2, 0)), x, w, N // 2)
        out = fft_stream.fft_stream(*args)
        require(out.shape == (3, 1, N) and peak_rel(
            out, fft_stream.fft_stream_reference(*args)) <= 1e-5,
            f"K9 at N {N}: one frame")
        count += 1
    return count


def run_waterfall(raw, ops, kernels):
    """The waterfall path block-parallel (K9: the launch counts, the rows'
    shape, the power inside Carson's band, peak memory, 20 timed calls),
    its complex form (bitwise the planar rows), streamed at the CLI's
    blocks and against the plain CPU chain."""
    from sdr_tpu_torch.apps.chains import waterfall_chain
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, raw, kernels)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, raw, kernels)
    peak = torch.cuda.max_memory_allocated()
    require_launches(launches, {"fft_stream": 1, "iq_convert": 1},
                     "waterfall path")
    frames = raw.numel() // 2 // WF_HOP
    require(tuple(y.shape) == (frames, WF_SIZE), f"waterfall rows {y.shape}")
    require(torch.isfinite(y).all().item(), "waterfall rows finite")
    # a spectrum of the 1 kHz tone at 75 kHz deviation: Carson's band, +-76
    # kHz, is +-61 bins of 1,250 Hz around the centre bin.  It holds about
    # 98 % of an FM signal's power (the Bessel sum for this index, 75, is
    # 98.44 %), and +-80 kHz (64 bins) more than 99.9 %
    power = (y * y).sum(dim=0, dtype=torch.float64)
    mid, total = WF_SIZE // 2, power.sum().item()
    carson = power[mid - 61: mid + 62].sum().item() / total
    wide = power[mid - 64: mid + 65].sum().item() / total
    require(carson >= 0.98, f"power inside Carson's band {carson} < 0.98")
    require(wide >= 0.999, f"power inside +-80 kHz {wide} < 0.999")
    print(f"waterfall block-parallel chain: {ROWS} x {ROW_BYTES} bytes -> "
          f"{tuple(y.shape)}; power inside Carson's band (+-61 bins) "
          f"{carson}, inside +-64 bins {wide}; peak memory {peak} bytes; "
          f"launches in one call {launches}")
    time_chain(ops, raw, "waterfall block-parallel chain")
    # the complex form, the CLI's: K9 reads complex64 rows, the same
    # frames bit for bit
    cops = waterfall_chain(planar=False, device=ops[0].device)
    torch.cuda.reset_peak_memory_stats()
    yc, claunches = counted_call(cops, raw, kernels)
    cpeak = torch.cuda.max_memory_allocated()
    require_launches(claunches, {"fft_stream": 1, "iq_convert": 1},
                     "waterfall complex form")
    require(torch.equal(yc, y), "waterfall complex form != planar rows "
                                f"(max diff {peak_rel(yc, y)} of a frame's "
                                "peak)")
    print(f"waterfall complex form (planar=False): bitwise the planar rows; "
          f"peak memory {cpeak} bytes; launches in one call {claunches}")
    del yc
    time_chain(cops, raw, "waterfall complex-form block-parallel chain")

    pipe = Pipeline(ops, block_in=WF_BLOCK)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        raw[i:i + WF_BLOCK] for i in range(0, raw.numel(), WF_BLOCK))),
        dim=-2)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"iq_convert": 1, "fft_stream": 1},
                      raw.numel() // WF_BLOCK, "waterfall streamed")
    require(torch.equal(streamed, y),
            "waterfall streamed op by op != block-parallel (max diff "
            f"{max_err(streamed, y)})")
    print(f"waterfall streamed op by op at {WF_BLOCK}-byte blocks: "
          f"equal to block-parallel; {raw.numel() // 2 / t_stream:.6e} "
          "complex input samples/s")
    compiled_run(pipe, list(raw.split(WF_BLOCK)), streamed, "waterfall",
                 raw.numel() // 2, dim=-2)

    # K9 and pocketfft round differently: relative to each frame's peak
    _, ref = Pipeline(waterfall_chain(device="cpu"), block_in=WF_BLOCK,
                      device="cpu").process(raw[:4 * WF_BLOCK].cpu())
    got = streamed[:ref.shape[0]].cpu()
    rel = ((got - ref).abs().amax(dim=-1)
           / ref.abs().amax(dim=-1)).max().item()
    require(rel <= 1e-5, f"waterfall card vs CPU plain chain {rel} > 1e-5 "
                         "of a frame's peak")
    print(f"waterfall card vs CPU plain chain on 4 blocks: max diff {rel} "
          "of a frame's peak")
    return launches


def synth_wideband_bank(n: int, seed: int, device) -> torch.Tensor:
    """One wideband stream of ``n`` complex64 samples at 64 x 1.28 MS/s
    carrying 64 FM stations made at that rate: station c at +c/64 cycles
    a sample, a tone of 200 + 150 c Hz at 75 kHz deviation (the phase in
    closed form, as ``synth_broadcast``'s, in float64), 0.1 in amplitude,
    with seeded Gaussian noise (tests/test_channelize.py's wideband bank
    at broadcast rates)."""
    fs = CH_C * FS_IN
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.arange(n, dtype=torch.int64, device=device)
    t = k.to(torch.float64) / fs
    re = 0.001 * torch.randn(n, generator=g, device=device)
    im = 0.001 * torch.randn(n, generator=g, device=device)
    for c in range(CH_C):
        f = 200.0 + 150.0 * c
        ang = torch.cos(2 * np.pi * f * t).mul_(-75e3 / f).add_(75e3 / f)
        # the carrier's phase exactly: (c k mod 64) / 64 turns
        ang += (k * c % CH_C).to(torch.float64) * (2 * np.pi / CH_C)
        re += 0.1 * torch.cos(ang).to(torch.float32)
        im += 0.1 * torch.sin(ang).to(torch.float32)
        del ang
    return torch.complex(re, im)


def library_interp(fir_op, hist, x, num: int):
    """One PyTorch call for an interpolating resampler's function over
    ``concat(hist, x)``: ``conv_transpose1d`` with stride I over the
    reversed taps (the zero-stuffed stream filtered), then every D-th
    output from the stream's first phase.  Output m reads the stuffed
    stream at ``m*D - offset``, the transposed convolution's output
    ``K - 1`` further.  The input is made here, outside the call."""
    I, D = fir_op.spec.interpolation, fir_op.spec.decimation
    w = torch.flip(fir_op._taps, (0,)).view(1, 1, -1)
    a = w.shape[-1] - 1 - fir_op.offset
    v = torch.cat([hist, x], dim=-1)
    v = v.reshape(-1, 1, v.shape[-1])

    def call():
        z = torch.nn.functional.conv_transpose1d(v, w, stride=I)
        return z[:, 0, a::D][:, :num].reshape(x.shape[:-1] + (num,))

    return call


def check_resampler_kernel(name: str, fir_op, x, interp: bool = False):
    """K2 as a resampling ``Fir`` launches it over the block-parallel
    batch ``x`` (history from the halo, start 0), bitwise against the
    plain version, timed beside one ``conv1d`` of the same function (the
    polyphase filters, then the interleave), or with ``interp`` one
    ``conv_transpose1d`` (:func:`library_interp`)."""
    from sdr_tpu_torch.kernels import resample
    I, D = fir_op.spec.interpolation, fir_op.spec.decimation
    Kp = fir_op.spec.taps_per_phase
    hist = fir_op.shard_carry(x)
    num = fir_op.out_len(x.shape[-1])
    a = (fir_op._table, I, D, x, hist, fir_op.offset, num, 0)
    y = resample.resample(*a)
    err = max_err(y, resample.resample_reference(*a))
    torch.cuda.synchronize()
    require(torch.isfinite(y).all().item(), f"{name} output finite")
    require(err == 0, f"{name} vs plain {err} != 0")
    lib = (library_interp(fir_op, hist, x, num) if interp else
           library_resample(fir_op.spec.phase_table, [1.0], I, D,
                            fir_op.offset, hist, x, num))
    b, by = bound(nbytes(x, hist, fir_op._table, y), 2 * Kp * y.numel(),
                  "f32")
    ms = time_ms(lambda: resample.resample(*a), 20)
    row = dict(
        name=name, kernel="resample", route="cuda",
        source="sdr_tpu_torch/csrc/resample.cu",
        replaces="sdr_tpu/kernels/resample_pallas.py:187",
        shape=f"{list(x.shape)} -> {list(y.shape)}, {I}/{D}, {Kp} taps a "
              f"phase, history {hist.shape[-1]}",
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: resample.resample_reference(*a), 3, 1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        library_ms=time_ms(lib, 20), library_max_abs_diff=max_err(lib(), y))
    if interp:
        row["library_note"] = (f"conv_transpose1d, stride {I}, over the "
                               f"reversed taps, then every {D}-th output")
    print_no_fma_floor(name, Kp, y.numel())
    return row


def check_channelize_kernel(ch_op, x, seed: int):
    """K7 as the wideband bank's ``Channelize`` launches it over the
    block-parallel batch ``x`` [32, 4,096,000]: each row's history its
    carry from the halo (the previous row's tail; row 0 the zero warmup,
    the seam), max |diff| = 0 against the plain version (the two may
    differ in the sign of a zero: PyTorch multiplies by the taps promoted
    to complex); then at extra geometries (:func:`channelize_geometries`).
    Timed with its bound and one grouped ``conv1d`` (groups = 2C, P taps)
    over the 2C float lanes moved to the channel axis, transposes
    included."""
    from sdr_tpu_torch.kernels import channelize
    hb = ch_op._hb
    P, C = hb.shape
    hist = ch_op.shard_carry(x)
    num = x.shape[-1] // C
    a = (hb, hist, x, num)
    v = channelize.branch_filter(*a)
    err = max_err(v, channelize.branch_filter_reference(*a))
    torch.cuda.synchronize()
    require(torch.isfinite(v).all().item(), "K7 output finite")
    require(err == 0, f"K7 vs plain {err} != 0")
    count = channelize_geometries(x.device, seed)
    rows = x.shape[0]
    z = torch.view_as_real(torch.cat([hist, x], dim=-1)).reshape(
        rows, -1, 2 * C)                                # [rows, m, 2C]
    w = hb.t().repeat_interleave(2, dim=0).unsqueeze(1)  # [2C, 1, P]

    def lib():
        y = torch.nn.functional.conv1d(z.transpose(1, 2).contiguous(), w,
                                       groups=2 * C)
        return y[..., :num].transpose(1, 2).contiguous()

    lib_diff = max_err(torch.view_as_complex(lib().view(rows, num, C, 2)),
                       v)
    b, by = bound(nbytes(hb, hist, x, v), 2 * P * 2 * v.numel(), "f32")
    ms = time_ms(lambda: channelize.branch_filter(*a), 20)
    print(f"K7 branch_filter: max |diff| 0 against its plain version at "
          f"{list(x.shape)} with its carry and at {count} extra geometries")
    return dict(
        name=f"K7 branch_filter (wideband bank, {list(x.shape)} complex64 "
             f"+ carry {list(hist.shape)}, C = {C}, P = {P})",
        kernel="channelize", function="launch_branch_filter", route="cuda",
        source="sdr_tpu_torch/csrc/channelize.cu",
        replaces="none: sdr_tpu/ops/channelize.py:108-114 (the branch "
                 "filter's P-term stencil XLA fuses into one pass)",
        shape=f"hist {list(hist.shape)}, x {list(x.shape)} -> "
              f"{list(v.shape)} complex64",
        plan=channelize.plan(C, P, num, x.device),
        max_abs_err=err, geometries=count, ms=ms,
        plain_ms=time_ms(lambda: channelize.branch_filter_reference(*a), 3,
                         1),
        bound_ms=b, bound_by=by, bound_fraction=b / ms,
        library_ms=time_ms(lib, 20), library_max_abs_diff=lib_diff,
        library_note=f"grouped conv1d (groups {2 * C}, {P} taps) over the "
                     f"{2 * C} float lanes moved to the channel axis; the "
                     "call includes its two transpose copies")


def channelize_geometries(device, seed: int) -> int:
    """K7 with max |diff| = 0 against its plain version over [3] rows at
    C in {1, 8, 64, 100} x P in {1, 5, 12, 16}, ``num`` one below and one
    above the kernel's tile (its plan), histories of 0 and (P - 1) C
    samples, and row bases 1-3 complex samples off 16-byte alignment (the
    rows hold one sample more than read, so a later row's base moves
    too); returns the count."""
    from sdr_tpu_torch.kernels import channelize
    g = torch.Generator(device=device).manual_seed(seed + 2)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=device),
                             torch.randn(shape, generator=g, device=device))

    count = 0
    for C in (1, 8, 64, 100):
        for P in (1, 5, 12, 16):
            hb = torch.randn(P, C, generator=g, device=device)
            tile = channelize.plan(C, P, 1 << 30, device)["tile"]
            for num in (tile - 1, tile + 1):
                for H in (0, (P - 1) * C):
                    for off in (1, 2, 3):
                        n = (num + P - 1) * C - H + 1
                        x = misaligned(cplx(3, n), off)
                        hist = misaligned(cplx(3, H), off) if H else \
                            x.new_empty((3, 0))
                        a = (hb, hist, x, num)
                        err = max_err(channelize.branch_filter(*a),
                                      channelize.branch_filter_reference(*a))
                        require(err == 0, f"K7 at C {C}, P {P}, num {num}, "
                                          f"history {H}, offset {off}: {err}")
                        count += 1
    # the widest row whose kR + P - 1 = 15 staged rows and taps fit a
    # block at P = 12: (15 * 2 + 12) C floats <= 58,112, so C = 1,383 runs
    # and 1,384 raises from the kernel's own plan
    for C, fits in ((1_383, True), (1_384, False)):
        hb = torch.randn(12, C, generator=g, device=device)
        x = cplx(1, 12 * C)
        a = (hb, x.new_empty((1, 0)), x, 1)
        try:
            err = max_err(channelize.branch_filter(*a),
                          channelize.branch_filter_reference(*a))
        except RuntimeError as e:
            require(not fits and "do not fit" in str(e),
                    f"K7 at C {C}, P 12: {e}")
        else:
            require(fits and err == 0, f"K7 at C {C}, P 12 ran ({err})")
        count += 1
    print("K7 limit: C = 1,383 runs and 1,384 raises at P = 12 (the staged "
          "rows and taps of a block within 58,112 floats)")
    return count


def check_branch_dft_kernel(ch_op, x, seed: int):
    """K7 + DFT as the wideband bank's ``Channelize`` launches it over the
    block-parallel batch ``x`` [32, 4,096,000] with each row's carry as
    history: within 1e-5 of each output row's peak ``|Y|`` of its plain
    version on the card (K7's plain stencil, then cuFFT), two launches
    bitwise equal; then at extra geometries
    (:func:`branch_dft_geometries`).  Timed with its bound (bytes: K7's;
    operations: the stencil's multiply and add a tap and lane, and 5 C
    log2 C an output row's DFT); the yardstick is cuFFT alone over K7's
    ``v`` made beforehand (the transform only, as K9's row has it)."""
    from sdr_tpu_torch.kernels import channelize
    hb = ch_op._hb
    P, C = hb.shape
    require(channelize.dft_route(C, P) == "fused",
            f"the bank's C = {C}, P = {P} not on the fused route")
    hist = ch_op.shard_carry(x)
    num = x.shape[-1] // C
    a = (hb, hist, x, num)
    y = channelize.branch_dft(*a)
    ref = channelize.branch_dft_reference(*a)
    torch.cuda.synchronize()
    require(torch.isfinite(torch.view_as_real(y)).all().item(),
            "K7 + DFT output finite")
    rel, row = peak_err(y, ref)
    err = max_err(y, ref)
    require(rel <= 1e-5, f"K7 + DFT vs plain {rel} > 1e-5 of a row's peak "
                         f"(output row {row})")
    del ref
    check_repeatable(lambda: channelize.branch_dft(*a), "K7 + DFT")
    count = branch_dft_geometries(x.device, seed)
    rows = y.numel() // C
    ops = 2 * P * 2 * y.numel() + rows * 5 * C * int(np.log2(C))
    b, by = bound(nbytes(hb, hist, x, y), ops, "f32")
    ms = time_ms(lambda: channelize.branch_dft(*a), 20)
    plain_ms = time_ms(lambda: channelize.branch_dft_reference(*a), 3, 1)
    v = channelize.branch_filter(*a)
    lib_ms = time_ms(lambda: torch.fft.fft(v, dim=-1), 20)
    del v
    print(f"K7 + DFT branch_dft: within {rel} of each output row's peak "
          f"|Y| of its plain version (K7's plain stencil, then cuFFT; worst "
          f"output row {row}; max abs diff {err}) at {list(x.shape)} with "
          f"its carry, two launches bitwise equal, and at {count} extra "
          f"geometries; {ms} ms, cuFFT alone over v {lib_ms} ms")
    return dict(
        name=f"K7 + DFT branch_dft (wideband bank, {list(x.shape)} "
             f"complex64 + carry {list(hist.shape)}, C = {C}, P = {P})",
        kernel="channelize", function="launch_branch_dft", route="cuda",
        source="sdr_tpu_torch/csrc/channelize.cu",
        replaces="none: sdr_tpu/ops/channelize.py:108-116 (the branch "
                 "filter's stencil, XLA's FFT across the branches and the "
                 "transpose)",
        shape=f"hist {list(hist.shape)}, x {list(x.shape)} -> "
              f"{list(y.shape)} complex64",
        plan=channelize.dft_plan(C, P, num), max_abs_err=err,
        max_peak_rel_err=rel, geometries=count, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, bound_fraction=b / ms, library_ms=lib_ms,
        library_note=f"torch.fft.fft (cuFFT) across the branches of K7's v "
                     f"made beforehand, complex64 {list(y.shape)}: the "
                     "transform only")


def branch_dft_geometries(device, seed: int) -> int:
    """K7 + DFT within 1e-5 of each output row's peak of its plain version
    over [3] rows at C in {64, 128, 256} x P in {1, 5, 12}, ``num`` one
    below and one above its tile, histories of 0 and (P - 1) C samples,
    row bases 1-3 samples off 16-byte alignment (the rows hold a sample
    more than read); at P = 12 the widest C the plan takes (1,024) and the
    first it refuses (2,048), and at C = 1,024 the first P whose tile does
    not fit a block (20): the wrapper refuses both before any launch, and
    the launch itself (the source's own plan) refuses them too; the
    source's plan equals ``dft_plan`` at each geometry.  Returns the
    count."""
    import ctypes

    from sdr_tpu_torch.kernels import channelize, fft_stream
    from sdr_tpu_torch.kernels._build import ptr
    g = torch.Generator(device=device).manual_seed(seed + 3)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=device),
                             torch.randn(shape, generator=g, device=device))

    lib = channelize.KERNEL.lib()
    lib.branch_dft_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]

    def source_plan(C, P, num):
        tile, smem = ctypes.c_int(), ctypes.c_int()
        rc = lib.branch_dft_plan(C, P, num, ctypes.byref(tile),
                                 ctypes.byref(smem))
        return rc, tile.value, smem.value

    count, worst = 0, 0.0
    geoms = [(C, P, num) for C in (64, 128, 256) for P in (1, 5, 12)
             for num in (channelize.dft_plan(C, P)["tile"] - 1,
                         channelize.dft_plan(C, P)["tile"] + 1)]
    geoms.append((1024, 12, 9))
    for C, P, num in geoms:
        hb = torch.randn(P, C, generator=g, device=device)
        want = channelize.dft_plan(C, P, num)
        require(source_plan(C, P, num) == (0, want["tile"], want["smem"]),
                f"K7 + DFT plan at C {C}, P {P}, num {num}: "
                f"{source_plan(C, P, num)} against {want}")
        for H in (0, (P - 1) * C):
            off = 1 + count % 3
            n = (num + P - 1) * C - H + 1
            x = misaligned(cplx(3, n), off)
            hist = misaligned(cplx(3, H), off) if H else x.new_empty((3, 0))
            a = (hb, hist, x, num)
            rel, _ = peak_err(channelize.branch_dft(*a),
                              channelize.branch_dft_reference(*a))
            require(rel <= 1e-5, f"K7 + DFT at C {C}, P {P}, num {num}, "
                                 f"history {H}, offset {off}: {rel}")
            worst = max(worst, rel)
            count += 1
    for C, P, code, words in ((2048, 12, -3, "64 to 1,024"),
                              (1024, 20, -1, "do not fit")):
        hb = torch.randn(P, C, generator=g, device=device)
        x = cplx(1, P * C)
        hist = x.new_empty((1, 0))
        require(channelize.dft_route(C, P) == "k7+fft",
                f"K7 + DFT route at C {C}, P {P}")
        try:
            channelize.branch_dft(hb, hist, x, 1)
        except ValueError:
            pass
        else:
            require(False, f"the wrapper took C {C}, P {P}")
        require(source_plan(C, P, 1)[0] == code,
                f"K7 + DFT source plan at C {C}, P {P}")
        y = torch.empty((1, 1, C), dtype=torch.complex64, device=device)
        try:
            channelize.KERNEL.launch(
                "launch_branch_dft", x.device, ptr(hb), ptr(hist), ptr(x),
                ptr(fft_stream.twiddles(C, device)), ptr(y), 1, 0, P * C, 1,
                C, P)
        except RuntimeError as e:
            require(words in str(e), f"K7 + DFT at C {C}, P {P}: {e}")
        else:
            require(False, f"K7 + DFT launched at C {C}, P {P}")
        count += 1
    print(f"K7 + DFT: within {worst} of each output row's peak of its "
          f"plain version at {count - 2} extra geometries; C = 1,024 runs "
          "at P = 12 while C = 2,048 and, at C = 1,024, P = 20 are refused "
          "by the wrapper, the route and the source's own plan")
    return count


def check_bank_kernels(x, ops, seed: int):
    """K7 and K7 + DFT at the wideband channel bank's [32, 4,096,000]
    input, then K3 at
    f = 8, K11, K2 and K3 at f = 1 at its shapes: the filterbank's [32,
    64] channels of 64,000 samples, their demod's 8,000, the resampler's
    2,400."""
    xb = x.view(ROWS, CH_BLOCK)
    rows = [check_channelize_kernel(ops[0], xb, seed),
            check_branch_dft_kernel(ops[0], xb, seed)]
    _, xc = ops[0].apply(ops[0].shard_carry(xb), xb)
    rows.append(check_complex_decimator_kernel(
        "K3 fir complex (wideband bank decimator, [32, 64, 64,000] "
        "channel-major, f = 8, 51 taps)", ops[1], xc))
    _, yd = ops[1].apply(ops[1].shard_carry(xc), xc)
    del xc
    rows += check_fm_demod_kernel(
        "K11 fm_demod (wideband bank complex [32, 64, 8,000])", ops[2], yd,
        seed)
    _, dm = ops[2].apply(ops[2].shard_carry(yd), yd)
    rows.append(check_resampler_kernel(
        "K2 resample (channel bank [32, 64], 8,000 -> 2,400)", ops[3], dm))
    _, rs = ops[3].apply(ops[3].shard_carry(dm), dm)
    rows.append(check_decimator_kernel(
        "K3 fir (channel bank audio FIR [32, 64], f = 1, 64 taps)", ops[4],
        rs))
    return rows


def check_narrowband_kernels(x, ops, seed: int):
    """K3 at f = 8, K11, K2 and K3 at f = 1 at the narrowband channel
    bank's shapes: ``run_time_batched``'s batch of NB_BLOCKS consecutive
    blocks of every channel, [4, 64] rows of 655,360 samples, their
    demod's 81,920, the resampler's 24,576."""
    xb = x.view(CH_C, NB_BLOCKS, -1).movedim(1, 0).contiguous()
    rows = [check_complex_decimator_kernel(
        "K3 fir complex (narrowband bank decimator, [4, 64, 655,360] rows, "
        "f = 8, 51 taps)", ops[0], xb)]
    _, yd = ops[0].apply(ops[0].shard_carry(xb), xb)
    del xb
    rows += check_fm_demod_kernel(
        "K11 fm_demod (narrowband bank complex [4, 64, 81,920])", ops[1],
        yd, seed)
    _, dm = ops[1].apply(ops[1].shard_carry(yd), yd)
    del yd
    rows.append(check_resampler_kernel(
        "K2 resample (narrowband bank [4, 64], 81,920 -> 24,576)", ops[2],
        dm))
    _, rs = ops[2].apply(ops[2].shard_carry(dm), dm)
    rows.append(check_decimator_kernel(
        "K3 fir (narrowband bank audio FIR [4, 64], f = 1, 64 taps)",
        ops[3], rs))
    return rows


def check_bank_tones(y: np.ndarray, what: str) -> float:
    """Channel c's audio carries its tone, 200 + 150 c Hz, within 5 Hz,
    for every c whose tone the audio FIR passes; returns the worst
    error."""
    worst = 0.0
    for c in range(TONE_CHANNELS):
        hz = tone_hz(y[c])
        worst = max(worst, abs(hz - (200 + 150 * c)))
        require(abs(hz - (200 + 150 * c)) < 5,
                f"{what}: channel {c} tone at {hz} Hz")
    return worst


def run_channelizer_wideband(x, ops, kernels):
    """The wideband channel bank block-parallel (launches, no cuFFT
    kernel, tones, peak memory, 20 timed calls), streamed (bitwise the
    block-parallel call), and against the plain CPU chain.  Returns the
    launches of one call and the filterbank source's launches by
    function."""
    from sdr_tpu_torch.apps.chains import channelizer_chain
    from sdr_tpu_torch.kernels import channelize
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, x, kernels)                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, x, kernels)
    peak = torch.cuda.max_memory_allocated()
    # the filterbank in one launch (K7 + DFT: no K7 alone, no cuFFT); the
    # decimator's and the audio FIR's seam and main launches, and the
    # resampler: each Fir filter or decimator splits its outputs at the
    # seam (the few that read history, then the rest from the block)
    functions = dict(channelize.KERNEL.function_launches)
    require_launches(launches, {"fir": 4, "resample": 1, "channelize": 1,
                                "fm_demod": 1}, "wideband channelizer path")
    require(functions == {"launch_branch_dft": 1},
            f"wideband channelizer path: the filterbank's launches "
            f"{functions}, expected K7 + DFT once")
    require_no_layout_copy("wideband channelizer path")
    fft_kernels = device_kernels(lambda: run_time_batched(ops, x, ROWS),
                                 "fft")
    require(not fft_kernels, f"wideband channelizer path ran cuFFT "
                             f"kernels: {fft_kernels}")
    per_row = CH_BLOCK // CH_C * 3 // 80
    require(tuple(y.shape) == (CH_C, ROWS * per_row), f"bank {y.shape}")
    out = y.cpu().numpy()
    require(np.isfinite(out).all(), "bank output finite")
    worst = check_bank_tones(out, "wideband bank")
    print(f"wideband channelizer block-parallel chain: {ROWS} x {CH_BLOCK} "
          f"wideband samples -> {tuple(y.shape)}; tones of channels 0-"
          f"{TONE_CHANNELS - 1} within {worst:.3f} Hz; peak memory {peak} "
          f"bytes; launches in one call {launches} (the filterbank's "
          f"{functions}); no cuFFT kernel")
    time_chain(ops, x, "wideband channelizer block-parallel chain",
               samples=x.numel(), unit="wideband complex input samples/s")

    pipe = Pipeline(ops, block_in=CH_BLOCK, in_dtype=torch.complex64)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        x[i:i + CH_BLOCK] for i in range(0, x.numel(), CH_BLOCK))), dim=-1)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"channelize": 1, "fm_demod": 1},
                      x.numel() // CH_BLOCK, "wideband channelizer streamed")
    require(channelize.KERNEL.function_launches == {
        "launch_branch_dft": x.numel() // CH_BLOCK},
        f"wideband channelizer streamed: the filterbank's launches "
        f"{channelize.KERNEL.function_launches}")
    dstream = max_err(streamed, y)
    require(torch.equal(streamed, y),
            f"bank streamed vs block-parallel not bitwise ({dstream})")
    print(f"wideband channelizer streamed op by op at {CH_BLOCK}-sample "
          f"blocks: max abs diff to block-parallel {dstream} (bitwise "
          f"equal: {torch.equal(streamed, y)}); "
          f"{x.numel() / t_stream:.6e} wideband complex input samples/s")
    compiled_run(pipe, list(x.split(CH_BLOCK)), streamed,
                 "wideband channelizer", x.numel(),
                 unit="wideband complex input samples/s")

    _, ref = Pipeline(channelizer_chain(CH_C, wideband=True, device="cpu"),
                      block_in=CH_BLOCK, in_dtype=torch.complex64,
                      device="cpu").process(x[:4 * CH_BLOCK].cpu())
    diff = max_err(streamed[:, :ref.shape[-1]].cpu(), ref)
    require(diff <= 1e-4, f"bank card vs CPU plain chain {diff} > 1e-4")
    print(f"wideband channelizer card vs CPU plain chain on 4 blocks: max "
          f"abs diff {diff}")
    return launches, functions


def run_channelizer_narrowband(x, ops, kernels):
    """The narrowband channel bank in NB_BLOCKS blocks (launches, tones,
    peak memory, 20 timed calls), against one block (the CLI's form), the
    streamed run over [64, n] blocks and the plain CPU chain."""
    from sdr_tpu_torch.apps.chains import channelizer_chain
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    counted_call(ops, x, kernels, NB_BLOCKS)        # warm-up
    torch.cuda.reset_peak_memory_stats()
    y, launches = counted_call(ops, x, kernels, NB_BLOCKS)
    peak = torch.cuda.max_memory_allocated()
    require_launches(launches, {"fir": 4, "resample": 1, "fm_demod": 1},
                     "narrowband channelizer path")
    require_no_layout_copy("narrowband channelizer path")
    require(tuple(y.shape) == (CH_C, NB_SAMPLES * 3 // 80),
            f"narrowband bank {y.shape}")
    out = y.cpu().numpy()
    require(np.isfinite(out).all(), "narrowband output finite")
    worst = check_bank_tones(out, "narrowband bank")
    print(f"narrowband channelizer chain: {list(x.shape)} in {NB_BLOCKS} "
          f"blocks -> {tuple(y.shape)}; tones of channels 0-"
          f"{TONE_CHANNELS - 1} within {worst:.3f} Hz; peak memory {peak} "
          f"bytes; launches in one call {launches}")
    time_chain(ops, x, "narrowband channelizer block-parallel chain",
               nblocks=NB_BLOCKS, samples=x.numel(),
               unit="channel complex input samples/s (all channels)")
    one = run_time_batched(ops, x, 1)
    d1 = max_err(one, y)
    require(d1 <= 1e-6, f"narrowband {NB_BLOCKS} blocks vs 1: {d1}")
    blk = NB_SAMPLES // NB_BLOCKS
    pipe = Pipeline(ops, block_in=blk, batch_shape=(CH_C,),
                    in_dtype=torch.complex64)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    streamed = torch.cat(eager_stream(pipe, (
        x[:, i:i + blk] for i in range(0, NB_SAMPLES, blk))), dim=-1)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require_per_block(kernels, {"fm_demod": 1}, NB_BLOCKS,
                      "narrowband channelizer streamed")
    dstream = max_err(streamed, y)
    require(dstream <= 1e-6,
            f"narrowband streamed vs block-parallel {dstream}")
    print(f"narrowband channelizer streamed op by op at [{CH_C}, {blk}] "
          f"blocks: max abs diff to block-parallel {dstream} (bitwise "
          f"equal: {torch.equal(streamed, y)}); "
          f"{x.numel() / t_stream:.6e} channel complex input samples/s "
          "(all channels)")
    compiled_run(pipe, list(x.split(blk, dim=-1)), streamed,
                 "narrowband channelizer", x.numel(),
                 unit="channel complex input samples/s (all channels)")
    n, m = NB_SAMPLES // NB_BLOCKS, NB_SAMPLES // NB_BLOCKS * 3 // 80
    ref = run_time_batched(channelizer_chain(CH_C, device="cpu"),
                           x[:8, :n].cpu(), 1, device="cpu")
    diff = max_err(y[:8, :m].cpu(), ref)
    require(diff <= 1e-5, f"narrowband card vs CPU plain chain {diff}")
    print(f"narrowband channelizer: {NB_BLOCKS} blocks vs 1 max abs diff "
          f"{d1} (bitwise equal: {torch.equal(one, y)}); card vs CPU plain "
          f"chain (8 channels, one block) max abs diff {diff}")
    return launches


def run_channelizer_cli():
    """``python -m sdr_tpu_torch.apps.channelizer --synthetic --channels
    64 --seconds 0.1``, plain and ``--wideband``: the line, 64 WAVs of
    4,800 samples at 48 kHz, and the plain form's tones (the
    ``--wideband`` synthetic zero-stuffs each station, so each channel
    carries all of them: ROADMAP F2)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    m = int(FS_IN * 0.1) // 80 * 80 * 3 // 80
    for extra in ([], ["--wideband"]):
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "ch")
            proc = subprocess.run(
                [sys.executable, "-m", "sdr_tpu_torch.apps.channelizer",
                 "--synthetic", "--channels", str(CH_C), "--seconds", "0.1",
                 "--out-prefix", prefix, *extra], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            what = f"channelizer cli {' '.join(extra) or '(narrowband)'}"
            print(f"{what}: rc {proc.returncode} {proc.stdout.strip()}")
            require(proc.returncode == 0, f"{what} failed: {proc.stderr}")
            require(f"demodulated {CH_C} channels x {m} samples at 48000 Hz "
                    "on 1 devices" in proc.stdout, f"{what} line")
            pcm = []
            for c in range(CH_C):
                with wave.open(f"{prefix}{c:03d}.wav", "rb") as wf:
                    require(wf.getframerate() == 48_000, "WAV rate")
                    require(wf.getnframes() == m, "WAV length")
                    pcm.append(np.frombuffer(wf.readframes(m), "<i2"))
        if not extra:
            worst = 0.0
            for c in range(TONE_CHANNELS):
                seg = pcm[c][200:].astype(np.float64)
                spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg)),
                                          1 << 16))
                hz = np.argmax(spec) * 48_000 / (1 << 16)
                worst = max(worst, abs(hz - (200 + 150 * c)))
                require(abs(hz - (200 + 150 * c)) < 5,
                        f"{what}: channel {c} tone at {hz} Hz")
            print(f"{what}: {CH_C} WAVs of {m} samples at 48 kHz; tones of "
                  f"channels 0-{TONE_CHANNELS - 1} within {worst:.3f} Hz")
        else:
            print(f"{what}: {CH_C} WAVs of {m} samples at 48 kHz")


def run_roofline(card: str) -> list:
    """Phase 14: each block-parallel chain that time_chain timed, beside
    its floors from ``utils/roofline.py`` on the data sheet's ceilings and
    on this run's measured ones.  Adds no timed call.  The io floor is the
    bytes a chain cannot avoid, its input read and its output written: a
    device time under it (less 5 %) means the timing is at fault.  A stage
    sum's share above 1 is printed, not hidden: a small intermediate can
    stay in the 50 MB L2 between stages."""
    from sdr_tpu_torch.utils.roofline import (DATASHEET, MEASURED_CEILINGS,
                                              chain_roofline)
    ceilings = {"sheet": MEASURED_CEILINGS[DATASHEET],
                "measured": CEILINGS["measured"]}
    rows = []
    for rec in CHAIN_TIMINGS:
        row = {k: rec[k] for k in ("chain", "block_in", "batch", "span_ms",
                                   "device_ms", "enqueue_ms")}
        row["in_dtype"] = str(rec["in_dtype"])
        for key, c in ceilings.items():
            r = chain_roofline(rec["ops"], rec["block_in"], rec["in_dtype"],
                               rec["batch"], ceilings=c)
            st = r["stages"]
            io_ms = (st[0]["bytes_in"] + st[-1]["bytes_out"]) / c.hbm_bps \
                * 1e3
            floor_ms = r["total_floor_s"] * 1e3
            worst = max(st, key=lambda s: s["floor_s"])
            row[key] = dict(
                floor_ms=floor_ms, io_floor_ms=io_ms,
                sol_samples_per_s=r["sol_samples_per_s"],
                share=floor_ms / rec["device_ms"],
                io_share=io_ms / rec["device_ms"],
                largest_stage=f"{worst['op']} {worst['floor_s'] * 1e3} ms "
                              f"({worst['bound_by']})",
                stages=[(s["op"], s["floor_s"] * 1e3, s["bound_by"])
                        for s in st])
        rows.append(row)
        sh, me = row["sheet"], row["measured"]
        print(f"roofline {rec['chain']}: span {rec['span_ms']} ms, device "
              f"{rec['device_ms']} ms; stage-sum floor {sh['floor_ms']} ms "
              f"(data sheet) / {me['floor_ms']} ms (measured), shares "
              f"{sh['share']} / {me['share']}; io floor {sh['io_floor_ms']} "
              f"/ {me['io_floor_ms']} ms, shares {sh['io_share']} / "
              f"{me['io_share']}; speed of light {sh['sol_samples_per_s']:.6e}"
              f" / {me['sol_samples_per_s']:.6e} input samples/s; largest "
              f"stage floor {sh['largest_stage']}; on {card}")
        require(rec["device_ms"] >= sh["io_floor_ms"] / IO_SLACK,
                f"{rec['chain']}: device {rec['device_ms']} ms under its io "
                f"floor {sh['io_floor_ms']} ms / {IO_SLACK}")
    require(rows, "no block-parallel chain was timed")
    return rows


# -- the sharded paths --------------------------------------------------

SHARD_RANKS = 4                       # gloo ranks sharing the one card
SHARD_REPS = 5                        # timed calls of each sharded path
SHARD_TIMEOUT_S = 600                 # a rank's limit: a hang fails the run
SHARD_CLI_SECONDS = 0.5               # the channelizer CLI's default
SHARD_LABEL = "4 ranks sharing one card: not a scaling figure"
NCCL_LABEL = "1 rank over NCCL: not a scaling figure"


class CollectiveClock:
    """Host seconds spent in ``torch.distributed.all_gather`` (gloo) and
    ``all_gather_into_tensor`` (NCCL), the collectives the port's halo
    helpers and runners make, while installed (``with``).  For gloo this
    includes waiting for the other ranks; a replay of a compiled call
    makes no collective call on the host."""

    NAMES = ("all_gather", "all_gather_into_tensor")

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        import torch.distributed as dist
        self._dist = dist
        self._orig = {n: getattr(dist, n) for n in self.NAMES}

        def timer(orig):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    self.seconds += time.perf_counter() - t0
            return timed

        for n, orig in self._orig.items():
            setattr(dist, n, timer(orig))
        return self

    def __exit__(self, *exc):
        for n, orig in self._orig.items():
            setattr(self._dist, n, orig)


def time_sharded(fn, what: str, label: str, card: str,
                 reps: int = SHARD_REPS):
    """Median span of ``reps`` calls, each between CUDA events, and the
    median host time of a call spent in the collectives; printed with the
    label that says what the figure is not."""
    spans, coll = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with CollectiveClock() as clock:
            a.record()
            fn()
            b.record()
            b.synchronize()
        spans.append(a.elapsed_time(b))
        coll.append(clock.seconds * 1e3)
    ms, cms = float(np.median(spans)), float(np.median(coll))
    print(f"{what}: median span {ms} ms over {reps} calls by CUDA "
          f"events (min {min(spans)}, max {max(spans)}); host time in the "
          f"collectives {cms} ms a call (median) -- {label}; {card}")
    return ms, cms


def time_back_to_back(fn, what: str, label: str, card: str,
                      reps: int = CHAIN_REPS) -> float:
    """ms a call over ``reps`` calls enqueued back to back with no wait
    between them (CUDA events before the first and after the last): where
    a call waits for the card, its enqueue and the card's work add up;
    otherwise the larger of the two sets the pace."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    print(f"{what}: {ms} ms a call over {reps} back-to-back calls by CUDA "
          f"events -- {label}; {card}")
    return ms


def stereo_ops(fused: bool, device):
    """The stereo + de-emphasis chain on the quantized front, with the back
    half on K2 -> K3 or, ``fused``, on K5."""
    from sdr_tpu_torch.apps.chains import fm_chain, fm_taps
    from sdr_tpu_torch.stream import ResampleFirScale
    ops = fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                   device=device)
    if not fused:
        return ops
    _, ars, afl = fm_taps()
    return [*ops[:3], ResampleFirScale(ars, 3, 10, afl, 1.0, fused=True,
                                       device=device), *ops[4:]]


def nccl_world1(device, backend: str | None = None):
    """A one-rank process group in this process: NCCL for CUDA tensors
    with gloo beside it for host ones (what ``init_distributed`` asks
    for), or ``backend``; gloo for a CPU rehearsal."""
    import torch.distributed as dist
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def sync_free(fn):
    """``fn()`` with ``torch.cuda.set_sync_debug_mode('error')``: any call
    in it that waits for the card raises."""
    if not torch.cuda.is_available():
        return fn()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def group_prefix_maps(seed: int, device) -> dict:
    """Seeded maps of a stream of ROWS rows in both of K15's forms, at the
    paths' lane shapes: {form: (m, v, s0)}, the scalar form [ROWS] (the
    AGC's, the DC blocker's, the lock's) and the matrix form [ROWS, 2]
    lanes of order 2 (the stereo Iir's)."""
    g = torch.Generator(device=device).manual_seed(seed + 18)

    def u(*shape):
        return torch.rand(shape, generator=g, device=device) * 2 - 1

    return {"scalar": (u(ROWS), u(ROWS), u()),
            "matrix": (u(ROWS, 2, 2, 2) * 0.5, u(ROWS, 2, 2), u(2, 2))}


def group_prefixes(maps: dict, group, rows: slice) -> dict:
    """Each form's prefixes and entering states over ``rows`` of
    ``maps`` through ``parallel/halo.py`` with ``group`` (K15's group
    path: two launches a composition): {name: tensor}."""
    from sdr_tpu_torch.parallel import halo
    out = {}
    for form, (m, v, s0) in maps.items():
        A, c = halo.exclusive_affine_prefix(m[rows], v[rows], group)
        out[f"{form}.A"], out[f"{form}.c"] = A, c
        out[f"{form}.state"] = halo.entering_state(m[rows], v[rows], s0,
                                                   group)
    return out


def check_group_prefixes(got: list, maps: dict, what: str) -> float:
    """Rank r's ``got[r]`` (:func:`group_prefixes` over its span of the
    rows) against this process: bitwise K15 and its plain version given
    the whole maps of the ranks before (each rank's total by K15), both
    forms; within 1e-5 of each lane's peak of one process over all the
    rows (another order of composition, H7).  Returns that distance."""
    from sdr_tpu_torch.kernels import affine_prefix as k15
    ranks = len(got)
    per = ROWS // ranks
    worst = 0.0
    for form, (m, v, s0) in maps.items():
        whole = k15.exclusive_prefix(m, v)
        whole_state = k15.entering_state(m, v, s0)
        parts = [(m[r * per:(r + 1) * per], v[r * per:(r + 1) * per])
                 for r in range(ranks)]
        totals = [torch.stack(t) for t in zip(
            *(k15.inclusive_total(*pt) for pt in parts))]
        for r, (mr, vr) in enumerate(parts):
            pre = (totals[0][:r], totals[1][:r])
            (A, c), st, _ = k15._launch(mr, vr, pre, s0, state=True)
            plain = k15.exclusive_prefix_reference(mr, vr, pre)
            plain_st = k15.entering_state_reference(mr, vr, s0, pre)
            mine = (got[r][f"{form}.A"], got[r][f"{form}.c"],
                    got[r][f"{form}.state"])
            require(same_bits(mine, (A, c, st)) and same_bits(
                mine, (*plain, plain_st)), f"{what} rank {r} {form}: the "
                "prefixes are not K15's over the ranks before, bitwise")
            rows = slice(r * per, (r + 1) * per)
            inner = 0 if form == "scalar" else 1
            worst = max(worst,
                        lane_rel(mine[0], whole[0][rows], 2 * inner),
                        lane_rel(mine[1], whole[1][rows], inner),
                        lane_rel(mine[2], whole_state[rows], inner))
    require(worst <= GROUP_REL, f"{what}: {worst} of a lane's peak from "
            "one process over all the rows")
    return worst


HOLD_S = 1.0                # host time the held capture stays open


def held_capture(group, device) -> None:
    """ROADMAP H25: a capture of an NCCL gather in ``torch.cuda.graph``'s
    default mode ("global", the mode of every capture in the port), held
    open HOLD_S on the host while the NCCL watchdog thread polls the
    events of the eager gathers before it, then replayed and checked."""
    from sdr_tpu_torch.parallel.halo import gather_ranks
    t = torch.arange(4096, dtype=torch.float32, device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gather_ranks(t * 2, group)
        time.sleep(HOLD_S)
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(out[0], t * 2), "a replay of the held capture's "
            "gather is wrong")
    print(f"NCCL world 1: a capture of a gather held open {HOLD_S} s while "
          f"the watchdog polls, in the 'global' mode: replayed right")
    del graph


SHARD_COMPILED_CHAINS = ("mono", "stereo_fused", "am")


def split_nccl_annotations(kernels: dict) -> tuple:
    """(:func:`device_kernels`' entries but the profiler's annotations of
    NCCL collectives, those annotations): the profiler lists an eager
    collective as ``nccl:<op>`` on the device beside its work."""
    notes = {k: n for k, n in kernels.items() if k.startswith("nccl:")}
    return {k: n for k, n in kernels.items() if k not in notes}, notes


def compiled_world1(name: str, mesh, seed: int, device, card: str) -> dict:
    """``compile_time_sharded`` over the one-rank NCCL mesh at the path's
    full width, ROWS blocks: each of four replays bitwise the eager
    ``run_time_sharded`` (the second after copying a second seeded
    recording into the call's input, the last two under
    ``set_sync_debug_mode('error')``); a replay's device kernels by the
    profiler the eager call's, name for name and count for count (the
    gathers' NCCL work and K15 twice a composition included); the median
    span of CHAIN_REPS replays beside the eager sharded call's and the
    one-process compiled call's (``compile_time_batched``), with the host
    time in the collectives; the capture's ms and its pool's bytes."""
    from sdr_tpu_torch.parallel import (compile_time_batched,
                                        compile_time_sharded,
                                        run_time_sharded)
    from sdr_tpu_torch.utils import graphs

    ops, raw, nb = compiled_inputs(name, seed, device)
    _, raw2, _ = compiled_inputs(name, seed + 1, device)

    def eager(x=raw):
        return run_time_sharded(ops, mesh, x, nblocks=nb, device=device)

    want, want2 = eager(), eager(raw2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call = compile_time_sharded(ops, mesh, raw.clone(), nblocks=nb,
                                device=device)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    pool = graphs.pool_bytes(call.pool)
    what = f"NCCL world 1 compiled {name}"
    require(same_bits(call(), want), f"{what}: replay != eager sharded call")
    require(same_bits(call(raw2), want2),
            f"{what}: replay on the second recording != eager sharded call")
    require(same_bits(sync_free(lambda: call(raw)), want),
            f"{what}: a sync-free replay after copying the first recording "
            "back in != eager sharded call")
    require(same_bits(sync_free(call), want), f"{what}: sync-free replay")
    require(call.input_copies == 2, f"{what}: input copies "
            f"{call.input_copies}, expected 2")
    # the profiler lists each eager NCCL collective as an annotation
    # ("nccl:_all_gather_base") beside its device work; a replay makes no
    # host call, so it has the work alone
    eager_kernels, gathers = split_nccl_annotations(device_kernels(eager,
                                                                   ""))
    replay_kernels, none = split_nccl_annotations(device_kernels(call, ""))
    require(replay_kernels == eager_kernels and not none,
            f"{what}: the replay's kernels {replay_kernels} != the eager "
            f"sharded call's {eager_kernels}")
    one = compile_time_batched(ops, raw.clone(), nb, device=device)
    require(same_bits(one(), want), f"{what}: one process != sharded")
    # what the group adds to the graph, against the one-process graph:
    # the gathers' device work (NCCL kernels, or at world 1 a copy each)
    # and K15's second launch a composition
    one_kernels, _ = split_nccl_annotations(device_kernels(one, ""))
    added = {k: n - one_kernels.get(k, 0) for k, n in replay_kernels.items()
             if n != one_kernels.get(k, 0)}
    n_gathers = sum(gathers.values())
    comm = sum(n for k, n in added.items() if "memcpy" in k.lower()
               or "nccl" in k.lower())
    prefixes = sum(n for k, n in added.items()
                   if "prefix_warp_kernel" in k or "prefix_thread_kernel" in k)
    require(comm == n_gathers and sum(added.values()) == comm + prefixes,
            f"{what}: the graph adds {added} to the one-process graph, "
            f"the eager call made the collectives {gathers}")
    rec = {"chain": name, "blocks": nb, "input": list(raw.shape),
           "capture_ms": capture_ms, "pool_bytes": pool,
           "kernels": replay_kernels, "eager_collectives": gathers,
           "added_to_one_process": added, "card": card,
           "label": NCCL_LABEL}
    for key, fn, label in (
            ("compiled", call, NCCL_LABEL),
            ("eager", eager, NCCL_LABEL),
            ("one_process_compiled", one, "compile_time_batched, the same "
             "work without a group"),
            ("compiled_again", call, NCCL_LABEL)):
        ms, cms = time_sharded(fn, f"{what}: {key}", label, card,
                               reps=CHAIN_REPS)
        rec[f"{key}_span_ms"], rec[f"{key}_collective_ms"] = ms, cms
    print(f"{what}: bitwise the eager run_time_sharded over 4 replays (one "
          f"on a second recording, two with the sync debug mode at "
          f"'error'); a replay's device kernels the eager call's "
          f"({sum(replay_kernels.values())} launches; the eager call's "
          f"collectives {gathers}); the graph adds to the one-process "
          f"graph {added}; capture {capture_ms:.1f} ms, pool "
          f"{pool} bytes; median spans (ms, {CHAIN_REPS} calls) compiled "
          f"{rec['compiled_span_ms']}, {rec['compiled_again_span_ms']}, "
          f"eager {rec['eager_span_ms']}, one-process compiled "
          f"{rec['one_process_compiled_span_ms']}; host ms in the "
          f"collectives a call: compiled {rec['compiled_collective_ms']}, "
          f"eager {rec['eager_collective_ms']} -- {NCCL_LABEL}; {card}")
    del call, one
    torch.cuda.empty_cache()
    return rec


def run_nccl_world1(seed: int, device, kernels, card: str):
    """``run_time_sharded`` over a one-rank NCCL group in this process, at
    the single-device paths' full width: the mono chain (bitwise
    ``run_time_batched`` over 32 blocks, the same launches) and the stereo
    chain with the fused back half (K4, K5; the IIR's and the pilot's
    affine prefixes gathered by NCCL on CUDA tensors; bitwise).  The
    counted call runs with the sync debug mode at 'error' (the shape check
    gathers host tensors over the group's gloo side and never waits for
    the card); each sharded call's span is printed beside the
    one-process call's.  Then a held capture (:func:`held_capture`) and
    the compiled sharded calls (:func:`compiled_world1`)."""
    import torch.distributed as dist
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.parallel import (run_time_batched, run_time_sharded,
                                        time_mesh)

    nccl_world1(device)
    paths = {}
    try:
        mesh = time_mesh(1, device.type)
        print(f"NCCL world 1: backend "
              f"{dist.get_backend_config(mesh.get_group('t'))}, mesh {mesh}")
        for name, synth, ops, want_launches in (
                ("mono", synth_broadcast, fm_chain(device=device),
                 {"u8_front_demod": 2, "resample": 1, "fir": 1}),
                ("stereo_fused", synth_stereo_broadcast,
                 stereo_ops(True, device),
                 dict(STEREO_FUSED_LAUNCHES, affine_prefix=4))):
            raw = synth(ROWS * ROW_BYTES, seed, device)
            one = lambda: run_time_batched(  # noqa: E731
                ops, raw, ROWS, device=device)
            want, batched = counted(one, kernels)
            fn = lambda: run_time_sharded(ops, mesh, raw,  # noqa: E731
                                          nblocks=ROWS, device=device)
            fn()                                        # warm-up
            got, launches = counted(lambda: sync_free(fn), kernels)
            require(torch.equal(got, want), f"NCCL world 1 {name}: sharded "
                    f"!= run_time_batched (max diff {max_err(got, want)})")
            # with a group K15 launches twice a composition: the rank's
            # whole map (gathered), then the prefixes
            expect = dict(batched, affine_prefix=2 * batched["affine_prefix"])
            require(launches == expect, f"NCCL world 1 {name}: launches "
                    f"{launches}, run_time_batched's {batched}")
            if want_launches is not None:
                require_launches(launches, want_launches,
                                 f"NCCL world 1 {name}")
            require(all(launches[k] > 0 for k in batched if batched[k]),
                    f"NCCL world 1 {name}: launches {launches}")
            print(f"NCCL world 1 {name}: run_time_sharded(time_mesh(1), "
                  f"nblocks={ROWS}) bitwise equal to run_time_batched, "
                  f"with the sync debug mode at 'error'; launches in one "
                  f"call {launches}")
            time_sharded(fn, f"NCCL world 1 {name}", NCCL_LABEL, card)
            time_sharded(one, f"one process {name} (run_time_batched)",
                         "the same work without a group", card)
            time_back_to_back(fn, f"NCCL world 1 {name}", NCCL_LABEL, card)
            time_back_to_back(one, f"one process {name}",
                              "the same work without a group", card)
            paths[f"sharded_nccl_{name}"] = launches
            del raw, want, got
        # K15's group path at world 1: rank 0 composes nothing before its
        # rows, so the prefixes are the one-process ones, bitwise
        maps = group_prefix_maps(seed, device)
        got, launches = counted(lambda: sync_free(lambda: group_prefixes(
            maps, mesh.get_group("t"), slice(None))), kernels)
        require_launches(launches, {"affine_prefix": 8},
                         "NCCL world 1 prefixes (2 a composition)")
        worst = check_group_prefixes([got], maps, "NCCL world 1")
        require(worst == 0.0, f"NCCL world 1 prefixes {worst} from one "
                "process, not bitwise")
        print(f"NCCL world 1: K15's group path (a total gathered, then the "
              f"prefixes) bitwise one process in both forms; launches "
              f"{launches}")
        held_capture(mesh.get_group("t"), device)
        # the sharded calls compiled, their gathers inside the graph
        recs = [compiled_world1(name, mesh, seed, device, card)
                for name in SHARD_COMPILED_CHAINS]
        print(json.dumps({"sharded_compiled": recs}))
    finally:
        dist.destroy_process_group()
    return paths


def compare_s1(tree: Path, backend: str, seed: int) -> int:
    """The NCCL world-1 spans of ``tree``'s port (another checkout, e.g.
    the parent commit's from ``git archive``) with the process group's
    ``backend``: mono and stereo with K5, each sharded call beside the
    one-process call, on the same inputs as phase 11.  Prints the spans;
    checks the outputs bitwise."""
    sys.path.insert(0, str(tree.resolve()))
    import sdr_tpu_torch
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.kernels._build import build_all
    from sdr_tpu_torch.parallel import (run_time_batched, run_time_sharded,
                                        time_mesh)
    import torch.distributed as dist

    card = card_line()
    print(f"S1 spans of {Path(sdr_tpu_torch.__file__).parent} over "
          f"{backend!r}; card: {card}")
    build_all(KERNELS)
    device = torch.device("cuda")
    nccl_world1(device, backend)
    try:
        mesh = time_mesh(1)
        for name, synth, ops in (
                ("mono", synth_broadcast, fm_chain(device=device)),
                ("stereo_fused", synth_stereo_broadcast,
                 stereo_ops(True, device))):
            raw = synth(ROWS * ROW_BYTES, seed, device)
            one = lambda: run_time_batched(  # noqa: E731
                ops, raw, ROWS, device=device)
            fn = lambda: run_time_sharded(ops, mesh, raw,  # noqa: E731
                                          nblocks=ROWS, device=device)
            require(torch.equal(fn(), one()), f"{name}: sharded != one")
            for rep in range(2):
                time_sharded(fn, f"S1 {backend} {name} sharded", NCCL_LABEL,
                             card)
                time_sharded(one, f"S1 {backend} {name} one process",
                             "the same work without a group", card)
                time_back_to_back(fn, f"S1 {backend} {name} sharded",
                                  NCCL_LABEL, card)
                time_back_to_back(one, f"S1 {backend} {name} one process",
                                  "the same work without a group", card)
            del raw
    finally:
        dist.destroy_process_group()
    return 0


def write_shard_inputs(d: Path, seed: int, device):
    """The recordings the ranks read their spans of, one file each, and
    the one-process references (``run_time_batched`` on the card) on the
    host: ``{scenario: tensor}``."""
    from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                           fm_chain)
    from sdr_tpu_torch.apps.channelizer import synthesize
    from sdr_tpu_torch.parallel import run_time_batched

    refs = {}
    raw = synth_broadcast(ROWS * ROW_BYTES, seed, device)
    raw.cpu().numpy().tofile(d / "mono.u8")
    refs["mono"] = run_time_batched(fm_chain(device=device), raw, ROWS,
                                    device=device)
    raw = synth_stereo_broadcast(ROWS * ROW_BYTES, seed, device)
    raw.cpu().numpy().tofile(d / "stereo.u8")
    for fused in (False, True):
        refs[f"stereo{'_fused' * fused}"] = run_time_batched(
            stereo_ops(fused, device), raw, ROWS, device=device)
    x = synth_wideband_bank(ROWS * CH_BLOCK, seed, device)
    x.cpu().numpy().tofile(d / "wide.c64")
    refs["wideband"] = run_time_batched(
        channelizer_chain(CH_C, wideband=True, device=device), x, ROWS,
        device=device)
    x = synthesize(CH_C, NB_SAMPLES, FS_IN, device)
    x.cpu().numpy().tofile(d / "bank.c64")
    ops = channelizer_chain(CH_C, device=device)
    refs["channel"] = run_time_batched(ops, x, 1, device=device)
    refs["grid"] = run_time_batched(ops, x, NB_BLOCKS, device=device)
    raw = synth_am(ROWS * ROW_BYTES, seed, device)
    raw.cpu().numpy().tofile(d / "am.u8")
    refs["am"] = run_time_batched(am_chain(device=device), raw, ROWS,
                                  device=device)
    ops = am_chain(agc_approx=1, device=device)
    refs["am_approx"] = run_time_batched(ops, raw, ROWS, device=device)
    refs["am_approx_demod"] = run_time_batched(ops[:5], raw, ROWS,
                                               device=device)
    del raw, x
    maps = group_prefix_maps(seed, device)
    np.savez(d / "prefix_maps.npz", **{
        f"{form}.{i}": t.cpu().numpy() for form, ts in maps.items()
        for i, t in enumerate(ts)})
    return {k: v.cpu() for k, v in refs.items()}


def shard_worker(rank: int, d: Path, device: torch.device) -> int:
    """One of SHARD_RANKS gloo ranks on ``device`` (the parent's,
    ``cuda``: card 0): each scenario on this rank's span (read from the
    parent's files), its launches counted around one call, SHARD_REPS
    calls timed; writes its outputs and a report to ``d``.  Builds
    nothing: the parent built the kernels."""
    import torch.distributed as dist
    from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                           fm_chain)
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.parallel import (channel_time_mesh,
                                        compile_time_sharded,
                                        global_time_sharded,
                                        host_block_iterator,
                                        init_distributed, make_mesh,
                                        run_channel_sharded,
                                        run_grid_sharded, run_time_sharded,
                                        time_mesh)
    from sdr_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    if device.type == "cuda":
        require(all(k.library_path().exists() for k in KERNELS),
                "a kernel library is missing: the parent builds them")
        torch.cuda.set_device(0)
    card = card_line()
    init_distributed("gloo", init_method=f"file://{d / 'store'}",
                     world_size=SHARD_RANKS, rank=rank)
    report = {}
    try:
        tmesh = time_mesh(None, device.type)
        cmesh = make_mesh((SHARD_RANKS,), ("c",), device.type)
        grid = channel_time_mesh(2, SHARD_RANKS // 2, device.type)
        per = ROWS // SHARD_RANKS

        def span(name, n_global, dtype=np.uint8):
            blk, = host_block_iterator(d / name, tmesh, n_global, dtype)
            return global_time_sharded(blk, tmesh, n_global, device=device)

        def scenario(name, fn):
            fn()                                        # warm-up
            y, launches = counted(fn, KERNELS)
            np.save(d / f"{name}.{rank}.npy", y.cpu().numpy())
            print(f"rank {rank} {name}: launches in one call {launches}")
            ms, cms = time_sharded(fn, f"rank {rank} {name}", SHARD_LABEL,
                                   card)
            report[name] = {"launches": launches, "median_ms": ms,
                            "collective_ms": cms}

        raw = span("mono.u8", ROWS * ROW_BYTES)
        ops = fm_chain(device=device)
        scenario("mono", lambda: run_time_sharded(ops, tmesh, raw,
                                                  nblocks=per, device=device))
        raw = span("stereo.u8", ROWS * ROW_BYTES)
        for fused in (False, True):
            sops = stereo_ops(fused, device)
            scenario(f"stereo{'_fused' * fused}",
                     lambda: run_time_sharded(sops, tmesh, raw,
                                              nblocks=per, device=device))
        x = span("wide.c64", ROWS * CH_BLOCK, np.complex64)
        ops = channelizer_chain(CH_C, wideband=True, device=device)
        scenario("wideband", lambda: run_time_sharded(
            ops, tmesh, x, nblocks=per, device=device))
        bank = np.memmap(d / "bank.c64", np.complex64, "r").reshape(
            CH_C, NB_SAMPLES)
        ops = channelizer_chain(CH_C, device=device)
        c, nc = cmesh.get_local_rank("c"), CH_C // SHARD_RANKS
        x = torch.from_numpy(np.array(bank[c * nc:(c + 1) * nc])).to(device)
        scenario("channel", lambda: run_channel_sharded(ops, cmesh, x,
                                                        device=device))
        c, t = grid.get_local_rank("c"), grid.get_local_rank("t")
        nc, nt = CH_C // grid["c"].size(), NB_SAMPLES // grid["t"].size()
        xg = torch.from_numpy(np.array(
            bank[c * nc:(c + 1) * nc, t * nt:(t + 1) * nt])).to(device)
        scenario("grid", lambda: run_grid_sharded(
            ops, grid, xg, nblocks=NB_BLOCKS // grid["t"].size(),
            device=device))
        del x, xg
        raw = span("am.u8", ROWS * ROW_BYTES)
        ops = am_chain(device=device)
        scenario("am", lambda: run_time_sharded(ops, tmesh, raw, nblocks=per,
                                                device=device))
        ops = am_chain(agc_approx=1, device=device)
        scenario("am_approx", lambda: run_time_sharded(
            ops, tmesh, raw, nblocks=per, device=device))
        scenario("am_approx_demod", lambda: run_time_sharded(
            ops[:5], tmesh, raw, nblocks=per, device=device))
        # K15's group path on seeded maps, this rank's span of the rows
        z = np.load(d / "prefix_maps.npz")
        maps = {form: tuple(torch.from_numpy(z[f"{form}.{i}"]).to(device)
                            for i in range(3))
                for form in ("scalar", "matrix")}
        got, launches = counted(lambda: group_prefixes(
            maps, tmesh.get_group("t"), slice(rank * per, (rank + 1) * per)),
            KERNELS)
        np.savez(d / f"prefixes.{rank}.npz",
                 **{k: t.cpu().numpy() for k, t in got.items()})
        report["prefixes"] = {"launches": launches}
        if device.type == "cuda":
            # a gloo group's CUDA collectives go through the host: the
            # compiled call refuses it before any collective, on every rank
            t0 = time.perf_counter()
            try:
                compile_time_sharded(fm_chain(device=device), tmesh,
                                     span("mono.u8", ROWS * ROW_BYTES),
                                     nblocks=per, device=device)
            except ValueError as e:
                report["compile_refused"] = str(e)
            report["compile_refused_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(report))
    return 0


# scenario -> (bound of the joined output against run_time_batched: 0 is
# bitwise; the kernels a rank must launch in one call)
SHARD_CHECKS = {
    "mono": (0.0, ("u8_front_demod", "resample", "fir")),
    "stereo": (1e-5, ("u8_front", "fm_demod", "resample", "fir", "iir",
                      "stereo_decode", "affine_prefix")),
    "stereo_fused": (1e-5, ("u8_front", "fm_demod", "backhalf", "iir",
                            "stereo_decode", "affine_prefix")),
    "wideband": (1e-4, ("channelize", "fir", "fm_demod", "resample")),
    "channel": (0.0, ("fir", "fm_demod", "resample")),
    "grid": (0.0, ("fir", "fm_demod", "resample")),
    "am": (1e-4, ("iq_convert", "mix", "fir", "agc_linear", "iir",
                  "affine_prefix", "am_envelope")),
    "am_approx": (1e-4, ("iq_convert", "mix", "fir", "agc_scan", "iir",
                         "affine_prefix")),
    "am_approx_demod": (0.0, ("iq_convert", "mix", "fir", "agc_scan")),
}
# scenario -> the exact launches of the kernels named, on every rank:
# StereoDecode on K14 alone (A in shard_carry, A and B in apply), K3 only
# for the unfused back half's audio FIR, the complex Mix on K8 once; K15
# twice a composition (the lock and the de-emphasis; the AGC and the DC
# blocker; the DC blocker), K16 once
SHARD_EXACT = {
    "stereo": {"stereo_decode": 3, "fir": 1, "affine_prefix": 4},
    "stereo_fused": {"stereo_decode": 3, "fir": 0, "affine_prefix": 4},
    "am": {"affine_prefix": 4, "am_envelope": 1},
    "am_approx": {"mix": 1, "affine_prefix": 2},
    "am_approx_demod": {"affine_prefix": 0},
}


def join_ranks(name: str, parts):
    """The ranks' outputs as one stream: time spans along the last axis,
    channel shares along -2, the 2 x 2 grid both (rank c*2 + t)."""
    if name == "channel":
        return torch.cat(parts, dim=-2)
    if name == "grid":
        half = SHARD_RANKS // 2
        return torch.cat([torch.cat(parts[c * half:(c + 1) * half], dim=-1)
                          for c in range(2)], dim=-2)
    return torch.cat(parts, dim=-1)


def run_gloo_ranks(seed: int, device, card: str):
    """SHARD_RANKS processes sharing the card over gloo, each reading its
    span of the recordings: every scenario's joined output against the
    one-process run (``SHARD_CHECKS``), each rank's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        refs = write_shard_inputs(d, seed, device)
        torch.cuda.empty_cache()
        print(f"sharded inputs written and referenced in "
              f"{time.perf_counter() - t0:.1f} s")
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank",
             str(r), "--shard-dir", str(d), "--shard-device", str(device)],
            cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(SHARD_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, log in enumerate(logs):
            print(log.rstrip())
        rcs = [p.returncode for p in procs]
        require(rcs == [0] * SHARD_RANKS, f"gloo ranks exited {rcs}")
        reports = [json.loads((d / f"rank{r}.json").read_text())
                   for r in range(SHARD_RANKS)]
        paths = {}
        for name, (tol, kernels) in SHARD_CHECKS.items():
            got = join_ranks(name, [torch.from_numpy(np.load(
                d / f"{name}.{r}.npy")) for r in range(SHARD_RANKS)])
            want = refs[name]
            require(got.shape == want.shape,
                    f"sharded {name}: {tuple(got.shape)} vs "
                    f"{tuple(want.shape)}")
            err = max_err(got, want)
            exact = torch.equal(got, want)
            require(exact if tol == 0 else err <= tol,
                    f"sharded {name}: max abs diff {err} (bound "
                    f"{tol or 'bitwise'})")
            per_rank = [rep[name]["launches"] for rep in reports]
            for r, launches in enumerate(per_rank):
                for k in kernels:
                    require(launches[k] > 0, f"sharded {name}: rank {r} "
                            f"launched no {k} ({launches})")
                for k, want in SHARD_EXACT.get(name, {}).items():
                    require(launches[k] == want, f"sharded {name}: rank {r} "
                            f"launched {k} {launches[k]} times, not {want}")
            paths[f"sharded_gloo_{name}"] = {
                k: [lr[k] for lr in per_rank] for k in per_rank[0]}
            spans = [rep[name]["median_ms"] for rep in reports]
            colls = [rep[name]["collective_ms"] for rep in reports]
            print(f"sharded {name} over {SHARD_RANKS} gloo ranks: max abs "
                  f"diff to run_time_batched {err} (bound "
                  f"{tol or 'bitwise'}; bitwise equal: {exact}); launches "
                  f"per rank {per_rank}; median span per rank {spans} ms, "
                  f"host collectives {colls} ms -- {SHARD_LABEL}; {card}")
        # K15's group path: each rank's prefixes K15's over the ranks
        # before it, bitwise
        z = np.load(d / "prefix_maps.npz")
        maps = {form: tuple(torch.from_numpy(z[f"{form}.{i}"]).to(device)
                            for i in range(3))
                for form in ("scalar", "matrix")}
        got = []
        for r in range(SHARD_RANKS):
            zr = np.load(d / f"prefixes.{r}.npz")
            got.append({k: torch.from_numpy(zr[k]).to(device) for k in zr})
        worst = check_group_prefixes(got, maps, "gloo ranks")
        per_rank = [rep["prefixes"]["launches"] for rep in reports]
        for r, launches in enumerate(per_rank):
            require_launches(launches, {"affine_prefix": 8},
                             f"gloo rank {r} prefixes (2 a composition)")
        paths["sharded_gloo_prefixes"] = {
            k: [lr[k] for lr in per_rank] for k in per_rank[0]}
        if device.type == "cuda":
            refused = [rep.get("compile_refused") for rep in reports]
            require(len(set(refused)) == 1 and refused[0] is not None
                    and "'gloo'" in refused[0]
                    and "'cpu:gloo,cuda:nccl'" in refused[0],
                    f"compile_time_sharded over {SHARD_RANKS} gloo ranks: "
                    f"refusals {refused}")
            took = [rep["compile_refused_s"] for rep in reports]
            print(f"compile_time_sharded over {SHARD_RANKS} gloo ranks on "
                  f"the card: the same ValueError on every rank, in "
                  f"{max(took):.4f} s at most, before any collective: "
                  f"{refused[0]}")
        print(f"sharded prefixes over {SHARD_RANKS} gloo ranks: each rank's "
              f"K15's over the ranks before it, bitwise (both forms); "
              f"{worst} of a lane's peak from one process over all the rows")
    return paths


def run_torchrun_cli(device):
    """The channelizer CLI under ``torchrun`` (4 gloo ranks on one device,
    ``cuda:0`` on the card, ``--wideband --synthetic``): rank 0's WAVs
    equal the one-process CLI's, byte for byte."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pinned = "cuda:0" if device.type == "cuda" else "cpu"
    args = ["--wideband", "--synthetic", "--seconds", str(SHARD_CLI_SECONDS),
            "--device", pinned]
    with tempfile.TemporaryDirectory() as tmp:
        one = subprocess.run(
            [sys.executable, "-m", "sdr_tpu_torch.apps.channelizer", *args,
             "--out-prefix", os.path.join(tmp, "one")], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=SHARD_TIMEOUT_S)
        require(one.returncode == 0, f"one-process cli: {one.stderr}")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(SHARD_RANKS), "-m",
             "sdr_tpu_torch.apps.channelizer", "--backend", "gloo",
             *args, "--out-prefix",
             os.path.join(tmp, "ranks")], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=SHARD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        print(f"torchrun channelizer cli: rc {run.returncode} "
              f"{run.stdout.strip()} ({wall:.1f} s as a command)")
        require(run.returncode == 0, f"torchrun cli: {run.stderr[-4000:]}")
        require(f"on {SHARD_RANKS} devices" in run.stdout, "torchrun line")
        for c in range(CH_C):
            a = Path(tmp, f"one{c:03d}.wav").read_bytes()
            b = Path(tmp, f"ranks{c:03d}.wav").read_bytes()
            require(a == b, f"torchrun cli WAV {c} differs")
        print(f"torchrun channelizer cli: {CH_C} WAVs equal to the "
              "one-process CLI's")


def run_sharded(seed: int, device, kernels, card: str):
    """The sharded phase: NCCL at world 1 in this process, four gloo ranks
    on the card, and the channelizer CLI under torchrun."""
    t0 = time.perf_counter()
    paths = run_nccl_world1(seed, device, kernels, card)
    paths.update(run_gloo_ranks(seed, device, card))
    run_torchrun_cli(device)
    print(f"sharded phase ran in {time.perf_counter() - t0:.1f} s")
    return paths


LIVE_BLOCKS = 32                      # 16.4 s of air at 1.28 MS/s
LIVE_SPEED = 8                        # the mock radio's pace, x real time
LIVE_ARGS = ["--freq", "90.2M", "--gain", "496", "--ppm", "1"]
LIVE_COMMANDS = [(2, FS_IN), (1, 90_200_000), (5, 1), (3, 1), (4, 496)]
STEREO_ARGS = ["--front", "quantized", "--stereo", "--deemphasis", "75e-6"]
UDP_BLOCK = 65_440                    # the largest multiple of 160 a datagram
UDP_BLOCKS = 64
SCAN_BLOCKS = 8


class MockRadio:
    """A loopback rtl_tcp server for one connection: the 12-byte header
    (``RTL0``, tuner 5 = R820T, 29 gains), the client's five 5-byte
    commands recorded, then ``payload`` at ``speed`` times real time
    (2 bytes a complex sample at 1.28 MS/s; None: as fast as loopback
    takes it), then the end of the stream."""

    def __init__(self, payload: bytes, speed):
        self.payload, self.speed = payload, speed
        self.commands, self.error = [], None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(300)
        self.url = f"rtl_tcp://127.0.0.1:{self._srv.getsockname()[1]}"
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._srv.accept()
            with conn:
                conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
                conn.settimeout(30)
                buf = b""
                while len(buf) < 5 * len(LIVE_COMMANDS):
                    chunk = conn.recv(256)
                    if not chunk:
                        break
                    buf += chunk
                self.commands = [struct.unpack(">BI", buf[i:i + 5])
                                 for i in range(0, len(buf) - 4, 5)]
                conn.settimeout(None)
                rate = None if self.speed is None else 2 * FS_IN * self.speed
                view, step = memoryview(self.payload), 1 << 16
                t0 = time.perf_counter()
                for off in range(0, len(view), step):
                    if rate is not None:
                        time.sleep(max(0.0, t0 + off / rate
                                       - time.perf_counter()))
                    conn.sendall(view[off:off + step])
                conn.shutdown(socket.SHUT_WR)
        except OSError as e:
            self.error = e
        finally:
            self._srv.close()

    def join(self, what: str):
        self._thread.join(timeout=600)
        require(not self._thread.is_alive(), f"{what}: mock radio hung")
        require(self.error is None, f"{what}: mock radio: {self.error}")
        require(self.commands == LIVE_COMMANDS, f"{what}: commands "
                f"{self.commands}, expected {LIVE_COMMANDS}")


def read_wav(path):
    with wave.open(str(path), "rb") as wf:
        return (wf.getframerate(), wf.getnchannels(),
                np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))


def live_command(payload: bytes, extra, out) -> bytes:
    """``python -m sdr_tpu_torch.apps.fm --in rtl_tcp://...`` as a
    command against a mock radio paced at LIVE_SPEED x real time: rc 0,
    the commands, no dropped block.  Returns the WAV's bytes."""
    radio = MockRadio(payload, LIVE_SPEED)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sdr_tpu_torch.apps.fm", "--in", radio.url,
         "--out", str(out), *LIVE_ARGS, *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    what = f"live cli {' '.join(extra) or '(mono)'}"
    require(proc.returncode == 0, f"{what}: rc {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    radio.join(what)
    require("radio dropped" not in proc.stderr,
            f"{what}: {proc.stderr.strip()}")
    print(f"{what} at {LIVE_SPEED}x real time: rc 0, {wall:.2f} s as a "
          f"command ({len(payload) / 2 / FS_IN:.2f} s of air), commands "
          f"{radio.commands}, no dropped block; {proc.stdout.strip()}")
    return Path(out).read_bytes()


def live_in_process(payload: bytes, extra, out, kernels, device):
    """The FM CLI's ``main`` in this process against a mock radio that
    sends as fast as loopback allows, under the port's ``Timer``: its
    launches (those of ``prime``'s eager call, warm-up and capture: the
    live blocks replay the compiled call), the graphs captured (one, in
    ``prime``; a short last group of ``--batched`` runs eagerly) and
    replayed, blocks dropped, and input samples/s against real time
    (a figure, not a check)."""
    import contextlib
    import io as iolib
    from sdr_tpu_torch.apps import fm
    from sdr_tpu_torch.stream import Timer
    from sdr_tpu_torch.utils import graphs
    radio = MockRadio(payload, None)
    err = iolib.StringIO()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    before = (graphs.captures, graphs.replays)
    with contextlib.redirect_stderr(err), Timer(device) as t:
        require(fm.main(["--in", radio.url, "--out", str(out), *LIVE_ARGS,
                         *extra]) == 0, "live main")
    launches = {k.name: k.launches for k in kernels}
    captures = graphs.captures - before[0]
    replays = graphs.replays - before[1]
    require(captures == 1, f"live main {extra}: {captures} graphs captured, "
            "expected 1 (in prime)")
    what = f"live main {' '.join(extra) or '(mono)'}, unpaced"
    radio.join(what)
    _, ch, pcm = read_wav(out)
    blocks = len(pcm) // ch // (STREAM_BLOCK * 3 // 160)
    dropped = err.getvalue().strip() or "radio dropped 0 blocks"
    rate = blocks * STREAM_BLOCK / 2 / t.seconds
    print(f"{what}: {blocks} of {len(payload) // STREAM_BLOCK} blocks in "
          f"{t.seconds:.4f} s (Timer, the pipeline's construction and the "
          f"connection included): {rate:.6e} complex input samples/s, "
          f"{rate / FS_IN:.2f}x real time (1.28e6 S/s); {dropped}; "
          f"graphs captured {captures}, replays {replays}; launches "
          f"{launches}")
    return launches


def check_native(path: Path, payload: bytes, device, wav_file: bytes,
                 tmp: Path):
    """The native loader: its build time, ``--native`` on the CLI (the
    file CLI's WAV), ``repeat=True`` (the file twice over), and UDP
    datagrams of UDP_BLOCK bytes over loopback through ``fm_chain()`` on
    the card, bitwise the same blocks read from a file."""
    from sdr_tpu_torch.apps import fm
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.io import native
    from sdr_tpu_torch.io.files import iq_file_source
    from sdr_tpu_torch.stream import Pipeline

    t0 = time.perf_counter()
    lib = native.build_native(force=True)
    print(f"native loader built with g++ in {time.perf_counter() - t0:.2f} "
          f"s into {lib.relative_to(ROOT)}")
    out = tmp / "native.wav"
    require(fm.main(["--in", str(path), "--out", str(out), "--native"]) == 0,
            "--native")
    require(out.read_bytes() == wav_file, "--native WAV != the file CLI's")
    want = np.frombuffer(payload, np.uint8)
    it = iter(native.native_file_source(path, STREAM_BLOCK, repeat=True))
    got = np.concatenate([next(it) for _ in range(2 * LIVE_BLOCKS)])
    require(np.array_equal(got, np.tile(want, 2)),
            "native_file_source(repeat=True) is not the file twice over")
    print(f"--native: the file CLI's WAV byte for byte; repeat=True: "
          f"{2 * LIVE_BLOCKS} blocks, the file twice over")

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    data = payload[:UDP_BLOCKS * UDP_BLOCK]
    upath = tmp / "udp.u8"
    upath.write_bytes(data)
    pipe = Pipeline(fm_chain(device=device), block_in=UDP_BLOCK,
                    device=device)
    want = list(pipe.run(iq_file_source(upath, UDP_BLOCK)))
    # a ring as deep as the burst: the check is for datagrams lost on the
    # way, not for a consumer outrun
    src = native.native_udp_source(port, UDP_BLOCK, n_buffers=UDP_BLOCKS,
                                   timeout=5.0)

    def send():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        time.sleep(0.5)
        for i in range(UDP_BLOCKS):
            s.sendto(data[i * UDP_BLOCK:(i + 1) * UDP_BLOCK],
                     ("127.0.0.1", port))
            time.sleep(0.002)
        s.close()

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    ys = list(pipe.run(src))
    sender.join(timeout=60)
    require(len(ys) == UDP_BLOCKS, f"native UDP: {UDP_BLOCKS - len(ys)} of "
            f"{UDP_BLOCKS} datagrams missing (dropped {src.dropped})")
    require(all(torch.equal(a, b) for a, b in zip(ys, want)),
            "native UDP blocks through fm_chain() != the file's")
    print(f"native UDP: {UDP_BLOCKS} datagrams of {UDP_BLOCK} bytes, every "
          f"one through Pipeline(fm_chain()) on the card, bitwise the same "
          f"blocks from a file; dropped {src.dropped}")


def check_surface(raw, device, kernels, tmp: Path, card: str):
    """``Pipeline.scan`` over [SCAN_BLOCKS, STREAM_BLOCK] (bitwise
    ``Pipeline.run`` and the eager run, replays of the step ``run``
    captured and no launch from Python; the eager run's launches),
    ``Timer`` and ``timed`` against the
    CUDA-event time of a block-parallel call queued behind a device-side
    sleep (they wait for the card), and ``profile`` writing a trace."""
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline, Timer
    from sdr_tpu_torch.utils import profile, timed, trace

    ops = fm_chain(device=device)
    pipe = Pipeline(ops, block_in=STREAM_BLOCK, device=device)
    x = raw[:SCAN_BLOCKS * STREAM_BLOCK].view(SCAN_BLOCKS, STREAM_BLOCK)
    from sdr_tpu_torch.utils import graphs
    run = torch.stack(list(pipe.run(x.unbind(0))))
    before = (graphs.captures, graphs.replays)
    (_, ys), scan_launches = counted(lambda: pipe.scan(x), kernels)
    require(torch.equal(ys, run), "Pipeline.scan != Pipeline.run")
    require((graphs.captures - before[0], graphs.replays - before[1])
            == (0, SCAN_BLOCKS) and not any(scan_launches.values()),
            f"Pipeline.scan: not {SCAN_BLOCKS} replays of run's capture "
            f"(launches {scan_launches})")
    eager, launches = counted(lambda: eager_stream(pipe, x.unbind(0)),
                              kernels)
    require(torch.equal(ys, torch.stack(eager)),
            "Pipeline.scan != the eager run")
    require_launches(launches, {"u8_front_demod": SCAN_BLOCKS,
                                "resample": SCAN_BLOCKS,
                                "fir": SCAN_BLOCKS}, "eager scan")
    print(f"Pipeline.scan over {list(x.shape)}: bitwise Pipeline.run and "
          f"the eager run, ys {list(ys.shape)}, {SCAN_BLOCKS} replays of the "
          f"step run captured, no launch from Python; the eager run's "
          f"launches {launches}")

    def queued():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        run_time_batched(ops, raw, ROWS, device=device)
        b.record()
        return a, b

    run_time_batched(ops, raw, ROWS, device=device)                # warm-up
    torch.cuda.synchronize()
    with Timer(device) as t:
        a, b = queued()
    ev = a.elapsed_time(b)
    require(t.seconds * 1e3 >= ev, f"Timer {t.seconds * 1e3} ms < the "
            f"call's {ev} ms of device time: it did not wait")
    lines = []
    torch.cuda.synchronize()
    with timed("queued call", sink=lines.append, device=device):
        a2, b2 = queued()
    ev2 = a2.elapsed_time(b2)
    got = float(lines[0].split(": ")[1].rstrip("s")) * 1e3
    # timed prints 0.1 ms steps: allow its rounding, half a step
    require(got >= ev2 - 0.05, f"timed {got} ms < the call's {ev2} ms")
    print(f"Timer {t.seconds * 1e3:.3f} ms >= {ev:.3f} ms and timed "
          f"{got:.3f} ms >= {ev2:.3f} ms of CUDA-event time of a "
          f"block-parallel call behind a device-side sleep: both wait for "
          f"the card; {card}")

    logdir = tmp / "profile"
    with profile(logdir, device=device):
        with trace("fm_block_parallel"):
            run_time_batched(ops, raw, ROWS, device=device)
        torch.cuda.synchronize()
    traces = list(logdir.iterdir())
    require(len(traces) == 1 and traces[0].stat().st_size > 0,
            f"profile wrote {traces}")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel")
    require(any(e.get("name") == "fm_block_parallel" for e in events),
            "profile: the trace region is missing")
    print(f"profile: {traces[0].name}, {traces[0].stat().st_size} bytes, "
          f"{len(events)} events, {kernels_seen} of them device kernels")
    return launches


def run_live(seed: int, device, kernels, card: str):
    """Phase 13: the FM CLI on a live (mock) rtl_tcp radio, the native
    loader, ``Pipeline.scan``, ``Timer``, ``timed`` and ``profile``."""
    from sdr_tpu_torch.apps import fm

    t0 = time.perf_counter()
    paths = {}
    mono = synth_broadcast(LIVE_BLOCKS * STREAM_BLOCK, seed, device)
    stereo = synth_stereo_broadcast(LIVE_BLOCKS * STREAM_BLOCK, seed, device)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        for name, raw, extra in (("mono", mono, []),
                                 ("stereo", stereo, STEREO_ARGS)):
            payload = raw.cpu().numpy().tobytes()
            path = tmp / f"{name}.u8"
            path.write_bytes(payload)
            wav = tmp / f"{name}_file.wav"
            require(fm.main(["--in", str(path), "--out", str(wav),
                             *extra]) == 0, f"file cli {name}")
            wav_file = wav.read_bytes()
            live = live_command(payload, extra, tmp / f"{name}_live.wav")
            require(live == wav_file, f"live {name} WAV != the file CLI's")
            rate, ch, pcm = read_wav(tmp / f"{name}_live.wav")
            require(rate == 48_000 and len(pcm) == LIVE_BLOCKS * ch
                    * (STREAM_BLOCK * 3 // 160), f"live {name} WAV shape")
            if name == "mono":
                hz = tone_hz(pcm.astype(np.float64))
                require(abs(hz - 1000) < 5, f"live mono tone at {hz} Hz")
                batched = live_command(payload, ["--batched", "8"],
                                       tmp / "batched_live.wav")
                require(batched == live,
                        "live --batched 8 WAV != the streamed live WAV")
                print(f"live mono: the file CLI's WAV byte for byte, tone "
                      f"{hz:.2f} Hz; --batched 8 the same bytes")
                paths["live_mono"] = live_in_process(
                    payload, [], tmp / "u_mono.wav", kernels, device)
                paths["live_batched"] = live_in_process(
                    payload, ["--batched", "8"], tmp / "u_batched.wav",
                    kernels, device)
                check_native(path, payload, device, wav_file, tmp)
            else:
                pcm = pcm.reshape(-1, 2).astype(np.float64)
                sep = check_separation(pcm[4000:, 0], pcm[4000:, 1],
                                       "live stereo")
                print(f"live stereo: the file CLI's WAV byte for byte, "
                      f"separation L {sep[0]:.1f}x R {sep[1]:.1f}x")
                launches = live_in_process(
                    payload, extra, tmp / "u_stereo.wav", kernels, device)
                require(launches["fm_demod"] == launches["u8_front"] > 0,
                        f"live stereo: K11 not launched once a block, as "
                        f"K4 is ({launches})")
                require(launches["iir"] == launches["u8_front"],
                        f"live stereo: K13 not launched once a block, as "
                        f"K4 is ({launches})")
                require(launches["fir"] == launches["u8_front"] and
                        launches["stereo_decode"] == 2 * launches["u8_front"],
                        f"live stereo: not K3 once and K14 twice a block "
                        f"({launches})")
                paths["live_stereo"] = launches
        paths["scan"] = check_surface(mono, device, kernels, tmp, card)
    print(f"live phase ran in {time.perf_counter() - t0:.1f} s")
    return paths


COMPILED_STREAM_BLOCKS = 8             # blocks of the streamed jit_step check


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes (any dtype, complex as its two parts)."""
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.reshape(-1).contiguous().view(torch.uint8)


def same_tree(a, b) -> bool:
    """Two carry trees (or outputs) equal bit for bit, leaf by leaf."""
    from sdr_tpu_torch.stream.pipeline import flatten_carries
    la, lb = flatten_carries(a), flatten_carries(b)
    return len(la) == len(lb) and all(
        u.shape == v.shape and u.dtype == v.dtype
        and torch.equal(byte_view(u), byte_view(v)) for u, v in zip(la, lb))


def eager_stream(pipe, blocks, carries=None) -> list:
    """The streamed run op by op (``Pipeline.apply`` a block, the carries
    threaded): the eager form the compiled ``Pipeline.run`` must equal,
    and the form whose launches count once a block."""
    cs = pipe.init() if carries is None else carries
    ys = []
    for blk in blocks:
        cs, y = pipe.apply(cs, blk.contiguous())
        ys.append(y)
    return ys


def compiled_run(pipe, blocks: list, streamed, what: str, items: int,
                 dim: int = -1,
                 unit: str = "complex input samples/s") -> None:
    """The streamed run as a user drives it, ``Pipeline.run`` (the first
    block eager, the step captured at the second and replayed after),
    over ``blocks``: bitwise ``streamed``, the eager stream op by op
    joined along ``dim``; its rate in ``items`` (input samples) a second;
    its graphs freed after."""
    from sdr_tpu_torch.utils import graphs
    before = (graphs.captures, graphs.replays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(pipe.run(blocks))
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    n = len(got)
    counts = (graphs.captures - before[0], graphs.replays - before[1])
    require(counts == (1, n - 1), f"{what} Pipeline.run: captures and "
            f"replays {counts}, expected (1, {n - 1})")
    require(same_bits(torch.cat(got, dim=dim), streamed),
            f"{what} Pipeline.run (compiled) != the eager stream")
    print(f"{what} Pipeline.run (compiled: 1 block eager, 1 capture, "
          f"{n - 1} replays): bitwise the eager stream op by op; "
          f"{items / t:.6e} {unit}")
    pipe.clear_compiled()


def compiled_inputs(name: str, seed: int, device):
    """(ops, recording, blocks a call) of a block-parallel chain of phases
    2-10, the recording made from ``seed``."""
    from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                           fm_chain, waterfall_chain)
    from sdr_tpu_torch.apps.channelizer import synthesize
    u8 = ROWS * ROW_BYTES
    if name == "mono":
        return fm_chain(device=device), synth_broadcast(u8, seed, device), ROWS
    if name in ("stereo", "stereo_fused"):
        return (stereo_ops(name == "stereo_fused", device),
                synth_stereo_broadcast(u8, seed, device), ROWS)
    if name == "exact":
        return (fm_chain(front="exact", device=device),
                synth_broadcast(u8, seed, device), ROWS)
    if name in ("am", "am_approx"):
        ops = am_chain(agc_approx=1, device=device) if name == "am_approx" \
            else am_chain(device=device)
        return ops, synth_am(u8, seed, device), ROWS
    if name in ("waterfall", "waterfall_complex"):
        return (waterfall_chain(planar=name == "waterfall", device=device),
                synth_broadcast(u8, seed, device), ROWS)
    if name == "channelizer_wideband":
        return (channelizer_chain(CH_C, wideband=True, device=device),
                synth_wideband_bank(ROWS * CH_BLOCK, seed, device), ROWS)
    g = torch.Generator(device=device).manual_seed(seed)
    x = synthesize(CH_C, NB_SAMPLES, FS_IN, device)
    x += 0.01 * torch.randn(x.shape, generator=g, dtype=x.dtype,
                            device=device)
    return channelizer_chain(CH_C, device=device), x, NB_BLOCKS


COMPILED_CHAINS = ("mono", "stereo", "stereo_fused", "exact", "am",
                   "am_approx", "waterfall", "waterfall_complex",
                   "channelizer_wideband", "channelizer")


def footprint(fn) -> int:
    """Device bytes one call of ``fn`` allocates at its peak beyond what
    was allocated before it (its intermediates and output)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def compiled_chain(name: str, seed: int, device, card: str) -> dict:
    """One block-parallel chain eager and compiled: each replay bitwise
    the eager call on the recording, on a second recording copied in, and
    with seeded carries threaded through the call's static buffers; one
    replay with ``set_sync_debug_mode('error')``; both spans and both
    ``queued_split``s in turns (eager, compiled, compiled, eager); the
    device bytes an eager call and a replay allocate and the bytes the
    graph's pool holds; an on-card recording's copy into the input; the
    call built with tracing on, its stages timed inside the graph."""
    from sdr_tpu_torch.parallel.sharded import (compile_time_batched,
                                                run_time_batched)
    from sdr_tpu_torch.profile_fm import queued_split, span_ms, stage_split
    from sdr_tpu_torch.stream.pipeline import flatten_carries
    from sdr_tpu_torch.utils import graphs, profiling

    ops, raw, nb = compiled_inputs(name, seed, device)
    _, raw2, _ = compiled_inputs(name, seed + 1, device)
    eager = run_time_batched(ops, raw, nb)
    eager2 = run_time_batched(ops, raw2, nb)
    torch.cuda.synchronize()
    eager_bytes = footprint(lambda: run_time_batched(ops, raw, nb))
    # the call captures on its input tensor, which the second recording
    # is copied into
    t0 = time.perf_counter()
    call = compile_time_batched(ops, raw.clone(), nb)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    y = call()
    require(same_bits(y, eager), f"compiled {name}: replay != eager call")
    y2 = call(raw2)
    require(call.input_copies == 1, f"compiled {name}: input copies "
            f"{call.input_copies}, expected 1")
    require(same_bits(y2, eager2),
            f"compiled {name}: replay on the second recording != eager")
    require(y2.data_ptr() == y.data_ptr(), f"compiled {name}: the output "
            "is not the call's own buffer")
    call(raw)
    require(call.input_copies == 2, f"compiled {name}: input copies "
            f"{call.input_copies}, expected 2")
    # one replay that must not wait for the card (the input on the card)
    y = sync_free(call)
    require(same_bits(y, eager), f"compiled {name}: sync-free replay")
    # the device kernels one replay runs, by the profiler (a replay counts
    # no launch from Python): the eager call's, name for name and count
    # for count (memsets and copies too); the wideband bank's K7 + DFT
    # and no cuFFT kernel
    eager_kernels = device_kernels(lambda: run_time_batched(ops, raw, nb), "")
    replay_kernels = device_kernels(call, "")
    require(replay_kernels == eager_kernels,
            f"compiled {name}: the replay's kernels {replay_kernels} != "
            f"the eager call's {eager_kernels}")
    if name == "channelizer_wideband":
        require(any("branch_dft_kernel" in k for k in replay_kernels)
                and not any("fft" in k.lower() for k in replay_kernels),
                f"compiled {name}: the replay's kernels {replay_kernels}")

    # seeded carries: the state after the second recording, threaded
    # through the call's buffers (written back inside the graph)
    cs, _ = run_time_batched(ops, raw2, nb, return_carries=True)
    ce, ye = run_time_batched(ops, raw, nb, carries=cs, return_carries=True)
    withc = compile_time_batched(ops, raw, nb, carries=cs,
                                 return_carries=True)
    cg, yg = withc()
    require(same_bits(yg, ye) and same_tree(cg, ce),
            f"compiled {name}: replay with carries != eager (output "
            f"{same_bits(yg, ye)}, carries {same_tree(cg, ce)})")
    ce2, ye2 = run_time_batched(ops, raw, nb, carries=ce,
                                return_carries=True)
    cg2, yg2 = withc(carries=cg)
    require(withc.carry_copies == len(flatten_carries(cs)),
            f"compiled {name}: carries copied {withc.carry_copies} times")
    require(same_bits(yg2, ye2) and same_tree(cg2, ce2),
            f"compiled {name}: the threaded second call != eager")
    pool = graphs.pool_bytes(call.pool)
    del withc, cg, cg2, yg, yg2, ce, ce2, ye, ye2, cs
    torch.cuda.empty_cache()
    # a replay allocates nothing: the graph's intermediates and output
    # live in its pool for as long as the call does
    replay_bytes = footprint(call)

    def eager_call():
        return run_time_batched(ops, raw, nb)

    turns = {}
    for label, fn in (("eager", eager_call), ("compiled", call),
                      ("compiled", call), ("eager", eager_call)):
        turns.setdefault(label, []).append(
            dict(span_ms=span_ms(fn), **queued_split(fn)))
    # a recording already on the card copied into the call's input (what
    # process(parallel_blocks=) pays a segment on the card)
    copy_in = queued_split(lambda: call.x.copy_(raw2))["device_ms"]
    del call
    # built with tracing on: the same output and device kernels (each
    # stage boundary is an event-record node, no kernel), and the stages'
    # device ms inside the graph summing to the call's span between
    # events outside it, within 3 %
    with profiling.tracing():
        traced = compile_time_batched(ops, raw, nb)
    require(same_bits(traced(), eager),
            f"compiled {name}: the replay built traced != the eager call")
    traced_kernels = device_kernels(traced, "")
    require(traced_kernels == replay_kernels, f"compiled {name}: built "
            f"traced, the replay's kernels {traced_kernels} != "
            f"{replay_kernels}")
    staged = stage_split(traced)
    require(abs(staged["sum_share"] - 1) <= 0.03, f"compiled {name}: the "
            f"stages sum to {staged['sum_share']} of the call's span")
    del traced
    torch.cuda.empty_cache()
    rec = {"chain": name, "blocks": nb, "input": list(raw.shape),
           "capture_ms": capture_ms, "eager_call_bytes": eager_bytes,
           "replay_bytes": replay_bytes, "pool_bytes": pool,
           "copy_in_device_ms": copy_in, "kernels": replay_kernels,
           "stages": staged, "card": card}
    for label, runs in turns.items():
        for i, r in enumerate(runs):
            for k, v in r.items():
                rec[f"{label}{i + 1}_{k}"] = v
    e = [r["device_ms"] for r in turns["eager"]]
    c = [r["device_ms"] for r in turns["compiled"]]
    print(f"compiled {name}: bitwise the eager call on two recordings and "
          f"with threaded carries; a replay's device kernels by the "
          f"profiler, the eager call's: {replay_kernels}; "
          f"capture {capture_ms:.1f} ms; span eager "
          f"{[r['span_ms'] for r in turns['eager']]} ms, compiled "
          f"{[r['span_ms'] for r in turns['compiled']]} ms; device eager "
          f"{e}, compiled {c}; enqueue eager "
          f"{[r['enqueue_ms'] for r in turns['eager']]}, compiled "
          f"{[r['enqueue_ms'] for r in turns['compiled']]} ms; device "
          f"bytes an eager call allocates {eager_bytes}, a replay "
          f"{replay_bytes}, the graph's pool holds {pool}; the input copied "
          f"in on the card {copy_in} ms; built traced, the same kernels "
          f"and its stages summing to {staged['sum_share']:.4f} of the "
          f"call's span: {staged['stage_ms']}; {card}")
    return rec


def compiled_stream(name: str, seed: int, device, card: str) -> dict:
    """The streamed compiled step (``Pipeline.run``) over
    COMPILED_STREAM_BLOCKS blocks bitwise the eager run op by op (the
    blocks yielded earlier unchanged by later replays; ``StereoDecode``'s
    history written back inside the graph), and one block's
    ``queued_split`` eager and compiled."""
    from sdr_tpu_torch.profile_fm import queued_split
    from sdr_tpu_torch.stream import Pipeline
    from sdr_tpu_torch.utils import graphs

    ops, raw, _ = compiled_inputs(name, seed, device)
    blk = AM_BLOCK if name == "am" else STREAM_BLOCK
    blocks = [raw[i * blk:(i + 1) * blk]
              for i in range(COMPILED_STREAM_BLOCKS)]
    pipe = Pipeline(ops, block_in=blk, device=device)
    want = eager_stream(pipe, blocks)
    got = list(pipe.run(blocks))
    require(all(same_bits(a, b) for a, b in zip(got, want)),
            f"compiled {name}: streamed jit_step != the eager run")
    step = pipe.jit_step()
    x = blocks[1].contiguous()
    box = {"cs": step(pipe.init(), blocks[0])[0],
           "ce": pipe.apply(pipe.init(), blocks[0].contiguous())[0]}

    def compiled():
        box["cs"], y = step(box["cs"], x)
        return y

    def eager():
        box["ce"], y = pipe.apply(box["ce"], x)
        return y

    e1, c1, c2, e2 = (queued_split(f) for f in (eager, compiled, compiled,
                                                 eager))
    print(f"compiled {name} streamed over {COMPILED_STREAM_BLOCKS} blocks "
          f"of {blk}: bitwise the eager run; one block: device eager "
          f"{e1['device_ms']}, {e2['device_ms']} ms, compiled "
          f"{c1['device_ms']}, {c2['device_ms']} ms; enqueue eager "
          f"{e1['enqueue_ms']}, {e2['enqueue_ms']} ms, compiled "
          f"{c1['enqueue_ms']}, {c2['enqueue_ms']} ms; {card}")
    # dropping the pipeline (its ops and steps) frees its graphs and their
    # pool at once: no reference cycle waits for the cyclic collector
    pool = step.pool
    held = graphs.pool_bytes(pool)
    gc.disable()
    try:
        del pipe, step, box, compiled, eager, ops
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left = graphs.pool_bytes(pool)
    finally:
        gc.enable()
    require(held > 0 and left == 0, f"compiled {name} streamed: the "
            f"pool held {held} bytes, {left} after the pipeline was dropped")
    print(f"compiled {name} streamed: its pool of {held} bytes freed when "
          f"the pipeline was dropped (the cyclic collector off)")
    return {"chain": f"{name}_streamed", "block": blk,
            "eager": [e1, e2], "compiled": [c1, c2], "pool_bytes": held,
            "card": card}


def check_capture_refuses_sync(device) -> str:
    """A chain with an op that waits for the card (a ``Map`` calling
    ``.item()``) cannot be captured: its compiled step raises, with no
    eager run in its place, and the card runs the next call."""
    from sdr_tpu_torch.stream import Map, Pipeline, Scale
    pipe = Pipeline([Scale(2.0, device=device),
                     Map(lambda x: x * float(x.max().item()),
                         device=device)],
                    block_in=4096, in_dtype=torch.float32, device=device)
    x = torch.ones(4096, device=device)
    try:
        pipe.jit_step()(pipe.init(), x)
    except Exception as e:          # the capture's own error, as it is
        err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    else:
        raise RuntimeError("check failed: a capture that syncs with the "
                           "host did not raise")
    torch.cuda.synchronize()
    y = pipe.apply(pipe.init(), x)[1]
    require(bool((y == 4.0).all()), "the card after a refused capture")
    print(f"a Map calling .item() refused at capture: {err}")
    return err


def run_compiled(seed: int, device, card: str) -> list:
    """Phase 15: the compiled calls (``compile_time_batched``,
    ``Pipeline.jit_step``) on every block-parallel chain of phases 2-10
    and the streamed mono, stereo and AM chains; each chain's graphs
    freed before the next."""
    t0 = time.perf_counter()
    recs = [compiled_chain(name, seed, device, card)
            for name in COMPILED_CHAINS]
    recs += [compiled_stream(name, seed, device, card)
             for name in ("mono", "stereo", "am")]
    check_capture_refuses_sync(device)
    print(json.dumps({"compiled": recs}))
    print(f"compiled phase ran in {time.perf_counter() - t0:.1f} s")
    return recs


def print_rows(rows, card: str) -> None:
    for r in rows:
        print(f"{r['name']}: max_abs_err {r['max_abs_err']}, {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']}), bound_fraction "
              f"{r['bound_fraction']} on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # a gloo rank of the phase
    ap.add_argument("--shard-dir", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-device", type=torch.device, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--s1-tree", type=Path, default=None,
                    help="time only the NCCL world-1 calls of the port in "
                         "this checkout (e.g. the parent commit's)")
    ap.add_argument("--s1-backend", default="cpu:gloo,cuda:nccl",
                    help="the process group's backend for --s1-tree")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.shard_rank is not None:
        return shard_worker(args.shard_rank, args.shard_dir,
                            args.shard_device)
    if args.s1_tree is not None:
        return compare_s1(args.s1_tree, args.s1_backend, args.seed)

    from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                           fm_chain, waterfall_chain)
    from sdr_tpu_torch.apps.channelizer import synthesize
    from sdr_tpu_torch import measure_ceilings
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.kernels._build import _nvcc, build_all
    from sdr_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    card = card_line()
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}; torch {torch.__version__}; "
          f"torch.version.cuda {torch.version.cuda}; nvcc: {nvcc[-1]}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    build_all(KERNELS + (measure_ceilings.KERNEL,))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    device = torch.device("cuda")
    # the card's ceilings, before any phase reads them
    CHAIN_TIMINGS.clear()
    t0 = time.perf_counter()
    probe = measure_ceilings.measure(device)
    CEILINGS["measured"] = measure_ceilings.as_ceilings(probe)
    print(f"ceilings measured in {time.perf_counter() - t0:.1f} s on {card}: "
          f"{json.dumps(probe)}")
    # the mono path: fm_chain(), K1 -> K2 -> K3
    raw = synth_broadcast(ROWS * ROW_BYTES, args.seed, device)
    ops = fm_chain(device=device)
    rows = check_kernels(raw, ops)
    print_rows(rows, card)
    mono = run_chain(raw, ops, KERNELS)
    run_cli(raw, stereo=False)
    del raw, ops

    # the stereo + de-emphasis path on the quantized front: K4, K3, K2 -> K3
    # (and K5 with the fused back half)
    raw = synth_stereo_broadcast(ROWS * ROW_BYTES, args.seed, device)
    ops = fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                   device=device)
    srows = check_stereo_kernels(raw, ops, args.seed)
    print_rows(srows, card)
    stereo, fused = run_stereo_chain(raw, ops, KERNELS)
    run_cli(raw, stereo=True)
    del raw, ops

    # the exact mono path, the complex f32 front: K10, K3 at f = 8, K11,
    # K2 -> K3
    raw = synth_broadcast(ROWS * ROW_BYTES, args.seed, device)
    ops = fm_chain(front="exact", device=device)
    erows = check_iq_convert_kernel(raw, args.seed)
    _, xc = ops[0].apply((), raw.view(ROWS, ROW_BYTES))
    erows.append(check_complex_decimator_kernel(
        "K3 fir complex (exact front decimator, [32, 5,242,880] rows, "
        "f = 8, 51 taps)", ops[1], xc))
    t0 = time.perf_counter()
    cfir_count = complex_fir_geometries(device, args.seed)
    check_complex_fir_limits(device, args.seed)
    print(f"K3's complex form: bitwise its plain version and the planar "
          f"route at {cfir_count} extra geometries "
          f"({time.perf_counter() - t0:.1f} s)")
    _, xd = ops[1].apply(ops[1].shard_carry(xc), xc)
    del xc
    erows += check_fm_demod_kernel(
        "K11 fm_demod (exact complex [32, 655,360])", ops[2], xd, args.seed)
    del xd
    print_rows(erows, card)
    exact = run_exact_chain(raw, ops, KERNELS)
    run_cli(raw, stereo=False, front="exact")
    del raw, ops

    # the AM path: K8 (the planar mix), K3 at f = 16 over the mixed planes
    raw = synth_am(ROWS * ROW_BYTES, args.seed, device)
    ops = am_chain(device=device)
    _, xp = ops[0].apply((), raw.view(ROWS, ROW_BYTES))
    arows = [check_mix_kernel(ops[1], xp, args.seed)]
    _, mixed = ops[1].apply(ops[1].shard_carry(xp), xp)
    del xp
    arows.append(check_decimator_kernel(
        "K3 fir (AM channel filter, planar [32, 2], f = 16, 64 taps)",
        ops[2], mixed))
    # K12 over the channel filter's planes, K15 as Agc.shard_carry
    # launches it, K16 over the gained planes, K13 and K15 as the
    # DcBlocker runs over the envelope
    _, xf = ops[2].apply(ops[2].shard_carry(mixed), mixed)
    del mixed
    arows += check_agc_linear_kernel(ops[3], xf, args.seed)
    arows += check_affine_prefix_kernel(
        [("AM Agc", lambda: ops[3].shard_carry(xf))], args.seed)
    _, xd = ops[3].apply(ops[3].shard_carry(xf), xf)
    del xf
    arows.append(check_am_envelope_kernel(xd, args.seed))
    _, xd = ops[4].apply((), xd)
    arows.append(check_iir_kernel("K13 iir (AM DcBlocker, [32, 327,680])",
                                  ops[5], xd, args.seed))
    arows += check_affine_prefix_kernel(
        [("AM DcBlocker", lambda: ops[5].shard_carry(xd))], args.seed)
    del xd
    iir_count = iir_geometries(device, args.seed)
    t0 = time.perf_counter()
    prefix_count = affine_prefix_geometries(device, args.seed)
    for r in srows + arows:
        if r["kernel"] == "iir":
            r["geometries"] = iir_count
        if r["kernel"] == "affine_prefix":
            r["geometries"] = prefix_count
    print(f"K13 iir: within 1e-5 of each row's peak of its plain version "
          f"at {iir_count} extra geometries")
    print(f"K15 affine_prefix: bitwise its plain version at {prefix_count} "
          f"extra geometries, 5 launches each "
          f"({time.perf_counter() - t0:.1f} s)")
    print_rows(arows, card)
    am = run_am_chain(raw, ops, KERNELS)
    run_am_cli(raw)

    # the AM path with the sequential AGC: the complex Mix on K8, K3's
    # complex form at f = 16, K6 (sweep, apply)
    ops = am_chain(agc_approx=1, device=device)
    _, xc = ops[0].apply((), raw.view(ROWS, ROW_BYTES))
    qrows = [check_mix_complex_kernel(ops[1], xc, args.seed)]
    _, xc = ops[1].apply(ops[1].shard_carry(xc), xc)
    qrows += [check_complex_decimator_kernel(
        "K3 fir complex (AM sequential channel filter, [32, 5,242,880] "
        "rows, f = 16, 64 taps)", ops[2], xc)]
    _, xc = ops[2].apply(ops[2].shard_carry(xc), xc)
    qrows.append(check_agc_kernel(ops[3], xc))
    del xc
    print_rows(qrows, card)
    am_approx = run_am_approx(raw, ops, KERNELS)
    del raw, ops

    # the transmitter: K2 at 10/3 and 8/1, its CLI, the round trip
    fm_tx_path, trows = run_fm_tx(KERNELS, device)
    print_rows(trows, card)

    # the waterfall: planar convert, FftStream on K9
    raw = synth_broadcast(ROWS * ROW_BYTES, args.seed, device)
    ops = waterfall_chain(device=device)
    _, xp = ops[0].apply((), raw.view(ROWS, ROW_BYTES))
    wrows = [check_fft_stream_kernel(ops[1], xp, args.seed)]
    del xp
    print_rows(wrows, card)
    waterfall = run_waterfall(raw, ops, KERNELS)
    del raw, ops

    # the wideband channel bank: the filterbank on K7, K3 at f = 8, K2, K3
    x = synth_wideband_bank(ROWS * CH_BLOCK, args.seed, device)
    ops = channelizer_chain(CH_C, wideband=True, device=device)
    crows = check_bank_kernels(x, ops, args.seed)
    print_rows(crows, card)
    wideband, wideband_functions = run_channelizer_wideband(x, ops,
                                                            KERNELS)
    del x, ops

    # the narrowband bank: [64, N] basebands, the CLI's synthetic formula
    x = synthesize(CH_C, NB_SAMPLES, FS_IN, device)
    ops = channelizer_chain(CH_C, device=device)
    nrows = check_narrowband_kernels(x, ops, args.seed)
    print_rows(nrows, card)
    narrowband = run_channelizer_narrowband(x, ops, KERNELS)
    del x, ops
    run_channelizer_cli()

    # the roofline of every chain timed above; no new timed call
    t0 = time.perf_counter()
    roofline = run_roofline(card)
    print(f"roofline phase in {time.perf_counter() - t0:.1f} s")

    # the compiled calls: every block-parallel chain of phases 2-10 as a
    # CUDA graph, the streamed step on mono, stereo and AM
    run_compiled(args.seed, device, card)

    # the sharded paths: NCCL at world 1, four gloo ranks sharing the
    # card, the channelizer CLI under torchrun
    sharded = run_sharded(args.seed, device, KERNELS, card)

    # the live path: the FM CLI on a mock rtl_tcp radio, the native
    # loader, Pipeline.scan, Timer, timed and profile
    live = run_live(args.seed, device, KERNELS, card)

    # launches: each row's on the path its shapes come from, and on every
    # path, each path's counts taken around one call of its own
    paths = {"mono": mono, "stereo": stereo, "stereo_fused": fused,
             "mono_exact": exact, "am": am, "am_approx": am_approx,
             "fm_tx": fm_tx_path, "waterfall": waterfall,
             "channelizer_wideband": wideband, "channelizer": narrowband,
             **sharded, **live}
    for r in rows:
        r["launches"] = mono[r["kernel"]]
    for r in srows:
        r["launches"] = (fused if r["kernel"] == "backhalf"
                         else stereo)[r["kernel"]]
    for r in erows:
        r["launches"] = exact[r["kernel"]]
    for r in arows:
        r["launches"] = am[r["kernel"]]
    for r in crows:
        r["launches"] = (wideband_functions.get(r["function"], 0)
                         if "function" in r else wideband[r["kernel"]])
    for r in nrows:
        r["launches"] = narrowband[r["kernel"]]
    for r in qrows:
        r["launches"] = am_approx[r["kernel"]]
    for r in trows:
        r["launches"] = fm_tx_path[r["kernel"]]
    for r in wrows:
        r["launches"] = waterfall[r["kernel"]]
    rows += srows + erows + arows + qrows + trows + wrows + crows + nrows
    for r in rows:
        if r.get("layout"):
            r["geometries"] = cfir_count
    for r in rows:
        # by source: K7 and K7 + DFT share channelize.cu's count
        r["launches_by_path"] = {p: c[r["kernel"]] for p, c in paths.items()}
    print(f"chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s, "
          "the kernels' build included")
    print(json.dumps({"roofline": roofline, "ceilings": probe}))
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
