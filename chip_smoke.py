#!/usr/bin/env python3
"""Drive the PyTorch port (`ttscube_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as it ends:
  device      the card (nvidia-smi name and power limit) and the CUDA version
  build       the kernel sources ttscube_tpu_torch/csrc/{fused_tail_stage,
              fused_tail_stage_grad,fused_mrf_stage,narrow_conv}.cu, by plain nvcc, in
              parallel, with each one's ptxas register and spill line
  kernel      B1 (the fused tail stage) against its plain PyTorch version at serving
              shapes, fp32 (TF32 off) and bf16 (limits below), in fp32 at the training
              shape (B = 16, T_in = 3,000), and at serve_batch's shapes (B = 128, 512
              frames; B = 256, one window of 320 frames); two launches must be bit-equal
  kernel_mrf  B3 (a whole MRF stage) likewise, at the serving shapes of v1's stages 0
              and 1, a ragged shape and C = 32, with a witness on the CPU; two launches
              must be bit-equal
  kernel_mid  B1-mid (a whole middle stage: upsample and MRF) likewise, at stage 2
  kernel_grad B2 (the tail stage's backward) against autograd through the plain
              version, fp32 (TF32 off): at the training shape for four seeds, and at a
              ragged one on all blocks and on 3; two launches must give bit-equal grads
  kernel_resblock  B4 (one ResBlock1) against its plain version at v1's four stages
              and a ragged shape, fp32 (TF32 off) and bf16, with a witness on the CPU; two
              launches bit-equal
  kernel_narrow_conv  B5 (a bias-free narrow conv) against its plain version, fp32
              (TF32 off, with a TF32 control) and bf16 operands, with a witness on the
              CPU; two launches bit-equal
  warmup      TTSCube at the full Cubegan v1 width from seeded random weights runs
              TTSCube.warmup (B1 once per frame bucket and text length); the first
              request after it, beside the same request in the steady state
  serve       that TTSCube answers three requests; the B1 launch counter must rise by one
              per request; one more request in fp32 (TF32 off) must match the same model
              run on the CPU
  serve_wide  the same with every generator stage fused (fuse_channels 256, 128, 64, 32):
              per request B3 launches twice, B1-mid and B1 once; an fp32 request (TF32
              off) must match the CPU; in a bf16 request each fused stage, fed what the
              CPU's run of that request gave it, must meet the bf16 limits against the
              CPU's stage
  serve_batch bench.py's serving configuration through Cubegan.infer: 128 items of 64
              characters at 512 frames (B1 once per call), then 256 items in windows of
              256 frames (B1 once per window): ms per batch, audio seconds per wall
              second, the busy share; chunked against whole synthesis at 4 items, fp32
              within 5e-5, bf16 by the floor rule, with the fused tail and with every
              stage fused (B3 and B1-mid then meet the window edges)
  train       train_step at the full v1 width (fp32, fused_tail_train) on a batch of 16
              utterances built by CubeganCollate, five steps: finite losses, every
              partition moves, B1 and B2 launch once per step
  train_check one step on the card (TF32 off) against the same step on the CPU
  train_bf16  the train phase's batch with bf16 convs in the generator and the
              discriminators (no fused tail), five steps: median beside the fp32 phase's,
              busy share, every parameter and moment still fp32; one step on the card
              against the same bf16 step on the CPU, losses by the floor rule (the
              floor: the card's fp32 step against its bf16 step; the witness: the CPU
              summing its bf16 convs in fp64), parameters within 2 lr; each kind of conv
              of the step alone, card against CPU, by the floor rule
  trainer     the port's trainer CLI (python -m ttscube_tpu_torch.scripts.train_cubegan)
              at the full v1 width (fp32, --fused-tail-train) on a seeded corpus it
              writes: 4 steps over 2 epochs, B1 and B2 once per step, every checkpoint
              file written; --resume restores the step, parameters and moments bit-equal,
              and the next step from them equals the live run's next step; the saved
              weights, slimmed to {lang, gen}, serve through TTSCube(model_path, ...) on
              the card as the same weights do through TTSCube.from_state_dicts; then
              the CLI with --compute-dtype bfloat16: two steps and a save, --resume
              bit-equal, and the next step from both bit-equal
  generator_resblock2  a plain Generator at v1's widths with ResBlock2 (HiFi-GAN v3's
              kernels and dilations), fp32 on the card against the CPU
  times       each kernel's median time beside its plain version's and its bound (and
              for B5 F.conv1d's): B1 in both forms at the serving shape and at the
              training shape, and bf16 at serve_batch's shapes; and the train step's
              median
  profile     one served request, one with every stage fused and one train step under
              torch.profiler: device-busy share, top kernels

Serving, training, their times and their profiles run under PyTorch's default TF32
settings, as a user's program does; only the fp32 comparisons and the kernels' fp32
times turn TF32 off.

The line before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. Without a CUDA
card, or without the port's package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HOP = 240
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores, fp32 CUDA
# cores, HBM3; kernels are timed over TIME_PER launches in a row
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TIME_PER = 10

TOL_FP32 = 5e-5   # the repo's audio tolerance (tests/test_composed_parity.py)
# B3 and B1-mid in fp32: the JAX package's MRF tolerance (tests/test_pallas_resblock.py,
# 3e-5 on activations of unit scale), scaled to the activation's range
TOL_MRF = 3e-5
WIDE = (256, 128, 64, 32)  # fuse_channels with every HiFi-GAN v1 stage fused
TOL_RES = 2e-5    # B4 in fp32: the JAX ResBlock test's atol (tests/test_pallas_resblock.py),
# scaled to the output's range
TOL_CONV = 1e-5   # B5: the JAX narrow-conv test's atol (tests/test_legacy_and_runtime.py),
# scaled to the output's range; bf16 operands against the fp32 conv of the same values
TOL_GRAD = 2e-4   # rtol = atol of the JAX package's grad tests (tests/test_pallas_resblock.py)
TOL_LOSS = 1e-4   # relative, a train step's losses on the card against the CPU
# At the training shape no fp32 VJP of the stage, the plain one included, meets TOL_GRAD
# against the exact (fp64) VJP: where an activation lies within fp32 noise of a leaky
# kink, the fp32 forward takes the other slope there, and the grads of every conv
# upstream of that position move (PERF.md). So there each grad is held to the exact VJP
# within GRAD_REL_RMS in relative RMS, at each of GRAD_SEEDS. The limit lies between
# the plain fp32 version's readings (the witness, which must pass) and the plain
# version's under TF32 (the control, which must fail), over those seeds.
GRAD_REL_RMS = 5e-3
GRAD_SEEDS = (3000, 3001, 3002, 3003)
# B2's blocks for the ragged case's second run: so few that each walks several tiles,
# and its partial sums and workspace carry from one tile to the next
FEW_GRAD_BLOCKS = 3
TRAIN_STEPS = 5
TRAIN_BATCH = 16
TRAIN_T_IN = 3000   # the last stage's input rows in a train step: 50 frames x 60
TRAINER_UTTS = 8    # the trainer phase's corpus: 2 epochs of 2 steps at batch 4
TRAINER_BATCH = 4
TRAINER_STEPS = 4
# serve_batch: bench.py's serving configuration (Cubegan v1, 64 phones, 8 speakers, fused
# tail, bf16 storage): BATCH items of BATCH_CHARS characters at BATCH_FRAMES frames, one
# warm call and BATCH_CALLS timed ones; then CHUNK_BATCH items in windows of CHUNK_FRAMES
# frames (plus a halo of 32 on each side); the chunked-vs-whole checks at CHECK_BATCH
BATCH, BATCH_CHARS, BATCH_FRAMES, BATCH_CALLS = 128, 64, 512, 4
CHUNK_BATCH, CHUNK_FRAMES, CHECK_BATCH = 256, 256, 4
# generator_resblock2: the public HiFi-GAN v3 config's residual blocks at v1's widths
V3_BLOCKS = dict(resblock="2", resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
# bf16 operands: the limits are fractions of the precision floor, the distance between
# the plain version in bf16 and in fp32 on the same inputs, measured in each case. The
# kernel must sit at most BF16_RMS of the floor's RMS and BF16_MAX of its max from the
# plain bf16 version; the kernel in fp32 (the control) must miss these limits.
BF16_RMS = 0.5
BF16_MAX = 1.0

REQUESTS = (
    "hello world.",
    "the quick brown fox jumps over the lazy dog, and then it runs away.",
    "speech synthesis turns text into audio. this request is longer than the others, "
    "so that its frame count lands in a larger bucket of the generator, and the "
    "fused tail stage runs over many more tiles of output samples.",
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(phase: str, t0: float, **fields) -> None:
    items = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase={phase} seconds={time.perf_counter() - t0:.3f} {items}".rstrip(),
          flush=True)


def cuda_times(fn, reps: int, per: int = 1) -> list:
    """Milliseconds of `fn` on the card, after 3 warm-up calls: `reps` readings, each
    one pair of CUDA events around `per` calls in a row, divided by `per`. With per > 1
    the host enqueues the next call while the card runs the last, so a reading is the
    device's time rather than the host's time to launch."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return times


def ops_bound_ms(flops: float, mode: str) -> float:
    """The least milliseconds the card needs for `flops` operations whose operands are
    `mode`: "bf16" on the bf16 tensor cores; "fp32" on the faster of its fp32-accurate
    routes, the fp32 CUDA cores or 3xTF32 on the tensor cores (three TF32 products for
    each fp32 one)."""
    if mode == "bf16":
        return flops / PEAK_BF16 * 1e3
    if mode == "fp32":
        return min(flops / PEAK_FP32, 3 * flops / PEAK_TF32) * 1e3
    raise ValueError(f"ops_bound_ms: mode {mode!r}")


def bound(flops: float, nbytes: float, mode: str) -> dict:
    """A kernel's bound: the larger of `ops_bound_ms` and its bytes (each input read
    once, each output written once) over the card's memory rate, and which it is."""
    t_ops, t_bytes = ops_bound_ms(flops, mode), nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def no_tf32():
    """fp32 convs and matmuls in full fp32 for an fp32 comparison or time."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def distance(a, b) -> tuple:
    """(max, RMS) of |a − b|, in fp64."""
    d = (a.detach().double() - b.detach().double().to(a.device)).abs()
    return float(d.max()), float(d.square().mean().sqrt())


def tail_input(batch: int, frames: int, seed: int, device):
    """The final stage's input as the serving path hands it over for F frames:
    z (B, 60·F + 16, 64), the output of the three upsample stages before it."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 60 * frames + 16, 64, generator=g).to(device)


def train_input(device):
    """The last stage's input as a train step hands it over: z (16, 3,000, 64), seeded."""
    import torch

    g = torch.Generator().manual_seed(TRAIN_T_IN)
    return torch.randn(TRAIN_BATCH, TRAIN_T_IN, 64, generator=g).to(device)


def tail_leaves(gen, batch: int, t_in: int, seed: int, device):
    """z (B, T_in, 64), the audio's cotangent dy, and the last stage's weights of the
    generator `gen` (weight-normed, PyTorch layouts) as leaves that take grads."""
    import torch

    c = gen.config
    i = len(c.upsample_rates) - 1
    convs = [cv for j in range(len(c.resblock_kernel_sizes))
             for cv in getattr(gen, f"res_{i}_{j}").convs()]
    up = getattr(gen, f"up_{i}")
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(batch, t_in, up.v.shape[0], generator=g).to(device)
    dy = torch.randn(batch, 4 * t_in, generator=g).to(device)
    with torch.no_grad():
        ws = ([z, up.weight(), up.bias, gen.conv_post.weight(), gen.conv_post.bias]
              + [cv.weight() for cv in convs] + [cv.bias for cv in convs])
    return [w.detach().clone().requires_grad_() for w in ws], dy


def tail_vjp(leaves, dy, cfg, how: str):
    """The stage's grads for dy: "kernel" through FusedTailStageGrad (forward B1,
    backward B2); "plain" autograd through the plain version in fp32; "exact" the same
    in fp64."""
    import torch
    from ttscube_tpu_torch.ops import fused_tail

    spec = dict(kernel_sizes=cfg.resblock_kernel_sizes, dilations=cfg.resblock_dilation_sizes)
    if how == "exact":
        leaves = [t.detach().double().requires_grad_() for t in leaves]
        dy = dy.double()
    z, up, ub, pk, pb, *kb = leaves
    n = len(kb) // 2
    if how == "kernel":
        out = fused_tail.fused_tail_stage_train(z, up, ub, kb[:n], kb[n:], pk, pb, **spec)
    else:
        w = fused_tail.pack_tail_weights(up, ub, kb[:n], kb[n:], pk, pb, **spec,
                                         dtype=torch.float64 if how == "exact" else
                                         torch.float32)
        out = fused_tail.fused_tail_stage_plain(z, w)
    return torch.autograd.grad(out, leaves, dy)


@contextlib.contextmanager
def grad_blocks(n: int):
    """Kernel B2 launched with `n` thread blocks (`fused_tail.GRAD_BLOCKS`)."""
    from ttscube_tpu_torch.ops import fused_tail

    saved, fused_tail.GRAD_BLOCKS = fused_tail.GRAD_BLOCKS, n
    try:
        yield
    finally:
        fused_tail.GRAD_BLOCKS = saved


def within_grad_tol(a, b) -> bool:
    """|a − b| ≤ atol + rtol·|b| everywhere, rtol = atol = TOL_GRAD."""
    return bool(((a.double() - b.double()).abs()
                 <= TOL_GRAD + TOL_GRAD * b.double().abs()).all())


def rel_rms(a, b) -> float:
    """‖a − b‖ / ‖b‖ over all elements, in fp64."""
    d = a.double() - b.double()
    return float(d.norm() / b.double().norm().clamp(min=1e-300))


def counters() -> dict:
    """Every kernel wrapper, by kernel name; each counts its launches in `.launches`."""
    from ttscube_tpu_torch.ops import fused_mrf, fused_resblock, fused_tail, narrow_conv

    return {"fused_tail_stage": fused_tail.fused_tail_stage,
            "fused_tail_stage_grad": fused_tail.fused_tail_stage_grad,
            "fused_mrf1": fused_mrf.fused_mrf1,
            "fused_tail_stage_mid": fused_tail.fused_tail_stage_mid,
            "fused_resblock1": fused_resblock.fused_resblock1,
            "narrow_conv_blocked": narrow_conv.narrow_conv_blocked}


def zero_counts() -> None:
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in counters().items()}


def moved(w, device):
    """Packed weights (a NamedTuple of tensors and specs) on `device`."""
    import torch

    return w._replace(**{f: getattr(w, f).to(device) for f in w._fields
                         if isinstance(getattr(w, f), torch.Tensor)})


def bf16_check(what: str, floor, err, ctl, wit=None) -> None:
    """The bf16 limits: the port's result (err) and the witness (wit, where there is
    one) within BF16_RMS of the floor's RMS and BF16_MAX of its max, the control (ctl)
    not; each a (max, RMS)."""
    within = lambda d: d[1] <= BF16_RMS * floor[1] and d[0] <= BF16_MAX * floor[0]
    print(f"  {what} limit: max<={BF16_MAX * floor[0]:.3e} rms<={BF16_RMS * floor[1]:.3e}",
          flush=True)
    readings = (("floor", floor), ("port", err), ("control", ctl)) + (
        (("witness", wit),) if wit is not None else ())
    for name, d in readings:
        print(f"  {what} {name}: max={d[0]:.3e} rms={d[1]:.3e} ({d[0] / floor[0]:.3f}, "
              f"{d[1] / floor[1]:.3f} of the floor)", flush=True)
    check(floor[0] > 1e-4, f"{what}: bf16 did not move the result")
    check(within(err), f"{what}: {err} is not within {BF16_RMS} (RMS) and {BF16_MAX} (max) "
                       f"of the floor {floor}")
    check(not within(ctl), f"{what}: the fp32 control passed")
    check(wit is None or within(wit), f"{what}: the limits are tighter than summation order "
                                      f"alone allows (witness {wit})")


def check_stage_kernel(what: str, kernel, plain, x, w32, w16, tol: float = TOL_MRF,
                       to_cpu=None) -> tuple:
    """A stage kernel (B3, B1-mid or B4) against its plain version on x: fp32 (TF32
    off) within `tol` scaled to the output's range, which the plain version on the CPU
    (the witness) must meet too; bf16 within the limits of `bf16_check`; two launches
    bit-equal. `to_cpu` moves weights to the CPU (packed weights by default). Returns
    the kernel's max abs errors (fp32, bf16)."""
    import torch

    to_cpu = to_cpu or (lambda w: moved(w, "cpu"))
    with no_tf32():
        got32, again, got16 = kernel(x, w32), kernel(x, w32), kernel(x, w16)
        want32, want16 = plain(x, w32), plain(x, w16)
        torch.cuda.synchronize()
    for got in (got32, got16):
        check(got.shape == want32.shape and bool(torch.isfinite(got).all()),
              f"{what}: shape {tuple(got.shape)} vs {tuple(want32.shape)}, or not finite")
    check(torch.equal(got32, again), f"{what}: two launches gave different outputs")
    xc, w32c, w16c = x.cpu(), to_cpu(w32), to_cpu(w16)
    limit = tol * max(1.0, float(want32.abs().max()))
    err, wit = distance(got32, want32)[0], distance(plain(xc, w32c), want32)[0]
    print(f"  {what} fp32 max_abs_err={err:.3e} witness={wit:.3e} limit={limit:.3e} "
          f"({tol:.0e} x max(1, max|plain| = {float(want32.abs().max()):.3f})) "
          f"bit_equal_relaunch=True", flush=True)
    check(err <= limit, f"{what} fp32: max abs err {err:.3e} > {limit:.3e}")
    check(wit <= limit, f"{what} fp32: the plain version on the CPU misses the limit")
    e16 = distance(got16, want16)
    bf16_check(f"{what} bf16", distance(want16, want32), e16, distance(got32, want16),
               distance(plain(xc, w16c), want16))
    return err, e16[0]


@contextlib.contextmanager
def recorded_stages():
    """The fused stages that `generator_apply_fused` runs inside, in stage order: (the
    wrapper's name, its input, its packed weights)."""
    from ttscube_tpu_torch.models import hifigan_fused as hf

    names = ("fused_mrf1", "fused_tail_stage_mid", "fused_tail_stage")
    saved = {n: getattr(hf, n) for n in names}
    seen = []

    def recorder(name, fn):
        def call(x, w):
            seen.append((name, x.detach().clone(), w))
            return fn(x, w)
        return call

    for n in names:
        setattr(hf, n, recorder(n, saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(hf, n, saved[n])


def train_batch(enc, batch: int, seed: int) -> dict:
    """`batch` utterances of at least 60 frames (the GAN window is 50) through the
    port's CubeganCollate, from seeded numpy phones, durations, pitch and audio."""
    import numpy as np

    from ttscube_tpu_torch.data.collate import CubeganCollate

    rng = np.random.default_rng(seed)
    phones, speakers = list(enc.phon2int), list(enc.speaker2int)
    items = []
    for i in range(batch):
        n = int(rng.integers(20, 40))
        durs = rng.integers(2, 7, n)
        durs[-1] += max(0, 60 - int(durs.sum()))
        frames = int(durs.sum())
        t = np.arange(frames * HOP) / 24000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 250) * t)
                 + 0.03 * rng.standard_normal(frames * HOP))
        items.append({
            "meta": {"phones": [phones[j] for j in rng.integers(0, len(phones), n)],
                     "speaker": speakers[i % len(speakers)],
                     "frame2phon": np.repeat(np.arange(n), durs).tolist(),
                     "phon2word": list(range(n))},
            "mgc": rng.standard_normal((frames, 80)).astype(np.float32),
            "pitch": (rng.uniform(80, 300, frames) * (rng.random(frames) > 0.3)).astype(
                np.float32),
            "audio": audio.astype(np.float32)})
    return CubeganCollate(enc)(items)


def param_distance(got: dict, want: dict, lr: float):
    """Parameters after one step, in units of the learning rate. The first Adam step
    moves each parameter by about lr·sign(g), so one whose grad is near zero may step
    the other way: the limit is 2·lr plus the float32 rounding of the two updates (one
    spacing of |p| each). Returns (max |Δ|, elements beyond that limit, elements beyond
    0.01·lr, elements)."""
    import torch

    worst, over, far, total = 0.0, 0, 0, 0
    for n, w in want.items():
        d = (got[n] - w).abs()
        limit = 2 * lr + 2 * torch.abs(torch.nextafter(w.abs(), torch.tensor(float("inf")))
                                       - w.abs())
        worst = max(worst, float(d.max()))
        over += int((d > limit).sum())
        far += int((d > 0.01 * lr).sum())
        total += d.numel()
    return worst, over, far, total


def resblock_args(gen, stage: int, chain: int, device):
    """One ResBlock1 of the v1 generator `gen` (stage, chain) in the JAX function's
    layouts: kernels (k, C_in, C_out) in call order, biases, k and dilations."""
    import torch

    c = gen.config
    convs = getattr(gen, f"res_{stage}_{chain}").convs()
    with torch.no_grad():
        kernels = [cv.weight().detach().permute(2, 1, 0).contiguous().to(device)
                   for cv in convs]
        biases = [cv.bias.detach().to(device) for cv in convs]
    return dict(kernels=kernels, biases=biases, kernel_size=c.resblock_kernel_sizes[chain],
                dilations=tuple(c.resblock_dilation_sizes[chain]))


def write_corpus(folder: Path, phones: list, n: int, seed: int) -> None:
    """A seeded corpus in the JAX package's import format ({id}.{wav,mgc,pitch,json},
    as tests/test_data.py's make_corpus writes it): n utterances of 60-240 frames, two
    speakers, written with the port's own wav writer."""
    import numpy as np

    from ttscube_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        frames = int(rng.integers(60, 241))
        P = int(rng.integers(frames // 6, frames // 3))
        cuts = np.sort(rng.choice(np.arange(1, frames), P - 1, replace=False))
        durs = np.diff(np.concatenate([[0], cuts, [frames]]))
        f2p = np.repeat(np.arange(P), durs).tolist()
        meta = {"id": f"utt{i}", "orig_text": "x" * P,
                "phones": [phones[int(k)] for k in rng.integers(0, len(phones), P)],
                "words": ["w1", "w2"], "phon2word": [0] * (P // 2) + [1] * (P - P // 2),
                "frame2phon": f2p, "speaker": f"spk{i % 2}",
                "left_context": "left words here", "right_context": "right words"}
        base = folder / f"utt{i}"
        (folder / f"utt{i}.json").write_text(json.dumps(meta))
        np.save(f"{base}.mgc.npy", rng.standard_normal((frames, 80)).astype(np.float32))
        np.save(f"{base}.pitch.npy", (rng.uniform(80, 300, frames)
                                      * (rng.random(frames) > 0.3)).astype(np.float32))
        t = np.arange(frames * HOP) / 24000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 250) * t)
                 + 0.03 * rng.standard_normal(frames * HOP))
        write_wav(f"{base}.wav", audio.astype(np.float32), 24000)


def same_train_state(a, b) -> bool:
    """Bit-equal parameters, buffers (the spectral u), step, and every optimizer
    moment and count."""
    import torch

    sb = b.model.state_dict()
    if a.step != b.step or any(not torch.equal(v, sb[k]) for k, v in
                               a.model.state_dict().items()):
        return False
    for part, opt in a.optimizers.items():
        for p, q in zip(opt.param_groups[0]["params"],
                        b.optimizers[part].param_groups[0]["params"]):
            sa, sq = opt.state.get(p, {}), b.optimizers[part].state.get(q, {})
            if sa.keys() != sq.keys() or any(not torch.equal(sa[k], sq[k]) for k in sa):
                return False
    return True


def device_profile(fn):
    """Run `fn` once under torch.profiler: (wall ms with the profiler on, device-busy
    ms, {kernel name: (ms, launches)}, device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    # device activities only (kernels, copies), not the profiler's own buffer work
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in ("Buffer Flush", "Activity Buffer Request")]
    by_name: dict = {}
    for e in dev_ev:
        ms_, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms_ + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, sum(v[0] for v in by_name.values()), by_name, len(dev_ev)


def print_profile(what: str, wall_ms, busy_ms, by_name, n_events) -> None:
    if busy_ms <= 0:
        print(f"  {what}: the profiler showed no device time: not measured", flush=True)
        return
    print(f"  profiled {what} wall_ms={wall_ms:.1f} (profiler on) device_busy_ms="
          f"{busy_ms:.1f} busy_share={busy_ms / wall_ms:.3f} device_ops={n_events}",
          flush=True)
    for name, (ms_, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {ms_:9.3f} ms {n:6d}x {name[:90]}", flush=True)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's among them), for a comparison that
    must be bit-equal; a warning, not an error, where an op has none."""
    import torch

    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]


@contextlib.contextmanager
def fp64_convs():
    """The port's bf16 convs on the CPU (`ops/conv._mp_conv`) summing in fp64 before
    their one rounding to bf16: another right implementation of the same rounding, the
    witness of what summation order alone does to a bf16 result."""
    from ttscube_tpu_torch.ops import conv as tconv

    real = tconv._mp_conv
    tconv._mp_conv = lambda conv, x, w, cd, **kw: real(
        lambda a, b, **k: conv(a.double(), b.double(), **k).float(), x, w, cd, **kw)
    try:
        yield
    finally:
        tconv._mp_conv = real


def bf16_conv_check(name: str, module, x, device) -> None:
    """One conv module of the bf16 step (`compute_dtype` bf16) on the card against the
    same module on the CPU, forward and backward: its output, its input's grad and its
    parameters' grads (the floor: the module in fp32 on the card; the control: that
    fp32 module; the witness: the CPU's convs summing in fp64). Each within BF16_RMS of
    the floor's RMS, and within one bf16 step at twice its largest magnitude: each is
    one rounding to bf16 of a sum that two right implementations compute a few fp32
    steps apart (the output before its fp32 bias, the parameters' grads before the
    weight norm's fp32 scaling, may exceed the largest value), so a rounding may land on
    the other neighbour; the floor's max is below one step there, which makes
    `bf16_check`'s max limit refuse that. The witness must meet the limits and the
    control must not."""
    import copy

    import torch

    def run(mod, where, fp32=False):
        mod = copy.deepcopy(mod).to(where)
        if fp32:
            mod.compute_dtype = None
        xx = x.detach().clone().to(where).requires_grad_()
        y = mod(xx)
        g = torch.Generator().manual_seed(y.numel())
        y.backward(torch.randn(y.shape, generator=g).to(where))
        return [y.detach(), xx.grad, torch.cat([p.grad.reshape(-1) for p in mod.parameters()])]

    with no_tf32():
        card16, card32 = run(module, device), run(module, device, fp32=True)
    with torch.backends.mkldnn.flags(enabled=False):
        cpu16 = run(module, "cpu")
        with fp64_convs():
            wit = run(module, "cpu")
    for i, what in enumerate(("output", "input grad", "parameter grads")):
        floor = distance(card16[i], card32[i])
        top = 2 * float(cpu16[i].abs().max())
        max_limit = 2.0 ** (math.floor(math.log2(top)) - 7)
        within = lambda d: d[1] <= BF16_RMS * floor[1] and d[0] <= max_limit
        print(f"  train_bf16 {name} {what} limit: max<={max_limit:.3e} (max|cpu|="
              f"{top / 2:.3e}) rms<={BF16_RMS * floor[1]:.3e}", flush=True)
        readings = {"floor": floor, "card": distance(card16[i], cpu16[i]),
                    "control": distance(card32[i], cpu16[i]), "witness": distance(wit[i], cpu16[i])}
        for label, d in readings.items():
            print(f"  train_bf16 {name} {what} {label}: max={d[0]:.3e} rms={d[1]:.3e} "
                  f"({d[0] / floor[0]:.3f}, {d[1] / floor[1]:.3f} of the floor)", flush=True)
        check(floor[0] > 1e-4, f"train_bf16 {name} {what}: bf16 did not move the result")
        check(within(readings["card"]), f"train_bf16 {name} {what}: the card is off the CPU")
        check(not within(readings["control"]), f"train_bf16 {name} {what}: the control passed")
        check(within(readings["witness"]), f"train_bf16 {name} {what}: the limits are tighter "
                                            "than summation order alone allows")


def batch_inputs(n_items: int, seed: int, device) -> dict:
    """bench.py's serving batch: n_items texts of BATCH_CHARS seeded characters from 63
    phones, seeded speakers of 7."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return {"x_char": torch.from_numpy(rng.integers(1, 64, (n_items, BATCH_CHARS))).to(device),
            "x_speaker": torch.from_numpy(rng.integers(1, 8, (n_items, 1))).to(device)}


def serve_batches(model, n_items: int, chunk, device) -> dict:
    """bench.py's measurement through `Cubegan.infer`: one warm call, then
    BATCH_CALLS timed calls (host clock to the audio's mean on the host), each on
    fresh characters, under the default TF32 settings; launches counted from zero over
    all of them. Returns the times, the rate and the counts."""
    import statistics

    import torch

    inputs = [batch_inputs(n_items, SEED + 10 + i, device) for i in range(1 + BATCH_CALLS)]
    torch.cuda.synchronize()
    zero_counts()
    ms = []
    for X in inputs:
        t1 = time.perf_counter()
        audio, _ = model.infer(X, max_frames=BATCH_FRAMES, chunk_frames=chunk)
        level = float(audio.abs().mean())  # to the host: the call has ended
        ms.append((time.perf_counter() - t1) * 1e3)
        check(audio.shape == (n_items, BATCH_FRAMES * HOP) and math.isfinite(level)
              and bool(torch.isfinite(audio).all()),
              f"serve_batch B={n_items}: audio {tuple(audio.shape)} or not finite")
    counts = read_counts()
    median = statistics.median(ms[1:])
    return dict(ms=ms, median_ms=median, counts=counts,
                rate=n_items * BATCH_FRAMES * HOP / 24000 / (median / 1e3))


def chunk_check(what: str, model16, model32, X, chunk: int) -> dict:
    """Chunked against whole synthesis on the same items (TF32 off, so that both take
    the same durations): fp32 within TOL_FP32, bf16 storage by `bf16_check`, every
    output finite, two chunked runs bit-equal. Under PyTorch's deterministic algorithms:
    by default cuDNN may run a transposed conv (the upsamples) with atomic adds, and two
    runs then differ in the last bits, which bf16 storage carries on (printed first).
    Returns the chunked runs' launches."""
    import torch

    with no_tf32():
        a, b = (model16.infer(X, max_frames=BATCH_FRAMES, chunk_frames=chunk)[0]
                for _ in range(2))
        print(f"  {what} bf16 chunked, two runs under the default cuDNN settings: "
              f"max_abs_diff={distance(a, b)[0]:.3e}", flush=True)
    with no_tf32(), deterministic():
        whole32, whole16 = (m.infer(X, max_frames=BATCH_FRAMES)[0] for m in (model32, model16))
        before = read_counts()
        chunk32, chunk16 = (m.infer(X, max_frames=BATCH_FRAMES, chunk_frames=chunk)[0]
                            for m in (model32, model16))
        launches = {n: v - before[n] for n, v in read_counts().items()}
        again32, again16 = (m.infer(X, max_frames=BATCH_FRAMES, chunk_frames=chunk)[0]
                            for m in (model32, model16))
        torch.cuda.synchronize()
    for a in (whole32, whole16, chunk32, chunk16):
        check(a.shape == whole32.shape and bool(torch.isfinite(a).all()),
              f"{what}: audio {tuple(a.shape)} or not finite")
    check(torch.equal(chunk32, again32) and torch.equal(chunk16, again16),
          f"{what}: two chunked runs differ")
    err = distance(chunk32, whole32)[0]
    print(f"  {what} fp32 chunked vs whole max_abs_err={err:.3e} tol={TOL_FP32:.0e} "
          f"bit_equal_relaunch=True launches={launches}", flush=True)
    check(err <= TOL_FP32, f"{what} fp32: chunked differs from whole by {err:.3e}")
    bf16_check(f"{what} bf16 chunked vs whole", distance(whole16, whole32),
                distance(chunk16, whole16), distance(chunk32, whole16))
    return launches


def relative_losses(met: dict, ref: dict) -> list:
    """A step's losses relative to the reference step's, in a fixed order."""
    return [met[k] / abs(ref[k]) for k in sorted(ref)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    if not (REPO / "ttscube_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    # -- device -------------------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", t0, name=json.dumps(kind), cuda=torch.version.cuda,
        torch=torch.__version__, count=torch.cuda.device_count())
    dev = torch.device("cuda")

    # -- build --------------------------------------------------------------------
    from ttscube_tpu_torch.ops import _build, fused_mrf, fused_tail, narrow_conv

    t0 = time.perf_counter()
    sources = (fused_tail.KERNEL_SOURCE, fused_tail.GRAD_KERNEL_SOURCE, fused_mrf.KERNEL_SOURCE,
               narrow_conv.KERNEL_SOURCE)
    _build.load_all(sources)
    for source in sources:
        for line in _build.nvcc_log(source).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}", flush=True)
    say("build", t0, sources=",".join(sources))

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig

    # -- kernel -------------------------------------------------------------------
    t0 = time.perf_counter()
    gen = init_random(Generator(HifiganConfig()), SEED).to(dev)  # full v1 widths
    w32, w16 = gen.tail_weights(None), gen.tail_weights(torch.bfloat16)
    errs = {}
    with no_tf32():
        for batch, frames in ((1, 256), (2, 300)):
            z = tail_input(batch, frames, seed=frames, device=dev)
            got32, got16 = (fused_tail.fused_tail_stage(z, w) for w in (w32, w16))
            again32, again16 = (fused_tail.fused_tail_stage(z, w) for w in (w32, w16))
            want32, want16 = (fused_tail.fused_tail_stage_plain(z, w) for w in (w32, w16))
            torch.cuda.synchronize()
            check(torch.equal(got32, again32) and torch.equal(got16, again16),
                  f"fused_tail_stage B={batch} F={frames}: two launches differ")
            for got in (got32, got16):
                check(got.shape == want32.shape == (batch, z.shape[1] * 4),
                      f"fused_tail_stage shape {tuple(got.shape)} vs {tuple(want32.shape)}")
                check(bool(torch.isfinite(got).all()), "fused_tail_stage: non-finite output")
            case = f"B={batch} F={frames}"
            err = errs[("fp32", batch, frames)] = distance(got32, want32)[0]
            print(f"  fused_tail_stage fp32 {case} max_abs_err={err:.3e} tol={TOL_FP32:.0e}",
                  flush=True)
            check(err <= TOL_FP32, f"fused_tail_stage fp32 {case}: max abs err {err:.3e}")
            # bf16: the floor, the kernel, the control (the kernel in fp32), and a witness
            # of what summation order alone does: the plain version on the CPU, whose
            # convs add in another order than cuDNN's
            err = distance(got16, want16)
            errs[("bf16", batch, frames)] = err[0]
            bf16_check(f"fused_tail_stage bf16 {case}", distance(want16, want32), err,
                       distance(got32, want16),
                       distance(fused_tail.fused_tail_stage_plain(z.cpu(), moved(w16, "cpu")),
                                want16))
        # fp32 at the training shape, where the train steps launch it
        z = train_input(dev)
        got32, again32 = (fused_tail.fused_tail_stage(z, w32) for _ in range(2))
        want32 = fused_tail.fused_tail_stage_plain(z, w32)
        torch.cuda.synchronize()
        check(got32.shape == want32.shape == (TRAIN_BATCH, 4 * z.shape[1])
              and bool(torch.isfinite(got32).all()), "fused_tail_stage: training shape")
        check(torch.equal(got32, again32), "fused_tail_stage training shape: two launches "
                                           "differ")
        err = errs[("fp32", TRAIN_BATCH, "train")] = distance(got32, want32)[0]
        print(f"  fused_tail_stage fp32 B={TRAIN_BATCH} T_in={TRAIN_T_IN} max_abs_err={err:.3e} "
              f"tol={TOL_FP32:.0e} bit_equal_relaunch=True", flush=True)
        check(err <= TOL_FP32, f"fused_tail_stage fp32 training shape: max abs err {err:.3e}")
        del z, got32, again32, want32
        # serve_batch's shapes: the whole batch and one chunked window; bf16 without a CPU
        # witness (the plain version on the CPU would take minutes here)
        for batch, frames in ((BATCH, BATCH_FRAMES), (CHUNK_BATCH, CHUNK_FRAMES + 64)):
            z = tail_input(batch, frames, seed=frames, device=dev)
            got32, got16, again16 = (fused_tail.fused_tail_stage(z, w) for w in (w32, w16, w16))
            want32 = fused_tail.fused_tail_stage_plain(z, w32)
            want16 = fused_tail.fused_tail_stage_plain(z, w16)
            torch.cuda.synchronize()
            case = f"B={batch} F={frames} (z {tuple(z.shape)})"
            check(torch.equal(got16, again16), f"fused_tail_stage {case}: two launches differ")
            for got in (got32, got16):
                check(got.shape == want32.shape == (batch, 4 * z.shape[1])
                      and bool(torch.isfinite(got).all()), f"fused_tail_stage {case}: shape")
            err = errs[("fp32", batch, frames)] = distance(got32, want32)[0]
            print(f"  fused_tail_stage fp32 {case} max_abs_err={err:.3e} tol={TOL_FP32:.0e}",
                  flush=True)
            check(err <= TOL_FP32, f"fused_tail_stage fp32 {case}: max abs err {err:.3e}")
            err = distance(got16, want16)
            errs[("bf16", batch, frames)] = err[0]
            bf16_check(f"fused_tail_stage bf16 {case}", distance(want16, want32), err,
                        distance(got32, want16))
            del z, got32, got16, again16, want32, want16
        torch.cuda.empty_cache()
    say("kernel", t0, checks=len(errs))

    # -- kernel_mrf -----------------------------------------------------------------
    t0 = time.perf_counter()
    c = gen.config
    mrf_errs, grids = {}, {}
    convs32 = [cv for j in range(len(c.resblock_kernel_sizes)) for cv in getattr(gen, f"res_3_{j}").convs()]
    with torch.no_grad():
        w_c32 = {cd: fused_mrf.pack_mrf_weights(
            [cv.weight() for cv in convs32], [cv.bias for cv in convs32],
            kernel_sizes=c.resblock_kernel_sizes, dilations=c.resblock_dilation_sizes,
            compute_dtype=cd) for cd in (None, torch.bfloat16)}
    for label, batch, t_len, weights in (
            ("stage0", 1, 1280, lambda cd: gen.stage_weights(0, cd)),   # 256 frames
            ("stage1", 1, 3840, lambda cd: gen.stage_weights(1, cd)),
            ("ragged", 2, 701, lambda cd: gen.stage_weights(1, cd)),
            ("C=32", 1, 4000, lambda cd: w_c32[cd])):
        m32, m16 = weights(None), weights(torch.bfloat16)
        g = torch.Generator().manual_seed(t_len)
        x = torch.randn(batch, t_len, m32.channels, generator=g).to(dev)
        mrf_errs[label] = check_stage_kernel(
            f"fused_mrf1 {label} B={batch} T={t_len} C={m32.channels}", fused_mrf.fused_mrf1,
            fused_mrf.fused_mrf_plain, x, m32, m16)
        grids[label] = fused_mrf.fused_mrf1.last_grid
    print(f"  fused_mrf1 thread blocks (256 threads each) per launch: {grids}", flush=True)
    say("kernel_mrf", t0, checks=2 * len(mrf_errs))

    # -- kernel_mid -----------------------------------------------------------------
    t0 = time.perf_counter()
    mid_errs = {}
    m32, m16 = gen.stage_weights(2, None), gen.stage_weights(2, torch.bfloat16)
    for label, batch, t_in in (("stage2", 1, 3840), ("ragged", 2, 301)):
        g = torch.Generator().manual_seed(t_in)
        z = torch.randn(batch, t_in, 128, generator=g).to(dev)
        mid_errs[label] = check_stage_kernel(
            f"fused_tail_stage_mid {label} B={batch} T_in={t_in}",
            fused_tail.fused_tail_stage_mid, fused_tail.fused_tail_stage_plain, z, m32, m16)
        grids["mid " + label] = fused_tail.fused_tail_stage_mid.last_grid
    print(f"  fused_tail_stage_mid thread blocks per launch: stage2 {grids['mid stage2']}, "
          f"ragged {grids['mid ragged']}", flush=True)
    say("kernel_mid", t0, checks=2 * len(mid_errs))

    # -- kernel_grad --------------------------------------------------------------
    t0 = time.perf_counter()
    grad_errs, readings = {}, {}
    cases = ([(TRAIN_BATCH, 3000, seed, fused_tail.GRAD_BLOCKS) for seed in GRAD_SEEDS]
             + [(2, 701, 701, fused_tail.GRAD_BLOCKS), (2, 701, 701, FEW_GRAD_BLOCKS)])
    for batch, t_in, seed, blocks in cases:
        leaves, dy = tail_leaves(gen, batch, t_in, seed=seed, device=dev)
        with no_tf32():
            with grad_blocks(blocks):
                got = tail_vjp(leaves, dy, gen.config, "kernel")
                again = tail_vjp(leaves, dy, gen.config, "kernel")
            plain = tail_vjp(leaves, dy, gen.config, "plain")
            exact = tail_vjp(leaves, dy, gen.config, "exact")
        control = tail_vjp(leaves, dy, gen.config, "plain")  # PyTorch's default: TF32 convs
        torch.cuda.synchronize()
        case = f"B={batch} T_in={t_in} seed={seed} blocks={blocks}"
        for i, a in enumerate(got):
            check(a.shape == plain[i].shape and bool(torch.isfinite(a).all()),
                  f"fused_tail_stage_grad {case}: grad {i} {tuple(a.shape)} or not finite")
        n_over = lambda gs, ref: sum(int(((g.double() - r.double()).abs() > TOL_GRAD
                                         + TOL_GRAD * r.double().abs()).sum())
                                     for g, r in zip(gs, ref))
        n_all = sum(a.numel() for a in got)
        worst = max(distance(a, e)[0] for a, e in zip(got, exact))
        grad_errs[(batch, t_in, seed, blocks)] = worst
        print(f"  fused_tail_stage_grad fp32 {case} grads={len(got)} elements={n_all}: "
              f"beyond rtol=atol={TOL_GRAD:.0e}: kernel vs plain {n_over(got, plain)}, "
              f"kernel vs exact {n_over(got, exact)}, plain vs exact "
              f"{n_over(plain, exact)}, control vs exact {n_over(control, exact)}; "
              f"kernel max_abs_err vs exact={worst:.3e}", flush=True)
        for name, gs in (("kernel", got), ("witness", plain), ("control", control)):
            worst_rel = max(rel_rms(a, e) for a, e in zip(gs, exact))
            readings.setdefault((t_in, name), []).append(worst_rel)
            print(f"    {case} {name}: grads beyond rtol=atol={TOL_GRAD:.0e} of the exact "
                  f"VJP {sum(not within_grad_tol(a, e) for a, e in zip(gs, exact))} of "
                  f"{len(gs)}, worst relative RMS {worst_rel:.3e}", flush=True)
        if t_in == 701:  # the ragged shape: every fp32 VJP meets TOL_GRAD
            for name, gs in (("plain", plain), ("exact", exact)):
                check(all(within_grad_tol(a, p) for a, p in zip(got, gs)),
                      f"fused_tail_stage_grad {case}: grads beyond rtol = atol = "
                      f"{TOL_GRAD} of the {name} VJP")
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"    {case} bit_equal_relaunch={equal}", flush=True)
        check(equal, "fused_tail_stage_grad: two launches gave different grads")
    # the training shape's limit, over the seeds: the kernel and the witness within it,
    # the control beyond it
    for name in ("kernel", "witness", "control"):
        r = readings[(3000, name)]
        print(f"  fused_tail_stage_grad B={TRAIN_BATCH} T_in=3000 {name}: worst relative RMS "
              f"per seed {', '.join(f'{x:.3e}' for x in r)} (limit {GRAD_REL_RMS:.0e})",
              flush=True)
    check(max(readings[(3000, "kernel")]) <= GRAD_REL_RMS, "fused_tail_stage_grad: the "
          "kernel's grads are off the exact VJP at the training shape")
    check(max(readings[(3000, "witness")]) <= GRAD_REL_RMS, "fused_tail_stage_grad: the "
          "limit is tighter than the plain fp32 version itself meets")
    check(min(readings[(3000, "control")]) > GRAD_REL_RMS, "fused_tail_stage_grad: the "
          "TF32 control passed")
    say("kernel_grad", t0, checks=len(grad_errs))

    # -- kernel_resblock ----------------------------------------------------------------
    from ttscube_tpu_torch.ops import fused_resblock

    t0 = time.perf_counter()
    res_errs = {}
    res_kernel = lambda x, a: fused_resblock.fused_resblock1(x, **a)
    res_plain = lambda x, a: fused_resblock.fused_resblock1_plain(x, **a)
    res_cpu = lambda a: dict(a, kernels=[t.cpu() for t in a["kernels"]],
                             biases=[t.cpu() for t in a["biases"]])
    # v1's four stages at 256 frames (stage i, chain j: k = 3, 7, 11, 11) and a ragged T
    for label, batch, t_len, stage, chain in (
            ("stage0", 1, 1280, 0, 0), ("stage1", 1, 3840, 1, 1), ("stage2", 1, 15360, 2, 2),
            ("stage3", 1, 61440, 3, 2), ("ragged", 2, 7696, 3, 2)):
        a = resblock_args(gen, stage, chain, dev)
        C = a["kernels"][0].shape[1]
        g = torch.Generator().manual_seed(t_len)
        x = torch.randn(batch, t_len, C, generator=g).to(dev)
        res_errs[label] = check_stage_kernel(
            f"fused_resblock1 {label} B={batch} T={t_len} C={C} k={a['kernel_size']}",
            res_kernel, res_plain, x, dict(a, compute_dtype=None),
            dict(a, compute_dtype=torch.bfloat16), tol=TOL_RES, to_cpu=res_cpu)
        grids["resblock " + label] = fused_resblock.fused_resblock1.last_grid
    print("  fused_resblock1 thread blocks per launch: " + ", ".join(
        f"{k[9:]} {v}" for k, v in grids.items() if k.startswith("resblock ")), flush=True)
    say("kernel_resblock", t0, checks=2 * len(res_errs),
        launches=fused_resblock.fused_resblock1.launches)

    # -- kernel_narrow_conv -------------------------------------------------------------
    t0 = time.perf_counter()
    conv_errs = {}
    nconv, nplain = narrow_conv.narrow_conv_blocked, narrow_conv.narrow_conv_plain
    # the shape of the TPU kernel's docstring, and others the kernel takes: a T that is
    # no multiple of the bf16 form's 256-row tile; C = 96 (an odd count of 16-channel
    # MMA columns); an even k, which pads (k - 1)//2 on the left; C = 256, where the
    # bf16 form walks input-channel chunks (and at k = 15 the fp32 form too)
    for label, (batch, t_len, C, k) in (("docstring", (8, 122880, 32, 11)),
                                        ("c64", (2, 1000, 64, 7)), ("c256", (1, 4096, 256, 3)),
                                        ("even_k", (2, 3000, 32, 4)),
                                        ("ragged", (3, 1000, 32, 11)),
                                        ("c96", (2, 700, 96, 6)),
                                        ("c256_k15", (1, 2000, 256, 15))):
        g = torch.Generator().manual_seed(t_len + k)
        x = torch.randn(batch, t_len, C, generator=g).to(dev)
        w = (torch.randn(k, C, C, generator=g) / math.sqrt(k * C)).to(dev)
        xb, wb = x.bfloat16(), w.bfloat16()
        with no_tf32():
            got, again, got16, again16 = nconv(x, w), nconv(x, w), nconv(xb, wb), nconv(xb, wb)
            want, want16 = nplain(x, w), nplain(xb, wb)
            torch.cuda.synchronize()
        tf32 = nplain(x, w)  # PyTorch's default: TF32 convs
        wit, wit16 = nplain(x.cpu(), w.cpu()), nplain(xb.cpu(), wb.cpu())
        torch.cuda.synchronize()
        check(got.shape == want.shape == (batch, t_len, C) and got16.dtype == torch.float32
              and bool(torch.isfinite(got).all()) and bool(torch.isfinite(got16).all()),
              f"narrow_conv {label}: shape {tuple(got.shape)} or not finite")
        check(torch.equal(got, again) and torch.equal(got16, again16),
              f"narrow_conv {label}: two launches differ")
        case = f"narrow_conv {label} B={batch} T={t_len} C={C} k={k}"
        for mode, out, ref, witness, control in (("fp32", got, want, wit, got16),
                                                 ("bf16", got16, want16, wit16, got)):
            limit = TOL_CONV * max(1.0, float(ref.abs().max()))
            err, w_err, c_err = (distance(a, ref)[0] for a in (out, witness, control))
            print(f"  {case} {mode}: max_abs_err={err:.3e} witness={w_err:.3e} "
                  f"control={c_err:.3e} limit={limit:.3e}" + (
                      f" tf32={distance(tf32, ref)[0]:.3e}" if mode == "fp32" else ""),
                  flush=True)
            check(err <= limit, f"{case} {mode}: max abs err {err:.3e} > {limit:.3e}")
            check(w_err <= limit, f"{case} {mode}: the CPU witness misses the limit")
            check(c_err > limit, f"{case} {mode}: the control (the other operand type) "
                                 "passed")
            conv_errs[(label, mode)] = err
        grids["conv " + label] = narrow_conv.narrow_conv_blocked.last_grid
    print("  narrow_conv thread blocks per launch: " + ", ".join(
        f"{k[5:]} {v}" for k, v in grids.items() if k.startswith("conv ")), flush=True)
    say("kernel_narrow_conv", t0, checks=len(conv_errs),
        launches=narrow_conv.narrow_conv_blocked.launches)
    phase_launches = {"fused_resblock1": fused_resblock.fused_resblock1.launches,
                      "narrow_conv_blocked": narrow_conv.narrow_conv_blocked.launches}

    # -- warmup -------------------------------------------------------------------
    from ttscube_tpu_torch.api import TTSCube, config_from_yaml, phonemizer_config
    from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
    from ttscube_tpu_torch.models.cubegan import Cubegan
    from ttscube_tpu_torch.models.phonemizer import Phonemizer

    t0 = time.perf_counter()
    ckpt = REPO / "artifacts" / "drive_ckpt"
    enc = CubeganEncodings(str(ckpt / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(ckpt / "phonemizer.encodings"))
    speaker = next(iter(enc.speaker2int))
    pstate = init_random(Phonemizer(phonemizer_config(penc)), SEED + 1).state_dict()
    cfg = config_from_yaml({}, enc)  # serving defaults: fused tail, bf16 storage
    state = init_random(Cubegan(cfg), SEED).state_dict()
    cube = TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    cube.warmup(speaker=speaker)  # its default buckets: 256 and 512 frames, ~32 and ~64 chars
    warm_s = time.perf_counter() - t1
    warm_counts = read_counts()
    check(warm_counts == dict(fused_tail_stage=4, fused_mrf1=0, fused_tail_stage_mid=0,
                              fused_tail_stage_grad=0, fused_resblock1=0,
                              narrow_conv_blocked=0), f"warmup launches {warm_counts}")
    # the first request after warmup (its bucket, 256 frames, was warmed), then the same
    # request three more times
    lat = []
    for _ in range(4):
        t1 = time.perf_counter()
        cube(REQUESTS[0], speaker=speaker)
        lat.append((time.perf_counter() - t1) * 1e3)
    print(f"  TTSCube.warmup {warm_s:.3f} s (the kernels were built and loaded in the build "
          f"phase); request chars={len(REQUESTS[0])}: first after warmup ms={lat[0]:.1f}, "
          f"steady state (next 3) ms={', '.join(f'{v:.1f}' for v in lat[1:])}", flush=True)
    t1 = time.perf_counter()
    cube.warmup(speaker=speaker)
    print(f"  TTSCube.warmup again: {time.perf_counter() - t1:.3f} s", flush=True)
    # where a first request's time goes: another text length, first and second time
    for i in range(2):
        print_profile(f"request of a new text length, call {i + 1}",
                      *device_profile(lambda: cube("a new request.", speaker=speaker)))
    say("warmup", t0, warmup_s=f"{warm_s:.3f}", first_ms=f"{lat[0]:.1f}",
        steady_ms=f"{statistics.median(lat[1:]):.1f}", launches=warm_counts["fused_tail_stage"])

    # -- serve --------------------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    served = []
    for text in REQUESTS:
        total = cube.frames(text, speaker=speaker)  # the duration pass alone
        before = fused_tail.fused_tail_stage.launches
        t1 = time.perf_counter()
        pcm = cube(text, speaker=speaker)
        ms = (time.perf_counter() - t1) * 1e3
        check(fused_tail.fused_tail_stage.launches - before == 1,
              "fused_tail_stage did not launch once per request")
        check(pcm.dtype.name == "int16" and pcm.shape == (total * HOP,),
              f"served audio {pcm.dtype} {pcm.shape}, want int16 ({total * HOP},)")
        served.append(total)
        print(f"  request chars={len(text)} frames={total} samples={pcm.shape[0]} "
              f"ms={ms:.1f} peak={int(abs(pcm.astype('int32')).max())}", flush=True)
    serve_counts = read_counts()
    main_launches = serve_counts["fused_tail_stage"]
    check(serve_counts == dict(fused_tail_stage=len(REQUESTS), fused_mrf1=0,
                               fused_tail_stage_mid=0, fused_tail_stage_grad=0,
                               fused_resblock1=0, narrow_conv_blocked=0),
          f"launches for {len(REQUESTS)} requests: {serve_counts}")
    check(len(set(served)) == len(served), "the requests were meant to differ in length")

    # the same model in fp32 on the card and on the CPU: equal durations, equal audio
    cfg32 = config_from_yaml({"hifigan": {"storage_dtype": "float32"}}, enc)
    on_card = TTSCube.from_state_dicts(cfg32, enc, penc, state, pstate, device="cuda")
    on_cpu = TTSCube.from_state_dicts(cfg32, enc, penc, state, pstate, device="cpu")
    with no_tf32():
        a_card, n_card = on_card.synthesize(REQUESTS[0], speaker=speaker)
    a_cpu, n_cpu = on_cpu.synthesize(REQUESTS[0], speaker=speaker)
    check(n_card == n_cpu, f"durations differ: card {n_card} frames, CPU {n_cpu}")
    err = float(abs(a_card - a_cpu).max())
    print(f"  fp32 card vs cpu frames={n_card} max_abs_err={err:.3e} tol={TOL_FP32:.0e}",
          flush=True)
    check(err <= TOL_FP32, f"fp32 audio on the card differs from the CPU by {err:.3e}")
    say("serve", t0, requests=len(REQUESTS), launches=main_launches)

    # -- serve_wide -------------------------------------------------------------------
    t0 = time.perf_counter()
    wide_cfg = lambda **h: config_from_yaml({"hifigan": dict(h, fuse_channels=list(WIDE))}, enc)
    wide = TTSCube.from_state_dicts(wide_cfg(), enc, penc, state, pstate, device="cuda")
    wide("warm up.", speaker=speaker)
    torch.cuda.synchronize()
    zero_counts()
    per_request = dict(fused_tail_stage=1, fused_tail_stage_grad=0, fused_mrf1=2,
                       fused_tail_stage_mid=1, fused_resblock1=0, narrow_conv_blocked=0)
    for text, frames in zip(REQUESTS, served):
        before = read_counts()
        t1 = time.perf_counter()
        pcm = wide(text, speaker=speaker)
        ms = (time.perf_counter() - t1) * 1e3
        rise = {n: v - before[n] for n, v in read_counts().items()}
        check(rise == per_request, f"serve_wide: launches per request {rise}, want {per_request}")
        check(pcm.dtype.name == "int16" and pcm.shape == (frames * HOP,),
              f"served audio {pcm.dtype} {pcm.shape}, want int16 ({frames * HOP},)")
        print(f"  request chars={len(text)} frames={frames} samples={pcm.shape[0]} "
              f"ms={ms:.1f} peak={int(abs(pcm.astype('int32')).max())}", flush=True)
    wide_counts = read_counts()
    check(all(wide_counts[n] == len(REQUESTS) * k for n, k in per_request.items()),
          f"serve_wide launches {wide_counts}")
    # fp32 (TF32 off): the card against the CPU, end to end
    on_card = TTSCube.from_state_dicts(wide_cfg(storage_dtype="float32"), enc, penc, state,
                                       pstate, device="cuda")
    on_cpu = TTSCube.from_state_dicts(wide_cfg(storage_dtype="float32"), enc, penc, state,
                                      pstate, device="cpu")
    with no_tf32():
        a_card, n_card = on_card.synthesize(REQUESTS[0], speaker=speaker)
    a_cpu32, n_cpu = on_cpu.synthesize(REQUESTS[0], speaker=speaker)
    check(n_card == n_cpu, f"durations differ: card {n_card} frames, CPU {n_cpu}")
    err = float(abs(a_card - a_cpu32).max())
    print(f"  fp32 card vs cpu, every stage fused: frames={n_card} max_abs_err={err:.3e} "
          f"tol={TOL_FP32:.0e}", flush=True)
    check(err <= TOL_FP32, f"fp32 audio on the card differs from the CPU by {err:.3e}")
    # bf16 (served dtypes): each fused stage of one request, fed what the CPU's run of
    # the request gave it, against the CPU's stage. End to end the bf16 limits do not
    # apply: a flipped bf16 rounding grows through four fused stages (PERF.md), so the
    # audio's distance is printed beside its floor, not held to a fraction of it.
    cpu16 = TTSCube.from_state_dicts(wide_cfg(), enc, penc, state, pstate, device="cpu")
    with recorded_stages() as stages:
        a_cpu16, n_cpu16 = cpu16.synthesize(REQUESTS[0], speaker=speaker)
    a_card16, n_card16 = wide.synthesize(REQUESTS[0], speaker=speaker)
    check(n_card16 == n_cpu16 == n_cpu, "bf16 durations differ between card and CPU")
    check([n for n, _, _ in stages] == ["fused_mrf1", "fused_mrf1", "fused_tail_stage_mid",
                                        "fused_tail_stage"], f"fused stages {stages}")
    kernels = {"fused_mrf1": (fused_mrf.fused_mrf1, fused_mrf.fused_mrf_plain),
               "fused_tail_stage_mid": (fused_tail.fused_tail_stage_mid,
                                        fused_tail.fused_tail_stage_plain),
               "fused_tail_stage": (fused_tail.fused_tail_stage,
                                    fused_tail.fused_tail_stage_plain)}
    for i, (name, x, s16) in enumerate(stages):
        kernel, plain = kernels[name]
        s32 = cpu16.model.gen.stage_weights(i, None)
        with no_tf32(), torch.no_grad():
            want16, want32 = plain(x, s16), plain(x, s32)
            xd, s16d, s32d = x.to(dev), moved(s16, dev), moved(s32, dev)
            got16, got32, card_plain16 = kernel(xd, s16d), kernel(xd, s32d), plain(xd, s16d)
            torch.cuda.synchronize()
        bf16_check(f"serve_wide bf16 request stage {i} ({name}, input {tuple(x.shape)})",
                   distance(want16, want32), distance(got16, want16),
                   distance(got32, want16), distance(card_plain16, want16))
    floor = distance(torch.from_numpy(a_cpu16), torch.from_numpy(a_cpu32))
    end = distance(torch.from_numpy(a_card16), torch.from_numpy(a_cpu16))
    print(f"  bf16 request end to end, card vs cpu: max={end[0]:.3e} rms={end[1]:.3e}; "
          f"floor (cpu bf16 vs fp32) max={floor[0]:.3e} rms={floor[1]:.3e} "
          f"({end[0] / floor[0]:.3f}, {end[1] / floor[1]:.3f} of it)", flush=True)
    check(bool(np.isfinite(a_card16).all()), "serve_wide: non-finite bf16 audio")
    say("serve_wide", t0, requests=len(REQUESTS), launches_b3=wide_counts["fused_mrf1"],
        launches_b1_mid=wide_counts["fused_tail_stage_mid"],
        launches_b1=wide_counts["fused_tail_stage"])

    # -- serve_batch ----------------------------------------------------------------
    import copy
    import dataclasses

    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig

    t0 = time.perf_counter()
    bcfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=64, num_speakers=8, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(fused_tail=True, storage_dtype="bfloat16"))
    bmodel = init_random(tcg.Cubegan(bcfg), SEED + 6).to(dev).eval()
    batch_runs = {}
    for label, n_items, chunk in (("whole", BATCH, None), ("chunked", CHUNK_BATCH, CHUNK_FRAMES)):
        run = batch_runs[label] = serve_batches(bmodel, n_items, chunk, dev)
        windows = 1 if chunk is None else -(-BATCH_FRAMES // chunk)
        want = dict(fused_tail_stage=(1 + BATCH_CALLS) * windows, fused_mrf1=0,
                    fused_tail_stage_mid=0, fused_tail_stage_grad=0, fused_resblock1=0,
                    narrow_conv_blocked=0)
        check(run["counts"] == want, f"serve_batch {label} launches {run['counts']}, want {want}")
        X = batch_inputs(n_items, SEED + 30, dev)
        wall, busy, by_name, n_ev = device_profile(
            lambda: float(bmodel.infer(X, max_frames=BATCH_FRAMES, chunk_frames=chunk)[0]
                          .abs().mean()))
        run["busy_share"] = busy / wall if busy > 0 else None
        print(f"  serve_batch {label} B={n_items} frames={BATCH_FRAMES} chunk_frames={chunk}: "
              f"ms per batch {', '.join(f'{v:.1f}' for v in run['ms'])} (first: warm call), "
              f"median {run['median_ms']:.1f}; audio s per wall s {run['rate']:.1f}; "
              f"B1 launches {run['counts']['fused_tail_stage']} ({windows} per call)",
              flush=True)
        print_profile(f"serve_batch {label} B={n_items}", wall, busy, by_name, n_ev)
        del X
    # chunked against whole at CHECK_BATCH items, with the fused tail and with every
    # stage fused (B3 and B1-mid then meet the window edges too)
    X4 = batch_inputs(CHECK_BATCH, SEED + 40, dev)
    chunk_launches = {}
    for label, fuse in (("tail", (32,)), ("wide", WIDE)):
        models = []
        for storage in ("bfloat16", "float32"):
            h = dataclasses.replace(bcfg.hifigan, storage_dtype=storage, fuse_channels=fuse)
            m = tcg.Cubegan(dataclasses.replace(bcfg, hifigan=h)).to(dev).eval()
            m.load_state_dict(bmodel.state_dict())
            models.append(m)
        chunk_launches[label] = chunk_check(f"serve_batch check {label} B={CHECK_BATCH}",
                                            *models, X4, CHUNK_FRAMES)
    check(chunk_launches["wide"]["fused_mrf1"] > 0
          and chunk_launches["wide"]["fused_tail_stage_mid"] > 0
          and chunk_launches["tail"]["fused_tail_stage"] > 0,
          f"serve_batch checks: launches {chunk_launches}")
    del models, m, bmodel, X4
    torch.cuda.empty_cache()
    say("serve_batch", t0, ms_b128=f"{batch_runs['whole']['median_ms']:.1f}",
        ms_b256_chunked=f"{batch_runs['chunked']['median_ms']:.1f}",
        launches_b1=batch_runs["whole"]["counts"]["fused_tail_stage"]
        + batch_runs["chunked"]["counts"]["fused_tail_stage"])

    # -- train ----------------------------------------------------------------------
    t0 = time.perf_counter()
    tcfg = tcg.CubeganConfig(languasito=cfg.languasito,
                             hifigan=HifiganConfig(fused_tail_train=True))  # v1, fp32
    model0 = init_random(tcg.Cubegan(tcfg, train=True), SEED + 2)  # kept on the CPU
    state = tcg.create_train_state(copy.deepcopy(model0).to(dev), seed=SEED)
    batch_np = train_batch(enc, TRAIN_BATCH, seed=SEED + 3)
    tb = tcg.batch_to_torch(batch_np, dev)
    tops = ("lang", "gen", "mpd", "msd")
    firsts = {top: next(p for n, p in state.model.named_parameters()
                        if n.startswith(top + ".") and p.requires_grad) for top in tops}
    before = {top: p.detach().clone() for top, p in firsts.items()}
    torch.cuda.synchronize()
    zero_counts()
    step_ms = []
    for step in range(TRAIN_STEPS):
        b1, b2 = fused_tail.fused_tail_stage.launches, fused_tail.fused_tail_stage_grad.launches
        t1 = time.perf_counter()
        _, met = tcg.train_step(state, tb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        met = {k: v.item() for k, v in met.items()}
        check(all(math.isfinite(v) for v in met.values()), f"train step {step}: {met}")
        check((fused_tail.fused_tail_stage.launches - b1,
               fused_tail.fused_tail_stage_grad.launches - b2) == (1, 1),
              "train step: B1 and B2 did not launch once each")
        print(f"  train step {step} B={TRAIN_BATCH} ms={step_ms[-1]:.1f} "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(met.items())), flush=True)
    train_counts = read_counts()
    train_launches = (train_counts["fused_tail_stage"], train_counts["fused_tail_stage_grad"])
    check(train_counts == dict(fused_tail_stage=TRAIN_STEPS, fused_tail_stage_grad=TRAIN_STEPS,
                               fused_mrf1=0, fused_tail_stage_mid=0, fused_resblock1=0,
                               narrow_conv_blocked=0), f"train: launches {train_counts}")
    for top in tops:
        check(not torch.equal(firsts[top].detach(), before[top]), f"train: {top} did not move")
    say("train", t0, steps=TRAIN_STEPS, launches_b1=train_launches[0],
        launches_b2=train_launches[1], batch=TRAIN_BATCH,
        frames=int(batch_np["y_frame2phone"].shape[1]))

    # -- train_check ------------------------------------------------------------------
    t0 = time.perf_counter()
    small = train_batch(enc, 2, seed=SEED + 4)
    starts = torch.tensor([3, 7])
    runs = {}
    for where in ("cuda", "cpu"):
        st = tcg.create_train_state(copy.deepcopy(model0).to(where), seed=SEED)
        # fp32 in full: TF32 off on the card; on the CPU without oneDNN, whose fp32
        # conv backward is inexact (PERF.md)
        ctx = no_tf32() if where == "cuda" else torch.backends.mkldnn.flags(enabled=False)
        t1 = time.perf_counter()
        with ctx:
            _, met = tcg.train_step(st, tcg.batch_to_torch(small, where), starts=starts)
        runs[where] = ({k: v.item() for k, v in met.items()},
                       {n: p.detach().cpu() for n, p in st.model.named_parameters()},
                       (time.perf_counter() - t1) * 1e3)
    (m_card, p_card, ms_card), (m_cpu, p_cpu, ms_cpu) = runs["cuda"], runs["cpu"]
    worst_loss = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    lr = tcfg.lr
    worst_p, over, far, total = param_distance(p_card, p_cpu, lr)
    print(f"  one step B=2 card (B1, B2) vs CPU (plain): card_ms={ms_card:.1f} "
          f"cpu_ms={ms_cpu:.1f} max_rel_loss_diff={worst_loss:.3e} tol={TOL_LOSS:.0e} "
          f"params: max {worst_p / lr:.4f} lr, {over} beyond 2 lr + rounding, {far} of "
          f"{total} beyond 0.01 lr (limit 0.1 %)", flush=True)
    check(worst_loss <= TOL_LOSS, f"train_check: losses differ by {worst_loss:.3e} relative")
    check(over == 0 and far <= 1e-3 * total, "train_check: parameters differ")
    say("train_check", t0)

    # -- train_bf16 -------------------------------------------------------------------
    t0 = time.perf_counter()
    dtypes = lambda c, cd: dataclasses.replace(c, hifigan=dataclasses.replace(
        c.hifigan, compute_dtype=cd, fused_tail_train=False), disc_compute_dtype=cd)
    tcfg16 = dtypes(tcfg, "bfloat16")
    model16 = tcg.Cubegan(tcfg16, train=True)
    model16.load_state_dict(model0.state_dict())
    state16 = tcg.create_train_state(model16.to(dev), seed=SEED)
    firsts = {top: next(p for n, p in state16.model.named_parameters()
                        if n.startswith(top + ".") and p.requires_grad) for top in tops}
    before = {top: p.detach().clone() for top, p in firsts.items()}
    torch.cuda.synchronize()
    zero_counts()
    step16_ms = []
    for step in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        _, met = tcg.train_step(state16, tb)
        torch.cuda.synchronize()
        step16_ms.append((time.perf_counter() - t1) * 1e3)
        met = {k: v.item() for k, v in met.items()}
        check(all(math.isfinite(v) for v in met.values()), f"bf16 train step {step}: {met}")
        print(f"  train_bf16 step {step} B={TRAIN_BATCH} ms={step16_ms[-1]:.1f} "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(met.items())), flush=True)
    bf16_counts = read_counts()
    check(all(v == 0 for v in bf16_counts.values()), f"train_bf16 launches {bf16_counts}: "
          "the bf16 step runs no fused kernel")
    for top in tops:
        check(not torch.equal(firsts[top].detach(), before[top]), f"train_bf16: {top} did "
                                                                   "not move")
    moments = [v for opt in state16.optimizers.values() for st_ in opt.state.values()
               for v in st_.values() if isinstance(v, torch.Tensor) and v.dim() > 0]
    check(all(p.dtype == torch.float32 for p in state16.model.parameters()) and moments
          and all(v.dtype == torch.float32 for v in moments),
          "train_bf16: a parameter or an optimizer moment is not fp32")
    check(state16.model.gen.conv_pre.compute_dtype == state16.model.mpd.p2.conv_0.compute_dtype
          == state16.model.msd.s0.conv_0.compute_dtype == torch.bfloat16,
          "train_bf16: the convs do not run in bf16")
    wall, busy, by_name, n_ev = device_profile(lambda: tcg.train_step(state16, tb))
    print_profile(f"train_bf16 step B={TRAIN_BATCH}", wall, busy, by_name, n_ev)
    bf16_busy = busy / wall if busy > 0 else None
    print(f"  train step B={TRAIN_BATCH} host-clock median of steps 2-{TRAIN_STEPS}: bf16 "
          f"{statistics.median(step16_ms[1:]):.1f} ms, fp32 (fused tail, train phase) "
          f"{statistics.median(step_ms[1:]):.1f} ms; first bf16 step {step16_ms[0]:.1f} ms",
          flush=True)
    # one bf16 step on the card against the same step on the CPU (TF32 off: the text
    # model's fp32 matmuls in full), the floor the card's fp32 step against its bf16 step
    runs16 = {}
    for label, where, c in (("card bf16", "cuda", tcfg16), ("card fp32", "cuda",
                                                           dtypes(tcfg, "float32")),
                            ("cpu bf16", "cpu", tcfg16), ("witness", "cpu", tcfg16)):
        m = tcg.Cubegan(c, train=True)
        m.load_state_dict(model0.state_dict())
        st = tcg.create_train_state(m.to(where), seed=SEED)
        ctx = no_tf32() if where == "cuda" else torch.backends.mkldnn.flags(enabled=False)
        t1 = time.perf_counter()
        # the witness: the CPU's bf16 step with its convs summing in fp64
        with ctx, fp64_convs() if label == "witness" else contextlib.nullcontext():
            _, met = tcg.train_step(st, tcg.batch_to_torch(small, where), starts=starts)
        runs16[label] = ({k: v.item() for k, v in met.items()},
                         {n: p.detach().cpu() for n, p in st.model.named_parameters()},
                         (time.perf_counter() - t1) * 1e3,
                         torch.cat([p.grad.detach().cpu().reshape(-1)
                                    for p in st.model.parameters() if p.requires_grad]))
        del m, st
    ref = runs16["card fp32"][0]
    rel = {k: torch.tensor(relative_losses(v[0], ref), dtype=torch.float64)
           for k, v in runs16.items()}
    bf16_check("train_bf16 losses, card vs CPU (relative to the card's fp32 step)",
               distance(rel["card bf16"], rel["card fp32"]),
               distance(rel["card bf16"], rel["cpu bf16"]),
               distance(rel["card fp32"], rel["cpu bf16"]),
               distance(rel["witness"], rel["cpu bf16"]))
    # grads and parameters: a bf16 rounding that flips with the summation order changes
    # what every later layer rounds, so through the whole step's depth two right
    # implementations (the witness) sit about half the floor apart in the grads, and a
    # grad near zero takes either sign: printed beside the floor, not held to the bf16
    # limits; each parameter within 2 lr plus rounding of the CPU's (the first Adam step
    # moves it by about lr·sign(g))
    grads = {k: v[3] for k, v in runs16.items()}
    g_floor = distance(grads["card bf16"], grads["card fp32"])
    for name, (a, b) in (("port", ("card bf16", "cpu bf16")),
                         ("control", ("card fp32", "cpu bf16")),
                         ("witness", ("witness", "cpu bf16"))):
        d = distance(grads[a], grads[b])
        print(f"  train_bf16 grads {name}: max={d[0]:.3e} rms={d[1]:.3e} ({d[0] / g_floor[0]:.3f}, "
              f"{d[1] / g_floor[1]:.3f} of the floor max={g_floor[0]:.3e} rms={g_floor[1]:.3e})",
              flush=True)
    worst_p, over, far, total = param_distance(runs16["card bf16"][1], runs16["cpu bf16"][1], lr)
    _, _, f_far, _ = param_distance(runs16["card bf16"][1], runs16["card fp32"][1], lr)
    _, _, c_far, _ = param_distance(runs16["card fp32"][1], runs16["cpu bf16"][1], lr)
    _, _, w_far, _ = param_distance(runs16["witness"][1], runs16["cpu bf16"][1], lr)
    print(f"  train_bf16 one step B=2 card vs CPU: card_ms={runs16['card bf16'][2]:.1f} "
          f"cpu_ms={runs16['cpu bf16'][2]:.1f}; params max {worst_p / lr:.4f} lr, {over} beyond "
          f"2 lr + rounding; beyond 0.01 lr (stepped the other way) of {total}: port {far}, "
          f"floor {f_far}, control {c_far}, witness {w_far}", flush=True)
    check(over == 0, "train_bf16: parameters differ from the CPU's by more than 2 lr")
    del runs16, grads
    # each kind of conv of the bf16 step alone, at the step's widths: where the card's
    # cuDNN rounds against where the CPU's route rounds
    g = torch.Generator().manual_seed(SEED + 8)
    mods = state16.model
    for name, module, shape in (("gen.res_3_0.WNConv1d_0", mods.gen.res_3_0.WNConv1d_0,
                                 (2, 12000, 32)),
                                ("gen.up_1 (transposed)", mods.gen.up_1, (2, 750, 256)),
                                ("mpd.p2.conv_2 (WNConv2d)", mods.mpd.p2.conv_2,
                                 (2, 128, 667, 2)),
                                ("msd.s0.conv_3 (SNConv1d, groups 16)", mods.msd.s0.conv_3,
                                 (2, 3000, 256)),
                                ("msd.s1.conv_1 (groups 4)", mods.msd.s1.conv_1, (2, 6000, 128))):
        bf16_conv_check(name, module, torch.randn(shape, generator=g), dev)
    say("train_bf16", t0, steps=TRAIN_STEPS, median_ms=f"{statistics.median(step16_ms[1:]):.1f}",
        busy_share=f"{bf16_busy:.3f}" if bf16_busy else "not measured")

    # -- trainer ----------------------------------------------------------------------
    import os
    import shutil
    import tempfile

    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.scripts import train_cubegan
    from ttscube_tpu_torch.utils import checkpoint as ckpt
    from ttscube_tpu_torch.convert import read_msgpack
    from ttscube_tpu_torch.utils.serialization import msgpack_serialize

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    corpus = work / "corpus"
    write_corpus(corpus, list(enc.phon2int), TRAINER_UTTS, seed=SEED + 5)
    base = str(work / "out" / "cubegan")
    argv = ["--train-folder", str(corpus), "--dev-folder", str(corpus), "--output-base", base,
            "--batch-size", str(TRAINER_BATCH), "--max-steps", str(TRAINER_STEPS),
            "--max-epochs", "2", "--epoch-generation", "1", "--generation-limit", "2",
            "--fused-tail-train"]
    trainer_ms, rises = [], []
    real_step = tcg.train_step

    def counted_step(st, batch, starts=None):
        """The CLI's train step, timed (host clock to a synchronize) and its B1 and B2
        launches counted."""
        before = read_counts()
        t1 = time.perf_counter()
        out = real_step(st, batch, starts)
        torch.cuda.synchronize()
        trainer_ms.append((time.perf_counter() - t1) * 1e3)
        after = read_counts()
        rises.append(tuple(after[n] - before[n] for n in ("fused_tail_stage",
                                                         "fused_tail_stage_grad")))
        return out

    cwd = os.getcwd()
    tcg.train_step = counted_step
    os.chdir(work)  # the CLI synthesizes the devset into generated_files/free/ here
    try:
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        live = train_cubegan.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        trainer_counts = read_counts()
    finally:
        tcg.train_step = real_step
        os.chdir(cwd)
    val_b1 = trainer_counts["fused_tail_stage"] - TRAINER_STEPS
    print(f"  trainer CLI: {cli_s:.1f} s for {live.step} steps over 2 epochs (B="
          f"{TRAINER_BATCH}, {TRAINER_UTTS} utterances of 60-240 frames, fp32, fused tail "
          f"training), launches {trainer_counts} (B1 in validation: {val_b1})", flush=True)
    check(live.step == TRAINER_STEPS, f"trainer: {live.step} steps, want {TRAINER_STEPS}")
    check(rises == [(1, 1)] * TRAINER_STEPS, f"trainer: B1, B2 launches per step {rises}")
    check(trainer_counts["fused_tail_stage_grad"] == TRAINER_STEPS and val_b1 > 0
          and trainer_counts["fused_resblock1"] == trainer_counts["narrow_conv_blocked"]
          == trainer_counts["fused_mrf1"] == trainer_counts["fused_tail_stage_mid"] == 0,
          f"trainer launches {trainer_counts}")
    files = {ext: os.path.getsize(base + ext)
             for ext in (".best", ".last", ".opt.last", ".yaml", ".encodings")
             if os.path.exists(base + ext)}
    check(len(files) == 5, f"trainer: files written {sorted(files)}")
    wavs = sorted(os.listdir(work / "generated_files" / "free"))
    check(len(wavs) == 2, f"trainer: devset synthesis wrote {wavs}")
    trained = {k: v.detach().cpu().clone() for k, v in live.model.state_dict().items()}
    t1 = time.perf_counter()
    ckpt.save_train_state(str(work / "timed.opt.last"), live)
    save_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    resumed = train_cubegan.main(argv + ["--resume", "--max-epochs", "0"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    check(resumed.step == live.step and same_train_state(live, resumed),
          "trainer: --resume did not restore the step, parameters and moments bit-equal")
    # the next step from the resumed state against the next step from the live one
    ds = CubeganDataset(str(corpus))
    tenc = CubeganEncodings(base + ".encodings")
    nb = tcg.batch_to_torch(CubeganCollate(tenc)([ds[i] for i in range(TRAINER_BATCH)]), dev)
    with no_tf32():  # fp32 in full: under TF32 the D step's rounding moves the G losses
        _, m_live = tcg.train_step(live, nb)
        _, m_back = tcg.train_step(resumed, nb)
    worst_loss = max(abs(m_back[k].item() - v.item()) / abs(v.item()) for k, v in m_live.items())
    worst_p, over, far, total = param_distance(
        {n: p.detach().cpu() for n, p in resumed.model.named_parameters()},
        {n: p.detach().cpu() for n, p in live.model.named_parameters()}, live.model.config.lr)
    print(f"  trainer resume: step {resumed.step}, state bit-equal; next step resumed vs "
          f"live: max_rel_loss_diff={worst_loss:.3e} tol={TOL_LOSS:.0e}, params max "
          f"{worst_p / live.model.config.lr:.4f} lr, {over} beyond 2 lr + rounding, {far} of "
          f"{total} beyond 0.01 lr", flush=True)
    check(worst_loss <= TOL_LOSS and over == 0 and far <= 1e-3 * total,
          "trainer: the resumed state's next step differs from the live one's")
    del live, resumed, nb
    # serve the saved weights from files on the card (C5), against the same weights
    # built from state dicts
    tree = read_msgpack(base + ".last")
    with open(base + ".model", "wb") as f:  # as scripts/export_model.py slims `.last`
        f.write(msgpack_serialize({k: tree[k] for k in ("lang", "gen")}))
    pbase = str(work / "out" / "phonemizer")
    pmodel = init_random(Phonemizer(phonemizer_config(penc)), SEED + 1)
    ckpt.save_params(pbase + ".model", pmodel)
    penc.save(pbase + ".encodings")
    files[".model"] = os.path.getsize(base + ".model")
    t1 = time.perf_counter()
    from_files = TTSCube(base, pbase)  # the card: the default device
    load_s = time.perf_counter() - t1
    scfg = config_from_yaml(ckpt.load_config(base), tenc)
    sstate = Cubegan(scfg).state_dict()
    check(all(k in trained for k in sstate if k.startswith(("lang.", "gen."))),
          "trainer: the serving model's weights are not all in the trained model")
    sstate.update({k: trained[k] for k in sstate if k in trained})
    from_sd = TTSCube.from_state_dicts(scfg, tenc, penc, sstate, pmodel.state_dict(),
                                       device="cuda")
    zero_counts()
    a_files, n_files = from_files.synthesize(REQUESTS[0], speaker="spk0")
    served_b1 = read_counts()["fused_tail_stage"]
    a_sd, n_sd = from_sd.synthesize(REQUESTS[0], speaker="spk0")
    err = float(abs(a_files - a_sd).max())
    print(f"  trainer serve from files: TTSCube(model_path, phonemizer_path) on "
          f"{from_files.device} in {load_s:.2f} s; frames={n_files} B1 launches={served_b1} "
          f"max_abs_err vs from_state_dicts={err:.3e} tol={TOL_FP32:.0e}", flush=True)
    check(from_files.device.type == "cuda" and served_b1 == 1 and n_files == n_sd
          and err <= TOL_FP32 and bool(np.isfinite(a_files).all()),
          "trainer: serving from the saved files differs from the same weights")
    print(f"  trainer step ms (host clock to a synchronize): "
          f"{', '.join(f'{v:.1f}' for v in trainer_ms)}; .opt.last save {save_s:.2f} s, "
          f"CLI --resume {resume_s:.2f} s; files (bytes): "
          + ", ".join(f"{k} {v}" for k, v in files.items()), flush=True)
    del from_files, from_sd
    # the CLI in bf16 (no fused tail): two steps and a save, --resume, and the next step
    # from the live state and from the resumed one, under deterministic algorithms
    base16 = str(work / "out16" / "cubegan")
    argv16 = ["--train-folder", str(corpus), "--dev-folder", str(corpus), "--output-base",
              base16, "--batch-size", str(TRAINER_BATCH), "--max-steps", "2", "--max-epochs",
              "1", "--epoch-generation", "0", "--compute-dtype", "bfloat16"]
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    live16 = train_cubegan.main(argv16)
    torch.cuda.synchronize()
    cli16_s = time.perf_counter() - t1
    trainer16_counts = read_counts()
    check(live16.step == 2 and all(v == 0 for v in trainer16_counts.values())
          and os.path.exists(base16 + ".opt.last"),
          f"bf16 trainer: step {live16.step}, launches {trainer16_counts}")
    check(live16.model.config.hifigan.compute_dtype == live16.model.config.disc_compute_dtype
          == "bfloat16" and all(p.dtype == torch.float32 for p in live16.model.parameters()),
          "bf16 trainer: the config or the parameters' type")
    resumed16 = train_cubegan.main(argv16 + ["--resume", "--max-epochs", "0"])
    check(resumed16.step == 2 and same_train_state(live16, resumed16),
          "bf16 trainer: --resume did not restore the state bit-equal")
    nb16 = tcg.batch_to_torch(CubeganCollate(CubeganEncodings(base16 + ".encodings"))(
        [ds[i] for i in range(TRAINER_BATCH)]), dev)
    with deterministic():
        _, m_live = tcg.train_step(live16, nb16)
        _, m_back = tcg.train_step(resumed16, nb16)
    equal = (all(torch.equal(v, m_back[k]) for k, v in m_live.items())
             and same_train_state(live16, resumed16))
    print(f"  bf16 trainer CLI (--compute-dtype bfloat16): {cli16_s:.1f} s for 2 steps, launches "
          f"{trainer16_counts}; --resume bit-equal; next step from both bit-equal: {equal}",
          flush=True)
    check(equal, "bf16 trainer: the resumed state's next step differs from the live one's")
    del live16, resumed16, nb16
    shutil.rmtree(work)
    say("trainer", t0, steps=TRAINER_STEPS, launches_b1=trainer_counts["fused_tail_stage"],
        launches_b2=trainer_counts["fused_tail_stage_grad"], bf16_steps=2)

    # -- generator_resblock2 ------------------------------------------------------------
    t0 = time.perf_counter()
    gen2 = init_random(Generator(HifiganConfig(**V3_BLOCKS)), SEED + 7).eval()
    mel = torch.randn(1, 64, 80, generator=torch.Generator().manual_seed(64))
    with torch.no_grad():
        want = gen2(mel)
        gen2.to(dev)
        with no_tf32(), deterministic():  # cuDNN's transposed convs, see chunk_check
            got, again = gen2(mel.to(dev)), gen2(mel.to(dev))
        torch.cuda.synchronize()
    check(got.shape == want.shape == (1, 64 * HOP) and bool(torch.isfinite(got).all())
          and torch.equal(got, again), f"generator_resblock2: {tuple(got.shape)}, finite, "
                                       "relaunch")
    err = distance(got, want)[0]
    print(f"  ResBlock2 Generator (v1 widths, kernels {V3_BLOCKS['resblock_kernel_sizes']}, "
          f"dilations {V3_BLOCKS['resblock_dilation_sizes']}) fp32 card vs CPU F=64 "
          f"max_abs_err={err:.3e} tol={TOL_FP32:.0e} peak={float(want.abs().max()):.3f}",
          flush=True)
    check(err <= TOL_FP32, f"generator_resblock2: card differs from the CPU by {err:.3e}")
    del gen2
    say("generator_resblock2", t0)

    # -- times --------------------------------------------------------------------
    t0 = time.perf_counter()
    print(f"  (each time: the median of readings over {TIME_PER} launches in a row)",
          flush=True)
    b1_rows = {}
    # both forms at the serving shape and at the training shape (where the main path
    # launches fp32 only)
    serve_z, train_z = tail_input(1, 256, seed=256, device=dev), train_input(dev)
    train_shape = f"B={TRAIN_BATCH} T_in={TRAIN_T_IN}"
    for shape, z, mode, w in (("B=1 F=256", serve_z, "bf16", w16),
                              ("B=1 F=256", serve_z, "fp32", w32),
                              (train_shape, train_z, "bf16", w16),
                              (train_shape, train_z, "fp32", w32)):
        kernel = lambda: fused_tail.fused_tail_stage(z, w)
        plain = lambda: fused_tail.fused_tail_stage_plain(z, w)
        # in turns (plain, kernel, kernel, plain) so that clock drift hits both alike;
        # bf16 under the default TF32 settings, as served; fp32 in full fp32
        with no_tf32() if mode == "fp32" else contextlib.nullcontext():
            p1, k1, k2, p2 = (cuda_times(f, 15, TIME_PER) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        flops = fused_tail.tail_flops(z.shape[0], z.shape[1], z.shape[2],
                                      w.kernel_sizes, w.dilations)
        # each input read once, the output written once: z, the packed weights, audio
        nbytes = 4 * (z.numel() + z.shape[0] * z.shape[1] * 4
                      + sum(t.numel() for t in w[:6]))
        row = b1_rows[(mode, shape)] = dict(ms=ms, plain_ms=plain_ms,
                                            **bound(flops, nbytes, mode))
        print(f"  fused_tail_stage {mode} {shape} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) achieved={flops / ms / 1e9:.2f} TFLOP/s = "
              f"{row['bound_ms'] / ms:.3f} of the bound library_ms=none (no single PyTorch "
              f"call computes this stage)", flush=True)
    # B1 bf16 at serve_batch's shapes, as served (default TF32): the whole batch and one
    # chunked window; fewer readings, as one launch takes tens of ms
    for shape, batch, frames in (("B=128 F=512", BATCH, BATCH_FRAMES),
                                 ("B=256 W=320", CHUNK_BATCH, CHUNK_FRAMES + 64)):
        z = tail_input(batch, frames, seed=frames, device=dev)
        kernel = lambda: fused_tail.fused_tail_stage(z, w16)
        plain = lambda: fused_tail.fused_tail_stage_plain(z, w16)
        p1, k1, k2, p2 = (cuda_times(f, 3, 2) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        flops = fused_tail.tail_flops(batch, z.shape[1], 64, w16.kernel_sizes, w16.dilations)
        nbytes = 4 * (z.numel() + batch * z.shape[1] * 4 + sum(t.numel() for t in w16[:6]))
        row = b1_rows[("bf16", shape)] = dict(ms=ms, plain_ms=plain_ms,
                                              **bound(flops, nbytes, "bf16"))
        print(f"  fused_tail_stage bf16 {shape} (z {tuple(z.shape)}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} ({plain_ms / ms:.2f}x the kernel's time) "
              f"bound_ms={row['bound_ms']:.4f} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) "
              f"achieved={flops / ms / 1e9:.2f} TFLOP/s = {row['bound_ms'] / ms:.3f} of the "
              f"bound library_ms=none", flush=True)
        del z
    torch.cuda.empty_cache()
    # B2 at the training shape: the kernel (with its wrapper's packing and sums) against
    # the plain version's autograd backward (its forward's graph kept, not timed)
    leaves, dy = tail_leaves(gen, TRAIN_BATCH, 3000, seed=3000, device=dev)
    z, *raw = leaves
    w = fused_tail.pack_tail_weights(raw[0], raw[1], raw[4:22], raw[22:], raw[2], raw[3],
                                     kernel_sizes=gen.config.resblock_kernel_sizes,
                                     dilations=gen.config.resblock_dilation_sizes)
    packed = w._replace(**{f: getattr(w, f).detach().contiguous().requires_grad_()
                           for f in ("wup", "bup", "wmrf", "bmrf", "wpost", "bpost")})
    zd = z.detach().contiguous()
    with no_tf32():
        out = fused_tail.fused_tail_stage_plain(zd.requires_grad_(), packed)
        plain_in = [zd, *packed[:6]]
        kernel = lambda: fused_tail.fused_tail_stage_grad(z.detach(), w, dy)
        plain = lambda: torch.autograd.grad(out, plain_in, dy, retain_graph=True)
        p1, k1, k2, p2 = (cuda_times(f, 15, TIME_PER) for f in (plain, kernel, kernel, plain))
    del out
    flops = fused_tail.tail_grad_flops(TRAIN_BATCH, 3000, 64, w.kernel_sizes, w.dilations)
    # inputs read once (z, dy, the packed weights), outputs written once (dz, the grads)
    nbytes = 4 * (2 * z.numel() + dy.numel() + 2 * sum(t.numel() for t in w[:6]))
    # the bound is 3xTF32's, the kernel's route; the fp32 CUDA cores' beside it
    t_fp32 = flops / PEAK_FP32 * 1e3
    grad_row = dict(ms=statistics.median(k1 + k2), plain_ms=statistics.median(p1 + p2),
                    **bound(flops, nbytes, "fp32"),
                    fp32_cores_bound_ms=max(t_fp32, nbytes / PEAK_BYTES * 1e3))
    print(f"  fused_tail_stage_grad fp32 B={TRAIN_BATCH} T_in=3000 ms={grad_row['ms']:.4f} "
          f"plain_backward_ms={grad_row['plain_ms']:.4f} bound_ms={grad_row['bound_ms']:.4f} "
          f"(3xTF32 on the tensor cores, the kernel's route; fp32 CUDA cores {t_fp32:.4f}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) achieved="
          f"{flops / grad_row['ms'] / 1e9:.2f} TFLOP/s = {grad_row['bound_ms'] / grad_row['ms']:.3f} "
          f"of the 3xTF32 bound, {grad_row['fp32_cores_bound_ms'] / grad_row['ms']:.3f} of the "
          f"fp32 cores' library_ms=none (no single PyTorch call computes the stage VJP)",
          flush=True)
    # where B2's time goes: thread block 0's clocks in each phase of its tiles, and in
    # the MMA phases the clocks per mma.sync of each of the SM's 4 schedulers
    clocks = torch.zeros(fused_tail.GRAD_LIMITS["n_phases"], dtype=torch.int64, device=dev)
    fused_tail.fused_tail_stage_grad(z.detach(), w, dy, phase_clocks=clocks)
    torch.cuda.synchronize()
    clocks = clocks.tolist()
    tiles0 = len(range(0, TRAIN_BATCH * -(-12000 // 256), fused_tail.GRAD_BLOCKS))
    mma = fused_tail.tail_grad_mma_counts(w.kernel_sizes, w.dilations)
    print(f"  fused_tail_stage_grad phases (block 0, {tiles0} tiles, {sum(clocks)} clocks): "
          + "; ".join(f"{name} {c} ({c / sum(clocks):.3f}" + (
              f", {c / (tiles0 * mma[name] / 4):.1f} clocks per MMA per scheduler)"
              if name in mma else ")") for name, c in zip(fused_tail.GRAD_PHASES, clocks)),
          flush=True)
    # B3 at the shapes of v1's stages 0 and 1, B1-mid at stage 2's, for a request of 256
    # frames: the kernel against its plain version, in turns, bf16 under the default
    # TF32 settings (as served), fp32 in full fp32; bounds from this run's shapes, fp32
    # by its fastest fp32-accurate route
    stage_rows = {}
    for label, i, t_len, c_in in (("fused_mrf1 stage0", 0, 1280, 256),
                                  ("fused_mrf1 stage1", 1, 3840, 128),
                                  ("fused_tail_stage_mid stage2", 2, 3840, 128)):
        g = torch.Generator().manual_seed(t_len)
        x = torch.randn(1, t_len, c_in, generator=g).to(dev)
        for mode, cd in (("bf16", torch.bfloat16), ("fp32", None)):
            w = gen.stage_weights(i, cd)
            if i < 2:
                kernel = lambda: fused_mrf.fused_mrf1(x, w)
                plain = lambda: fused_mrf.fused_mrf_plain(x, w)
                flops = fused_mrf.mrf_flops(1, t_len, c_in, w.kernel_sizes, w.dilations)
                n_out, n_w = x.numel(), w.w.numel() + w.b.numel()
            else:
                kernel = lambda: fused_tail.fused_tail_stage_mid(x, w)
                plain = lambda: fused_tail.fused_tail_stage_plain(x, w)
                C = w.wup.shape[2]
                flops = fused_tail.tail_flops(1, t_len, c_in, w.kernel_sizes, w.dilations,
                                              channels=C, with_post=False)
                n_out = 4 * t_len * C
                n_w = sum(t.numel() for t in (w.wup, w.bup, w.wmrf, w.bmrf))
            with no_tf32() if cd is None else contextlib.nullcontext():
                p1, k1, k2, p2 = (cuda_times(f, 10, TIME_PER)
                                  for f in (plain, kernel, kernel, plain))
            ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
            # each input read once, the output written once: x, the packed weights, out
            nbytes = 4 * (x.numel() + n_out + n_w)
            row = stage_rows[(label, mode)] = dict(ms=ms, plain_ms=plain_ms,
                                                   **bound(flops, nbytes, mode))
            print(f"  {label} {mode} B=1 T={t_len} C_in={c_in} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) achieved="
                  f"{flops / ms / 1e9:.2f} TFLOP/s library_ms=none (no single PyTorch call "
                  f"computes this stage)", flush=True)
    # B4 at v1's stage 3 (one ResBlock1 of the k = 11 chain at 256 frames), B5 at the
    # shape of the TPU kernel's docstring: each kernel against its plain version, in
    # turns; B5 also against F.conv1d (cuDNN) on the same values laid out (B, C, T),
    # its library yardstick; bf16 under the default TF32 settings, fp32 in full fp32
    a = resblock_args(gen, 3, 2, dev)
    x = torch.randn(1, 61440, 32, generator=torch.Generator().manual_seed(61440)).to(dev)
    res_rows = {}
    for mode, cd in (("bf16", torch.bfloat16), ("fp32", None)):
        kernel = lambda: fused_resblock.fused_resblock1(x, **a, compute_dtype=cd)
        plain = lambda: fused_resblock.fused_resblock1_plain(x, **a, compute_dtype=cd)
        with no_tf32() if cd is None else contextlib.nullcontext():
            p1, k1, k2, p2 = (cuda_times(f, 10, TIME_PER) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        flops = fused_resblock.resblock_flops(1, 61440, 32, a["kernel_size"], a["dilations"])
        nbytes = 4 * (2 * x.numel() + sum(t.numel() for t in a["kernels"] + a["biases"]))
        row = res_rows[mode] = dict(ms=ms, plain_ms=plain_ms, **bound(flops, nbytes, mode))
        print(f"  fused_resblock1 {mode} B=1 T=61440 C=32 k=11 ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={row['bound_ms']:.4f} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) achieved={flops / ms / 1e9:.2f} TFLOP/s library_ms=none "
              f"(no single PyTorch call computes a ResBlock1)", flush=True)
    B5, T5, C5, K5 = 8, 122880, 32, 11
    g = torch.Generator().manual_seed(T5)
    x32 = torch.randn(B5, T5, C5, generator=g).to(dev)
    w32c = (torch.randn(K5, C5, C5, generator=g) / math.sqrt(K5 * C5)).to(dev)
    conv_rows = {}
    for mode, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xx, ww = x32.to(dt), w32c.to(dt)
        x_nct, w_oik = xx.transpose(1, 2).contiguous(), ww.permute(2, 1, 0).contiguous()
        kernel = lambda: narrow_conv.narrow_conv_blocked(xx, ww)
        plain = lambda: narrow_conv.narrow_conv_plain(xx, ww)
        library = lambda: torch.nn.functional.conv1d(x_nct, w_oik, padding=(K5 - 1) // 2)
        with no_tf32() if mode == "fp32" else contextlib.nullcontext():
            p1, l1, k1, k2, l2, p2 = (cuda_times(f, 10, TIME_PER) for f in
                                      (plain, library, kernel, kernel, library, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        library_ms = statistics.median(l1 + l2)
        flops = narrow_conv.narrow_conv_flops(B5, T5, C5, K5)
        # x and w read once in their own type, the fp32 output written once
        nbytes = xx.element_size() * (xx.numel() + ww.numel()) + 4 * xx.numel()
        row = conv_rows[mode] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                     **bound(flops, nbytes, mode))
        print(f"  narrow_conv {mode} B={B5} T={T5} C={C5} k={K5} ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={library_ms:.4f} (F.conv1d, {mode}) bound_ms="
              f"{row['bound_ms']:.4f} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
              f"achieved={flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s = "
              f"{row['bound_ms'] / ms:.3f} of the bound", flush=True)
    del x32, w32c, xx, ww, x_nct, w_oik
    print(f"  train step B={TRAIN_BATCH} median_ms={statistics.median(step_ms[1:]):.1f} "
          f"(steps 2-{TRAIN_STEPS}, host clock, default TF32) first_ms={step_ms[0]:.1f}",
          flush=True)
    say("times", t0)

    # -- profile ------------------------------------------------------------------
    t0 = time.perf_counter()
    prof = device_profile(lambda: cube(REQUESTS[1], speaker=speaker))
    print_profile(f"request frames={served[1]}", *prof)
    prof = device_profile(lambda: wide(REQUESTS[1], speaker=speaker))
    print_profile(f"request frames={served[1]}, every stage fused", *prof)
    prof = device_profile(lambda: tcg.train_step(state, tb))
    print_profile(f"train step B={TRAIN_BATCH}", *prof)
    say("profile", t0)

    # launches on the main paths (warmup, serve, serve_wide, serve_batch whole and
    # chunked, train, train_bf16, trainer in fp32 and in bf16), each counted from zero
    # just before its path ran
    paths = (warm_counts, serve_counts, wide_counts, batch_runs["whole"]["counts"],
             batch_runs["chunked"]["counts"], train_counts, bf16_counts, trainer_counts,
             trainer16_counts)
    main_counts = {n: sum(c[n] for c in paths) for n in serve_counts}
    print(f"  main-path launches: {main_counts}; launches in the kernel phases: "
          f"{phase_launches}", flush=True)
    print(json.dumps({"kernels": [*[{
        "name": f"fused_tail_stage[{mode} {shape}]", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:295",
        "launches": main_counts["fused_tail_stage"],
        "max_abs_err": errs[err_key], **b1_rows[(mode, shape)], "library_ms": None}
        for mode, shape, err_key in (
            ("bf16", "B=1 F=256", ("bf16", 1, 256)),
            ("bf16", "B=128 F=512", ("bf16", BATCH, BATCH_FRAMES)),
            ("bf16", "B=256 W=320", ("bf16", CHUNK_BATCH, CHUNK_FRAMES + 64)),
            ("fp32", f"B={TRAIN_BATCH} T_in={TRAIN_T_IN}", ("fp32", TRAIN_BATCH, "train")))], {
        "name": "fused_tail_stage_grad", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage_grad.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:664",
        "launches": main_counts["fused_tail_stage_grad"],
        "max_abs_err": max(v for k, v in grad_errs.items() if k[1] == 3000),
        **grad_row, "library_ms": None}, {
        "name": "fused_mrf1", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_mrf_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:754",
        "launches": main_counts["fused_mrf1"],
        "max_abs_err": mrf_errs["stage0"][1],
        **stage_rows[("fused_mrf1 stage0", "bf16")], "library_ms": None}, {
        "name": "fused_tail_stage_mid", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_mrf_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:295",
        "launches": main_counts["fused_tail_stage_mid"],
        "max_abs_err": mid_errs["stage2"][1],
        **stage_rows[("fused_tail_stage_mid stage2", "bf16")], "library_ms": None}, {
        "name": "fused_resblock1", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_mrf_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:110",
        "launches": main_counts["fused_resblock1"],
        "phase_launches": phase_launches["fused_resblock1"],
        "max_abs_err": res_errs["stage3"][1], **res_rows["bf16"], "library_ms": None}, *[{
        "name": f"narrow_conv_blocked[{mode}]", "route": "cuda", "operands": mode,
        "source": "ttscube_tpu_torch/csrc/narrow_conv.cu",
        "replaces": "ttscube_tpu/ops/pallas_conv.py:46",
        "launches": main_counts["narrow_conv_blocked"],
        "phase_launches": phase_launches["narrow_conv_blocked"],
        "max_abs_err": conv_errs[("docstring", mode)], **conv_rows[mode]}
        for mode in ("fp32", "bf16")]]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
