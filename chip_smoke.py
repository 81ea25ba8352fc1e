#!/usr/bin/env python3
"""Drive the PyTorch port (`ttscube_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as it ends:
  device      the card (nvidia-smi name and power limit) and the CUDA version
  build       the kernel sources ttscube_tpu_torch/csrc/fused_tail_stage{,_grad}.cu, by
              plain nvcc, in parallel, with each one's ptxas register and spill line
  kernel      B1 (the fused tail stage) against its plain PyTorch version at serving
              shapes, fp32 (TF32 off) and bf16 (limits below), raising on a miss
  kernel_grad B2 (the tail stage's backward) against autograd through the plain
              version, fp32 (TF32 off): at the training shape for four seeds, and at a
              ragged one on all blocks and on 3; two launches must give bit-equal grads
  serve       TTSCube at the full Cubegan v1 width from seeded random weights answers three
              requests; the B1 launch counter must rise by one per request; one more
              request in fp32 (TF32 off) must match the same model run on the CPU
  train       train_step at the full v1 width (fp32, fused_tail_train) on a batch of 16
              utterances built by CubeganCollate, five steps: finite losses, every
              partition moves, B1 and B2 launch once per step
  train_check one step on the card (TF32 off) against the same step on the CPU
  times       B1's and B2's median times beside their plain versions and bounds, and
              the train step's median
  profile     one served request and one train step under torch.profiler: device-busy
              share, top kernels

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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

TOL_FP32 = 5e-5   # the repo's audio tolerance (tests/test_composed_parity.py)
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


def cuda_times(fn, reps: int) -> list:
    """Milliseconds of `fn` on the card, one pair of CUDA events per call, after 3
    warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


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


def main() -> int:
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
    from ttscube_tpu_torch.ops import _build, fused_tail

    t0 = time.perf_counter()
    sources = (fused_tail.KERNEL_SOURCE, fused_tail.GRAD_KERNEL_SOURCE)
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
            want32, want16 = (fused_tail.fused_tail_stage_plain(z, w) for w in (w32, w16))
            torch.cuda.synchronize()
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
            floor = distance(want16, want32)
            err = distance(got16, want16)
            ctl = distance(got32, want16)
            wit = distance(fused_tail.fused_tail_stage_plain(
                z.cpu(), w16._replace(**{f: getattr(w16, f).cpu() for f in
                                         ("wup", "bup", "wmrf", "bmrf", "wpost", "bpost")})),
                want16)
            errs[("bf16", batch, frames)] = err[0]
            within = lambda d: d[1] <= BF16_RMS * floor[1] and d[0] <= BF16_MAX * floor[0]
            print(f"  fused_tail_stage bf16 {case} limit: max<={BF16_MAX * floor[0]:.3e} "
                  f"rms<={BF16_RMS * floor[1]:.3e}", flush=True)
            for name, d in (("floor", floor), ("kernel", err), ("control", ctl),
                            ("witness", wit)):
                print(f"  fused_tail_stage bf16 {case} {name}: max={d[0]:.3e} "
                      f"rms={d[1]:.3e} ({d[0] / floor[0]:.3f}, {d[1] / floor[1]:.3f} of "
                      f"the floor)", flush=True)
            check(floor[0] > 1e-4, "bf16 operands did not move the plain version")
            check(within(err), f"fused_tail_stage bf16 {case}: {err} is not within "
                               f"{BF16_RMS} (RMS) and {BF16_MAX} (max) of the floor {floor}")
            check(not within(ctl), f"fused_tail_stage bf16 {case}: the fp32 control passed")
            check(within(wit), f"bf16 {case}: the limits are tighter than summation order "
                               f"alone allows (witness {wit})")
    say("kernel", t0, checks=len(errs))

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

    # -- serve --------------------------------------------------------------------
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
    cube("warm up.", speaker=speaker)  # first-call set-up (cuDNN handles, kernel load)
    torch.cuda.synchronize()
    fused_tail.fused_tail_stage.launches = 0
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
    main_launches = fused_tail.fused_tail_stage.launches
    check(main_launches == len(REQUESTS),
          f"fused_tail_stage launched {main_launches} times for {len(REQUESTS)} requests")
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

    # -- train ----------------------------------------------------------------------
    import copy

    from ttscube_tpu_torch.models import cubegan as tcg

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
    fused_tail.fused_tail_stage.launches = fused_tail.fused_tail_stage_grad.launches = 0
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
    train_launches = (fused_tail.fused_tail_stage.launches,
                      fused_tail.fused_tail_stage_grad.launches)
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

    # -- times --------------------------------------------------------------------
    t0 = time.perf_counter()
    z = tail_input(1, 256, seed=256, device=dev)
    rows = []
    for mode, w, peak in (("bf16", w16, PEAK_BF16), ("fp32", w32, PEAK_FP32)):
        kernel = lambda: fused_tail.fused_tail_stage(z, w)
        plain = lambda: fused_tail.fused_tail_stage_plain(z, w)
        # in turns (plain, kernel, kernel, plain) so that clock drift hits both alike;
        # bf16 under the default TF32 settings, as served; fp32 in full fp32
        with no_tf32() if w is w32 else contextlib.nullcontext():
            p1, k1, k2, p2 = (cuda_times(f, 25) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        flops = fused_tail.tail_flops(z.shape[0], z.shape[1], z.shape[2],
                                      w.kernel_sizes, w.dilations)
        # each input read once, the output written once: z, the packed weights, audio
        nbytes = 4 * (z.numel() + z.shape[0] * z.shape[1] * 4
                      + sum(t.numel() for t in w[:6]))
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        rows.append(dict(mode=mode, ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes"))
        print(f"  fused_tail_stage {mode} B=1 F=256 ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={max(t_ops, t_bytes):.4f} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) achieved={flops / ms / 1e9:.2f} TFLOP/s "
              f"library_ms=none (no single PyTorch call computes this stage)", flush=True)
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
        p1, k1, k2, p2 = (cuda_times(f, 25) for f in (plain, kernel, kernel, plain))
    del out
    flops = fused_tail.tail_grad_flops(TRAIN_BATCH, 3000, 64, w.kernel_sizes, w.dilations)
    # inputs read once (z, dy, the packed weights), outputs written once (dz, the grads)
    nbytes = 4 * (2 * z.numel() + dy.numel() + 2 * sum(t.numel() for t in w[:6]))
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    grad_row = dict(ms=statistics.median(k1 + k2), plain_ms=statistics.median(p1 + p2),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"  fused_tail_stage_grad fp32 B={TRAIN_BATCH} T_in=3000 ms={grad_row['ms']:.4f} "
          f"plain_backward_ms={grad_row['plain_ms']:.4f} bound_ms={grad_row['bound_ms']:.4f} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) achieved="
          f"{flops / grad_row['ms'] / 1e9:.2f} TFLOP/s library_ms=none (no single PyTorch "
          f"call computes the stage VJP)", flush=True)
    print(f"  train step B={TRAIN_BATCH} median_ms={statistics.median(step_ms[1:]):.1f} "
          f"(steps 2-{TRAIN_STEPS}, host clock, default TF32) first_ms={step_ms[0]:.1f}",
          flush=True)
    say("times", t0)

    # -- profile ------------------------------------------------------------------
    t0 = time.perf_counter()
    prof = device_profile(lambda: cube(REQUESTS[1], speaker=speaker))
    print_profile(f"request frames={served[1]}", *prof)
    prof = device_profile(lambda: tcg.train_step(state, tb))
    print_profile(f"train step B={TRAIN_BATCH}", *prof)
    say("profile", t0)

    serving = rows[0]
    print(json.dumps({"kernels": [{
        "name": "fused_tail_stage", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:295",
        "launches": main_launches + train_launches[0],
        "max_abs_err": errs[("bf16", 1, 256)],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": None}, {
        "name": "fused_tail_stage_grad", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage_grad.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:664",
        "launches": train_launches[1],
        "max_abs_err": max(v for k, v in grad_errs.items() if k[1] == 3000),
        "ms": grad_row["ms"], "plain_ms": grad_row["plain_ms"],
        "bound_ms": grad_row["bound_ms"], "bound_by": grad_row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
