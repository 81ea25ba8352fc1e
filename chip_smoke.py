#!/usr/bin/env python3
"""Drive the PyTorch port (`ttscube_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as it ends:
  device      the card (nvidia-smi name and power limit) and the CUDA version
  build       the kernel sources ttscube_tpu_torch/csrc/{fused_tail_stage,
              fused_tail_stage_grad,fused_mrf_stage,narrow_conv}.cu, by plain nvcc, in
              parallel, with each one's ptxas register and spill line
  kernel      B1 (the fused tail stage) against its plain PyTorch version at serving
              shapes, fp32 (TF32 off) and bf16 (limits below), raising on a miss
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
  serve       TTSCube at the full Cubegan v1 width from seeded random weights answers three
              requests; the B1 launch counter must rise by one per request; one more
              request in fp32 (TF32 off) must match the same model run on the CPU
  serve_wide  the same with every generator stage fused (fuse_channels 256, 128, 64, 32):
              per request B3 launches twice, B1-mid and B1 once; an fp32 request (TF32
              off) must match the CPU; in a bf16 request each fused stage, fed what the
              CPU's run of that request gave it, must meet the bf16 limits against the
              CPU's stage
  train       train_step at the full v1 width (fp32, fused_tail_train) on a batch of 16
              utterances built by CubeganCollate, five steps: finite losses, every
              partition moves, B1 and B2 launch once per step
  train_check one step on the card (TF32 off) against the same step on the CPU
  trainer     the port's trainer CLI (python -m ttscube_tpu_torch.scripts.train_cubegan)
              at the full v1 width (fp32, --fused-tail-train) on a seeded corpus it
              writes: 4 steps over 2 epochs, B1 and B2 once per step, every checkpoint
              file written; --resume restores the step, parameters and moments bit-equal,
              and the next step from them equals the live run's next step; the saved
              weights, slimmed to {lang, gen}, serve through TTSCube(model_path, ...) on
              the card as the same weights do through TTSCube.from_state_dicts
  times       each kernel's median time beside its plain version's and its bound (and
              for B5 F.conv1d's), and the train step's median
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

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
TRAINER_UTTS = 8    # the trainer phase's corpus: 2 epochs of 2 steps at batch 4
TRAINER_BATCH = 4
TRAINER_STEPS = 4
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


def bf16_check(what: str, floor, err, ctl, wit) -> None:
    """The bf16 limits: the kernel (err) and the witness (wit) within BF16_RMS of the
    floor's RMS and BF16_MAX of its max, the control (ctl) not; each a (max, RMS)."""
    within = lambda d: d[1] <= BF16_RMS * floor[1] and d[0] <= BF16_MAX * floor[0]
    print(f"  {what} limit: max<={BF16_MAX * floor[0]:.3e} rms<={BF16_RMS * floor[1]:.3e}",
          flush=True)
    for name, d in (("floor", floor), ("kernel", err), ("control", ctl), ("witness", wit)):
        print(f"  {what} {name}: max={d[0]:.3e} rms={d[1]:.3e} ({d[0] / floor[0]:.3f}, "
              f"{d[1] / floor[1]:.3f} of the floor)", flush=True)
    check(floor[0] > 1e-4, f"{what}: bf16 operands did not move the plain version")
    check(within(err), f"{what}: {err} is not within {BF16_RMS} (RMS) and {BF16_MAX} (max) "
                       f"of the floor {floor}")
    check(not within(ctl), f"{what}: the fp32 control passed")
    check(within(wit), f"{what}: the limits are tighter than summation order alone allows "
                       f"(witness {wit})")


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
            err = distance(got16, want16)
            errs[("bf16", batch, frames)] = err[0]
            bf16_check(f"fused_tail_stage bf16 {case}", distance(want16, want32), err,
                       distance(got32, want16),
                       distance(fused_tail.fused_tail_stage_plain(z.cpu(), moved(w16, "cpu")),
                                want16))
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
    # the shape of the TPU kernel's docstring, and others the kernel takes (C = 256
    # walks input-channel chunks; an even k pads (k - 1)//2 on the left)
    for label, (batch, t_len, C, k) in (("docstring", (8, 122880, 32, 11)),
                                        ("c64", (2, 1000, 64, 7)), ("c256", (1, 4096, 256, 3)),
                                        ("even_k", (2, 3000, 32, 4))):
        g = torch.Generator().manual_seed(t_len + k)
        x = torch.randn(batch, t_len, C, generator=g).to(dev)
        w = (torch.randn(k, C, C, generator=g) / math.sqrt(k * C)).to(dev)
        xb, wb = x.bfloat16(), w.bfloat16()
        with no_tf32():
            got, again, got16 = nconv(x, w), nconv(x, w), nconv(xb, wb)
            want, want16 = nplain(x, w), nplain(xb, wb)
            torch.cuda.synchronize()
        tf32 = nplain(x, w)  # PyTorch's default: TF32 convs
        wit, wit16 = nplain(x.cpu(), w.cpu()), nplain(xb.cpu(), wb.cpu())
        torch.cuda.synchronize()
        check(got.shape == want.shape == (batch, t_len, C) and got16.dtype == torch.float32
              and bool(torch.isfinite(got).all()) and bool(torch.isfinite(got16).all()),
              f"narrow_conv {label}: shape {tuple(got.shape)} or not finite")
        check(torch.equal(got, again), f"narrow_conv {label}: two launches differ")
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
    shutil.rmtree(work)
    say("trainer", t0, steps=TRAINER_STEPS, launches_b1=trainer_counts["fused_tail_stage"],
        launches_b2=trainer_counts["fused_tail_stage_grad"])

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
    # B3 at the shapes of v1's stages 0 and 1, B1-mid at stage 2's, for a request of 256
    # frames: the kernel against its plain version, in turns, bf16 under the default
    # TF32 settings (as served), fp32 in full fp32; bounds from this run's shapes
    stage_rows = {}
    for label, i, t_len, c_in in (("fused_mrf1 stage0", 0, 1280, 256),
                                  ("fused_mrf1 stage1", 1, 3840, 128),
                                  ("fused_tail_stage_mid stage2", 2, 3840, 128)):
        g = torch.Generator().manual_seed(t_len)
        x = torch.randn(1, t_len, c_in, generator=g).to(dev)
        for mode, cd, peak in (("bf16", torch.bfloat16, PEAK_BF16), ("fp32", None, PEAK_FP32)):
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
                p1, k1, k2, p2 = (cuda_times(f, 10) for f in (plain, kernel, kernel, plain))
            ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
            # each input read once, the output written once: x, the packed weights, out
            nbytes = 4 * (x.numel() + n_out + n_w)
            t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            stage_rows[(label, mode)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
            print(f"  {label} {mode} B=1 T={t_len} C_in={c_in} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(t_ops, t_bytes):.4f} "
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
    for mode, cd, peak in (("bf16", torch.bfloat16, PEAK_BF16), ("fp32", None, PEAK_FP32)):
        kernel = lambda: fused_resblock.fused_resblock1(x, **a, compute_dtype=cd)
        plain = lambda: fused_resblock.fused_resblock1_plain(x, **a, compute_dtype=cd)
        with no_tf32() if cd is None else contextlib.nullcontext():
            p1, k1, k2, p2 = (cuda_times(f, 10) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        flops = fused_resblock.resblock_flops(1, 61440, 32, a["kernel_size"], a["dilations"])
        nbytes = 4 * (2 * x.numel() + sum(t.numel() for t in a["kernels"] + a["biases"]))
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res_rows[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                              bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"  fused_resblock1 {mode} B=1 T=61440 C=32 k=11 ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={max(t_ops, t_bytes):.4f} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) achieved={flops / ms / 1e9:.2f} TFLOP/s library_ms=none "
              f"(no single PyTorch call computes a ResBlock1)", flush=True)
    B5, T5, C5, K5 = 8, 122880, 32, 11
    g = torch.Generator().manual_seed(T5)
    x32 = torch.randn(B5, T5, C5, generator=g).to(dev)
    w32c = (torch.randn(K5, C5, C5, generator=g) / math.sqrt(K5 * C5)).to(dev)
    conv_rows = {}
    for mode, dt, peak in (("fp32", torch.float32, PEAK_FP32), ("bf16", torch.bfloat16, PEAK_BF16)):
        xx, ww = x32.to(dt), w32c.to(dt)
        x_nct, w_oik = xx.transpose(1, 2).contiguous(), ww.permute(2, 1, 0).contiguous()
        kernel = lambda: narrow_conv.narrow_conv_blocked(xx, ww)
        plain = lambda: narrow_conv.narrow_conv_plain(xx, ww)
        library = lambda: torch.nn.functional.conv1d(x_nct, w_oik, padding=(K5 - 1) // 2)
        with no_tf32() if mode == "fp32" else contextlib.nullcontext():
            p1, l1, k1, k2, l2, p2 = (cuda_times(f, 10) for f in
                                      (plain, library, kernel, kernel, library, plain))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        library_ms = statistics.median(l1 + l2)
        flops = narrow_conv.narrow_conv_flops(B5, T5, C5, K5)
        # x and w read once in their own type, the fp32 output written once
        nbytes = xx.element_size() * (xx.numel() + ww.numel()) + 4 * xx.numel()
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        conv_rows[mode] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"  narrow_conv {mode} B={B5} T={T5} C={C5} k={K5} ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={library_ms:.4f} (F.conv1d, {mode}) bound_ms="
              f"{max(t_ops, t_bytes):.4f} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
              f"achieved={flops / ms / 1e9:.2f} TFLOP/s", flush=True)
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

    serving = rows[0]
    # launches on the main paths (serve, serve_wide, train, trainer), each counted from
    # zero just before its path ran
    main_counts = {n: serve_counts[n] + wide_counts[n] + train_counts[n] + trainer_counts[n]
                   for n in serve_counts}
    print(f"  main-path launches: {main_counts}; launches in the kernel phases: "
          f"{phase_launches}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_tail_stage", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:295",
        "launches": main_counts["fused_tail_stage"],
        "max_abs_err": errs[("bf16", 1, 256)],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": None}, {
        "name": "fused_tail_stage_grad", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage_grad.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:664",
        "launches": main_counts["fused_tail_stage_grad"],
        "max_abs_err": max(v for k, v in grad_errs.items() if k[1] == 3000),
        "ms": grad_row["ms"], "plain_ms": grad_row["plain_ms"],
        "bound_ms": grad_row["bound_ms"], "bound_by": grad_row["bound_by"],
        "library_ms": None}, {
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
        "max_abs_err": res_errs["stage3"][1], **res_rows["bf16"], "library_ms": None}, {
        "name": "narrow_conv_blocked", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/narrow_conv.cu",
        "replaces": "ttscube_tpu/ops/pallas_conv.py:46",
        "launches": main_counts["narrow_conv_blocked"],
        "phase_launches": phase_launches["narrow_conv_blocked"],
        "max_abs_err": conv_errs[("docstring", "fp32")], **conv_rows["fp32"]}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
