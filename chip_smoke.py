#!/usr/bin/env python3
"""Drive the PyTorch port (`ttscube_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as it ends:
  device  the card (nvidia-smi name and power limit) and the CUDA version
  build   the kernel source ttscube_tpu_torch/csrc/fused_tail_stage.cu, by plain nvcc
  kernel  the kernel against its plain PyTorch version at serving shapes, fp32 (TF32
          off) and bf16 (limits below), raising on a miss
  serve   TTSCube at the full Cubegan v1 width from seeded random weights answers three
          requests; the fused-tail launch counter must rise by one per request; one more
          request in fp32 (TF32 off) must match the same model run on the CPU
  times   the kernel's median time beside its plain version and its bound
  profile one served request under torch.profiler: device-busy share, top kernels

Serving, its times and its profile run under PyTorch's default TF32 settings, as the
API does; only the fp32 comparisons and the fp32 times turn TF32 off.

The line before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. Without a CUDA
card, or without the port's package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
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
    d = (a.double() - b.double().to(a.device)).abs()
    return float(d.max()), float(d.square().mean().sqrt())


def tail_input(batch: int, frames: int, seed: int, device):
    """The final stage's input as the serving path hands it over for F frames:
    z (B, 60·F + 16, 64), the output of the three upsample stages before it."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 60 * frames + 16, 64, generator=g).to(device)


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
    _build.load(fused_tail.KERNEL_SOURCE)
    for line in _build.nvcc_log(fused_tail.KERNEL_SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)
    say("build", t0, source=fused_tail.KERNEL_SOURCE)

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
    say("times", t0)

    # -- profile ------------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        cube(REQUESTS[1], speaker=speaker)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    # device activities only (kernels, copies), not the profiler's own buffer work
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in ("Buffer Flush", "Activity Buffer Request")]
    by_name: dict = {}
    for e in dev_ev:
        ms_, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms_ + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(v[0] for v in by_name.values())
    if busy_ms > 0:
        print(f"  profiled request frames={served[1]} wall_ms={wall_ms:.1f} (profiler on) "
              f"device_busy_ms={busy_ms:.1f} busy_share={busy_ms / wall_ms:.3f} "
              f"device_ops={len(dev_ev)}", flush=True)
        for name, (ms_, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"    {ms_:9.3f} ms {n:6d}x {name[:90]}", flush=True)
    else:
        print("  profiler showed no device time: not measured", flush=True)
    say("profile", t0)

    serving = rows[0]
    print(json.dumps({"kernels": [{
        "name": "fused_tail_stage", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/fused_tail_stage.cu",
        "replaces": "ttscube_tpu/ops/pallas_resblock.py:295",
        "launches": main_launches, "max_abs_err": errs[("bf16", 1, 256)],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
