#!/usr/bin/env python3
"""Three measurements behind PERF.md's findings on C7, the mesh and serving, on one card.

    python3 chip_probes.py c7            # where the first request after warmup goes
    python3 chip_probes.py mesh          # (1, 1) mesh steps against plain steps
    python3 chip_probes.py serve PARENT  # serving through PARENT's package and this one

`c7` runs each case in a fresh process (CUDA loads a kernel's module at its first launch
in a process, so only a fresh process shows a first request's cost), at Cubegan v1 width
from seeded random weights, once with `TTSCube.warmup`'s phonemizer sweep and once with
it turned off (`TTSCube._warm_phonemizer` replaced by a no-op in that process): the
first request's time by stage and the two after it; the first request's host ops under
torch.profiler; and after warmup the phonemizer alone at every text length from 3 to
399 characters, listing the lengths whose first call took more than 15 ms.

`mesh` takes two train steps of a small Cubegan (v1's fused tail, B = 2) under
PyTorch's deterministic algorithms, with TF32 off and then on: without the mesh twice,
without the mesh with AdamW's foreach update off, and over a (1, 1) mesh (FSDP2, NCCL,
one rank): as `shard_model` leaves it, with AdamW's foreach update off, with the
discriminators' backward marked as not the step's last (`set_is_last_backward(False)`),
and with nn.LSTM's own `flatten_parameters` back on. Against the first run, for each
step: the losses, how far the weights that the step's forward reads (the text model's
`cond_rnn`, the generator's `conv_pre`) are from the parameters before the step, the
parameters after it in units of lr, and by module the largest grad difference relative
to the module's largest grad.

`serve` runs, each in a fresh process, the package of the tree at PARENT (an unpacked
earlier commit, A), of this one (B), and of this one with warmup's phonemizer sweep
turned off (C), in the order A B C C B A: `Cubegan.infer` on chip_smoke's serve_batch
(B = 128, 512 frames), one warm call and 6 timed ones, then a v1 TTSCube's first
request after warmup, 20 steady ones, and 20 more timed by stage.

Without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
LONG_MS = 15.0  # a phonemizer call above this is reported
STEPS = 2  # mesh: train steps in each run
SERVE_REQUESTS, SERVE_CALLS = 20, 6  # serve: steady requests, timed batch calls


def _cube(sweep: bool):
    import torch

    from chip_smoke import SEED
    from ttscube_tpu_torch import api
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
    from ttscube_tpu_torch.models.cubegan import Cubegan
    from ttscube_tpu_torch.models.phonemizer import Phonemizer

    if not sweep:
        api.TTSCube._warm_phonemizer = lambda self: None
    ckpt = REPO / "artifacts" / "drive_ckpt"
    enc = CubeganEncodings(str(ckpt / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(ckpt / "phonemizer.encodings"))
    cfg = api.config_from_yaml({}, enc)
    cube = api.TTSCube.from_state_dicts(
        cfg, enc, penc, init_random(Cubegan(cfg), SEED).state_dict(),
        init_random(Phonemizer(api.phonemizer_config(penc)), SEED + 1).state_dict(),
        device="cuda")
    speaker = next(iter(enc.speaker2int))
    cube.warmup(speaker=speaker)
    torch.cuda.synchronize()
    return cube, speaker


def _stages(cube, speaker, text) -> dict:
    """One request's time by stage (host clock; each stage ends in a synchronize)."""
    import numpy as np
    import torch

    out, sync = {}, torch.cuda.synchronize

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        sync()
        out[name] = round((time.perf_counter() - t) * 1e3, 2)
        return r

    timed("phonemizer", lambda: cube.text2feat(text))
    X = timed("prepare", lambda: cube._prepare(text, speaker))
    total = timed("durations", lambda: cube._frames(X))
    bucket = int(np.clip(-(-total // 256) * 256, 256, 8192))
    with torch.inference_mode():
        audio = timed("infer", lambda: cube.model.infer(X, max_frames=bucket)[0])
    a = timed("to_host", lambda: cube._to_host(audio, total))
    timed("int16", lambda: cube._int16(a))
    return out


def c7_case(case: str, sweep: bool) -> None:
    from chip_smoke import REQUESTS, host_profile

    cube, speaker = _cube(sweep)
    if case == "stages":
        for i in range(3):
            stages = _stages(cube, speaker, REQUESTS[0])
            print(f"  sweep={sweep} request {i + 1}: ms by stage {stages}", flush=True)
    elif case == "profile":
        wall, busy, rows = host_profile(lambda: cube(REQUESTS[0], speaker=speaker), top=6)
        print(f"  sweep={sweep} first request under the profiler: wall {wall:.1f} ms, busy "
              f"{busy:.1f} ms; host ops by self ms: " + "; ".join(
                  f"{n} {ms:.2f} ({c})" for n, ms, c in rows), flush=True)
    elif case == "lengths":
        import torch

        slow = []
        for n in range(3, 400):
            t = time.perf_counter()
            cube.text2feat("ab " * (n // 3) + "a" * (n % 3))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if ms > LONG_MS:
                slow.append((n, round(ms, 1)))
        print(f"  sweep={sweep} phonemizer lengths 3-399 whose first call took over "
              f"{LONG_MS} ms: {slow}", flush=True)


def mesh() -> None:
    import contextlib

    import torch
    from torch.distributed.tensor import DTensor

    from chip_smoke import deterministic, no_tf32
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.entry import _example_batch
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models import hifigan_fused
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.parallel import mesh as pm

    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=30, num_speakers=3, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(upsample_rates=(5, 3, 4, 4), upsample_kernel_sizes=(16, 16, 4, 4),
                              upsample_initial_channel=512, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), fused_tail_train=True),
        mpd_channels=(8, 16), msd_width=8)
    batch = tcg.batch_to_torch(_example_batch(B=2), "cuda")
    full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

    def steps(rank, world, device, mesh_shape, d_not_last, foreach=None, flatten=False):
        model = init_random(tcg.Cubegan(cfg, train=True), 0).to(device)
        fn = tcg.train_step
        if mesh_shape is not None:
            fn = pm.make_parallel_train_step(model, pm.make_mesh(*mesh_shape, device=device),
                                             fn)
        if flatten:  # nn.LSTM's own flatten_parameters, which shard_model turns off
            for mod in model.modules():
                if isinstance(mod, torch.nn.RNNBase):
                    del mod.flatten_parameters
        if d_not_last:
            # the discriminators' backward told that it is not the step's last, so that
            # FSDP2 does not wait for its grads' reduction before their optimizer step
            d_loss, gt_losses = model.d_loss, model.gt_losses

            def d(*a, **k):
                out = d_loss(*a, **k)
                model.set_is_last_backward(False)
                return out

            def gt(*a, **k):
                out = gt_losses(*a, **k)
                model.set_is_last_backward(True)
                return out

            model.d_loss, model.gt_losses = d, gt
        # the weights each step's forward reads: the text model's cond_rnn (a module
        # forward inside lang's) and the generator's conv_pre (read by the fused train path)
        seen = {}
        rnn = model.lang.cond_rnn

        def read(mod, args):
            seen.setdefault("lang.cond_rnn", next(mod.parameters()).detach().clone())

        hook = rnn.register_forward_pre_hook(read)
        real_train = hifigan_fused.generator_apply_fused_train

        def spy(gen, mel, c):
            seen.setdefault("gen.conv_pre", gen.conv_pre.v.detach().clone())
            return real_train(gen, mel, c)

        hifigan_fused.generator_apply_fused_train = spy
        names = {"lang.cond_rnn": "lang.cond_rnn." + next(rnn.named_parameters())[0],
                 "gen.conv_pre": "gen.conv_pre.v"}
        state = tcg.create_train_state(model)
        if foreach is not None:
            for opt in state.optimizers.values():
                for group in opt.param_groups:
                    group["foreach"] = foreach
        out = []
        try:
            for _ in range(STEPS):
                before = {k: full(dict(model.named_parameters())[n]) for k, n in names.items()}
                seen.clear()
                state, m = fn(state, batch)
                torch.cuda.synchronize()
                stale = {k: float((seen[k] - before[k]).abs().max()) for k in names}
                out.append(({k: float(v) for k, v in m.items()},
                            {n: full(p) for n, p in model.named_parameters()},
                            {n: full(p.grad) for n, p in model.named_parameters()
                             if p.grad is not None}, stale))
        finally:
            hook.remove()
            hifigan_fused.generator_apply_fused_train = real_train
        return out

    lr = cfg.lr
    for tf32 in (False, True):
        with deterministic(), (contextlib.nullcontext() if tf32 else no_tf32()):
            ref = steps(0, 1, torch.device("cuda"), None, False)
            runs = {"plain again": steps(0, 1, torch.device("cuda"), None, False),
                    "plain, AdamW foreach off": steps(0, 1, torch.device("cuda"), None, False,
                                                      False),
                    "mesh": pm.run_ranks(steps, 1, "cuda", args=((1, 1), False)),
                    "mesh, AdamW foreach off": pm.run_ranks(steps, 1, "cuda",
                                                            args=((1, 1), False, False)),
                    "mesh, D's backward not the last": pm.run_ranks(steps, 1, "cuda",
                                                                    args=((1, 1), True)),
                    "mesh, LSTM weights flattened": pm.run_ranks(
                        steps, 1, "cuda", args=((1, 1), False, None, True))}
        for name, run in [("plain", ref)] + list(runs.items()):
            for i, (m1, p1, g1, stale) in enumerate(run):
                m0, p0, g0, _ = ref[i]
                loss = {k: abs(m0[k] - m1[k]) / abs(m0[k]) for k in m0}
                far = sum(int(((p1[n] - p).abs() > 0.01 * lr).sum()) for n, p in p0.items())
                total = sum(p.numel() for p in p0.values())
                worst = max(float((p1[n] - p).abs().max()) for n, p in p0.items()) / lr
                diff, scale = {}, {}
                for n, g in g0.items():
                    mod = ".".join(n.split(".")[:2])
                    diff[mod] = max(diff.get(mod, 0.0), float((g - g1[n]).abs().max()))
                    scale[mod] = max(scale.get(mod, 0.0), float(g.abs().max()))
                by = sorted(((diff[k] / (scale[k] + 1e-30), k) for k in diff), reverse=True)
                print(f"  TF32 {'on' if tf32 else 'off'}, {name} vs plain, step {i + 1}: "
                      f"rel_loss_diff " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
                          loss.items())) + f"; weights read by the forward minus the "
                      f"parameters before the step: " + ", ".join(
                          f"{k} {v:.2e}" for k, v in stale.items()) + f"; params after it "
                      f"max {worst:.4f} lr, {far} of {total} beyond 0.01 lr; grads differ in "
                      f"{sum(v > 0 for v, _ in by)} of {len(by)} modules, largest over the "
                      f"module's largest grad: " + ", ".join(f"{k} {v:.2e}" for v, k in by[:3]
                                                             if v > 0), flush=True)


def _request_stages(cube, speaker: str, text: str) -> dict:
    """One request's host ms by stage, each ending in a synchronize, through calls that
    every tree's TTSCube has: phonemizer and collate, duration pass, synthesis, the
    audio's copy to the host with its int16 conversion."""
    import numpy as np
    import torch

    out, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()

    with torch.inference_mode():
        X = cube._prepare(text, speaker)
        lap("prepare")
        total = cube._frames(X)
        lap("durations")
        bucket = int(np.clip(-(-total // 256) * 256, 256, 8192))
        audio, _ = cube.model.infer(X, max_frames=bucket)
        lap("infer")
        a = audio[0, : total * cube.config.hop_size].float().cpu().numpy()
        np.asarray(np.clip(a, -1, 1) * 32767, dtype=np.int16)
        lap("host")
    return out


def serve_case(root: str, sweep: bool = True) -> None:
    """Serving through the package at `root`: serve_batch's whole batch (B = 128 at 512
    frames) through Cubegan.infer, one warm call and SERVE_CALLS timed ones; then a v1
    TTSCube's first request after warmup and SERVE_REQUESTS steady ones."""
    sys.path.insert(0, str(Path(root).resolve()))
    import statistics

    import torch

    import ttscube_tpu_torch
    from chip_smoke import BATCH, BATCH_FRAMES, REQUESTS, SEED, batch_inputs
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig

    bcfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=64, num_speakers=8, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(fused_tail=True, storage_dtype="bfloat16"))
    model = init_random(tcg.Cubegan(bcfg), SEED + 6).to("cuda").eval()
    ms = []
    for i in range(1 + SERVE_CALLS):
        X = batch_inputs(BATCH, SEED + 10 + i, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(model.infer(X, max_frames=BATCH_FRAMES)[0].abs().mean())
        ms.append((time.perf_counter() - t) * 1e3)
    del model
    cube, speaker = _cube(sweep)
    lat = []
    for _ in range(1 + SERVE_REQUESTS):
        t = time.perf_counter()
        cube(REQUESTS[0], speaker=speaker)
        lat.append((time.perf_counter() - t) * 1e3)
    runs = [_request_stages(cube, speaker, REQUESTS[0]) for _ in range(SERVE_REQUESTS)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"  {Path(ttscube_tpu_torch.__file__).parent.parent.name or root}"
          f"{'' if sweep else ' without the phonemizer sweep'}: steady ms by stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + "; request "
          f"chars={len(REQUESTS[0])} first after warmup {lat[0]:.2f} ms, steady median "
          f"{statistics.median(lat[1:]):.2f} ms (min {min(lat[1:]):.2f}, max "
          f"{max(lat[1:]):.2f}); serve_batch B={BATCH} frames={BATCH_FRAMES} median "
          f"{statistics.median(ms[1:]):.2f} ms of {', '.join(f'{v:.2f}' for v in ms[1:])}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probes: torch.cuda.is_available() is False; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "c7":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        for sweep in (False, True):
            for case in ("stages", "profile", "lengths"):
                r = subprocess.run([sys.executable, __file__, "c7-case", case, str(int(sweep))],
                                   cwd=REPO, timeout=600)
                if r.returncode:
                    return r.returncode
        return 0
    if what == "c7-case":
        c7_case(sys.argv[2], bool(int(sys.argv[3])))
        return 0
    if what == "mesh":
        mesh()
        return 0
    if what == "serve":  # the parent tree at sys.argv[2] (A), this one (B), and this one
        # without warmup's phonemizer sweep (C), in turns
        a, b = sys.argv[2], str(REPO)
        for root, sweep in ((a, 1), (b, 1), (b, 0), (b, 0), (b, 1), (a, 1)):
            r = subprocess.run([sys.executable, __file__, "serve-case", root, str(sweep)],
                               cwd=REPO, timeout=600)
            if r.returncode:
                return r.returncode
        return 0
    if what == "serve-case":
        serve_case(sys.argv[2], bool(int(sys.argv[3])))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
