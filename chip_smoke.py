#!/usr/bin/env python3
"""Drive the PyTorch port (`ttscube_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as it ends:
  device      the card (nvidia-smi name and power limit) and the CUDA version
  build       the kernel sources ttscube_tpu_torch/csrc/{fused_tail_stage,
              fused_tail_stage_grad,fused_mrf_stage,narrow_conv,stage_conv}.cu, by plain
              nvcc, in parallel, with each one's ptxas register and spill line
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
  kernel_stage_conv  S1 (one conv of an unfused serving stage, bf16 storage and
              operands) against its plain version at v1's stage widths (C 256, 128, 64),
              at B = 2 and a T that is no multiple of its 512-row tile, and at the main
              path's shapes, B = 128 with each stage's T (2,560, 7,680, 30,720), where
              each persistent block walks many items; in its last-conv epilogue
              (residual, the blocks' sum and mean): within 2 bf16 ulps, at most 1 % of
              elements differing, the fp32 control differing in more; two launches
              bit-equal
  warmup      TTSCube at the full Cubegan v1 width from seeded random weights runs
              TTSCube.warmup (B1 once per frame bucket and text length); the first
              request after it, beside the same request in the steady state, at most
              FIRST_REQUEST_BOUND times its median; a fresh TTSCube's first request after
              its warmup and a steady one under the profiler, host ops by self time
  serve       that TTSCube answers three requests; the B1 launch counter must rise by one
              per request, S1's by 54 (stages 0-2, 18 convs each); one more request in fp32 (TF32 off) must match the same model
              run on the CPU
  serve_wide  the same with every generator stage fused (fuse_channels 256, 128, 64, 32):
              per request B3 launches twice, B1-mid and B1 once; an fp32 request (TF32
              off) must match the CPU; in a bf16 request each fused stage, fed what the
              CPU's run of that request gave it, must meet the bf16 limits against the
              CPU's stage
  serve_batch bench.py's serving configuration through Cubegan.infer: 128 items of 64
              characters at 512 frames (B1 once per call), then 256 items in windows of
              256 frames (B1 once per window, S1 54 times): ms per batch, audio seconds per wall
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
  mesh        the mesh (ttscube_tpu_torch/parallel/mesh.py, FSDP2 over NCCL) on every
              card: entry.dryrun_multichip (step, step, save, restore, step, synthesis);
              the trainer CLI at v1 width with --mesh-data 1 --mesh-model 1
              --fused-tail-train (B1 and B2 once per step under the mesh) against the
              same run without the mesh, both with TF32 off (each step's losses 1e-4
              relative and the parameters after it in units of lr), each step's host
              ms beside the other's; synthesis of 4 items over the mesh
              against Cubegan.infer (fp32, TF32 off, 5e-5)
  phonemizer  the phonemizer family at its full widths: make_demo_corpus (2 speakers x
              IMPORT_SENTENCES) and import_phonemizer_blizzard (speaker 0, a quarter for
              dev); the trainer CLI (train_phonemizer) for the aligned model and for M2M:
              every file written, --resume bit-equal and the next step from it equal to
              the live run's (deterministic algorithms), one card step against the CPU's
              (TF32 off), step ms, busy share, dev PACC/SACC; M2M's free-running decode of
              the dev set against the CPU's, its ms and device launches per decode step;
              word G2P trained on the sentences' lexicon, its transcription on the card
              against the CPU's, words per second. None of the kernels runs here
  import_export  raw audio to a served voice with the port alone: the phonemizer
              phase's corpus, import_blizzard_2023 on the card and on the CPU (every .mgc
              within 1e-4, every other file equal), 2 train steps at v1 width on the
              imported folder, export_model with the phonemizer the phonemizer phase
              trained, and one request through TTSCube from the exported volumes on the
              card (B1 once); the import's seconds per audio second by part, the
              export's seconds, the request's ms
  quality     the exported voice scored: 2 dev utterances of each speaker synthesised by
              that TTSCube on the card (B1 once per request) beside their originals; the
              port's eval_drive_quality on them on the card and with --device cpu (per
              pair MCD-DTW within 0.01 dB, F0-RMSE and duration error equal, VUV error
              within 1 point, log-mels within 1e-5 of the peak in linear mel; pairs whose
              DTW path differs; ms per pair by part); Text2Feat with the phonemizer phase's
              word G2P on the card as its hook and a 2-word Lexicon, equal to the same on
              the CPU, the lexicon's words never passed to the hook, words per second;
              patch over a copy of the dev folder (.pitch lengths equal to the importer's);
              the numpy twin of durations_to_frame2phone equal to the torch function on the
              card at B = 128, F = 512; within 60 s
  lm          HF and fastText conditioning at full width on import_export's corpus:
              make_demo_lm writes a BERT-base directory (768 wide, 12 layers, 12 heads,
              vocabulary 30,522, seeded) and a 2-layer one at the same width for the CLI
              round trip, beside a seeded 300-d .vec; the BERT-base encoder alone on the
              card against the CPU (B = 2, T = 64, a padded and a fully masked row; 1e-4);
              the trainer CLI with --lm hf:<dir> --fused-tail-train (B1 and B2 launch, the
              encoder moves by less than 1e-4, --resume bit-equal and its next step
              bit-equal) and with --lm fasttext:<vec>; a train step at B = 16 over
              512-token windows through BERT-base, beside the same step without the LM,
              and the encoder's forward and backward alone; both voices exported and
              served by TTSCube on the card from the unpacked files (the HF tokenizer
              directory moved away): warmup and the first request within 1.5x, the three
              requests' latencies, fp32 against the CPU (5e-5), the encoder's device ms
  legacy      Textcoder and the dual-rate WaveRNN vocoder at full width on import_export's
              folder: the Textcoder trainer CLI (B = 16, pframes 3, one epoch; --resume
              bit-equal and its next step bit-equal), five timed steps and one B = 2 step
              against the CPU (TF32 off); synthesize_devset forced and free for 3 dev
              utterances through a v1 Generator (ms per utterance, ms and launches per
              decoder group); the vocoder trainer CLI at its defaults (2 x 512 GRUs at 24
              and 2.4 kHz, MOL, 24,000-sample crops, B = 16; .lr.best and .hr.best,
              --resume bit-equal), timed steps (busy share, peak memory); CubenetVocoder.infer
              on 1 s of mel in 20 chunks (audio s per wall s, µs and launches per sample
              step, the sampled logits against the teacher-forced nets, fp32 TF32 off).
              None of the kernels runs here
  inventory   the rest of the inventory on import_export's files, at full v1 width:
              download_model joins the exported volumes from a file:// base into a
              temporary HOME's cache, StoryCube("voice") serves through TTSCube.load on
              the card (a 3-paragraph story over seeded music: B1 once per paragraph; under
              deterministic() the host mix of the same requests within 1 int16 step; ms,
              audio s per wall s); synthesize_from_checkpoint of the trainer's .last for 2
              dev utterances, forced and free (ms per utterance; the forced wav card with
              TF32 off against the CPU within 2 int16 steps); card against CPU (TF32 off):
              Languasito v1 (B = 4, 64 characters, 400 frames), ResNet, UpsampleNet,
              UpsampleNet2, Mel2Style, ConvTranspose1d, fft -> ifft and Griffin-Lim;
              device_timer of B1 (checked in the times phase, within 0.5-2x of its
              median), the max_stages prefixes 0-4 of the voice's generator (per-stage
              ms; the last equal to the whole output), and trace() naming B1's kernel
  generator_resblock2  a plain Generator at v1's widths with ResBlock2 (HiFi-GAN v3's
              kernels and dilations), fp32 on the card against the CPU
  times       each kernel's median time beside its plain version's and its bound (and
              for B5 and S1 F.conv1d's): B1 in both forms at the serving shape and at the
              training shape, and bf16 at serve_batch's shapes; S1 over each of stages
              0-2 (18 launches) at B = 128, 512 frames and at long-form's window, B = 64,
              320 frames, its output held to the plain stage's (within S1_CHAIN of the
              stage's bf16-against-fp32 floor, max and RMS); and the train step's median
  profile     one served request, one with every stage fused and one train step under
              torch.profiler: device-busy share, top kernels

Serving, training, their times and their profiles run under PyTorch's default TF32
settings, as a user's program does; only the fp32 comparisons and the kernels' fp32
times turn TF32 off.

The line before the last is a JSON object with one entry per kernel, after the card's
name and power limit once more; the last line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero. Without a CUDA
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
# S1's launches per serving generator call at v1's widths with fuse_channels (32,): stages
# 0-2, each 3 ResBlock1s of 3 dilations, 2 convs each
S1_PER_CALL = 3 * 3 * 3 * 2
# S1 over a stage's MRF, a chain of 18 convs that each round to bf16 where the plain
# stage does but sum in another order: its output within this many times the floor (the
# plain stage at bf16 against it at fp32 storage) of the plain stage's, in max and RMS,
# as for the whole generator in tests/test_torch_gpu.py
S1_CHAIN = 1.25
LONG_BATCH = 64  # long-form synthesis's window batch (benchmark v1-synth-long)
CHUNK_BATCH, CHUNK_FRAMES, CHECK_BATCH = 256, 256, 4
# import_export: the demo corpus of 2 speakers, cut from make_demo_corpus's default 300
# sentences each to fit the run's time limit
IMPORT_SENTENCES = 32
# phonemizer: the phonemizer data of speaker 0's sentences, a quarter of them for dev (8);
# the trainer CLI at its full widths and batch PHONEMIZER_BATCH for PHONEMIZER_STEPS;
# PHONEMIZER_TIMED further steps timed; word G2P trained for G2P_EPOCHS on the lexicon
# of those sentences
PHONEMIZER_DEV_RATIO = 0.25
PHONEMIZER_BATCH = 4
PHONEMIZER_STEPS = {"aligned": 240, "m2m": 12}
PHONEMIZER_TIMED = 6
G2P_EPOCHS = 10
TOL_LOGITS = 2e-5  # the phonemizers' and G2P's logits, card against CPU (the cond tolerance)
# lm: HF conditioning's encoder at BERT-base (bert-base-uncased's config.json, Devlin et
# al. 2019: 768 wide, 12 layers, 12 heads, 3,072 feed-forward, 30,522 vocabulary rows);
# the trainer CLI's round trip (train, resume, export, serve) at the same width and
# LM_CLI_LAYERS layers, cut in depth for the time limit; fastText at the reference's
# 300-d vectors. The encoder alone, card against CPU, at LM_CHECK (B, T) within TOL_LM;
# LM_TIMED_STEPS train steps at B = LM_STEP_BATCH over 512-token windows
LM_VOCAB = 30522
LM_CLI_LAYERS = 2
LM_VEC_DIM = 300
LM_CHECK = (2, 64)
TOL_LM = 1e-4
LM_STEP_BATCH = 16
LM_TIMED_STEPS = 4
# legacy: Textcoder (its module's widths, pframes 3) and the vocoder (train_vocoder's
# defaults) at B = LEGACY_BATCH on import_export's folder; the Textcoder CLI for
# TEXTCODER_CLI_STEPS (4 at B = 16 is one epoch of the 56 train utterances) and
# TEXTCODER_TIMED steps timed; synthesize_devset of SYNTH_UTTS dev utterances, free runs
# of SYNTH_FRAMES (its default); the vocoder CLI for VOCODER_CLI_STEPS and VOCODER_TIMED
# steps timed; infer on INFER_FRAMES (1 s) in INFER_CHUNKS chunks; the sampled logits
# against the teacher-forced nets within TOL_SAMPLER (the CPU tests' WaveRNN logits limit)
LEGACY_BATCH = 16
TEXTCODER_CLI_STEPS = 4
TEXTCODER_TIMED = 5
SYNTH_UTTS = 3
SYNTH_FRAMES = 1024
VOCODER_CLI_STEPS = 2
VOCODER_TIMED = 3
INFER_FRAMES, INFER_CHUNKS = 100, 20
TOL_SAMPLER = 5e-5
VOCODER_PROFILE_CROP = 4800
# inventory: StoryCube over the exported voice, loaded by name (TTSCube.load) from a
# cache that download_model fills from import_export's volumes; the story's paragraphs
# are the serve phase's REQUESTS, over STORY_MUSIC_S of seeded music; the story's audio
# against the host mix of the same requests within STORY_TOL int16 steps;
# synthesize_from_checkpoint on CHECKPOINT_UTTS dev utterances, its forced wav card
# against CPU within CHECKPOINT_TOL int16 steps; Languasito v1 at the LanguasitoConfig
# widths over LANG_V1 (B, characters, frames); the blocks at BLOCKS_T frames; device_timer
# of B1 within TIMER_RATIO of the times phase's median
STORY_MUSIC_S = 2.0
STORY_TOL = 1
CHECKPOINT_UTTS = 2
CHECKPOINT_TOL = 2
LANG_V1 = (4, 64, 400)
BLOCKS_T = 400
TOL_BLOCKS = 1e-5  # of each output's range (the CPU tests' block tolerance)
TOL_GL = 1e-4      # of the signal's peak: ifft(fft) and Griffin-Lim, card against CPU
# quality: QUALITY_PER_SPEAKER dev utterances of each speaker of import_export's folder
# served by its exported voice and scored by the port's eval_drive_quality on the card and
# on the CPU: a pair's MCD-DTW within TOL_MCD dB, its VUV error within TOL_VUV percentage
# points, the log-mels within TOL_MEL of the peak in linear mel; Text2Feat with the
# phonemizer phase's word G2P as its hook and a Lexicon over QUALITY_LEXICON on REQUESTS
# and QUALITY_TEXT (which holds the lexicon's words); the numpy twin of
# durations_to_frame2phone at bench.py's TWIN_SHAPE (B, N, F); the phase within
# QUALITY_BUDGET_S seconds
QUALITY_PER_SPEAKER = 2
TOL_MCD = 0.01
TOL_VUV = 1.0
TOL_MEL = 1e-5
QUALITY_LEXICON = {"ukela": ["U", "K", "E", "L", "A"], "mirade": ["M", "I", "_", "R", "A"]}
QUALITY_TEXT = "Ukela sano, mirade tivo.\nUKELA muna ama nevika; Mirade lori!"
TWIN_SHAPE = (128, 100, 512)
QUALITY_BUDGET_S = 60.0
TIMER_RATIO = (0.5, 2.0)
PREFIX_READINGS = 5
# C7: the first request after TTSCube.warmup, at most this many times the same request's
# steady-state median
FIRST_REQUEST_BOUND = 1.5
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


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


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


KERNEL_WRAPPERS = ("fused_tail_stage", "fused_tail_stage_grad", "fused_mrf1",
                   "fused_tail_stage_mid", "fused_resblock1", "narrow_conv_blocked",
                   "stage_conv")
_counted_from: dict = {}


def launches(name: str) -> int:
    """The launches of kernel wrapper `name` in this process (`launches.<name>` in the
    port's counters, `utils/profiling`)."""
    from ttscube_tpu_torch.utils.profiling import counters

    return counters().get(f"launches.{name}", 0)


def zero_counts() -> None:
    """Count every wrapper's launches from here on (`read_counts`)."""
    _counted_from.update({n: launches(n) for n in KERNEL_WRAPPERS})


def read_counts() -> dict:
    """Each wrapper's launches since the last `zero_counts`."""
    return {n: launches(n) - _counted_from.get(n, 0) for n in KERNEL_WRAPPERS}


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


def check_stage_conv(case: str, C: int, k: int, d: int, batch: int, t_len: int,
                     dev) -> float:
    """S1 against its plain version (cuDNN, TF32 off) on seeded x, residual and sum of
    (batch, t_len, C), in its fullest epilogue (residual, the blocks' sum and their mean),
    bf16 operands: within 2 bf16 ulps of each element's scale (the largest of the result,
    the conv's own output, the residual, the sum and the conv output's RMS), at most 1 %
    of the elements differing; the fp32 control (the plain version without the roundings
    after the conv) differs in more; two launches bit-equal. Returns the largest distance
    in ulps."""
    import torch

    from ttscube_tpu_torch.models.hifigan import LRELU_SLOPE
    from ttscube_tpu_torch.ops import stage_conv as sc

    g = torch.Generator().manual_seed(C + 10 * k + d + batch)
    n = lambda scale, *s: (scale * torch.randn(*s, generator=g)).to(dev)
    x, res, acc = (n(1.0, batch, t_len, C).bfloat16() for _ in range(3))
    w, b = n((C * k) ** -0.5, C, C, k), n(0.1, C)
    kw = dict(dilation=d, slope=LRELU_SLOPE, residual=res, accum=acc, n_mean=3)
    with no_tf32():
        conv = sc.stage_conv_plain(x, w, b, dilation=d, slope=LRELU_SLOPE).float().abs()
        want = sc.stage_conv_plain(x, w, b, **kw)
        ctl = sc.stage_conv_plain(x.float(), w, b, **dict(kw, residual=res.float(),
                                                            accum=acc.float()))
    scale = (want.float().abs() * 3).maximum(conv).maximum(res.float().abs())
    scale = scale.maximum(acc.float().abs()).maximum(conv.square().mean().sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    del conv, scale

    def reading(y):
        diff = (y.float() - want.float()).abs()
        return (diff / ulp).max().item(), (diff > 0).float().mean().item()

    cw = sc.pack_conv(w, b)
    got, again = sc.stage_conv(x, cw, **kw), sc.stage_conv(x, cw, **kw)
    torch.cuda.synchronize()
    most, share = reading(got)
    c_most, c_share = reading(ctl)
    print(f"  {case}: max {most:.2f} ulps, {share:.4%} of elements differ; control "
          f"{c_most:.2f} ulps, {c_share:.2%}", flush=True)
    check(torch.equal(got, again), f"{case}: two launches differ")
    check(most <= 2 and share <= 0.01, f"{case}: {most:.2f} ulps, {share:.4%} differ")
    check(c_share > 0.01, f"{case}: the fp32 control passed")
    return most


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


def device_profile(fn, host: bool = True):
    """Run `fn` once under torch.profiler: (wall ms with the profiler on, device-busy
    ms, {kernel name: (ms, launches)}, device events). `host=False` records the device
    alone: a run of a few hundred thousand launches then takes seconds, not minutes, to
    read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA][not host:]) as prof:
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


def host_profile(fn, top: int = 8):
    """Run `fn` once under torch.profiler with host events: (wall ms with the profiler
    on, device-busy ms, the `top` host ops by self CPU ms as (name, ms, calls))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in ("Buffer Flush", "Activity Buffer Request")) / 1e3
    return wall_ms, busy, [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in rows[:top]]


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


def train_cli(argv: list):
    """The trainer CLI's run of `argv` on the card, as `main` runs it without a mesh:
    its final TrainState (`train_on`; `main` returns only the step count)."""
    import torch

    from ttscube_tpu_torch.scripts import train_cubegan

    return train_cubegan.train_on(train_cubegan.parse_args(argv), torch.device("cuda"))


def relative_losses(met: dict, ref: dict) -> list:
    """A step's losses relative to the reference step's, in a fixed order."""
    return [met[k] / abs(ref[k]) for k in sorted(ref)]


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    """A parameter file's tree as {dotted name: tensor}."""
    import torch

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.as_tensor(v)
    return out


def mesh_phase(enc, work: Path) -> dict:
    """The mesh (parallel/mesh.py) on this machine's cards: `entry.dryrun_multichip`
    over every card (NCCL); the trainer CLI at v1 width with --mesh-data 1 --mesh-model 1
    --fused-tail-train (B1 and B2 under FSDP2) against the same run without the mesh,
    both in full fp32: each step's losses TOL_LOSS relative and the parameters after it
    in units of lr; and mesh
    synthesis of 4 items against Cubegan.infer (fp32, TF32 off, TOL_FP32). Returns the
    mesh run's launches and the numbers to print."""
    import statistics

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ttscube_tpu_torch import entry
    from ttscube_tpu_torch.api import config_from_yaml
    from ttscube_tpu_torch.convert import init_random, read_msgpack
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.parallel import mesh as pm
    from ttscube_tpu_torch.scripts import train_cubegan

    n_cards = torch.cuda.device_count()
    t1 = time.perf_counter()
    dry = entry.dryrun_multichip(n_cards)
    dry_s = time.perf_counter() - t1
    print(f"  dryrun_multichip({n_cards}) on NCCL: {dry_s:.1f} s; losses by step: " + "; ".join(
        f"{k} loss_g={v['loss_g']:.4f} loss_d={v['loss_d']:.4f}" for k, v in dry.items()),
          flush=True)

    corpus = work / "corpus"
    write_corpus(corpus, list(enc.phon2int), TRAINER_UTTS, seed=SEED + 5)
    runs = {}
    real_step = tcg.train_step
    for name, flags in (("plain", []), ("mesh", ["--mesh-data", "1", "--mesh-model", "1"])):
        base = str(work / name / "cubegan")
        argv = ["--train-folder", str(corpus), "--dev-folder", str(corpus), "--output-base",
                base, "--batch-size", str(TRAINER_BATCH), "--max-steps", "2", "--max-epochs",
                "1", "--epoch-generation", "0", "--fused-tail-train", *flags]
        ms, metrics, rises, first = [], [], [], {}

        def recorded(st, batch, starts=None):
            before = read_counts()
            t2 = time.perf_counter()
            out = real_step(st, batch, starts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t2) * 1e3)
            after = read_counts()
            rises.append(tuple(after[n] - before[n] for n in ("fused_tail_stage",
                                                             "fused_tail_stage_grad")))
            metrics.append({k: float(v) for k, v in out[1].items()})
            if not first:  # the parameters after the first step, whole
                first.update({n: (p.full_tensor() if isinstance(p, DTensor) else p)
                              .detach().cpu() for n, p in st.model.named_parameters()})
            return out

        tcg.train_step = recorded
        try:
            with deterministic(), no_tf32():
                torch.cuda.synchronize()
                zero_counts()
                t1 = time.perf_counter()
                step = train_cubegan.main(argv)
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t1
                counts = read_counts()
        finally:
            tcg.train_step = real_step
        check(step == 2 and rises == [(1, 1)] * 2,
              f"mesh: the {name} CLI ran {step} steps, B1/B2 launches per step {rises}")
        runs[name] = dict(ms=ms, metrics=metrics, counts=counts, cli_s=cli_s, first=first,
                          params=_flat_tree(read_msgpack(base + ".last")))
    # the resumed-vs-live limits: each step's losses TOL_LOSS relative; the parameters
    # after the first step within 2 lr plus rounding (Adam's first step moves each by
    # about lr·sign(g), and FSDP's gathered weights sum the grads in another order, so a
    # grad near zero may step the other way), and after each step at most 0.1 % of them
    # beyond 0.01 lr. Both runs in full fp32: with TF32 the two orders differ by more
    loss_diffs = [max(abs(m[k] - v) / abs(v) for k, v in a.items())
                  for a, m in zip(runs["plain"]["metrics"], runs["mesh"]["metrics"])]
    lr = 2e-4  # the CLI's default --lr
    worst_p, over, far, total = param_distance(runs["mesh"]["first"],
                                               runs["plain"]["first"], lr)
    worst_2, _, far_2, _ = param_distance(runs["mesh"]["params"], runs["plain"]["params"], lr)
    print(f"  trainer CLI --mesh-data 1 --mesh-model 1 --fused-tail-train (FSDP2 over NCCL, "
          f"one rank) vs no mesh, B={TRAINER_BATCH}, TF32 off: max_rel_loss_diff step 1 "
          f"{loss_diffs[0]:.3e}, step 2 {loss_diffs[1]:.3e} tol={TOL_LOSS:.0e}; params after "
          f"step 1 max {worst_p / lr:.4f} lr, {over} beyond 2 lr + rounding, {far} of "
          f"{total} beyond 0.01 lr; after step 2 max {worst_2 / lr:.4f} lr, {far_2} beyond "
          f"0.01 lr; step host ms mesh {', '.join(f'{v:.1f}' for v in runs['mesh']['ms'])} "
          f"vs no mesh {', '.join(f'{v:.1f}' for v in runs['plain']['ms'])}; CLI s mesh "
          f"{runs['mesh']['cli_s']:.1f} vs {runs['plain']['cli_s']:.1f}; launches "
          f"{runs['mesh']['counts']}", flush=True)
    check(max(loss_diffs) <= TOL_LOSS and over == 0 and max(far, far_2) <= 1e-3 * total,
          "mesh: the mesh CLI's steps differ from the CLI's without the mesh")
    check(all(math.isfinite(v) for m in runs["mesh"]["metrics"] for v in m.values()),
          "mesh: a loss of the mesh CLI is not finite")
    check(runs["mesh"]["counts"]["fused_tail_stage_grad"] == 2,
          f"mesh: B2 launches {runs['mesh']['counts']}")

    # synthesis over a (1, 1) mesh (FSDP2, NCCL) against Cubegan.infer, fp32
    cfg = config_from_yaml({"hifigan": {"storage_dtype": "float32"}}, enc)
    state = init_random(tcg.Cubegan(cfg), SEED + 9).state_dict()
    rng = np.random.default_rng(SEED + 9)  # characters and speakers of these encodings
    X = {"x_char": torch.from_numpy(rng.integers(1, len(enc.phon2int),
                                                 (CHECK_BATCH, BATCH_CHARS))).to("cuda"),
         "x_speaker": torch.from_numpy(rng.integers(1, len(enc.speaker2int),
                                                    (CHECK_BATCH, 1))).to("cuda")}

    def synth(rank, world, device):
        model = tcg.Cubegan(cfg).to(device).eval()
        model.load_state_dict(state)
        mesh = pm.make_mesh(world, 1, device=device)
        run = pm.make_parallel_synthesis(model, mesh, BATCH_FRAMES // 2)
        with no_tf32():
            zero_counts()
            got = run(X)
            torch.cuda.synchronize()
            return got, read_counts()

    single = tcg.Cubegan(cfg).to("cuda").eval()
    single.load_state_dict(state)
    with no_tf32():
        want, _ = single.infer(X, max_frames=BATCH_FRAMES // 2)
    got, synth_counts = pm.run_ranks(synth, 1, "cuda")
    err = float((got - want).abs().max())
    print(f"  mesh synthesis of {CHECK_BATCH} items at {BATCH_FRAMES // 2} frames (fp32, TF32 "
          f"off): max_abs_err vs Cubegan.infer={err:.3e} tol={TOL_FP32:.0e}; B1 launches "
          f"{synth_counts['fused_tail_stage']}", flush=True)
    check(tuple(got.shape) == (CHECK_BATCH, BATCH_FRAMES // 2 * HOP) and err <= TOL_FP32
          and bool(torch.isfinite(got).all()) and synth_counts["fused_tail_stage"] == 1,
          "mesh: synthesis over the mesh differs from Cubegan.infer")
    del single, got, want
    counts = {n: runs["mesh"]["counts"][n] + synth_counts[n] for n in synth_counts}
    return dict(counts=counts, mesh_ms=statistics.median(runs["mesh"]["ms"]),
                plain_ms=statistics.median(runs["plain"]["ms"]), dryrun_s=dry_s)


def same_simple_state(a, b) -> bool:
    """Bit-equal parameters, step, and every AdamW moment and count of two SimpleStates."""
    import torch

    sb = b.model.state_dict()
    if a.step != b.step or any(not torch.equal(v, sb[k]) for k, v in
                               a.model.state_dict().items()):
        return False
    for p, q in zip(a.optimizer.param_groups[0]["params"], b.optimizer.param_groups[0]["params"]):
        sa, sq = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sa.keys() != sq.keys() or any(not torch.equal(sa[k], sq[k]) for k in sa):
            return False
    return True


def top2_margin(logits, upto=None) -> float:
    """The smallest top-1/top-2 margin of (B, T, K) logits, over each row's first
    upto[b] + 1 steps where `upto` is given: how near a free run's argmaxes came to a
    tie."""
    import torch

    top = torch.topk(logits.detach().double().cpu(), 2, dim=-1).values
    m = top[..., 0] - top[..., 1]
    if upto is not None:
        m = torch.where(torch.arange(m.shape[1])[None, :] <= torch.as_tensor(upto)[:, None],
                        m, torch.full_like(m, float("inf")))
    return float(m.min())


def phonemizer_phase(work: Path) -> dict:
    """The phonemizer family on the card at its full widths: the demo corpus (2 speakers
    x IMPORT_SENTENCES, kept in `work/corpus` for import_export) and its phonemizer data
    (speaker 0, a quarter for dev); the trainer CLI for the aligned and the M2M models
    (PHONEMIZER_STEPS at batch PHONEMIZER_BATCH): every file written, `--resume`
    restores the state bit-equal and the next step from it equals the live run's under
    deterministic algorithms, one card step against the same step on the CPU (TF32 off:
    loss TOL_LOSS relative, the parameters in units of lr), the step's host ms and busy
    share, PACC/SACC on the dev set; for M2M the free-running validation decode of the
    dev set, its ms, its device launches per decode step, and the card's decode against
    the CPU's (TOL_LOGITS, the margin printed); then word G2P trained on the lexicon of
    those sentences, its transcription on the card against the CPU's and its words per
    second. Returns the aligned model's output base (for import_export), the launches
    of the phase's paths (none of the kernels) and the numbers to print."""
    import copy
    import os

    import numpy as np
    import torch

    from ttscube_tpu_torch.data.collate import PhonemizerCollate
    from ttscube_tpu_torch.data.datasets import PhonemizerDataset
    from ttscube_tpu_torch.data.encodings import PhonemizerEncodings
    from ttscube_tpu_torch.models.cubegan import batch_to_torch
    from ttscube_tpu_torch.models.g2p import G2P, greedy_decode
    from ttscube_tpu_torch.models.phonemizer import PhonemizerM2M
    from ttscube_tpu_torch.scripts import (g2p as g2p_cli, import_phonemizer_blizzard,
                                           make_demo_corpus, train_phonemizer)
    from ttscube_tpu_torch.train import states as ts

    dev = torch.device("cuda")  # the CLIs' default device
    corpus = work / "corpus"
    make_demo_corpus.main(make_demo_corpus.parser().parse_args(
        ["--output", str(corpus), "--sentences", str(IMPORT_SENTENCES), "--speakers", "2"]))
    data = str(work / "phonemizer_data")
    import_phonemizer_blizzard.main(["--input-file", str(corpus / "align_spk0.txt"),
                                     "--dev-ratio", str(PHONEMIZER_DEV_RATIO),
                                     "--output-base", data])
    trainset, devset = PhonemizerDataset(data + ".train"), PhonemizerDataset(data + ".dev")
    check(len(devset) >= 8, f"phonemizer: {len(devset)} dev sentences")
    out = {"counts": {}}
    torch.cuda.synchronize()
    zero_counts()
    for kind in ("aligned", "m2m"):
        steps = PHONEMIZER_STEPS[kind]
        base = str(work / "model" / ("phonemizer" if kind == "aligned" else "phonemizer_m2m"))
        argv = ["--train-file", data + ".train", "--dev-file", data + ".dev", "--output-base",
                base, "--model-type", kind, "--batch-size", str(PHONEMIZER_BATCH)]
        t1 = time.perf_counter()
        live = train_phonemizer.main(argv + ["--max-steps", str(steps)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        files = [ext for ext in ("encodings", "best", "last", "opt.last", "pacc.best",
                                 "sacc.best") if os.path.getsize(f"{base}.{ext}") > 0]
        check(live.step == steps and len(files) == 6 and next(live.model.parameters()).is_cuda
              and isinstance(live.model, PhonemizerM2M) == (kind == "m2m"),
              f"phonemizer {kind}: {live.step} steps, files {files}")
        collate = PhonemizerCollate(PhonemizerEncodings(base + ".encodings"))
        pacc, sacc = train_phonemizer.dev_scores(live, devset, collate, PHONEMIZER_BATCH, dev)
        resumed = train_phonemizer.main(argv + ["--resume", "--max-epochs", "0"])
        check(same_simple_state(live, resumed), f"phonemizer {kind}: --resume did not restore "
              "the step, parameters and moments bit-equal")
        nb_host = collate([trainset[i] for i in range(PHONEMIZER_BATCH)])
        nb = batch_to_torch(nb_host, dev)
        with deterministic():
            _, m_live = ts.phonemizer_train_step(live, nb)
            _, m_back = ts.phonemizer_train_step(resumed, nb)
        equal = torch.equal(m_live["loss"], m_back["loss"]) and same_simple_state(live, resumed)
        # one step on the card against the same step on the CPU, from the same weights
        # and a fresh optimizer, TF32 off
        w = {k: v.detach().cpu().clone() for k, v in live.model.state_dict().items()}
        card_m = copy.deepcopy(live.model)
        card_m.load_state_dict(w)
        cpu_m = copy.deepcopy(live.model).cpu()
        cpu_m.load_state_dict(w)
        sc, sp = ts.create_phonemizer_state(card_m), ts.create_phonemizer_state(cpu_m)
        with no_tf32():
            _, mc = ts.phonemizer_train_step(sc, nb)
        _, mp = ts.phonemizer_train_step(sp, batch_to_torch(nb_host, "cpu"))
        rel = abs(mc["loss"].item() - mp["loss"].item()) / abs(mp["loss"].item())
        lr = sc.optimizer.param_groups[0]["lr"]
        worst, over, far, total = param_distance(
            {n: p.detach().cpu() for n, p in card_m.named_parameters()},
            {n: p.detach().cpu() for n, p in cpu_m.named_parameters()}, lr)
        del sc, sp, card_m, cpu_m
        # the step's host ms (after the first) and one profiled step's busy share
        step_ms = []
        for _ in range(PHONEMIZER_TIMED):
            t1 = time.perf_counter()
            ts.phonemizer_train_step(live, nb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        prof = device_profile(lambda: ts.phonemizer_train_step(live, nb))
        run = out[kind] = dict(step_ms=statistics.median(step_ms[1:]), busy=prof[1] / prof[0],
                               pacc=pacc, sacc=sacc, cli_s=cli_s)
        print(f"  phonemizer {kind}: trainer CLI {cli_s:.1f} s for {steps} steps (B="
              f"{PHONEMIZER_BATCH}, {len(trainset)} train / {len(devset)} dev sentences); "
              f"dev PACC={pacc:.4f} SACC={sacc:.4f}; --resume bit-equal, next step from both "
              f"bit-equal: {equal}; card vs CPU step: loss rel {rel:.3e} tol={TOL_LOSS:.0e}, "
              f"params max {worst / lr:.4f} lr, {over} beyond 2 lr + rounding, {far} of "
              f"{total} beyond 0.01 lr; step ms (host clock, after the first) "
              f"{', '.join(f'{v:.1f}' for v in step_ms)}, median {run['step_ms']:.1f}",
              flush=True)
        print_profile(f"phonemizer {kind} train step B={PHONEMIZER_BATCH}", *prof)
        check(equal, f"phonemizer {kind}: the resumed state's next step differs from the "
                     "live one's")
        check(rel <= TOL_LOSS and over == 0 and far <= 1e-3 * total,
              f"phonemizer {kind}: the card's step differs from the CPU's")
        if kind == "aligned":
            out["pbase"] = base
            continue
        # M2M: the free-running validation decode of the dev set, card against CPU
        X = batch_to_torch(collate([devset[i] for i in range(len(devset))]), dev)
        T = X["y_phon"].shape[1]
        free = {k: v for k, v in X.items() if k not in ("y_phon", "y_new_word")}
        model = live.model.eval()
        decode = lambda: model(free, max_steps=T)
        with torch.no_grad():
            dec_ms = []
            for _ in range(4):
                t1 = time.perf_counter()
                decode()
                torch.cuda.synchronize()
                dec_ms.append((time.perf_counter() - t1) * 1e3)
            dprof = device_profile(decode)
            with no_tf32():
                got = decode()
            cpu_model = copy.deepcopy(model).cpu()
            want = cpu_model({k: v.cpu() for k, v in free.items()}, max_steps=T)
        errs = [distance(a, b)[0] for a, b in zip(got[:2], want[:2])]
        margin = min(top2_margin(want[0]), top2_margin(want[1]))
        same_fin = torch.equal(got[2].cpu(), want[2])
        run.update(decode_ms=statistics.median(dec_ms[1:]), launches_per_step=dprof[3] / T,
                   decode_busy=dprof[1] / dprof[0])
        print(f"  phonemizer m2m free-running decode of the dev set (B={len(devset)}, T={T}): "
              f"ms {', '.join(f'{v:.1f}' for v in dec_ms)} (median after the first "
              f"{run['decode_ms']:.1f}); {dprof[3]} device ops = {run['launches_per_step']:.1f} "
              f"per decode step; card vs CPU (TF32 off): phon logits max_abs_err={errs[0]:.3e}, "
              f"next-word logits {errs[1]:.3e} tol={TOL_LOGITS:.0e}, finished equal: "
              f"{same_fin}, smallest top-1/top-2 margin {margin:.3e}", flush=True)
        print_profile(f"phonemizer m2m free-running decode B={len(devset)} T={T}", *dprof)
        check(max(errs) <= TOL_LOGITS and same_fin, "phonemizer m2m: the card's free-running "
              f"decode differs from the CPU's (margin {margin:.3e})")
        del live, resumed, model, cpu_model

    # word G2P on the lexicon of the imported sentences
    lexicon = {}
    for e in [trainset[i] for i in range(len(trainset))] + [devset[i] for i in range(len(devset))]:
        for w, word in enumerate(e["words"]):
            if word.isalpha():
                lexicon.setdefault(word.lower(), [p for p, k in zip(e["hybrid"], e["phon2word"])
                                                  if k == w])
    missing = sorted(set(make_demo_corpus.WORDS) - set(lexicon))
    lex = work / "g2p" / "lexicon.tsv"
    lex.parent.mkdir()
    lex.write_text("".join(f"{w}\t{' '.join(p)}\n" for w, p in sorted(lexicon.items())))
    gbase = str(work / "g2p" / "g2p")
    t1 = time.perf_counter()
    g2p = g2p_cli.main(["--train-file", str(lex), "--dev-file", str(lex), "--store", gbase,
                        "--max-epochs", str(G2P_EPOCHS), "--patience", str(G2P_EPOCHS),
                        "--batch-size", "8"])
    torch.cuda.synchronize()
    g2p_train_s = time.perf_counter() - t1
    words = sorted(lexicon)
    g2p.transcribe(words)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    card_tr = g2p.transcribe(words)
    words_per_s = len(words) / (time.perf_counter() - t1)
    cpu_g2p = G2P("cpu")
    cpu_g2p.load(gbase, load_last=True)
    cpu_tr = cpu_g2p.transcribe(words)
    acc = sum(card_tr[i] == lexicon[w] for i, w in enumerate(words)) / len(words)
    x = torch.from_numpy(g2p.encode_words(words))
    with torch.no_grad():
        with no_tf32():
            gl, gd = g2p.model.eval()(x.to(dev), max_steps=G2P.MAX_PHONES)
        cl, cd = cpu_g2p.model.eval()(x, max_steps=G2P.MAX_PHONES)
    eos = [int(np.argmax(d)) if d.any() else G2P.MAX_PHONES - 1 for d in cd.numpy()]
    read = torch.arange(G2P.MAX_PHONES)[None, :, None] <= torch.tensor(eos)[:, None, None]
    g_err = distance(gl.cpu() * read, cl.detach() * read)[0]
    g_margin = top2_margin(cl, eos)
    same_tok = torch.equal(greedy_decode(gl, gd).cpu(), greedy_decode(cl, cd))
    out["g2p"] = dict(words_per_s=words_per_s, acc=acc, train_s=g2p_train_s)
    print(f"  g2p: lexicon of {len(words)} words (make_demo_corpus's WORDS missing: {missing}), "
          f"trained {G2P_EPOCHS} epochs on the card in {g2p_train_s:.1f} s; transcription on "
          f"the card {words_per_s:.0f} words/s, word accuracy {acc:.3f}; card vs CPU: tokens "
          f"equal {same_tok and card_tr == cpu_tr}, logits to each EOS max_abs_err={g_err:.3e} "
          f"tol={TOL_LOGITS:.0e}, smallest top-1/top-2 margin there {g_margin:.3e}", flush=True)
    check(same_tok and card_tr == cpu_tr and g_err <= TOL_LOGITS and g2p.device.type == "cuda",
          f"g2p: the card's transcription differs from the CPU's (margin {g_margin:.3e})")
    out["counts"] = read_counts()
    check(all(v == 0 for v in out["counts"].values()),
          f"phonemizer: kernels launched {out['counts']}")
    return out


def import_export_phase(work: Path, pbase: str) -> dict:
    """From raw audio to a served voice with the port alone: the demo corpus that the
    phonemizer phase wrote to `work/corpus`, imported on the card by
    `import_blizzard_2023` and again on the CPU (every .mgc within 1e-4, every other file
    equal), 2 train steps at v1 width on the imported folder, `export_model` with the
    aligned phonemizer that the phonemizer phase trained (`pbase`, its `.sacc.best`),
    and one request through TTSCube(model_path, phonemizer_path) on the card from the
    exported volumes. Returns the launches of that request and the numbers to print."""
    import tarfile

    import numpy as np
    import torch

    from ttscube_tpu_torch.api import TTSCube
    from ttscube_tpu_torch.scripts import export_model, import_blizzard_2023, train_cubegan

    corpus = work / "corpus"
    times = {}
    for where, device in (("card", []), ("cpu", ["--device", "cpu"])):
        t1 = time.perf_counter()
        for k in range(2):
            t = import_blizzard_2023.main(
                ["--input-file", str(corpus / f"align_spk{k}.txt"), "--speaker", f"spk{k}",
                 "--prefix", f"spk{k}", "--dev-ratio", "0.125",
                 "--train-output", str(work / where / "train"),
                 "--dev-output", str(work / where / "dev"), *device])
            times[where] = {n: times.get(where, {}).get(n, 0.0) + v for n, v in t.items()}
        times[where]["wall_s"] = time.perf_counter() - t1
    names = sorted(p.relative_to(work / "card") for p in (work / "card").rglob("*")
                   if p.is_file())
    check(names == sorted(p.relative_to(work / "cpu") for p in (work / "cpu").rglob("*")
                          if p.is_file()) and len(names) == 2 * IMPORT_SENTENCES * 5,
          f"import_export: {len(names)} files imported on the card")
    worst_mgc, unequal = 0.0, []
    for n in names:
        a, b = work / "card" / n, work / "cpu" / n
        if n.suffix == ".mgc":
            x, y = np.load(a), np.load(b)
            worst_mgc = max(worst_mgc, float(np.abs(x - y).max()) if x.shape == y.shape
                            else float("inf"))
        elif a.read_bytes() != b.read_bytes():
            unequal.append(str(n))
    card = times["card"]
    per = {k: card[k] / card["audio_s"] for k in ("mel_s", "pitch_s", "png_s", "total_s")}
    print(f"  import_blizzard_2023 of {2 * IMPORT_SENTENCES} utterances ({card['audio_s']:.1f} "
          f"s of audio): on the card {card['wall_s']:.2f} "
          f"s, s per audio s: mel {per['mel_s']:.5f}, pitch {per['pitch_s']:.5f}, png "
          f"{per['png_s']:.5f}, all {per['total_s']:.5f}; on the CPU {times['cpu']['wall_s']:.2f}"
          f" s (mel {times['cpu']['mel_s'] / card['audio_s']:.5f}); card vs CPU: .mgc "
          f"max_abs_err={worst_mgc:.3e} tol=1e-04, other files unequal: {unequal}", flush=True)
    check(worst_mgc <= 1e-4 and not unequal, "import_export: the card's import differs "
          "from the CPU's")

    base = str(work / "model" / "cubegan")
    t1 = time.perf_counter()
    steps = train_cubegan.main(["--train-folder", str(work / "card" / "train"), "--dev-folder",
                                str(work / "card" / "dev"), "--output-base", base,
                                "--batch-size", str(TRAINER_BATCH), "--max-steps", "2",
                                "--max-epochs", "1", "--epoch-generation", "0"])
    train_s = time.perf_counter() - t1
    check(steps == 2, f"import_export: {steps} train steps")
    (work / "dist").mkdir()
    t1 = time.perf_counter()
    n_vol = export_model.main(["--input-model", base, "--input-phonemizer", pbase,
                               "--output-model", str(work / "dist" / "voice")])
    export_s = time.perf_counter() - t1
    pkg = work / "pkg"
    pkg.mkdir()
    with open(pkg / "voice.tar.gz", "wb") as f:
        for i in range(n_vol):
            f.write((work / "dist" / f"voice-{i:02d}").read_bytes())
    with tarfile.open(pkg / "voice.tar.gz", "r:gz") as tar:
        tar.extractall(pkg)
    cube = TTSCube(str(pkg / "cubegan"), str(pkg / "phonemizer"))  # the card
    cube.warmup(speaker="spk0")
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    pcm = cube(REQUESTS[0], speaker="spk0")
    request_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    print(f"  trained 2 steps on the imported folder in {train_s:.1f} s; export_model "
          f"{export_s:.2f} s ({n_vol} volume(s); the phonemizer: {pbase}.sacc.best, trained "
          f"in the phonemizer phase); TTSCube from the exported files on "
          f"{cube.device}: request of {len(REQUESTS[0])} characters {request_ms:.1f} ms, "
          f"{len(pcm)} samples, launches {counts}", flush=True)
    check(pcm.dtype == np.int16 and len(pcm) > 0 and counts["fused_tail_stage"] == 1,
          "import_export: the exported voice did not serve through B1")
    return dict(counts=counts, per_audio_s=per, export_s=export_s, request_ms=request_ms,
                cube=cube)


def quality_phase(work: Path, cube) -> dict:
    """The served voice scored on the card, with the word-level front end and the host
    twin of length regulation, on what import_export and phonemizer left in `work`:
    QUALITY_PER_SPEAKER dev utterances of each speaker of `work/card/dev` synthesised by
    `cube` (import_export's TTSCube over the exported volumes, on the card; B1 once per
    request), written with their imported originals as orig_/synth_ pairs into
    `work/quality`; the port's eval_drive_quality on that folder on the card and on a copy
    with --device cpu (per pair MCD-DTW within TOL_MCD, F0-RMSE equal, VUV error within
    TOL_VUV points, duration error equal; the log-mels within TOL_MEL of the peak in
    linear mel; the pairs whose DTW path differs counted; ms per pair by part);
    Text2Feat with the word G2P of the phonemizer phase loaded on the card as its hook and
    a Lexicon over QUALITY_LEXICON, on REQUESTS and QUALITY_TEXT, against the same with
    the G2P on the CPU (TF32 off; equal results, the lexicon's phones on its words, none
    of them passed to the hook; words per second under the default settings); patch over
    a copy of the dev folder (each .pitch as long as the importer's, the share of frames
    whose voicing or F0 differs printed); the numpy twin of durations_to_frame2phone
    against the torch function on the card at TWIN_SHAPE. Returns the synthesis'
    launches and the numbers to print."""
    import shutil

    import numpy as np
    import torch

    from ttscube_tpu_torch.data.text import Lexicon, SimpleTokenizer, Text2Feat
    from ttscube_tpu_torch.dsp.pitch import rapt_pitch
    from ttscube_tpu_torch.models.g2p import G2P
    from ttscube_tpu_torch.ops.length_regulator import (durations_to_frame2phone,
                                                        durations_to_frame2phone_np)
    from ttscube_tpu_torch.scripts import eval_drive_quality, patch
    from ttscube_tpu_torch.utils.wavio import read_wav, write_wav

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    dev_dir = work / "card" / "dev"
    items = [json.loads(f.read_text()) for f in sorted(dev_dir.glob("*.json"))]
    speakers = sorted({it["speaker"] for it in items})
    chosen = [it for spk in speakers
              for it in [i for i in items if i["speaker"] == spk][:QUALITY_PER_SPEAKER]]
    check(len(speakers) == 2 and len(chosen) == 2 * QUALITY_PER_SPEAKER,
          f"quality: {len(chosen)} dev utterances of speakers {speakers}")

    # synthesis: one request per utterance through TTSCube on the card
    qdir = work / "quality"
    qdir.mkdir()
    synth_ms = []
    torch.cuda.synchronize()
    zero_counts()
    for it in chosen:
        uid = it["id"]
        shutil.copyfile(dev_dir / f"{uid}.wav", qdir / f"orig_{uid}.wav")
        sr = read_wav(str(dev_dir / f"{uid}.wav"))[1]
        t1 = time.perf_counter()
        pcm = cube(it["orig_text"], speaker=it["speaker"])
        synth_ms.append((time.perf_counter() - t1) * 1e3)
        check(pcm.dtype == np.int16 and len(pcm) > 0, f"quality: request {uid}")
        write_wav(str(qdir / f"synth_{uid}.wav"), pcm, sr)
    counts = read_counts()
    print(f"  synthesised {len(chosen)} dev utterances ({', '.join(it['id'] for it in chosen)}) "
          f"through TTSCube on {cube.device}: ms {', '.join(f'{v:.1f}' for v in synth_ms)}; "
          f"launches {counts}", flush=True)
    check(counts["fused_tail_stage"] == len(chosen),
          f"quality: B1 launched {counts['fused_tail_stage']} times for {len(chosen)} requests")

    # scoring: the port's script on the card, then on a copy with --device cpu
    cpu_dir = work / "quality_cpu"
    cpu_dir.mkdir()
    for f in qdir.glob("*.wav"):
        shutil.copyfile(f, cpu_dir / f.name)
    t1 = time.perf_counter()
    card_sum = eval_drive_quality.main(["--dir", str(qdir), "--protocol", ""])
    card_s = time.perf_counter() - t1
    cpu_sum = eval_drive_quality.main(["--dir", str(cpu_dir), "--protocol", "",
                                       "--device", "cpu"])
    rows = {r["id"]: r for r in cpu_sum["pairs"]}
    check(sorted(rows) == sorted(r["id"] for r in card_sum["pairs"]) == sorted(
        it["id"] for it in chosen), "quality: the scored pairs")
    mcd_err = max(abs(r["mcd_dtw_db"] - rows[r["id"]]["mcd_dtw_db"]) for r in card_sum["pairs"])
    vuv_err = max(abs(r["vuv_error_pct"] - rows[r["id"]]["vuv_error_pct"])
                  for r in card_sum["pairs"])
    same_f0_dur = all(r["f0_rmse_hz"] == rows[r["id"]]["f0_rmse_hz"] and r["dur_error_pct"] ==
                      rows[r["id"]]["dur_error_pct"] for r in card_sum["pairs"])
    # each pair again by part, the card's log-mels and DTW path beside the CPU's
    parts = {"mel": [], "rapt": [], "dtw": [], "pair": []}
    paths_differ, mel_err = 0, 0.0
    for uid in sorted(rows):
        t_pair = time.perf_counter()
        wavs = [read_wav(str(qdir / f"{kind}_{uid}.wav")) for kind in ("orig", "synth")]
        t1 = time.perf_counter()
        mels = [eval_drive_quality.log_mel(w, r, dev) for w, r in wavs]
        t2 = time.perf_counter()
        f0 = [rapt_pitch(w, sr=r) for w, r in wavs]
        t3 = time.perf_counter()
        _, path = eval_drive_quality.mcd_dtw(*mels)
        eval_drive_quality.f0_metrics(*f0, path)
        t4 = time.perf_counter()
        for k, v in (("mel", t2 - t1), ("rapt", t3 - t2), ("dtw", t4 - t3), ("pair", t4 - t_pair)):
            parts[k].append(v * 1e3)
        cpu_mels = [eval_drive_quality.log_mel(w, r, "cpu") for w, r in wavs]
        paths_differ += eval_drive_quality.mcd_dtw(*cpu_mels)[1] != path
        for a, b in zip(mels, cpu_mels):
            la, lb = 10.0 ** a.astype(np.float64), 10.0 ** b.astype(np.float64)
            mel_err = max(mel_err, float(np.abs(la - lb).max() / lb.max()))
    per_pair = {k: statistics.median(v) for k, v in parts.items()}
    print(f"  eval_drive_quality on {len(rows)} pairs: card {card_s:.2f} s, mean MCD-DTW "
          f"{card_sum['mean_mcd_dtw_db']} dB (CPU {cpu_sum['mean_mcd_dtw_db']}), chance floor "
          f"{card_sum['calibration']['chance_floor_mcd_dtw_db']} dB, mean F0-RMSE "
          f"{card_sum['mean_f0_rmse_hz']} Hz, VUV {card_sum['mean_vuv_error_pct']} %, duration "
          f"{card_sum['mean_dur_error_pct']} %, voiced {card_sum['mean_voiced_ratio_synth']}; "
          f"card vs CPU: MCD max diff {mcd_err:.4f} dB tol={TOL_MCD}, F0-RMSE and duration "
          f"equal: {same_f0_dur}, VUV max diff {vuv_err:.2f} points tol={TOL_VUV}, log-mels "
          f"max_abs_err {mel_err:.3e} of the peak (linear) tol={TOL_MEL:.0e}, pairs whose DTW "
          f"path differs: {paths_differ}; ms per pair (median of {len(rows)}, host clock): "
          f"mel on the card {per_pair['mel']:.2f}, RAPT {per_pair['rapt']:.2f}, DTW "
          f"{per_pair['dtw']:.2f}, whole pair {per_pair['pair']:.2f}", flush=True)
    check(mcd_err <= TOL_MCD and same_f0_dur and vuv_err <= TOL_VUV and mel_err <= TOL_MEL,
          "quality: the card's scores differ from the CPU's")

    # Text2Feat with the word G2P on the card as its hook, against the same on the CPU
    gbase = str(work / "g2p" / "g2p")
    g2ps = {"card": G2P(), "cpu": G2P("cpu")}
    for g in g2ps.values():
        g.load(gbase, load_last=True)
    lexicon = Lexicon()
    lexicon.word2phones = QUALITY_LEXICON
    calls = []

    def hook(g):
        def transcribe(words):
            calls.append(list(words))
            return g.transcribe(words)
        return transcribe

    t2f = {k: Text2Feat(hook(g), lexicon) for k, g in g2ps.items()}
    texts = REQUESTS + (QUALITY_TEXT,)
    with no_tf32():
        got = [t2f["card"](t) for t in texts]
    want = [t2f["cpu"](t) for t in texts]
    n_words = sum(t.is_word for text in texts for t in SimpleTokenizer()(text))
    t2f_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        for t in texts:
            t2f["card"](t)
        torch.cuda.synchronize()
        t2f_s.append(time.perf_counter() - t1)
    words_per_s = n_words / statistics.median(t2f_s)
    seen = {w.lower() for c in calls for w in c}
    # each lexicon word's phones: the lexicon's, its '_' dropped
    lex_words = [([p for p, k in zip(o["phones"], o["phon2word"]) if k == i], w.lower())
                 for o in got for i, w in enumerate(o["words"]) if w in lexicon]
    n_lex = len(lex_words)
    print(f"  Text2Feat on the card (the phonemizer phase's word G2P, {g2ps['card'].device}, as "
          f"the hook; a Lexicon over {sorted(QUALITY_LEXICON)}) on {len(texts)} texts, "
          f"{n_words} words: equal to the CPU's: {got == want}; {len(calls)} hook calls, "
          f"lexicon words among them: {sorted(seen & set(QUALITY_LEXICON))}; {n_lex} lexicon "
          f"words in the texts; {words_per_s:.0f} words/s (median of 3 passes, host clock)",
          flush=True)
    check(got == want, "quality: Text2Feat on the card differs from the CPU's")
    check(not seen & set(QUALITY_LEXICON) and n_lex > 0 and all(
        ph == [p for p in QUALITY_LEXICON[w] if p != "_"] for ph, w in lex_words),
          "quality: the lexicon did not override the hook")

    # patch over a copy of the dev folder, against the importer's .pitch files
    pdir = work / "patch_dev"
    shutil.copytree(dev_dir, pdir)
    t1 = time.perf_counter()
    done = patch.main(["--folder", str(pdir)])
    patch_s = time.perf_counter() - t1
    frames = voicing = f0_diff = 0
    for base in done:
        name = Path(base).name
        a, b = np.load(dev_dir / f"{name}.pitch"), np.load(pdir / f"{name}.pitch")
        check(a.shape == b.shape, f"quality: patch's {name}.pitch {b.shape} against the "
              f"importer's {a.shape}")
        frames += len(a)
        voicing += int(((a > 0) != (b > 0)).sum())
        f0_diff += int((a != b).sum())
    check(len(done) == len(items), f"quality: patch wrote {len(done)} of {len(items)}")
    print(f"  patch over {len(done)} dev wavs in {patch_s:.2f} s: every .pitch as long as the "
          f"importer's; of {frames} frames, voicing differs in {voicing / frames:.4f}, F0 in "
          f"{f0_diff / frames:.4f} (the importer tracks the float segment, patch the int16 "
          f".wav)", flush=True)

    # the numpy twin against the torch function on the card, at bench.py's shape
    B, N, F = TWIN_SHAPE
    rng = np.random.default_rng(SEED)
    n_valid = rng.integers(1, N + 1, B).astype(np.int32)
    durs = rng.integers(2, 12, (B, N)).astype(np.int32)  # some rows longer than F
    durs[np.arange(N)[None, :] >= n_valid[:, None]] = 0
    f2p, mask = durations_to_frame2phone_np(durs, n_valid, F)
    tf2p, tmask = durations_to_frame2phone(torch.from_numpy(durs).to(dev),
                                           torch.from_numpy(n_valid).to(dev), F)
    twin_equal = (tf2p.is_cuda and np.array_equal(f2p, tf2p.cpu().numpy())
                  and np.array_equal(mask, tmask.cpu().numpy()))
    over = int((durs.sum(axis=1) > F).sum())
    print(f"  durations_to_frame2phone_np against durations_to_frame2phone on the card at "
          f"B={B} N={N} F={F} (valid phones {n_valid.min()}-{n_valid.max()}, {over} rows "
          f"longer than F): equal {twin_equal}", flush=True)
    check(twin_equal, "quality: the numpy twin differs from the torch function on the card")
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= QUALITY_BUDGET_S, f"quality: {phase_s:.1f} s, over {QUALITY_BUDGET_S} s")
    return dict(counts=counts, per_pair=per_pair, words_per_s=words_per_s, mcd_err=mcd_err,
                paths_differ=paths_differ, mean_mcd=card_sum["mean_mcd_dtw_db"],
                synth_ms=synth_ms)


def write_vec(path: Path, words, dim: int, seed: int) -> str:
    """A seeded fastText `.vec` table ("count dim" header, one word per line)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    path.write_text(f"{len(words)} {dim}\n" + "".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(dim)) + "\n"
        for w in words))
    return str(path)


def unpack(volumes: str, n: int, dest: Path) -> list:
    """The export's `n` volumes `{volumes}-NN` joined and unpacked into `dest`; returns
    the archive's member names."""
    import tarfile

    dest.mkdir(parents=True)
    with open(dest / "voice.tar.gz", "wb") as f:
        for i in range(n):
            f.write(Path(f"{volumes}-{i:02d}").read_bytes())
    with tarfile.open(dest / "voice.tar.gz", "r:gz") as tar:
        tar.extractall(dest)
        return tar.getnames()


def lm_phase(work: Path, pbase: str) -> dict:
    """HF and fastText conditioning on the card, on the corpus that import_export
    imported into `work/card` and with the aligned phonemizer the phonemizer phase
    trained (`pbase`): the port's make_demo_lm writes the BERT-base directory (768
    wide, 12 layers, 12 heads, the vocabulary padded to LM_VOCAB rows, seeded) and one of
    LM_CLI_LAYERS layers at the same width for the trainer CLI's round trip, beside a
    seeded LM_VEC_DIM-d `.vec` over the demo lexicon; the BERT-base encoder alone on the
    card against the CPU (fp32, TF32 off, LM_CHECK, one row padded, one fully masked;
    TOL_LM); the trainer CLI with `--lm hf:<dir> --fused-tail-train` (B1 and B2 launch,
    the encoder moves by less than 1e-4, `--resume` bit-equal and the next step from it
    bit-equal under deterministic algorithms) and with `--lm fasttext:<vec>`; one train
    step at B = LM_STEP_BATCH with 512-token windows through the BERT-base encoder, its
    host ms and busy share beside the same step without the LM, and the encoder's
    forward and backward alone; each voice exported (`--wordvec`, `cubegan.hf/`) and
    served by TTSCube on the card from the unpacked files, the HF voice with its
    tokenizer directory moved away: the first request after warmup within
    FIRST_REQUEST_BOUND of the steady one, REQUESTS' latencies, an fp32 request against
    the CPU (TOL_FP32), and for HF the encoder's device ms in a request. Returns the
    launches of the phase's paths and the numbers to print."""
    import copy
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from ttscube_tpu_torch.api import TTSCube
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.models.lm import TransformerEncoder, load_local_lm
    from ttscube_tpu_torch.scripts import export_model, make_demo_corpus, make_demo_lm
    from ttscube_tpu_torch.utils import config_io
    from ttscube_tpu_torch.utils.checkpoint import load_config
    from ttscube_tpu_torch.utils.hf import HFTokenizer

    dev = torch.device("cuda")
    out = {"counts": []}
    t1 = time.perf_counter()
    dirs = {name: make_demo_lm.main(
        ["--output", str(work / f"lm_{name}"), "--hidden", "768", "--layers", str(layers),
         "--heads", "12", "--pad-vocab", str(LM_VOCAB), "--seed", str(SEED)])
        for name, layers in (("base", 12), ("cli", LM_CLI_LAYERS))}
    vec = write_vec(work / "words.vec", sorted(make_demo_corpus.WORDS), LM_VEC_DIM, SEED)
    print(f"  make_demo_lm: BERT-base (768 wide, 12 layers, 12 heads, vocabulary "
          f"{LM_VOCAB}) and the CLI's {LM_CLI_LAYERS}-layer directory in "
          f"{time.perf_counter() - t1:.1f} s; pytorch_model.bin "
          f"{os.path.getsize(os.path.join(dirs['base'], 'pytorch_model.bin'))} bytes",
          flush=True)

    # the BERT-base encoder alone, card against CPU
    cfg12, sd12 = load_local_lm(dirs["base"])
    check(sd12 is not None and (cfg12.hidden_size, cfg12.num_layers, cfg12.num_heads,
                                cfg12.intermediate_size, cfg12.vocab_size)
          == (768, 12, 12, 3072, LM_VOCAB), f"lm: the BERT-base directory's config {cfg12}")
    enc_cpu = TransformerEncoder(cfg12).eval()
    enc_cpu.load_state_dict(sd12, strict=True)
    enc = copy.deepcopy(enc_cpu).to(dev)
    B, T = LM_CHECK
    g = torch.Generator().manual_seed(T)
    ids = torch.randint(1, LM_VOCAB, (B, T), generator=g)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[0, T - 23:], ids[0, T - 23:] = False, 0  # padded
    mask[1] = False  # every token masked: a uniform softmax, as in JAX
    with torch.no_grad():
        with no_tf32():
            got = enc(ids.to(dev), mask.to(dev))
            again = enc(ids.to(dev), mask.to(dev))
        want = enc_cpu(ids, mask)
        ids_d, mask_d = ids.to(dev), mask.to(dev)
        enc_ms = statistics.median(cuda_times(lambda: enc(ids_d, mask_d), 5, TIME_PER))
    err = distance(got, want)[0]
    print(f"  BERT-base encoder B={B} T={T} (row 0 padded after {T - 23}, row 1 fully "
          f"masked) fp32 (TF32 off) card vs CPU max_abs_err={err:.3e} tol={TOL_LM:.0e} "
          f"bit_equal_relaunch={torch.equal(got, again)}; forward {enc_ms:.3f} ms on the "
          f"card (median over {TIME_PER} in a row)", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= TOL_LM,
          f"lm: the encoder on the card differs from the CPU by {err:.3e}")
    del enc, enc_cpu

    # the trainer CLI: --lm hf (B1 and B2) and --lm fasttext
    train, dev_folder = str(work / "card" / "train"), str(work / "card" / "dev")

    def argv(name, spec):
        base = str(work / "lm_model" / name / "cubegan")
        return base, ["--train-folder", train, "--dev-folder", dev_folder, "--output-base",
                      base, "--batch-size", str(TRAINER_BATCH), "--max-steps", "2",
                      "--max-epochs", "1", "--epoch-generation", "0", "--fused-tail-train",
                      "--lm", spec]

    runs = {}
    for kind, spec in (("hf", f"hf:{dirs['cli']}"), ("fasttext", f"fasttext:{vec}")):
        base, args = argv(kind, spec)
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        live = train_cli(args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        counts = read_counts()
        out["counts"].append(counts)
        conf = load_config(base)
        check(live.step == 2 and counts["fused_tail_stage_grad"] == 2
              and counts["fused_tail_stage"] >= 2 and os.path.exists(base + ".opt.last")
              and conf["conditioning"] == spec and ("lm_config" in conf) == (kind == "hf"),
              f"lm {kind} trainer: step {live.step}, launches {counts}, yaml {conf}")
        runs[kind] = dict(base=base, args=args, live=live, cli_s=cli_s, counts=counts)
        print(f"  trainer CLI --lm {kind} (--fused-tail-train, B={TRAINER_BATCH}): {cli_s:.1f} "
              f"s for 2 steps, validation and the saves; launches {counts}", flush=True)
    live = runs["hf"]["live"]
    check(hasattr(live.model, "hf") and "b" in live.optimizers
          and live.model.hf.config.num_layers == LM_CLI_LAYERS
          and runs["fasttext"]["live"].model.lang.tower_t.lm.input_size == LM_VEC_DIM,
          "lm: the trainers' models")
    _, imported = load_local_lm(dirs["cli"])
    moved = max(float((live.model.hf.state_dict()[k].cpu() - v).abs().max())
                for k, v in imported.items())
    t1 = time.perf_counter()
    resumed = train_cli(runs["hf"]["args"] + ["--resume", "--max-epochs", "0"])
    resume_s = time.perf_counter() - t1
    restored = resumed.step == 2 and same_train_state(live, resumed)
    tenc = CubeganEncodings(runs["hf"]["base"] + ".encodings")
    ds = CubeganDataset(train, hf_tokenizer=HFTokenizer(dirs["cli"]))
    collate = CubeganCollate(tenc, hf_conditioning=True, bucket_tokens=512, bucket_words=8)
    nb = tcg.batch_to_torch(collate([ds[i] for i in range(TRAINER_BATCH)]), dev)
    with deterministic():
        _, m_live = tcg.train_step(live, nb)
        _, m_back = tcg.train_step(resumed, nb)
    equal = (all(torch.equal(v, m_back[k]) for k, v in m_live.items())
             and same_train_state(live, resumed))
    print(f"  --lm hf: the imported encoder moved by {moved:.3e} in 2 steps (b partition, "
          f"Adam at 1e-6; limit 1e-4); --resume in {resume_s:.1f} s restores the state "
          f"bit-equal: {restored}; next step from both bit-equal: {equal}", flush=True)
    check(0 < moved < 1e-4, f"lm: the encoder moved by {moved:.3e}")
    check(restored and equal, "lm: --resume or the next step from it differs")
    del resumed, runs["hf"]["live"], runs["fasttext"]["live"], live, nb

    # one train step at B = LM_STEP_BATCH with 512-token windows through BERT-base,
    # beside the same step without the LM
    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=len(tenc.phon2int),
                                    num_speakers=len(tenc.speaker2int),
                                    max_pitch=tenc.max_pitch, max_duration=tenc.max_duration,
                                    cond_type="hf", lm_dim=cfg12.hidden_size),
        hifigan=HifiganConfig(fused_tail_train=True))
    ds12 = CubeganDataset(train, hf_tokenizer=HFTokenizer(dirs["base"]))
    b16 = tcg.batch_to_torch(collate([ds12[i] for i in range(LM_STEP_BATCH)]), dev)
    check(tuple(b16["x_tok_ids"].shape) == (LM_STEP_BATCH, 512), "lm: the step's token window")
    step_rows = {}
    for name in ("hf", "plain"):
        if name == "hf":
            model = init_random(tcg.Cubegan(cfg, train=True, lm_config=cfg12), SEED + 20)
            model.hf.load_state_dict(sd12, strict=True)
            batch = b16
        else:
            model = init_random(tcg.Cubegan(dataclasses.replace(
                cfg, languasito=dataclasses.replace(cfg.languasito, cond_type=None,
                                                    lm_dim=None)), train=True), SEED + 20)
            batch = {k: v for k, v in b16.items()
                     if k not in ("x_tok_ids", "x_tok_mask", "x_word2tok")}
        st = tcg.create_train_state(model.to(dev))
        torch.cuda.synchronize()
        zero_counts()
        ms = []
        for _ in range(LM_TIMED_STEPS):
            t1 = time.perf_counter()
            tcg.train_step(st, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        counts = read_counts()
        check(counts["fused_tail_stage_grad"] == LM_TIMED_STEPS,
              f"lm {name} step: launches {counts}")
        if name == "hf":
            out["counts"].append(counts)
        prof = device_profile(lambda: tcg.train_step(st, batch))
        row = step_rows[name] = dict(ms=statistics.median(ms[1:]), busy=prof[1] / prof[0],
                                     busy_ms=prof[1])
        if name == "hf":
            hf = st.model.hf
            ids16, mask16 = b16["x_tok_ids"], b16["x_tok_mask"]
            row["enc_ms"] = statistics.median(cuda_times(
                lambda: hf(ids16, mask16).sum().backward(), 3))
            hf.zero_grad(set_to_none=True)
        what = "BERT-base over 512-token windows" if name == "hf" else "without the LM"
        print(f"  train step B={LM_STEP_BATCH} ({what}, fp32 with the fused tail, "
              f"default TF32): host ms {', '.join(f'{v:.1f}' for v in ms)}, median after "
              f"the first {row['ms']:.1f}", flush=True)
        print_profile(f"train step B={LM_STEP_BATCH} {name}", *prof)
        del st, model, batch
        torch.cuda.empty_cache()
    hf_row = step_rows["hf"]
    print(f"  the encoder's forward and backward alone (B={LM_STEP_BATCH}, T=512): "
          f"{hf_row['enc_ms']:.1f} ms on the card = {hf_row['enc_ms'] / hf_row['busy_ms']:.3f} "
          f"of the step's device-busy ms; the step {hf_row['ms']:.1f} ms against "
          f"{step_rows['plain']['ms']:.1f} without the LM", flush=True)
    out["step"] = step_rows

    # export and serve both voices from the unpacked files
    served = {}
    for kind in ("hf", "fasttext"):
        vol = str(work / "lm_dist" / kind / "voice")
        os.makedirs(os.path.dirname(vol))
        t1 = time.perf_counter()
        n = export_model.main(["--input-model", runs[kind]["base"], "--input-phonemizer", pbase,
                               "--output-model", vol]
                              + (["--wordvec", vec] if kind == "fasttext" else []))
        export_s = time.perf_counter() - t1
        pkg = work / "lm_pkg" / kind
        names = unpack(vol, n, pkg)
        check(("cubegan.hf/tokenizer.json" in names and not any(
            x.endswith(".bin") for x in names)) if kind == "hf" else
              "cubegan.wordvec.npz" in names, f"lm {kind} export: {names}")
        away = work / "lm_cli_moved"
        if kind == "hf":
            os.rename(dirs["cli"], away)  # only cubegan.hf/ can serve the voice now
        try:
            cube = TTSCube(str(pkg / "cubegan"), str(pkg / "phonemizer"))  # the card
            check(hasattr(cube.model, "hf") == (kind == "hf") and cube.device.type == "cuda",
                  f"lm {kind}: the served model")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cube.warmup(speaker="spk0")
            warm_s = time.perf_counter() - t1
            first = []
            for _ in range(4):
                t1 = time.perf_counter()
                cube(REQUESTS[0], speaker="spk0")
                first.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            zero_counts()
            lat = {}
            for text in REQUESTS:
                ms = []
                for _ in range(3):
                    t1 = time.perf_counter()
                    pcm = cube(text, speaker="spk0")
                    ms.append((time.perf_counter() - t1) * 1e3)
                check(pcm.dtype == np.int16 and len(pcm) > 0, f"lm {kind}: served audio")
                lat[len(text)] = (statistics.median(ms), len(pcm) // HOP)
            counts = read_counts()
            out["counts"].append(counts)
            check(counts["fused_tail_stage"] == 3 * len(REQUESTS),
                  f"lm {kind}: B1 launches for {3 * len(REQUESTS)} requests: {counts}")
            row = served[kind] = dict(export_s=export_s, warm_s=warm_s, first=first[0],
                                      steady=statistics.median(first[1:]), lat=lat)
            if kind == "hf":
                X = cube._prepare(REQUESTS[1], "spk0")
                with torch.inference_mode():
                    eprof = device_profile(lambda: cube.model.hf(X["x_tok_ids"],
                                                                 X["x_tok_mask"]))
                rprof = device_profile(lambda: cube(REQUESTS[1], speaker="spk0"))
                row.update(enc_ms=eprof[1], req_busy=rprof[1], req_wall=rprof[0],
                           tokens=tuple(X["x_tok_ids"].shape))
            # an fp32 request on the card (TF32 off) against the CPU, from the same files
            # with fp32 storage
            pkg32 = work / "lm_pkg32" / kind
            shutil.copytree(pkg, pkg32)
            conf = config_io.load(str(pkg32 / "cubegan.yaml"))
            conf["hifigan"] = {"storage_dtype": "float32"}
            config_io.dump(conf, str(pkg32 / "cubegan.yaml"))
            on_card = TTSCube(str(pkg32 / "cubegan"), str(pkg32 / "phonemizer"), device="cuda")
            on_cpu = TTSCube(str(pkg32 / "cubegan"), str(pkg32 / "phonemizer"), device="cpu")
            with no_tf32():
                a_card, n_card = on_card.synthesize(REQUESTS[0], speaker="spk0")
            a_cpu, n_cpu = on_cpu.synthesize(REQUESTS[0], speaker="spk0")
            row["fp32_err"] = float(abs(a_card - a_cpu).max()) if n_card == n_cpu else np.inf
            del cube, on_card, on_cpu
        finally:
            if away.exists():
                os.rename(away, dirs["cli"])
        moved_note = " (tokenizer directory moved away)" if kind == "hf" else ""
        print(f"  {kind} voice: export_model {export_s:.2f} s ({n} volume(s)); TTSCube from "
              f"the unpacked files on the card{moved_note}: warmup {warm_s:.2f} s, first request after it {row['first']:.1f} ms, steady "
              f"{row['steady']:.1f} ms (bound {FIRST_REQUEST_BOUND}x); requests (median of 3) "
              + ", ".join(f"{c} chars ({f} frames) {v:.1f} ms" for c, (v, f) in lat.items())
              + f"; fp32 card vs CPU max_abs_err={row['fp32_err']:.3e} tol={TOL_FP32:.0e}",
              flush=True)
        if kind == "hf":
            print(f"  hf voice ({LM_CLI_LAYERS}-layer encoder): the encoder alone on the "
                  f"request's window {row['tokens']} {row['enc_ms']:.3f} device ms; the "
                  f"request of {len(REQUESTS[1])} chars under the profiler: wall "
                  f"{row['req_wall']:.1f} ms, device busy {row['req_busy']:.1f} ms "
                  f"(encoder {row['enc_ms'] / row['req_busy']:.3f} of it)", flush=True)
        check(row["fp32_err"] <= TOL_FP32, f"lm {kind}: fp32 audio on the card differs "
                                           f"from the CPU by {row['fp32_err']:.3e}")
        check(row["first"] <= FIRST_REQUEST_BOUND * row["steady"],
              f"lm {kind}: the first request after warmup took {row['first']:.1f} ms, more "
              f"than {FIRST_REQUEST_BOUND} x the steady state's {row['steady']:.1f} ms")
    out["served"] = served
    out["counts"] = {n: sum(c[n] for c in out["counts"]) for n in out["counts"][0]}
    out["enc_err"] = err
    return out


def legacy_phase(work: Path) -> dict:
    """Textcoder and the dual-rate WaveRNN vocoder on the card at their full widths, on
    the corpus that import_export imported into `work/card`: the Textcoder trainer CLI
    (B = LEGACY_BATCH, pframes 3, TEXTCODER_CLI_STEPS steps with validation and saves:
    the JAX package's file names, `--resume` bit-equal and the next step from it
    bit-equal under deterministic algorithms); TEXTCODER_TIMED steps at B = LEGACY_BATCH
    (host-clock median, busy share) and one B = 2 step on the card against the CPU (TF32
    off: losses TOL_LOSS relative, the parameters in units of lr, the running averages);
    `synthesize_devset` forced and free for SYNTH_UTTS dev utterances through a v1
    Generator at full width from seeded weights (ms per utterance, the free run's ms and
    device launches per decoder group); the vocoder trainer CLI at its defaults (2 x 512
    GRUs at 24 and 2.4 kHz, MOL, crops of 24,000 samples, B = 16) for VOCODER_CLI_STEPS
    steps (`.lr.best` and `.hr.best` written, `--resume` bit-equal); VOCODER_TIMED steps
    (host-clock median, busy share, peak memory); `CubenetVocoder.infer` on INFER_FRAMES
    frames of a dev utterance's mel in INFER_CHUNKS chunks (audio s per wall s, µs and
    device launches per sample step, and the logits each step sampled from against the
    teacher-forced nets on the samples, fp32 with TF32 off, within TOL_SAMPLER). None of
    the kernels runs here. Returns the launches of the phase's paths and the numbers to
    print."""
    import copy
    import os

    import numpy as np
    import torch

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import TextcoderCollate, VocoderCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset, VocoderDataset
    from ttscube_tpu_torch.data.encodings import TextcoderEncodings
    from ttscube_tpu_torch.models.cubegan import batch_to_torch
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
    from ttscube_tpu_torch.scripts import train_textcoder, train_vocoder
    from ttscube_tpu_torch.train import states as ts
    from ttscube_tpu_torch.train.runtime import synthesize_devset

    dev = torch.device("cuda")
    train_dir, dev_dir = work / "card" / "train", work / "card" / "dev"
    out = {}
    clock = [time.perf_counter()]

    def lap() -> str:
        """The seconds since the phase's previous part ended, for its print line."""
        now = time.perf_counter()
        took, clock[0] = now - clock[0], now
        return f"[part {took:.1f} s]"

    torch.cuda.synchronize()
    zero_counts()

    # -- Textcoder: the trainer CLI, resume, its next step --------------------------------
    base = str(work / "legacy" / "textcoder")
    argv = ["--train-folder", str(train_dir), "--dev-folder", str(dev_dir), "--output-base",
            base, "--batch-size", str(LEGACY_BATCH), "--pframes", "3"]
    t1 = time.perf_counter()
    live = train_textcoder.main(argv + ["--max-steps", str(TEXTCODER_CLI_STEPS)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    files = [ext for ext in ("yaml", "encodings", "best", "last", "opt.last")
             if os.path.getsize(f"{base}.{ext}") > 0]
    check(live.step == TEXTCODER_CLI_STEPS and len(files) == 5
          and next(live.model.parameters()).is_cuda, f"legacy textcoder: {live.step} steps, "
          f"files {files}")
    resumed = train_textcoder.main(argv + ["--resume", "--max-epochs", "0"])
    restored = same_simple_state(live, resumed)
    enc = TextcoderEncodings(base + ".encodings")
    collate = TextcoderCollate(enc)
    trainset, devset = CubeganDataset(str(train_dir)), CubeganDataset(str(dev_dir))
    nb_host = collate([trainset[i] for i in range(LEGACY_BATCH)])
    nb = batch_to_torch(nb_host, dev)
    with deterministic():
        _, m_live = ts.textcoder_train_step(live, nb)
        _, m_back = ts.textcoder_train_step(resumed, nb)
    equal = torch.equal(m_live["loss"], m_back["loss"]) and same_simple_state(live, resumed)
    print(f"  textcoder trainer CLI: {TEXTCODER_CLI_STEPS} steps at B={LEGACY_BATCH} with "
          f"validation and saves {cli_s:.1f} s ({len(trainset)} train / {len(devset)} dev "
          f"utterances; files {', '.join(files)}); --resume bit-equal: {restored}, the next "
          f"step from both bit-equal: {equal} {lap()}", flush=True)
    check(restored and equal, "legacy textcoder: --resume or the step after it differs")
    del resumed

    # -- Textcoder: the step's time, and one B = 2 step against the CPU ---------------------
    step_ms = []
    for _ in range(TEXTCODER_TIMED):
        t1 = time.perf_counter()
        ts.textcoder_train_step(live, nb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    prof = device_profile(lambda: ts.textcoder_train_step(live, nb))
    small_host = collate([trainset[i] for i in range(2)])
    w = {k: v.detach().cpu().clone() for k, v in live.model.state_dict().items()}
    card_m, cpu_m = copy.deepcopy(live.model), copy.deepcopy(live.model).cpu()
    card_m.load_state_dict(w)
    cpu_m.load_state_dict(w)
    sc, sp = ts.create_textcoder_state(card_m), ts.create_textcoder_state(cpu_m)
    with no_tf32():
        _, mc = ts.textcoder_train_step(sc, batch_to_torch(small_host, dev))
    _, mp = ts.textcoder_train_step(sp, batch_to_torch(small_host, "cpu"))
    rel = max(abs(mc[k].item() - mp[k].item()) / abs(mp[k].item()) for k in mp)
    lr = sc.optimizer.param_groups[0]["initial_lr"]
    worst, over, far, total = param_distance(
        {n: p.detach().cpu() for n, p in card_m.named_parameters()},
        {n: p.detach().cpu() for n, p in cpu_m.named_parameters()}, lr)
    stats_err = max(distance(b.cpu(), cpu_m.state_dict()[n])[0]
                    for n, b in card_m.named_buffers())
    del sc, sp, card_m, cpu_m
    out["textcoder"] = dict(step_ms=statistics.median(step_ms[1:]), busy=prof[1] / prof[0],
                            cli_s=cli_s)
    print(f"  textcoder step B={LEGACY_BATCH} ms (host clock) "
          f"{', '.join(f'{v:.1f}' for v in step_ms)}, median after the first "
          f"{out['textcoder']['step_ms']:.1f}; card vs CPU step B=2 (TF32 off): losses max "
          f"rel {rel:.3e} tol={TOL_LOSS:.0e}, params max {worst / lr:.4f} lr, {over} beyond 2 "
          f"lr + rounding, {far} of {total} beyond 0.01 lr; running averages "
          f"max_abs_err={stats_err:.3e} tol=1e-05 {lap()}", flush=True)
    print_profile(f"textcoder train step B={LEGACY_BATCH}", *prof)
    check(rel <= TOL_LOSS and over == 0 and far <= 1e-3 * total and stats_err <= 1e-5,
          "legacy textcoder: the card's step differs from the CPU's")

    # -- synthesize_devset through a v1 generator ---------------------------------------------
    gen = init_random(Generator(HifiganConfig()), SEED + 11).to(dev).eval()
    subset = [devset[i] for i in range(SYNTH_UTTS)]
    synth = {}
    for forced in (True, False):
        where = work / "legacy" / ("forced" if forced else "free")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mels = synthesize_devset(live.model, gen, subset, collate, str(where),
                                 forced_synthesis=forced, max_frames=SYNTH_FRAMES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / SYNTH_UTTS
        names = sorted(p.name for p in where.iterdir())
        check(len(names) == 2 * SYNTH_UTTS and all(np.isfinite(m).all() for m in mels),
              f"legacy synthesize_devset: {names}")
        synth["forced" if forced else "free"] = ms
    X = {k: v for k, v in batch_to_torch(collate(subset[:1]), dev).items() if k.startswith("x_")}
    groups = -(-SYNTH_FRAMES // 3)
    live.model.eval()
    with torch.no_grad():
        live.model.infer(X, SYNTH_FRAMES, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        live.model.infer(X, SYNTH_FRAMES, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        free_ms = (time.perf_counter() - t1) * 1e3
        fprof = device_profile(lambda: live.model.infer(
            X, SYNTH_FRAMES, generator=torch.Generator().manual_seed(0)))
    out["synth"] = dict(synth, group_ms=free_ms / groups, launches_per_group=fprof[3] / groups)
    print(f"  synthesize_devset {SYNTH_UTTS} dev utterances through a v1 Generator: forced "
          f"{synth['forced']:.1f} ms, free ({SYNTH_FRAMES} frames) {synth['free']:.1f} ms per "
          f"utterance; the free run alone {free_ms:.1f} ms = {free_ms / groups:.3f} ms per "
          f"decoder group ({groups} groups), {fprof[3] / groups:.1f} device launches per group "
          f"{lap()}", flush=True)
    print_profile(f"textcoder free run, {groups} groups", *fprof)
    del live, gen

    # -- the vocoder: the trainer CLI, resume ---------------------------------------------------
    vbase = str(work / "legacy" / "vocoder")
    vargv = ["--train-folder", str(train_dir), "--dev-folder", str(dev_dir), "--output-base",
             vbase, "--batch-size", str(LEGACY_BATCH), "--cache-dir", str(work / "legacy_cache")]
    t1 = time.perf_counter()
    vlive = train_vocoder.main(vargv + ["--max-steps", str(VOCODER_CLI_STEPS)])
    torch.cuda.synchronize()
    vcli_s = time.perf_counter() - t1
    vfiles = [ext for ext in ("yaml", "best", "last", "opt.last", "lr.best", "hr.best")
              if os.path.getsize(f"{vbase}.{ext}") > 0]
    vback = train_vocoder.main(vargv + ["--resume", "--max-epochs", "0"])
    vrestored = same_simple_state(vlive, vback)
    c = vlive.model.config
    print(f"  vocoder trainer CLI at its defaults (GRUs {c.num_layers_hr} x {c.layer_size_hr} "
          f"at 24 kHz, {c.num_layers_lr} x {c.layer_size_lr} at 2.4 kHz, {c.output}, crops of "
          f"24000 samples, B={LEGACY_BATCH}): {VOCODER_CLI_STEPS} steps with validation and "
          f"saves {vcli_s:.1f} s; files {', '.join(vfiles)}; --resume bit-equal: {vrestored} "
          f"{lap()}", flush=True)
    check(vlive.step == VOCODER_CLI_STEPS and len(vfiles) == 6 and vrestored,
          f"legacy vocoder CLI: {vlive.step} steps, files {vfiles}, resume {vrestored}")
    del vback

    # -- the vocoder: the step's time and memory -------------------------------------------------
    vset = VocoderDataset(str(train_dir), max_segment_size=24000, cache_dir=str(
        work / "legacy_cache"), crop_seed=5, device=dev)
    vb = batch_to_torch(VocoderCollate()([vset[i] for i in range(LEGACY_BATCH)]), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vstep_ms = []
    for _ in range(VOCODER_TIMED):
        t1 = time.perf_counter()
        _, vm = ts.vocoder_train_step(vlive, vb)
        torch.cuda.synchronize()
        vstep_ms.append((time.perf_counter() - t1) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # profiled on a crop of VOCODER_PROFILE_CROP samples, device events only: the whole
    # step's ~320,000 launches take minutes to read back
    vb_short = {"x": vb["x"][:, :VOCODER_PROFILE_CROP],
                "x_low": vb["x_low"][:, :VOCODER_PROFILE_CROP // 10],
                "mel": vb["mel"][:, :VOCODER_PROFILE_CROP // 240 + 1]}
    vprof = device_profile(lambda: ts.vocoder_train_step(vlive, vb_short), host=False)
    check(all(math.isfinite(float(v)) for v in vm.values()), f"legacy vocoder step: {vm}")
    out["vocoder"] = dict(step_ms=statistics.median(vstep_ms[1:]), busy=vprof[1] / vprof[0],
                          peak_gb=peak_gb, cli_s=vcli_s)
    print(f"  vocoder step B={LEGACY_BATCH} x 24000 samples ms (host clock) "
          f"{', '.join(f'{v:.1f}' for v in vstep_ms)}, median after the first "
          f"{out['vocoder']['step_ms']:.1f}; peak memory {peak_gb:.2f} GiB; losses "
          f"{', '.join(f'{k}={float(v):.4f}' for k, v in vm.items())} {lap()}", flush=True)
    print_profile(f"vocoder train step B={LEGACY_BATCH} on {VOCODER_PROFILE_CROP}-sample "
                  f"crops", *vprof)

    # -- the vocoder: chunk-parallel synthesis, and its logits on the card ------------------------
    model = vlive.model.eval()
    mel = torch.from_numpy(VocoderDataset(str(dev_dir), random_start=False, cache_dir=str(
        work / "legacy_cache"), device=dev)[0][2][:INFER_FRAMES]).to(dev)[None]
    check(mel.shape == (1, INFER_FRAMES, 80), f"legacy infer: mel {tuple(mel.shape)}")
    steps_n = INFER_FRAMES * c.upsample // c.upsample_low + (
        INFER_FRAMES // INFER_CHUNKS + 1) * c.upsample
    model.infer(mel, torch.Generator().manual_seed(1), num_chunks=INFER_CHUNKS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_low, audio = model.infer(mel, torch.Generator().manual_seed(1), num_chunks=INFER_CHUNKS)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    # profiled on INFER_CHUNKS frames (one per chunk), device events only
    short = mel[:, :INFER_CHUNKS]
    short_steps = INFER_CHUNKS * c.upsample // c.upsample_low + 2 * c.upsample
    iprof = device_profile(lambda: model.infer(short, torch.Generator().manual_seed(1),
                                               num_chunks=INFER_CHUNKS), host=False)
    audio_s = audio.shape[1] / 24000
    with no_tf32(), torch.no_grad():
        x_low, audio, aux = model.infer(mel, torch.Generator().manual_seed(2),
                                        num_chunks=INFER_CHUNKS, return_logits=True)
        want_lr = model.lr_net(mel, model.shift(x_low))
        want_hr = model.hr(aux["mel_seed"], model.shift(aux["audio_c"]), aux["low_seed"])
        torch.cuda.synchronize()
    err = max(distance(aux["lr_logits"], want_lr)[0], distance(aux["hr_logits"], want_hr)[0])
    out["infer"] = dict(rate=audio_s / infer_s, us_per_step=infer_s * 1e6 / steps_n,
                        launches_per_step=iprof[3] / short_steps, logits_err=err)
    print(f"  CubenetVocoder.infer {INFER_FRAMES} frames in {INFER_CHUNKS} chunks: "
          f"{audio.shape[1]} samples ({audio_s:.2f} s) in {infer_s * 1e3:.1f} ms = "
          f"{audio_s / infer_s:.4f} audio s per wall s; {steps_n} sample steps "
          f"({INFER_FRAMES * c.upsample // c.upsample_low} at 2.4 kHz, then "
          f"{(INFER_FRAMES // INFER_CHUNKS + 1) * c.upsample} at 24 kHz x {INFER_CHUNKS} "
          f"chunks): {out['infer']['us_per_step']:.1f} us per step; "
          f"{out['infer']['launches_per_step']:.1f} device launches per step ({short_steps} "
          f"steps of {INFER_CHUNKS} frames under the profiler); the sampled logits vs the teacher-forced nets on the samples "
          f"(fp32, TF32 off) max_abs_err={err:.3e} tol={TOL_SAMPLER:.0e}; audio peak "
          f"{float(audio.abs().max()):.3f} {lap()}", flush=True)
    print_profile(f"vocoder infer of {INFER_CHUNKS} frames, {short_steps} sample steps",
                  *iprof)
    check(audio.shape == (1, INFER_FRAMES * c.upsample) and bool(torch.isfinite(audio).all())
          and float(audio.abs().max()) <= 1.0 and err <= TOL_SAMPLER,
          "legacy infer: the audio or the sampled logits are off")
    out["counts"] = read_counts()
    check(not any(out["counts"].values()), f"legacy: a kernel launched: {out['counts']}")
    del vlive, model
    torch.cuda.empty_cache()
    return out


def inventory_phase(work: Path, gen, w16) -> dict:
    """The rest of the inventory on the card at full v1 width, on import_export's files
    in `work`:
    1. download_model joins the exported volumes (`work/dist/voice-NN`) from a file://
       base into the cache of a temporary HOME; StoryCube("voice") serves through
       TTSCube.load on the card; a 3-paragraph story over seeded music launches B1 once
       per paragraph, and under deterministic() equals the host mix of the same cube's
       three requests within STORY_TOL int16 steps;
    2. synthesize_from_checkpoint of import_export's `.last` on CHECKPOINT_UTTS dev
       utterances, forced and free; the forced wav of one utterance (TF32 off) against the
       CPU's run of the same function within CHECKPOINT_TOL int16 steps;
    3. card against CPU (TF32 off): Languasito v1 (the encodings' vocabularies, LANG_V1),
       ResNet, UpsampleNet, UpsampleNet2, Mel2Style, ConvTranspose1d, fft → ifft on 1 s
       and griffinlim (32 iterations) from one initial phase;
    4. device_timer of B1 at the serving shape (the `gen` weights `w16`, checked against
       the times phase later), the max_stages prefixes 0 … 4 of the voice's generator at
       256 frames, the last equal to the whole output, and trace() naming B1's kernel.
    Returns the launches of the story and of the profiling part and the numbers to
    print."""
    import copy
    import os

    import numpy as np
    import torch

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.dsp.mel import MelSpec, feature_mel_config
    from ttscube_tpu_torch.models import blocks
    from ttscube_tpu_torch.models.hifigan_fused import generator_apply_fused
    from ttscube_tpu_torch.models.languasito import Languasito, LanguasitoConfig
    from ttscube_tpu_torch.ops import ConvTranspose1d, fused_tail
    from ttscube_tpu_torch.story import StoryCube
    from ttscube_tpu_torch.train.runtime import (cubegan_from_checkpoint,
                                                 cubegan_synthesize_dataset,
                                                 synthesize_from_checkpoint)
    from ttscube_tpu_torch.utils.profiling import device_timer, trace
    from ttscube_tpu_torch.utils.repository import download_model
    from ttscube_tpu_torch.utils.wavio import read_wav, write_wav

    dev = torch.device("cuda")
    out = {}
    clock = [time.perf_counter()]

    def lap() -> str:
        now = time.perf_counter()
        took, clock[0] = now - clock[0], now
        return f"[part {took:.1f} s]"

    # -- 1. a named voice with no network, and its story ----------------------------------
    saved_home = os.environ.get("HOME")
    os.environ["HOME"] = str(work / "home")
    try:
        cache = Path.home() / ".ttscube" / "models" / "voice"
        cache.mkdir(parents=True)
        n_vol = len(list((work / "dist").glob("voice-*")))
        t1 = time.perf_counter()
        download_model(str(cache), "voice", download_base=f"file://{work / 'dist'}/{{0}}")
        fetch_s = time.perf_counter() - t1
        check((cache / "cubegan.model").is_file() and not list(cache.glob("model*")),
              f"inventory: download_model left {sorted(p.name for p in cache.iterdir())}")
        rng = np.random.default_rng(SEED + 15)
        n = int(24000 * STORY_MUSIC_S)
        write_wav(str(cache / "music.wav"), (0.2 * np.sin(np.linspace(0, 440 * np.pi, n))
                                             + 0.05 * rng.standard_normal(n)).astype(np.float32),
                  24000)
        story = StoryCube("voice")  # TTSCube.load from the cache, on the card
    finally:
        if saved_home is None:
            os.environ.pop("HOME")
        else:
            os.environ["HOME"] = saved_home
    cube = story._cube
    check(cube.device.type == "cuda", f"inventory: the named voice runs on {cube.device}")
    cube.warmup(speaker="spk0")
    text = "\n\n".join(REQUESTS)
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    told = story(text, speaker="spk0")
    story_ms = (time.perf_counter() - t1) * 1e3
    story_counts = read_counts()
    audio_s = len(told["audio"]) / 24000
    check(story_counts == dict(fused_tail_stage=len(REQUESTS), fused_mrf1=0,
                               fused_tail_stage_mid=0, fused_tail_stage_grad=0,
                               fused_resblock1=0, narrow_conv_blocked=0,
                               stage_conv=S1_PER_CALL * len(REQUESTS)),
          f"inventory: a story of {len(REQUESTS)} paragraphs launched {story_counts}")
    check([m["name"] for m in told["meta"]].count("paragraph") == len(REQUESTS)
          and told["audio"].dtype == np.int16, "inventory: the story's paragraphs")
    with deterministic():
        again = story(text, speaker="spk0")["audio"]
        pcms = [cube(p, speaker="spk0") for p in REQUESTS]
    music = read_wav(str(cache / "music.wav"))[0]
    voice = np.concatenate([np.zeros(5 * 24000, np.float32)] + [
        a for p in pcms for a in (p.astype(np.float32) / 32767.0, np.zeros(24000, np.float32))]
        + [np.zeros(5 * 24000, np.float32)])
    mix = (np.clip(np.resize(music, len(voice)) * 0.30 + voice, -1, 1) * 32700).astype(np.int16)
    check(mix.shape == again.shape, f"inventory: story {again.shape} vs host mix {mix.shape}")
    story_err = int(np.abs(again.astype(np.int32) - mix).max())
    print(f"  StoryCube('voice') through TTSCube.load: {n_vol} volume(s) joined from file:// "
          f"in {fetch_s:.2f} s; story of {len(REQUESTS)} paragraphs ({audio_s:.2f} s of audio) "
          f"ms={story_ms:.1f} audio_s_per_wall_s={audio_s / story_ms * 1e3:.3f} launches "
          f"{story_counts}; under deterministic() against the host mix of the 3 requests: "
          f"max_abs_err={story_err} int16 steps tol={STORY_TOL} {lap()}", flush=True)
    check(story_err <= STORY_TOL, f"inventory: the story differs from the host mix by {story_err}")
    out["story"] = dict(ms=story_ms, rate=audio_s / story_ms * 1e3, err=story_err)

    # -- 2. synthesize_from_checkpoint -------------------------------------------------------
    base, dev_dir = str(work / "model" / "cubegan"), str(work / "card" / "dev")
    wav = lambda d, u: np.round(read_wav(str(d / f"{u}.wav"))[0] * 32768).astype(np.int32)
    ckpt = {}
    for mode in ("forced", "free"):
        where = work / "ckpt" / mode
        t1 = time.perf_counter()
        with no_tf32() if mode == "forced" else contextlib.nullcontext(), deterministic():
            synthesize_from_checkpoint(base, dev_dir, str(where), limit=CHECKPOINT_UTTS,
                                       free=mode == "free")
        files = sorted(where.glob("*.wav"))
        check(len(files) == CHECKPOINT_UTTS, f"inventory: {len(files)} {mode} wavs written")
        ckpt[mode] = dict(call_s=time.perf_counter() - t1,
                          samples=[len(read_wav(str(f))[0]) for f in files], files=files)
    # the synthesis alone on the rebuilt model, as a user's program runs it (TF32 on)
    model, ds, collate = cubegan_from_checkpoint(base, dev_dir)
    for mode in ("forced", "free"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cubegan_synthesize_dataset(model, ds, collate, str(work / "ckpt" / f"{mode}_timed"),
                                   limit=CHECKPOINT_UTTS, free=mode == "free")
        torch.cuda.synchronize()
        ckpt[mode]["ms"] = (time.perf_counter() - t1) * 1e3 / CHECKPOINT_UTTS
    del model
    utt = ckpt["forced"]["files"][0].stem
    synthesize_from_checkpoint(base, dev_dir, str(work / "ckpt" / "cpu"), limit=1, free=False,
                               device="cpu")
    got, want = wav(work / "ckpt" / "forced", utt), wav(work / "ckpt" / "cpu", utt)
    check(got.shape == want.shape and np.abs(want).max() > 0,
          f"inventory: forced wav {got.shape} vs CPU {want.shape}")
    ckpt_err = int(np.abs(got - want).max())
    print(f"  synthesize_from_checkpoint({base}.last) on the card: forced ({CHECKPOINT_UTTS} "
          f"utterances, samples {ckpt['forced']['samples']}) call {ckpt['forced']['call_s']:.2f} s, "
          f"synthesis ms per utterance {ckpt['forced']['ms']:.1f}; free (samples "
          f"{ckpt['free']['samples']}) call {ckpt['free']['call_s']:.2f} s, synthesis ms per "
          f"utterance {ckpt['free']['ms']:.1f}; forced {utt} card (TF32 off) vs CPU "
          f"max_abs_err={ckpt_err} int16 steps tol={CHECKPOINT_TOL} {lap()}", flush=True)
    check(ckpt_err <= CHECKPOINT_TOL, f"inventory: the forced wav differs from the CPU's by "
                                      f"{ckpt_err} steps")
    out["ckpt"] = {m: dict(ms=v["ms"], call_s=v["call_s"]) for m, v in ckpt.items()}

    # -- 3. card against CPU at full width ---------------------------------------------------
    enc = CubeganEncodings(base + ".encodings")
    lcfg = LanguasitoConfig(num_phones=len(enc.phon2int), num_speakers=len(enc.speaker2int),
                            max_pitch=enc.max_pitch, max_duration=enc.max_duration)
    B, N, F = LANG_V1
    g = torch.Generator().manual_seed(SEED + 16)
    lengths = [N - 8 * b for b in range(B)]
    x_char = torch.zeros(B, N, dtype=torch.int64)
    f2p = torch.zeros(B, F, dtype=torch.int64)
    for b, n in enumerate(lengths):
        x_char[b, :n] = torch.randint(1, lcfg.num_phones + 1, (n,), generator=g)
        f2p[b] = torch.randint(0, n, (F,), generator=g).sort().values
    X = {"x_char": x_char, "x_speaker": torch.randint(1, lcfg.num_speakers + 1, (B, 1),
                                                       generator=g),
         "y_frame2phone": f2p, "y_pitch": torch.rand(B, F, generator=g) * lcfg.max_pitch}
    x80 = lambda c=80: torch.randn(2, BLOCKS_T, c, generator=g)
    cases = [("Languasito v1", Languasito(lcfg), X, (2e-4, 2e-4, 2e-5), False),
             ("ResNet 512x8", blocks.ResNet(80), x80(), (TOL_BLOCKS,), True),
             ("UpsampleNet x16", blocks.UpsampleNet(80), x80(), (TOL_BLOCKS,), True),
             ("UpsampleNet2 x16", blocks.UpsampleNet2(), x80(), (TOL_BLOCKS,), True),
             ("Mel2Style 80/100/8", blocks.Mel2Style(), x80(), (TOL_BLOCKS, TOL_BLOCKS), True),
             ("ConvTranspose1d 256->128 k16 s8", ConvTranspose1d(256, 128, 16, 8, 4), x80(256),
              (TOL_BLOCKS,), True)]
    rows = []
    for i, (name, module, x, tols, scaled) in enumerate(cases):
        module = init_random(module, SEED + 20 + i).eval()
        with torch.no_grad():
            want = module(x)
            card_module = copy.deepcopy(module).to(dev)
            xd = {k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)
            with no_tf32():
                got = card_module(xd)
            torch.cuda.synchronize()
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for j, (a, b, tol) in enumerate(zip(got, want, tols)):
            limit = tol * max(1.0, float(b.abs().max())) if scaled else tol
            err = distance(a, b)[0]
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  f"inventory: {name} output {j} {tuple(a.shape)} vs {tuple(b.shape)}")
            rows.append(f"{name}[{j}] {tuple(a.shape)} {err:.2e}/{limit:.1e}")
            check(err <= limit, f"inventory: {name} output {j} card vs CPU {err:.3e} > {limit:.3e}")
        del card_module
    ms_ = MelSpec(feature_mel_config())
    y = torch.randn(24000, generator=g) * 0.05 + 0.5 * torch.sin(
        2 * math.pi * 330 * torch.arange(24000) / 24000)
    with no_tf32():
        spec_d, spec_c = ms_.fft(y.to(dev)), ms_.fft(y)
        rec_d, rec_c = ms_.ifft(spec_d, 24000), ms_.ifft(spec_c, 24000)
        phase = torch.rand(spec_c.shape, generator=g) * (2 * math.pi)
        gl_d = ms_.griffinlim(spec_c.abs().to(dev), 32, phase=phase)
        gl_c = ms_.griffinlim(spec_c.abs(), 32, phase=phase)
        torch.cuda.synchronize()
    for name, a, b, tol in (("fft", torch.view_as_real(spec_d), torch.view_as_real(spec_c),
                             TOL_BLOCKS), ("ifft(fft) 1 s", rec_d, rec_c, TOL_GL),
                            ("griffinlim 32", gl_d, gl_c, TOL_GL)):
        limit = tol * max(1.0, float(b.abs().max())) if name == "fft" else \
            tol * float(b.abs().max())
        err = distance(a, b)[0]
        rows.append(f"{name} {tuple(a.shape)} {err:.2e}/{limit:.1e}")
        check(err <= limit, f"inventory: {name} card vs CPU {err:.3e} > {limit:.3e}")
    print("  card vs CPU (TF32 off), max_abs_err/limit: " + "; ".join(rows) + f" {lap()}",
          flush=True)

    # -- 4. profiling on the card ------------------------------------------------------------
    torch.cuda.synchronize()
    zero_counts()
    z = tail_input(1, 256, seed=256, device=dev)  # the times phase's serving shape
    timer_ms = device_timer(fused_tail.fused_tail_stage, z, w16, reps=TIME_PER) * 1e3
    vgen, c = cube.model.gen, cube.config.hifigan
    mel = torch.randn(1, 256, 80, generator=g).to(dev)

    def prefix(m, k):
        return generator_apply_fused(vgen, m, c, compute_dtype=c.torch_compute_dtype,
                                     storage_dtype=c.torch_storage_dtype,
                                     fuse_channels=c.fuse_channels, max_stages=k)

    with torch.inference_mode():
        # the prefixes in turns, PREFIX_READINGS times, each reading TIME_PER calls: the
        # plain stages launch ~100 kernels each and a single reading moves by ~10 %
        readings = [[device_timer(prefix, mel, k, reps=TIME_PER) * 1e3 for k in range(5)]
                    for _ in range(PREFIX_READINGS)]
        prefix_ms = [statistics.median(r[k] for r in readings) for k in range(5)]
        with deterministic():
            last, whole = prefix(mel, 4), vgen.fused(mel)
        torch.cuda.synchronize()
        check(torch.equal(last, whole), "inventory: max_stages=4 differs from the whole "
                                        "generator's output")
        with trace(str(work / "trace")) as log_dir:
            vgen.fused(mel)
    prof_counts = read_counts()
    with open(Path(log_dir) / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    b1_names = sorted(n for n in names if "tail_kernel" in n)
    print(f"  device_timer(fused_tail_stage, bf16 B=1 F=256, reps={TIME_PER}) "
          f"ms={timer_ms:.4f}; max_stages prefixes of the voice's generator at 256 frames "
          f"(bf16 storage; medians of {PREFIX_READINGS} readings) ms: "
          + ", ".join(f"{k}: {v:.3f}" for k, v in enumerate(prefix_ms))
          + "; per stage ms: " + ", ".join(
              f"{k}: {prefix_ms[k] - prefix_ms[k - 1]:.3f}" for k in range(1, 5))
          + f"; prefix 4 equals the whole output; trace.json kernels {len(names)}, B1's: "
          f"{b1_names}; launches {prof_counts} {lap()}", flush=True)
    check(b1_names, f"inventory: the trace names no B1 kernel among {sorted(names)[:10]}")
    out.update(timer_ms=timer_ms, prefix_ms=prefix_ms,
               counts={k: story_counts[k] + prof_counts[k] for k in story_counts})
    return out


def main() -> int:
    import numpy as np
    import torch

    t_script = time.perf_counter()
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
    print(card_line(), flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", t0, name=json.dumps(kind), cuda=torch.version.cuda,
        torch=torch.__version__, count=torch.cuda.device_count())
    dev = torch.device("cuda")

    # -- build --------------------------------------------------------------------
    from ttscube_tpu_torch.ops import _build, fused_mrf, fused_tail, narrow_conv, stage_conv

    t0 = time.perf_counter()
    sources = (fused_tail.KERNEL_SOURCE, fused_tail.GRAD_KERNEL_SOURCE, fused_mrf.KERNEL_SOURCE,
               narrow_conv.KERNEL_SOURCE, stage_conv.KERNEL_SOURCE)
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
        launches=launches("fused_resblock1"))

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
        launches=launches("narrow_conv_blocked"))

    # -- kernel_stage_conv --------------------------------------------------------------
    t0 = time.perf_counter()
    s1_errs = {}
    for C in (256, 128, 64):
        for k, d in ((3, 1), (11, 5)):
            case = f"stage_conv C={C} k={k} d={d} B=2 T=1000"
            s1_errs[case] = check_stage_conv(case, C, k, d, 2, 1000, dev)
    # the main path's shapes (B = 128, 512 frames): stage i's width and length
    for i, (k, d) in enumerate(((11, 5), (7, 3), (3, 1))):
        C, t_len = 256 >> i, BATCH_FRAMES * (5, 15, 60)[i]
        case = f"stage_conv C={C} k={k} d={d} B={BATCH} T={t_len}"
        s1_errs[case] = check_stage_conv(case, C, k, d, BATCH, t_len, dev)
        torch.cuda.empty_cache()
    say("kernel_stage_conv", t0, checks=len(s1_errs), launches=launches("stage_conv"))
    phase_launches = {n: launches(n)
                      for n in ("fused_resblock1", "narrow_conv_blocked", "stage_conv")}

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
                              narrow_conv_blocked=0, stage_conv=4 * S1_PER_CALL),
          f"warmup launches {warm_counts}")
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
    check(lat[0] <= FIRST_REQUEST_BOUND * statistics.median(lat[1:]),
          f"warmup: the first request after warmup took {lat[0]:.1f} ms, more than "
          f"{FIRST_REQUEST_BOUND} x the steady state's {statistics.median(lat[1:]):.1f} ms")
    # where a first request's time goes (C7): a second TTSCube's first request after its
    # warmup under the profiler, with host events, beside a steady request of the text
    fresh = TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cuda")
    fresh.warmup(speaker=speaker)
    for what in ("a second TTSCube's first after its warmup", "steady"):
        wall, busy, rows = host_profile(lambda: fresh(REQUESTS[0], speaker=speaker))
        print(f"  request chars={len(REQUESTS[0])} {what} under the profiler: wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms; host ops by self ms: " + "; ".join(
                  f"{name} {ms:.2f} ({n})" for name, ms, n in rows), flush=True)
    del fresh
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
        before = launches("fused_tail_stage")
        t1 = time.perf_counter()
        pcm = cube(text, speaker=speaker)
        ms = (time.perf_counter() - t1) * 1e3
        check(launches("fused_tail_stage") - before == 1,
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
                               fused_resblock1=0, narrow_conv_blocked=0,
                               stage_conv=S1_PER_CALL * len(REQUESTS)),
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
                       fused_tail_stage_mid=1, fused_resblock1=0, narrow_conv_blocked=0,
                       stage_conv=0)
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
                    narrow_conv_blocked=0, stage_conv=S1_PER_CALL * (1 + BATCH_CALLS) * windows)
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
        b1, b2 = launches("fused_tail_stage"), launches("fused_tail_stage_grad")
        t1 = time.perf_counter()
        _, met = tcg.train_step(state, tb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        met = {k: v.item() for k, v in met.items()}
        check(all(math.isfinite(v) for v in met.values()), f"train step {step}: {met}")
        check((launches("fused_tail_stage") - b1,
               launches("fused_tail_stage_grad") - b2) == (1, 1),
              "train step: B1 and B2 did not launch once each")
        print(f"  train step {step} B={TRAIN_BATCH} ms={step_ms[-1]:.1f} "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(met.items())), flush=True)
    train_counts = read_counts()
    train_launches = (train_counts["fused_tail_stage"], train_counts["fused_tail_stage_grad"])
    check(train_counts == dict(fused_tail_stage=TRAIN_STEPS, fused_tail_stage_grad=TRAIN_STEPS,
                               fused_mrf1=0, fused_tail_stage_mid=0, fused_resblock1=0,
                               narrow_conv_blocked=0, stage_conv=0),
          f"train: launches {train_counts}")
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
        live = train_cli(argv)
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
    resumed = train_cli(argv + ["--resume", "--max-epochs", "0"])
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
    live16 = train_cli(argv16)
    torch.cuda.synchronize()
    cli16_s = time.perf_counter() - t1
    trainer16_counts = read_counts()
    check(live16.step == 2 and all(v == 0 for v in trainer16_counts.values())
          and os.path.exists(base16 + ".opt.last"),
          f"bf16 trainer: step {live16.step}, launches {trainer16_counts}")
    check(live16.model.config.hifigan.compute_dtype == live16.model.config.disc_compute_dtype
          == "bfloat16" and all(p.dtype == torch.float32 for p in live16.model.parameters()),
          "bf16 trainer: the config or the parameters' type")
    resumed16 = train_cli(argv16 + ["--resume", "--max-epochs", "0"])
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

    # -- mesh ---------------------------------------------------------------------------
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    mesh_run = mesh_phase(enc, work)
    shutil.rmtree(work)
    say("mesh", t0, step_ms=f"{mesh_run['mesh_ms']:.1f}", plain_step_ms=
        f"{mesh_run['plain_ms']:.1f}", launches_b1=mesh_run["counts"]["fused_tail_stage"],
        launches_b2=mesh_run["counts"]["fused_tail_stage_grad"])

    # -- phonemizer ---------------------------------------------------------------------
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_import_"))
    ph_run = phonemizer_phase(work)
    say("phonemizer", t0, aligned_step_ms=f"{ph_run['aligned']['step_ms']:.1f}",
        m2m_step_ms=f"{ph_run['m2m']['step_ms']:.1f}",
        m2m_busy_share=f"{ph_run['m2m']['busy']:.3f}",
        m2m_decode_ms=f"{ph_run['m2m']['decode_ms']:.1f}",
        aligned_pacc=f"{ph_run['aligned']['pacc']:.4f}",
        g2p_words_per_s=f"{ph_run['g2p']['words_per_s']:.0f}")

    # -- import_export ------------------------------------------------------------------
    t0 = time.perf_counter()
    ie_run = import_export_phase(work, ph_run["pbase"])
    say("import_export", t0, s_per_audio_s=f"{ie_run['per_audio_s']['total_s']:.5f}",
        export_s=f"{ie_run['export_s']:.2f}", request_ms=f"{ie_run['request_ms']:.1f}")

    # -- quality --------------------------------------------------------------------------
    t0 = time.perf_counter()
    q_run = quality_phase(work, ie_run.pop("cube"))
    say("quality", t0, mean_mcd_dtw_db=q_run["mean_mcd"], mcd_card_vs_cpu=
        f"{q_run['mcd_err']:.4f}", paths_differ=q_run["paths_differ"],
        pair_ms=f"{q_run['per_pair']['pair']:.1f}",
        text2feat_words_per_s=f"{q_run['words_per_s']:.0f}",
        launches_b1=q_run["counts"]["fused_tail_stage"])

    # -- lm -------------------------------------------------------------------------------
    t0 = time.perf_counter()
    lm_run = lm_phase(work, ph_run["pbase"])
    say("lm", t0, encoder_err=f"{lm_run['enc_err']:.3e}",
        step_ms=f"{lm_run['step']['hf']['ms']:.1f}",
        plain_step_ms=f"{lm_run['step']['plain']['ms']:.1f}",
        hf_request_ms=f"{lm_run['served']['hf']['steady']:.1f}",
        launches_b1=lm_run["counts"]["fused_tail_stage"],
        launches_b2=lm_run["counts"]["fused_tail_stage_grad"])

    # -- legacy ---------------------------------------------------------------------------
    t0 = time.perf_counter()
    legacy_run = legacy_phase(work)
    say("legacy", t0, textcoder_step_ms=f"{legacy_run['textcoder']['step_ms']:.1f}",
        textcoder_busy_share=f"{legacy_run['textcoder']['busy']:.3f}",
        group_ms=f"{legacy_run['synth']['group_ms']:.3f}",
        vocoder_step_ms=f"{legacy_run['vocoder']['step_ms']:.1f}",
        vocoder_busy_share=f"{legacy_run['vocoder']['busy']:.3f}",
        vocoder_peak_gib=f"{legacy_run['vocoder']['peak_gb']:.2f}",
        infer_audio_s_per_s=f"{legacy_run['infer']['rate']:.4f}",
        infer_us_per_step=f"{legacy_run['infer']['us_per_step']:.1f}")

    # -- inventory ------------------------------------------------------------------------
    t0 = time.perf_counter()
    inv_run = inventory_phase(work, gen, w16)
    shutil.rmtree(work)
    say("inventory", t0, story_ms=f"{inv_run['story']['ms']:.1f}",
        story_audio_s_per_s=f"{inv_run['story']['rate']:.3f}",
        ckpt_forced_ms=f"{inv_run['ckpt']['forced']['ms']:.1f}",
        ckpt_free_ms=f"{inv_run['ckpt']['free']['ms']:.1f}",
        timer_b1_ms=f"{inv_run['timer_ms']:.4f}",
        launches_b1=inv_run["counts"]["fused_tail_stage"])

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
    # S1 over each unfused stage's MRF (its 18 launches) at the main path's shapes and
    # precision (bf16 storage and operands), bulk synthesis (B = 128, 512 frames) and
    # long-form's window (B = 64, 256 + 64 frames), against its plain version (the stock
    # convs, the same arithmetic) and against F.conv1d alone on the same 18 convs (cuDNN
    # on the bf16 values held in fp32, NCW, TF32 as served): its library yardstick, which
    # the port does not call. Bound: the bf16 operations, or the bf16 bytes (each conv's
    # input read and output written once, the residuals and the sums read once)
    from ttscube_tpu_torch.models import hifigan_fused as thf
    from ttscube_tpu_torch.models.hifigan import LRELU_SLOPE

    hc = gen.config
    s1_rows = {}
    for batch, frames in ((BATCH, BATCH_FRAMES), (LONG_BATCH, CHUNK_FRAMES + 64)):
        t_len = frames
        for i in range(3):
            C, t_len = hc.upsample_initial_channel >> (i + 1), t_len * hc.upsample_rates[i]
            blocks = [getattr(gen, f"res_{i}_{j}") for j in range(len(hc.resblock_kernel_sizes))]
            g = torch.Generator().manual_seed(t_len + C)
            x = torch.randn(batch, t_len, C, generator=g).to(dev).bfloat16()
            x_nct = x.float().transpose(1, 2).contiguous()
            convs = gen.stage_conv_weights(i)
            kernel = lambda: stage_conv.stage_mrf(x, convs, hc.resblock_dilation_sizes,
                                                  LRELU_SLOPE)

            def plain(x=x, operands=torch.bfloat16):
                acc = None
                for blk in blocks:
                    h = thf._plain_resblock1(x, blk, operands, x.dtype)
                    acc = h if acc is None else acc + h
                return acc / len(blocks)

            with torch.no_grad():
                lib_convs = [(cv.weight().bfloat16().float(), cv.bias,
                              blk.dilations[m // 2] if m % 2 == 0 else 1)
                             for blk in blocks for m, cv in enumerate(blk.convs())]

            def library():
                for w, bias, dil in lib_convs:
                    torch.nn.functional.conv1d(x_nct, w, bias, padding=dil * (w.shape[2] - 1) // 2,
                                               dilation=dil)

            with torch.no_grad():
                p1, l1, k1, k2, l2, p2 = (cuda_times(f, 3, 2) for f in
                                          (plain, library, kernel, kernel, library, plain))
            ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
            library_ms = statistics.median(l1 + l2)
            flops = sum(2 * stage_conv.stage_conv_flops(batch, t_len, C, kk) * len(ds)
                        for kk, ds in zip(hc.resblock_kernel_sizes, hc.resblock_dilation_sizes))
            n_blocks = len(blocks)
            n_convs = 2 * sum(len(ds) for ds in hc.resblock_dilation_sizes)
            # per conv its input and output; a residual per dilation; the sum in n - 1
            nbytes = 2 * x.numel() * (2 * n_convs + n_convs // 2 + n_blocks - 1)
            label = f"stage{i} B={batch} F={frames}"
            # the output against the plain stage's, beside the floor: the plain stage at
            # bf16 against it at fp32 storage and operands (TF32 off), in this run
            with torch.no_grad(), no_tf32():
                got, want16 = kernel(), plain()
                floor = distance(want16, plain(x.float(), None))
            err = distance(got, want16)
            print(f"  stage_conv {label} MRF: max={err[0]:.3e} rms={err[1]:.3e}; floor "
                  f"max={floor[0]:.3e} rms={floor[1]:.3e} ({err[0] / floor[0]:.3f}, "
                  f"{err[1] / floor[1]:.3f} of it)", flush=True)
            check(floor[0] > 1e-4, f"stage_conv {label}: bf16 did not move the stage")
            check(bool(torch.isfinite(got).all()) and err[0] <= S1_CHAIN * floor[0]
                  and err[1] <= S1_CHAIN * floor[1],
                  f"stage_conv {label}: the MRF's output {err} is not within {S1_CHAIN} of "
                  f"the floor {floor}")
            del got, want16
            row = s1_rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                        floor_share=max(err[0] / floor[0],
                                                        err[1] / floor[1]),
                                        **bound(flops, nbytes, "bf16"))
            print(f"  stage_conv {label} T={t_len} C={C} ({n_convs} launches) ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} (F.conv1d x "
                  f"{n_convs}) bound_ms={row['bound_ms']:.3f} ({row['bound_by']}; "
                  f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.2f} GB) achieved="
                  f"{flops / ms / 1e9:.1f} TFLOP/s = {row['bound_ms'] / ms:.3f} of the bound",
                  flush=True)
            del x, x_nct, lib_convs
    torch.cuda.empty_cache()
    b1_serve_ms = b1_rows[("bf16", "B=1 F=256")]["ms"]
    ratio = inv_run["timer_ms"] / b1_serve_ms
    print(f"  device_timer of B1 bf16 B=1 F=256 (inventory phase) ms={inv_run['timer_ms']:.4f} "
          f"= {ratio:.3f} x this phase's median {b1_serve_ms:.4f} (limits {TIMER_RATIO})",
          flush=True)
    check(TIMER_RATIO[0] <= ratio <= TIMER_RATIO[1],
          f"times: device_timer's B1 is {ratio:.3f} x the median")
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
    # chunked, train, train_bf16, trainer in fp32 and in bf16, the mesh's trainer and
    # synthesis, the phonemizer family's training and decoding, the exported voice's
    # request and the quality phase's requests, the LM-conditioned trainers, step and
    # voices, the story and the profiling hooks), each counted from zero just before its
    # path ran
    paths = (warm_counts, serve_counts, wide_counts, batch_runs["whole"]["counts"],
             batch_runs["chunked"]["counts"], train_counts, bf16_counts, trainer_counts,
             trainer16_counts, mesh_run["counts"], ph_run["counts"], ie_run["counts"],
             q_run["counts"], lm_run["counts"], legacy_run["counts"], inv_run["counts"])
    main_counts = {n: sum(c[n] for c in paths) for n in serve_counts}
    print(f"  main-path launches: {main_counts}; launches in the kernel phases: "
          f"{phase_launches}", flush=True)
    print(f"  script seconds={time.perf_counter() - t_script:.1f}", flush=True)
    print(card_line(), flush=True)  # again here, where the end of the output keeps it
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
        for mode in ("fp32", "bf16")], *[{
        "name": f"stage_conv[{label}]", "route": "cuda",
        "source": "ttscube_tpu_torch/csrc/stage_conv.cu", "replaces": None,
        "launches": main_counts["stage_conv"],
        "phase_launches": phase_launches["stage_conv"],
        "max_ulps": max(s1_errs.values()), **row} for label, row in s1_rows.items()]]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
