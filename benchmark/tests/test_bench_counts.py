"""The operation counts behind every roofline and `mfu`, held against PERF.md's B1
count and against torch's own count of the reference's matmuls and convs at small
shapes; the interval arithmetic; the reading of a trace."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights
from benchmark.counts import flops
from benchmark.counts.intervals import busy, gaps, union
from benchmark.counts.roofline import bound_ms, mfu_percent, ops_bound_ms
from benchmark.harness import Bench
from benchmark.reference import cubegan as ref
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace

C = Bench(REPO).config("cubegan-v1")


def small(c):
    """A small configuration of the same structure, for counting by torch."""
    c = copy.deepcopy(c)
    c["hifigan"].update(upsample_initial_channel=16, upsample_rates=[2, 2],
                        upsample_kernel_sizes=[4, 2], resblock_kernel_sizes=[3, 5],
                        resblock_dilation_sizes=[[1, 3], [1]])
    c["discriminators"].update(mpd_channels=[4, 8], msd_width=4)
    c["lm"] = dict(vocab_size=50, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=32, max_position_embeddings=40, type_vocab_size=2,
                   layer_norm_eps=1e-12)
    return c


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_b1_at_the_serving_shape_is_perf_mds_count():
    """B1 at B = 1, 256 frames (z (1, 15,376, 64)): 16.15 GFLOP, 0.01633 ms at bf16."""
    f, nbytes = flops.tail(C, 1, 256)
    assert flops.last_stage_input(C, 256) == (15376, 64)
    assert f == pytest.approx(16.15e9, abs=0.01e9)
    assert ops_bound_ms(f, "bf16") == pytest.approx(0.01633, abs=1e-5)
    assert bound_ms(f, nbytes, "bf16") == ops_bound_ms(f, "bf16")


def test_b2_is_three_times_b1_and_fp32_bound():
    f1, _ = flops.tail(C, 16, 50)
    f2, b2 = flops.tail_grad(C, 16, 50)
    assert f2 == 3 * f1
    assert bound_ms(f2, b2, "fp32") == pytest.approx(3 * f2 / 495e12 * 1e3)


def test_generator_count_is_torchs():
    c = small(C)
    shapes = {}
    for i, (u, k) in enumerate(zip(c["hifigan"]["upsample_rates"],
                                   c["hifigan"]["upsample_kernel_sizes"])):
        ch = 16 >> i
        shapes[f"gen.up_{i}.v"] = (ch, ch // 2, k)
        for j, (rk, d) in enumerate(zip([3, 5], [[1, 3], [1]])):
            for m in range(2 * len(d)):
                shapes[f"gen.res_{i}_{j}.WNConv1d_{m}.v"] = (ch // 2, ch // 2, rk)
    shapes.update({"gen.conv_pre.v": (16, 80, 7), "gen.conv_post.v": (1, 4, 7)})
    for n in list(shapes):
        shapes[n.replace(".v", ".g")] = (shapes[n][0],)
        shapes[n.replace(".v", ".bias")] = (shapes[n][1] if ".up_" in n else shapes[n][0],)
    W = weights.make(shapes, 1, "cpu")
    got = counted(lambda: ref.generator(W, c, torch.randn(2, 9, 80)))
    assert flops.generator(c, 2, 9) == got


def test_text_model_count_is_torchs():
    c = small(C)
    from benchmark.runners.common import build

    model, shapes, W = build(C, 3, "cpu", train=False)
    X = {"x_char": torch.randint(1, 80, (2, 7)), "x_speaker": torch.tensor([[1], [2]])}
    f2p = torch.arange(11)[None].repeat(2, 1).clamp(max=6)

    def infer():
        h_t = ref.tower(W, C, X, "tower_t")
        ref.dur_logits(W, C, h_t)
        ref.pitch_head(W, C, h_t, f2p)
        ref.cond_forward(W, C, X, f2p, torch.zeros(2, 11))

    assert flops.text_model(C, 2, 7, 11) == counted(infer)
    del c, model


def test_discriminator_and_mel_counts_are_torchs():
    from benchmark.runners.common import build

    c = copy.deepcopy(C)
    model, shapes, W = build(c, 4, "cpu", train=True)
    W = {n: v for n, v in W.items() if n.startswith(("mpd", "msd"))}
    y = torch.randn(1, 1234)
    U = {n: v for n, v in W.items() if n.endswith(".u")}

    def one_input():
        for p in c["discriminators"]["mpd_periods"]:
            ref.period_disc(W, c, f"mpd.p{p}", p, y)
        x = y
        for i in range(3):
            ref.scale_disc(W, c, U, f"msd.s{i}", i == 0, x)
            x = ref.avgpool42(x)

    want = counted(one_input)
    assert sum(sum(d) for d in flops.discriminator_layers(c, 1, 1234)) == want
    consts = ref.mel_constants(c, "cpu")
    assert flops.gan_mel(c, 1, 1234) == counted(lambda: ref.gan_mel(consts, c, y))
    del model


def test_encoder_count_is_torchs():
    c = small(C)
    lm = c["lm"]
    shapes = {"hf.word_emb.weight": (50, 16), "hf.pos_emb.weight": (40, 16),
              "hf.type_emb.weight": (2, 16), "hf.emb_ln.weight": (16,), "hf.emb_ln.bias": (16,)}
    for i in range(2):
        p = f"hf.layer_{i}"
        for n in ("attn.query", "attn.key", "attn.value", "attn.output"):
            shapes.update({f"{p}.{n}.weight": (16, 16), f"{p}.{n}.bias": (16,)})
        shapes.update({f"{p}.ff_in.weight": (32, 16), f"{p}.ff_in.bias": (32,),
                       f"{p}.ff_out.weight": (16, 32), f"{p}.ff_out.bias": (16,)})
        for n in ("attn_ln", "ff_ln"):
            shapes.update({f"{p}.{n}.weight": (16,), f"{p}.{n}.bias": (16,)})
    W = weights.make(shapes, 2, "cpu")
    ids = torch.randint(1, 50, (3, 12))
    got = counted(lambda: ref.bert(W, c, ids, torch.ones(3, 12, dtype=torch.bool)))
    assert flops.encoder(c, 3, 12) == got
    assert lm["num_hidden_layers"] == 2


def test_train_step_count_adds_its_parts():
    c = C
    parts = (3 * flops.text_model(c, 16, 96, 832) + 3 * flops.generator(c, 16, 50)
             + 3 * flops.gan_mel(c, 16, 12000))
    layers = flops.discriminator_layers(c, 16, 12000)
    every, firsts = sum(map(sum, layers)), sum(d[0] for d in layers)
    assert flops.train_step(c, 16, 96, 832) == parts + 9 * every - 2 * firsts
    assert mfu_percent(989e12, 1.0) == pytest.approx(100.0)


def test_union_counts_overlaps_once():
    iv = [(0, 4), (2, 6), (5, 7), (10, 12), (11, 11.5), (20, 20)]
    assert union(iv) == [(0, 7), (10, 12)]
    assert busy(iv, 0, 15) == 9
    assert busy(iv, 3, 11) == 5
    assert gaps(iv, -1, 15) == [(-1, 0), (7, 10), (12, 15)]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_attributes_kernels_to_the_spans_that_launched_them():
    ev = [_ev("user_annotation", "bench.window", 0, 100),
          _ev("user_annotation", "bench.a", 10, 20), _ev("user_annotation", "bench.a", 60, 10),
          _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=3),
          _ev("cpu_op", "aten::mm", 40, 5),
          _ev("kernel", "k1", 20, 10, tid=7, corr=1), _ev("kernel", "k2", 25, 10, tid=8, corr=2),
          _ev("kernel", "k1", 80, 5, tid=7, corr=3), _ev("gpu_memcpy", "copy", 95, 10, tid=7),
          _ev("kernel", "outside", 200, 10, tid=7)]
    t = Trace({"traceEvents": ev})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((15 + 5 + 5) * 1e-6)  # [20, 35), [80, 85), [95, 100)
    assert t.span_ms("bench.a") == pytest.approx(15e-3)    # k1 twice, not k2
    assert t.span_ms("bench.b") is None
    assert t.kernel_ms(("k1",)) == pytest.approx(15e-3)
    assert t.top_ops()[0] == ["k1", pytest.approx(15e-6)]
    longest = t.idle_gaps(1)[0]
    assert longest == ["cudaLaunchKernel", pytest.approx(45e-6)]  # the launch at 35 µs
