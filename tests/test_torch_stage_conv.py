"""Kernel S1's wrapper (`ops/stage_conv.py`) on the CPU: CPU tensors take its plain
version and launch nothing; the serving generator's unfused MRF runs the stock ResBlock1
loop (`hifigan_fused._plain_resblock1`) on CPU tensors, and S1's plain version through
`stage_mrf` equals that loop bit for bit where S1 takes the stage on the card. The kernel
itself is held to the plain version on the card (tests/test_torch_gpu.py)."""

import pytest
import torch

from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.models import hifigan_fused as thf
from ttscube_tpu_torch.models.hifigan import LRELU_SLOPE, Generator, HifiganConfig
from ttscube_tpu_torch.ops import stage_conv as sc
from ttscube_tpu_torch.utils.profiling import counters

# stage 0 of a generator 128 wide: 64 channels, v1's kernel sizes and dilations
CFG = HifiganConfig(upsample_initial_channel=128)


def _launches() -> int:
    return counters().get("launches.stage_conv", 0)


def _stock_mrf(gen, x, compute, storage):
    want = None
    for j in range(len(CFG.resblock_kernel_sizes)):
        h = thf._plain_resblock1(x, getattr(gen, f"res_0_{j}"), compute, storage)
        want = h if want is None else want + h
    return want / len(CFG.resblock_kernel_sizes)


@pytest.fixture(scope="module")
def gen():
    return init_random(Generator(CFG), 0)


@pytest.mark.parametrize("mode", ["leaky_out", "residual", "mean"])
def test_cpu_tensors_take_the_plain_version(mode):
    g = torch.Generator().manual_seed(1)
    x, res, acc = (torch.randn(2, 37, 64, generator=g).bfloat16() for _ in range(3))
    w, b = torch.randn(64, 64, 7, generator=g) / 20, torch.randn(64, generator=g) / 10
    kw = {"leaky_out": dict(leaky_out=True), "residual": dict(residual=res, leaky_in=False),
          "mean": dict(residual=res, accum=acc, n_mean=3)}[mode]
    cw = sc.pack_conv(w, b)
    before = _launches()
    got = sc.stage_conv(x, cw, dilation=3, slope=LRELU_SLOPE, **kw)
    out = torch.empty_like(x)
    into = sc.stage_conv(x, cw, dilation=3, slope=LRELU_SLOPE, out=out, **kw)
    assert _launches() == before
    want = sc.stage_conv_plain(x, w, b, dilation=3, slope=LRELU_SLOPE, **kw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert into is out and torch.equal(out, want)


@pytest.mark.parametrize("storage,compute", [(torch.bfloat16, None), (None, None),
                                             (torch.bfloat16, torch.bfloat16)],
                         ids=["bf16 storage", "fp32", "bf16 operands"])
def test_plain_mrf_equals_the_stock_resblock_loop(gen, storage, compute):
    """With the dtypes `generator_apply_fused` hands on (the storage dtype for an unset
    compute dtype), `_serving_mrf` on CPU tensors is the stock loop and launches nothing;
    where S1 would take the stage on the card, bf16 storage and operands, S1's plain
    version through `stage_mrf` (the wrapper's CPU version) equals that loop too."""
    compute = compute or storage
    x = torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(2))
    x = x.to(storage or torch.float32)
    want = _stock_mrf(gen, x, compute, storage)
    before = _launches()
    got = thf._serving_mrf(gen, 0, x, CFG, compute, storage)
    assert got.dtype == x.dtype and torch.equal(got, want)
    if sc.takes(x, compute, CFG.resblock_kernel_sizes, CFG.resblock_dilation_sizes):
        plain = sc.stage_mrf(x, gen.stage_conv_weights(0), CFG.resblock_dilation_sizes,
                             LRELU_SLOPE)
        assert plain.dtype == x.dtype and torch.equal(plain, want)
    else:
        assert storage is None
    assert _launches() == before


@pytest.mark.parametrize("t_len", [5, 600])
def test_plain_mrf_at_lengths_beside_the_halo(gen, t_len):
    """S1's plain MRF equals the stock loop on a sequence shorter than the widest halo
    (k = 11, d = 5: 25 rows a side) and on one longer than the kernel's 512-row tile."""
    x = torch.randn(1, t_len, 64, generator=torch.Generator().manual_seed(t_len)).bfloat16()
    want = _stock_mrf(gen, x, torch.bfloat16, torch.bfloat16)
    got = sc.stage_mrf(x, gen.stage_conv_weights(0), CFG.resblock_dilation_sizes,
                       LRELU_SLOPE)
    assert got.shape == x.shape and torch.equal(got, want)


def test_the_kernel_takes_bf16_at_the_v1_widths():
    ks, dils, bf = (3, 7, 11), ((1, 3, 5),) * 3, torch.bfloat16
    for C in (256, 128, 64):
        assert sc.takes(torch.empty(1, 8, C, dtype=bf), bf, ks, dils)
    assert not sc.takes(torch.empty(1, 8, 64), bf, ks, dils)  # fp32 storage
    assert not sc.takes(torch.empty(1, 8, 64, dtype=bf), None, ks, dils)  # fp32 operands
    assert not sc.takes(torch.empty(1, 8, 64, dtype=bf), torch.float32, ks, dils)
    assert not sc.takes(torch.empty(1, 8, 32, dtype=bf), bf, ks, dils)  # v1 stage 3
    assert not sc.takes(torch.empty(1, 8, 64, dtype=bf), bf, (4,), ((1,),))
    assert not sc.takes(torch.empty(1, 8, 64, dtype=bf), bf, (11,), ((13,),))


def test_pack_conv_lays_out_the_bf16_weight(gen):
    """The kernel's weight is the bf16 operand that `conv_operands` makes, (k, C_in,
    C_out); the packs are cached until a parameter changes."""
    w = torch.randn(64, 32, 3, generator=torch.Generator().manual_seed(3)) / 10
    cw = sc.pack_conv(w, torch.zeros(64))
    assert cw.taps.shape == (3, 32, 64) and cw.taps.dtype == torch.bfloat16
    assert torch.equal(cw.taps.float(), sc.conv_operands(w, w, torch.bfloat16)[1]
                       .permute(2, 1, 0))
    first = gen.stage_conv_weights(0)
    assert gen.stage_conv_weights(0) is first
    with torch.no_grad():
        gen.res_0_0.convs()[0].bias.add_(0.0)
    assert gen.stage_conv_weights(0) is not first
