"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import neither JAX nor the JAX package, so that they run on a machine
that has only PyTorch. There, run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Where torch.cuda.is_available() is False they skip.
"""

import numpy as np
import pytest
import torch

from ttscube_tpu_torch.ops import fused_tail

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
GRAD_REL_RMS = 5e-3  # chip_smoke.py's limit on B2's grads at the training shape


def _case(B, T_in, seed, device, ks=KS, dils=DILS):
    """z and the tail weights in PyTorch layouts (v1 chains unless given)."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(device)
    kernels = [n(0.5 / np.sqrt(k * 32), 32, 32, k)
               for k, d in zip(ks, dils) for _ in range(2 * len(d))]
    return (n(1.0, B, T_in, 64), n(0.5 / 8, 64, 32, 4), n(0.1, 32), kernels,
            [n(0.1, 32) for _ in kernels], n(0.3, 1, 32, 7), n(0.05, 1))


@pytest.fixture
def cuda():
    """The card, with TF32 off for the fp32 comparisons (restored afterwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _distance(a, b):
    """(max, RMS) of |a − b|, in fp64."""
    d = (a.double() - b.double()).abs()
    return d.max().item(), d.square().mean().sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T_in,bf16,ks,dils", [
    (1, 301, False, KS, DILS), (2, 64, False, KS, DILS), (2, 301, True, KS, DILS),
    # the chains of the JAX package's tests/test_pallas_resblock.py tail test
    (2, 700, False, (3, 7), ((1, 3), (1, 3, 5))), (2, 700, True, (3, 7), ((1, 3), (1, 3, 5))),
])
def test_fused_tail_kernel_matches_plain(cuda, B, T_in, bf16, ks, dils):
    """Ragged lengths (tiles cut at the end, a sequence shorter than one tile). Limits as
    in chip_smoke.py: 5e-5 in fp32 (TF32 off). With bf16 operands the floor is the plain
    version's own bf16-vs-fp32 distance: the kernel must sit within half its RMS and
    within its max of the plain bf16 version, and the kernel in fp32 (the control) must
    not."""
    args = _case(B, T_in, seed=T_in, device=cuda, ks=ks, dils=dils)
    pack = lambda cd: fused_tail.pack_tail_weights(*args[1:], kernel_sizes=ks, dilations=dils,
                                                   compute_dtype=cd)
    w32 = pack(None)
    before = fused_tail.fused_tail_stage.launches
    got32 = fused_tail.fused_tail_stage(args[0], w32)
    want32 = fused_tail.fused_tail_stage_plain(args[0], w32)
    torch.cuda.synchronize()
    assert fused_tail.fused_tail_stage.launches == before + 1
    assert got32.shape == want32.shape == (B, 4 * T_in)
    assert (got32 - want32).abs().max().item() <= 5e-5
    if bf16:
        w16 = pack(torch.bfloat16)
        got16 = fused_tail.fused_tail_stage(args[0], w16)
        want16 = fused_tail.fused_tail_stage_plain(args[0], w16)
        floor = _distance(want16, want32)
        within = lambda d: d[1] <= 0.5 * floor[1] and d[0] <= floor[0]
        assert floor[0] > 1e-4
        assert within(_distance(got16, want16)), (_distance(got16, want16), floor)
        assert not within(_distance(got32, want16))


@pytest.mark.gpu
def test_fused_tail_kernel_refuses_what_it_cannot_run(cuda):
    """A CUDA tensor the kernel does not take raises; it never falls back."""
    args = _case(1, 32, seed=0, device=cuda)
    w = fused_tail.pack_tail_weights(*args[1:], kernel_sizes=KS, dilations=DILS)
    with pytest.raises(ValueError, match="fp32"):
        fused_tail.fused_tail_stage(args[0].double(), w)
    with pytest.raises(ValueError, match="fp32"):
        fused_tail.fused_tail_stage(args[0][:, ::2], w)
    with pytest.raises(ValueError, match="device"):
        fused_tail.fused_tail_stage(args[0], w._replace(wmrf=w.wmrf.cpu()))


@pytest.mark.gpu
def test_serving_generator_matches_module_path_on_the_card(cuda):
    """The full v1 generator on the card: generator_apply_fused (cuDNN convs and the
    fused tail kernel, fp32) against Generator.forward (cuDNN convs only), 5e-5."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
    from ttscube_tpu_torch.models.hifigan_fused import generator_apply_fused

    gen = init_random(Generator(HifiganConfig()), 0).to(cuda)
    mel = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 6, 80)).astype(np.float32)).to(cuda)
    before = fused_tail.fused_tail_stage.launches
    with torch.no_grad():
        got = generator_apply_fused(gen, mel, gen.config)
        want = gen(mel)
    assert fused_tail.fused_tail_stage.launches == before + 1
    assert got.shape == want.shape == (1, 6 * 240)
    assert (got - want).abs().max().item() <= 5e-5


def _grad_leaves(args):
    """z and every weight of `_case`'s stage as leaves that take grads."""
    z, up, ub, kernels, biases, pk, pb = args
    return [t.detach().clone().requires_grad_() for t in (z, up, ub, pk, pb, *kernels, *biases)]


def _plain_vjp(leaves, dy, ks, dils):
    """Autograd through the plain version: the grads kernel B2 must give."""
    z, up, ub, pk, pb, *kb = leaves
    n = len(kb) // 2
    w = fused_tail.pack_tail_weights(up, ub, kb[:n], kb[n:], pk, pb, kernel_sizes=ks,
                                     dilations=dils)
    return torch.autograd.grad(fused_tail.fused_tail_stage_plain(z, w), leaves, dy)


def _exact_vjp(leaves, dy, ks, dils):
    """The plain version's VJP in fp64: the exact grads of the same function."""
    z, up, ub, pk, pb, *kb = [t.detach().double().requires_grad_() for t in leaves]
    n = len(kb) // 2
    w = fused_tail.pack_tail_weights(up, ub, kb[:n], kb[n:], pk, pb, kernel_sizes=ks,
                                     dilations=dils, dtype=torch.float64)
    leaves64 = [z, up, ub, pk, pb, *kb]
    return torch.autograd.grad(fused_tail.fused_tail_stage_plain(z, w), leaves64, dy.double())


def _kernel_vjp(leaves, dy, ks, dils):
    """The same grads through FusedTailStageGrad: forward B1, backward B2."""
    z, up, ub, pk, pb, *kb = leaves
    n = len(kb) // 2
    out = fused_tail.fused_tail_stage_train(z, up, ub, kb[:n], kb[n:], pk, pb,
                                            kernel_sizes=ks, dilations=dils)
    return torch.autograd.grad(out, leaves, dy)


def _within(a, b, tol=2e-4):
    return bool(((a.double() - b.double()).abs() <= tol + tol * b.double().abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,T_in,ks,dils,blocks", [
    (2, 701, KS, DILS, None),            # ragged: the last tile is cut
    (2, 300, (3, 7), ((1, 3), (1, 3, 5)), None),  # the chains of the JAX package's grad test
    (2, 701, KS, DILS, 3),  # 22 tiles on 3 blocks: partials and workspace carry across tiles
])
def test_fused_tail_grad_kernel_matches_plain_vjp(cuda, monkeypatch, B, T_in, ks, dils,
                                                  blocks):
    """B2 against autograd of the plain version, fp32 (TF32 off), every grad at
    rtol = atol = 2e-4 (the JAX package's grad tests' tolerance); two launches on the
    same input give bit-equal grads; the counters rise by one launch each. With
    `blocks`, B2 runs on that many thread blocks, so that each walks several tiles."""
    if blocks is not None:
        monkeypatch.setattr(fused_tail, "GRAD_BLOCKS", blocks)
    args = _case(B, T_in, seed=T_in, device=cuda, ks=ks, dils=dils)
    leaves = _grad_leaves(args)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 4 * T_in)).astype(np.float32)).to(cuda)
    want = _plain_vjp(leaves, dy, ks, dils)
    before = (fused_tail.fused_tail_stage.launches, fused_tail.fused_tail_stage_grad.launches)
    got = _kernel_vjp(leaves, dy, ks, dils)
    again = _kernel_vjp(leaves, dy, ks, dils)
    torch.cuda.synchronize()
    assert (fused_tail.fused_tail_stage.launches, fused_tail.fused_tail_stage_grad.launches) \
        == (before[0] + 2, before[1] + 2)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g.shape == w_.shape, i
        torch.testing.assert_close(g, w_, rtol=2e-4, atol=2e-4, msg=f"grad {i}")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_fused_tail_grad_kernel_refuses_what_it_cannot_run(cuda):
    args = _case(1, 32, seed=0, device=cuda)
    w = fused_tail.pack_tail_weights(*args[1:], kernel_sizes=KS, dilations=DILS)
    dy = torch.zeros(1, 128, device=cuda)
    with pytest.raises(ValueError, match="dy"):
        fused_tail.fused_tail_stage_grad(args[0], w, dy[:, :64])
    with pytest.raises(ValueError, match="fp32"):
        fused_tail.fused_tail_stage_grad(
            args[0], fused_tail.pack_tail_weights(*args[1:], kernel_sizes=KS,
                                                  dilations=DILS,
                                                  compute_dtype=torch.bfloat16), dy)


@pytest.mark.gpu
def test_fused_tail_grad_kernel_at_the_training_shape(cuda):
    """B = 16 windows of 12,000 samples. Here no fp32 VJP of the stage, the plain one
    included, meets rtol = atol = 2e-4 against the exact (fp64) VJP: where an activation
    lies within fp32 noise of a leaky kink, the fp32 forward takes the other slope there
    and the grads of every conv upstream of it move. So each grad is held to the exact
    VJP within GRAD_REL_RMS in relative RMS (chip_smoke.py's limit, set from several
    seeds there): the kernel and the plain fp32 version (the witness) must meet it, the
    plain version under TF32 (the control) must not. Two launches give bit-equal grads."""
    B, T_in = 16, 3000
    args = _case(B, T_in, seed=T_in, device=cuda)
    leaves = _grad_leaves(args)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 4 * T_in)).astype(np.float32)).to(cuda)
    got = _kernel_vjp(leaves, dy, KS, DILS)
    again = _kernel_vjp(leaves, dy, KS, DILS)
    plain = _plain_vjp(leaves, dy, KS, DILS)
    exact = _exact_vjp(leaves, dy, KS, DILS)
    torch.backends.cudnn.allow_tf32 = True
    control = _plain_vjp(leaves, dy, KS, DILS)
    torch.backends.cudnn.allow_tf32 = False

    def worst_rel_rms(gs):
        return max(float((a.double() - e).norm() / e.norm()) for a, e in zip(gs, exact))

    assert worst_rel_rms(got) <= GRAD_REL_RMS
    assert worst_rel_rms(plain) <= GRAD_REL_RMS
    assert worst_rel_rms(control) > GRAD_REL_RMS
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- B3 (fused_mrf1) and B1-mid (fused_tail_stage_mid) ------------------------------------

V1 = dict(ks=KS, dils=DILS)
NARROW = dict(ks=(3, 11), dils=((1, 3), (1, 3, 5)))  # the JAX package's MRF test chains


def _mrf_case(B, T, C, seed, device, ks, dils):
    """x (B, T, C) and an MRF stage's kernels and biases in PyTorch layouts."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(device)
    kernels = [n(0.5 / np.sqrt(k * C), C, C, k) for k, d in zip(ks, dils)
               for _ in range(2 * len(d))]
    return n(1.0, B, T, C), kernels, [n(0.1, C) for _ in kernels]


def _fp32_limit(want):
    """The JAX package's MRF tolerance (3e-5 on activations of unit scale), scaled to
    the activation's range."""
    return 3e-5 * max(1.0, want.abs().max().item())


def _check_bf16(got16, want16, got32, want32):
    """The floor scheme of the B1 test above: the kernel within half the floor's RMS
    and within its max of the plain bf16 version, the kernel in fp32 not."""
    floor = _distance(want16, want32)
    within = lambda d: d[1] <= 0.5 * floor[1] and d[0] <= floor[0]
    assert floor[0] > 1e-4
    assert within(_distance(got16, want16)), (_distance(got16, want16), floor)
    assert not within(_distance(got32, want16))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C,chains", [
    (1, 1280, 256, V1),    # stage 0 of v1 at 256 frames
    (1, 3840, 128, V1),    # stage 1
    (2, 301, 128, NARROW),  # ragged: the last row tile is cut
    (2, 77, 64, V1),       # shorter than one row tile
    (1, 500, 32, V1),
])
def test_fused_mrf_kernel_matches_plain(cuda, B, T, C, chains):
    """B3 against its plain version, fp32 (TF32 off) and bf16; two launches bit-equal;
    one launch counted per call."""
    from ttscube_tpu_torch.ops import fused_mrf

    x, kernels, biases = _mrf_case(B, T, C, seed=T + C, device=cuda, **chains)
    pack = lambda cd: fused_mrf.pack_mrf_weights(kernels, biases, kernel_sizes=chains["ks"],
                                                 dilations=chains["dils"], compute_dtype=cd)
    w32, w16 = pack(None), pack(torch.bfloat16)
    before = fused_mrf.fused_mrf1.launches
    got32, again = fused_mrf.fused_mrf1(x, w32), fused_mrf.fused_mrf1(x, w32)
    got16 = fused_mrf.fused_mrf1(x, w16)
    want32, want16 = fused_mrf.fused_mrf_plain(x, w32), fused_mrf.fused_mrf_plain(x, w16)
    torch.cuda.synchronize()
    assert fused_mrf.fused_mrf1.launches == before + 3
    assert got32.shape == want32.shape == (B, T, C)
    assert torch.equal(got32, again)
    assert (got32 - want32).abs().max().item() <= _fp32_limit(want32)
    _check_bf16(got16, want16, got32, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T_in,chains", [(1, 3840, V1), (2, 301, NARROW)])
def test_fused_mid_stage_kernel_matches_plain(cuda, B, T_in, chains):
    """B1-mid (C_in = 128 → C = 64, fold 4) against its plain version, fp32 (TF32 off)
    and bf16; two launches bit-equal."""
    x, kernels, biases = _mrf_case(B, T_in, 128, seed=T_in, device=cuda, **chains)
    _, mrf_kernels, mrf_biases = _mrf_case(1, 1, 64, seed=T_in + 1, device=cuda, **chains)
    rng = np.random.default_rng(T_in + 2)
    up = torch.from_numpy((0.5 / np.sqrt(128) * rng.standard_normal((128, 64, 4)))
                          .astype(np.float32)).to(cuda)
    up_b = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32)).to(cuda)
    pack = lambda cd: fused_tail.pack_tail_weights(
        up, up_b, mrf_kernels, mrf_biases, kernel_sizes=chains["ks"],
        dilations=chains["dils"], compute_dtype=cd)
    w32, w16 = pack(None), pack(torch.bfloat16)
    before = fused_tail.fused_tail_stage_mid.launches
    got32 = fused_tail.fused_tail_stage_mid(x, w32)
    again = fused_tail.fused_tail_stage_mid(x, w32)
    got16 = fused_tail.fused_tail_stage_mid(x, w16)
    want32 = fused_tail.fused_tail_stage_plain(x, w32)
    want16 = fused_tail.fused_tail_stage_plain(x, w16)
    torch.cuda.synchronize()
    assert fused_tail.fused_tail_stage_mid.launches == before + 3
    assert got32.shape == want32.shape == (B, 4 * T_in, 64)
    assert torch.equal(got32, again)
    assert (got32 - want32).abs().max().item() <= _fp32_limit(want32)
    _check_bf16(got16, want16, got32, want32)


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_cannot_run(cuda):
    from ttscube_tpu_torch.ops import fused_mrf

    x, kernels, biases = _mrf_case(1, 40, 64, seed=0, device=cuda, **V1)
    w = fused_mrf.pack_mrf_weights(kernels, biases, kernel_sizes=KS, dilations=DILS)
    with pytest.raises(ValueError, match="fp32"):
        fused_mrf.fused_mrf1(x.double(), w)
    with pytest.raises(ValueError, match="fp32"):
        fused_mrf.fused_mrf1(x[:, :, :32], w)
    with pytest.raises(ValueError, match="device"):
        fused_mrf.fused_mrf1(x, w._replace(w=w.w.cpu()))
    z = x[:, :, :32].repeat(1, 1, 4).contiguous()  # (1, 40, 128)
    up = torch.zeros(128, 64, 4, device=cuda)
    wm = fused_tail.pack_tail_weights(up, torch.zeros(64, device=cuda), kernels, biases,
                                      kernel_sizes=KS, dilations=DILS)
    with pytest.raises(ValueError, match="fp32"):
        fused_tail.fused_tail_stage_mid(z.double(), wm)
    with pytest.raises(ValueError, match="conv_post"):
        fused_tail.fused_tail_stage(z, wm)


@pytest.mark.gpu
def test_wide_serving_generator_matches_module_path_on_the_card(cuda):
    """The full v1 generator with every stage fused (B3 on stages 0 and 1, B1-mid on
    stage 2, B1 on stage 3), fp32, against Generator.forward (cuDNN convs only): 5e-5;
    each kernel launched as often as the path has such stages."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
    from ttscube_tpu_torch.models.hifigan_fused import generator_apply_fused
    from ttscube_tpu_torch.ops import fused_mrf

    gen = init_random(Generator(HifiganConfig()), 0).to(cuda)
    mel = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 37, 80)).astype(np.float32)).to(cuda)
    counters = (fused_mrf.fused_mrf1, fused_tail.fused_tail_stage_mid,
                fused_tail.fused_tail_stage)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = generator_apply_fused(gen, mel, gen.config, fuse_channels=(256, 128, 64, 32))
        want = gen(mel)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 1]
    assert got.shape == want.shape == (1, 37 * 240)
    assert (got - want).abs().max().item() <= 5e-5


# -- B4, B5 and the trainer ---------------------------------------------------------------

RESBLOCK_CASES = [  # (B, T, C, k, dilations): the JAX test's shapes, then v1's stages
    (2, 2048, 32, 11, (1, 3, 5)), (2, 8192, 32, 3, (1, 3, 5)), (2, 1920, 64, 7, (1, 3, 5)),
    (2, 1024, 128, 11, (1, 3)), (2, 7696, 32, 11, (1, 3, 5)),
    (1, 1280, 256, 3, (1, 3, 5)), (1, 3840, 128, 7, (1, 3, 5)), (1, 15360, 64, 11, (1, 3, 5)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C,k,dils", RESBLOCK_CASES)
def test_fused_resblock_kernel_matches_plain(cuda, B, T, C, k, dils):
    """B4 against its plain version: fp32 (TF32 off) within 2e-5 (the JAX test's atol)
    scaled to the output's range, bf16 by the floor scheme, two launches bit-equal, one
    launch counted per call."""
    from ttscube_tpu_torch.ops import fused_resblock

    rng = np.random.default_rng(T + C + k)
    n = lambda scale, *s: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(cuda)
    x = n(1.0, B, T, C)
    kernels = [n(0.3 / np.sqrt(k * C), k, C, C) for _ in range(2 * len(dils))]
    biases = [n(0.1, C) for _ in kernels]
    run = lambda f, cd=None: f(x, kernels, biases, kernel_size=k, dilations=dils,
                               compute_dtype=cd)
    before = fused_resblock.fused_resblock1.launches
    got32, again = run(fused_resblock.fused_resblock1), run(fused_resblock.fused_resblock1)
    got16 = run(fused_resblock.fused_resblock1, torch.bfloat16)
    want32 = run(fused_resblock.fused_resblock1_plain)
    want16 = run(fused_resblock.fused_resblock1_plain, torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_resblock.fused_resblock1.launches == before + 3
    assert got32.shape == want32.shape == (B, T, C) and got32.dtype == torch.float32
    assert torch.equal(got32, again)
    assert (got32 - want32).abs().max().item() <= 2e-5 * max(1.0, want32.abs().max().item())
    _check_bf16(got16, want16, got32, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C,k", [(2, 1000, 64, 7), (1, 4096, 256, 3), (2, 77, 32, 4),
                                     (1, 500, 96, 15), (1, 300, 256, 15)])
def test_narrow_conv_kernel_matches_plain(cuda, B, T, C, k):
    """B5 against `F.conv1d` over the same operands: fp32 (TF32 off) within 1e-5 (the
    JAX test's atol) scaled to the output's range; bf16 operands against the plain fp32
    conv of the same bf16-rounded values (products exact in fp32) within the same;
    two launches bit-equal. C = 256 at k = 15 walks input-channel chunks."""
    from ttscube_tpu_torch.ops import narrow_conv

    rng = np.random.default_rng(T + C + k)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((k, C, C)) / np.sqrt(k * C))
                         .astype(np.float32)).to(cuda)
    before = narrow_conv.narrow_conv_blocked.launches
    got, again = narrow_conv.narrow_conv_blocked(x, w), narrow_conv.narrow_conv_blocked(x, w)
    got16 = narrow_conv.narrow_conv_blocked(x.bfloat16(), w.bfloat16())
    want, want16 = (narrow_conv.narrow_conv_plain(x, w),
                    narrow_conv.narrow_conv_plain(x.bfloat16(), w.bfloat16()))
    torch.cuda.synchronize()
    assert narrow_conv.narrow_conv_blocked.launches == before + 3
    assert got.shape == (B, T, C) and got16.dtype == torch.float32
    assert torch.equal(got, again)
    for a, b in ((got, want), (got16, want16)):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    assert (got16 - want).abs().max().item() > 1e-3  # the operands really were rounded


@pytest.mark.gpu
def test_b4_b5_refuse_what_they_cannot_run(cuda):
    from ttscube_tpu_torch.ops import fused_resblock, narrow_conv

    x = torch.zeros(1, 64, 32, device=cuda)
    w = [torch.zeros(3, 32, 32, device=cuda)] * 2
    b = [torch.zeros(32, device=cuda)] * 2
    with pytest.raises(ValueError, match="fp32"):
        fused_resblock.fused_resblock1(x.double(), w, b, kernel_size=3, dilations=(1,))
    with pytest.raises(ValueError, match="device"):
        fused_resblock.fused_resblock1(x, [t.cpu() for t in w], [t.cpu() for t in b],
                                       kernel_size=3, dilations=(1,))
    with pytest.raises(ValueError, match="device"):
        narrow_conv.narrow_conv_blocked(x, w[0].cpu())
    with pytest.raises(ValueError, match="up to 256"):
        narrow_conv.narrow_conv_blocked(torch.zeros(1, 8, 288, device=cuda),
                                        torch.zeros(3, 288, 288, device=cuda))


@pytest.mark.gpu
def test_trainer_resumes_on_the_card(cuda, tmp_path):
    """The port's loop on the card (a small config, fp32, fused tail training): the
    `.opt.last` it writes restores parameters, u, moments and step bit-equal into a
    fresh state; the next step from the restored state equals the next step from the
    live one (losses 1e-4 relative)."""
    import copy
    import json

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.train.loop import train
    from ttscube_tpu_torch.utils.checkpoint import load_train_state
    from ttscube_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(4):  # tests/test_data.py's corpus format
        durs = rng.integers(2, 6, 6)
        f2p = [p for p, d in enumerate(durs) for _ in range(d)]
        F = len(f2p)
        meta = {"id": f"utt{i}", "orig_text": "xxxxxx", "phones": list("abcdea"),
                "words": ["w1", "w2"], "phon2word": [0, 0, 0, 1, 1, 1], "frame2phon": f2p,
                "speaker": f"spk{i % 2}"}
        (corpus / f"utt{i}.json").write_text(json.dumps(meta))
        np.save(corpus / f"utt{i}.mgc.npy", rng.standard_normal((F, 80)).astype(np.float32))
        np.save(corpus / f"utt{i}.pitch.npy", rng.uniform(0, 300, F).astype(np.float32))
        write_wav(str(corpus / f"utt{i}.wav"), rng.uniform(-0.3, 0.3, F * 240), 24000)
    ds = CubeganDataset(str(corpus))
    enc = CubeganEncodings()
    enc.compute(ds)
    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=30, num_speakers=3, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(upsample_rates=(5, 3, 4, 4), upsample_kernel_sizes=(16, 16, 4, 4),
                              upsample_initial_channel=512, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), fused_tail_train=True),
        mpd_channels=(8, 16), msd_width=8)
    fresh = lambda seed: tcg.create_train_state(
        init_random(tcg.Cubegan(cfg, train=True), seed).to(cuda))
    collate = CubeganCollate(enc, min_frames=60, bucket_frames=60, bucket_phones=16)
    base = str(tmp_path / "m" / "cubegan")
    live = train(state=fresh(0), train_step=tcg.train_step, val_step=tcg.val_step,
                 trainset=ds, devset=ds, collate=collate, batch_size=2, output_base=base,
                 selection_metric="loss_mel", device=cuda, max_steps=2)
    restored = load_train_state(base + ".opt.last", fresh(1))
    assert restored.step == live.step == 2
    sd = restored.model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in live.model.state_dict().items())
    for part, opt in live.optimizers.items():
        for p, q in zip(opt.param_groups[0]["params"],
                        restored.optimizers[part].param_groups[0]["params"]):
            assert torch.equal(opt.state[p]["exp_avg"],
                               restored.optimizers[part].state[q]["exp_avg"])
            assert torch.equal(opt.state[p]["exp_avg_sq"],
                               restored.optimizers[part].state[q]["exp_avg_sq"])
    batch = tcg.batch_to_torch(collate([ds[0], ds[1]]), cuda)
    _, m_live = tcg.train_step(copy.deepcopy(live), batch)
    _, m_back = tcg.train_step(restored, batch)
    for k, v in m_live.items():
        assert abs(m_back[k].item() - v.item()) <= 1e-4 * abs(v.item()), k
