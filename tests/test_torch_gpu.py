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
from ttscube_tpu_torch.utils.profiling import counters as _counters

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
GRAD_REL_RMS = 5e-3  # chip_smoke.py's limit on B2's grads at the training shape


def launches(wrapper) -> int:
    """The launches of a kernel wrapper so far (`launches.<name>`, utils/profiling)."""
    return _counters().get(f"launches.{wrapper.__name__}", 0)


def _case(B, T_in, seed, device, ks=KS, dils=DILS, c_in=64):
    """z and the tail weights in PyTorch layouts (v1 chains and 64 input channels unless
    given)."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(device)
    kernels = [n(0.5 / np.sqrt(k * 32), 32, 32, k)
               for k, d in zip(ks, dils) for _ in range(2 * len(d))]
    return (n(1.0, B, T_in, c_in), n(0.5 / np.sqrt(c_in), c_in, 32, 4), n(0.1, 32), kernels,
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
    before = launches(fused_tail.fused_tail_stage)
    got32 = fused_tail.fused_tail_stage(args[0], w32)
    want32 = fused_tail.fused_tail_stage_plain(args[0], w32)
    torch.cuda.synchronize()
    assert launches(fused_tail.fused_tail_stage) == before + 1
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
@pytest.mark.parametrize("B,T_in,c_in,ks,dils,bf16", [
    # the training shapes: B = 16 windows of 3,000 input rows, and the trainer's B = 4
    # with a last tile that is cut
    (16, 3000, 64, KS, DILS, False), (4, 2999, 64, KS, DILS, False),
    # the most input channels and a k = 15 chain, whose fp32 weights are staged in two
    # chunks of taps
    (2, 301, 128, (3, 15), ((1, 2), (1, 2)), False),
    (2, 301, 128, (3, 15), ((1, 2), (1, 2)), True),
    # k = 31: three chunks of taps in both forms
    (1, 500, 64, (31,), ((1,),), False), (1, 500, 64, (31,), ((1,),), True),
])
def test_fused_tail_kernel_edges_and_relaunches(cuda, B, T_in, c_in, ks, dils, bf16):
    """B1 where its MMA passes meet their edges, with the limits of the test above
    (5e-5 in fp32, TF32 off; the bf16 floor scheme with its control); two launches are
    bit-equal in either form."""
    args = _case(B, T_in, seed=T_in + c_in, device=cuda, ks=ks, dils=dils, c_in=c_in)
    pack = lambda cd: fused_tail.pack_tail_weights(*args[1:], kernel_sizes=ks, dilations=dils,
                                                   compute_dtype=cd)
    w32 = pack(None)
    got32, again32 = (fused_tail.fused_tail_stage(args[0], w32) for _ in range(2))
    want32 = fused_tail.fused_tail_stage_plain(args[0], w32)
    torch.cuda.synchronize()
    assert got32.shape == want32.shape == (B, 4 * T_in)
    assert torch.equal(got32, again32)
    assert (got32 - want32).abs().max().item() <= 5e-5
    if bf16:
        w16 = pack(torch.bfloat16)
        got16, again16 = (fused_tail.fused_tail_stage(args[0], w16) for _ in range(2))
        want16 = fused_tail.fused_tail_stage_plain(args[0], w16)
        assert torch.equal(got16, again16)
        _check_bf16(got16, want16, got32, want32)


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
    before = launches(fused_tail.fused_tail_stage)
    with torch.no_grad():
        got = generator_apply_fused(gen, mel, gen.config)
        want = gen(mel)
    assert launches(fused_tail.fused_tail_stage) == before + 1
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
@pytest.mark.parametrize("B,T_in,ks,dils,blocks,c_in", [
    (2, 701, KS, DILS, None, 64),            # ragged: the last tile is cut
    (2, 300, (3, 7), ((1, 3), (1, 3, 5)), None, 64),  # the JAX package's grad test chains
    (2, 701, KS, DILS, 3, 64),  # 22 tiles on 3 blocks: partials and workspace carry over
    (1, 301, KS, DILS, None, 64),   # one window, its last tile cut
    (4, 333, KS, DILS, None, 64),   # the trainer's batch, a ragged last tile in each window
    (1, 50, KS, DILS, None, 64),    # shorter than one tile
    # the most taps an MRF conv may have (its weights fill the shared memory's last
    # room) and the most input channels the upsample takes
    (2, 301, (15, 3), ((1,), (1, 3)), None, 128),
])
def test_fused_tail_grad_kernel_matches_plain_vjp(cuda, monkeypatch, B, T_in, ks, dils,
                                                  blocks, c_in):
    """B2 against autograd of the plain version, fp32 (TF32 off), every grad at
    rtol = atol = 2e-4 (the JAX package's grad tests' tolerance); two launches on the
    same input give bit-equal grads; the counters rise by one launch each. With
    `blocks`, B2 runs on that many thread blocks, so that each walks several tiles."""
    if blocks is not None:
        monkeypatch.setattr(fused_tail, "GRAD_BLOCKS", blocks)
    args = _case(B, T_in, seed=T_in, device=cuda, ks=ks, dils=dils, c_in=c_in)
    leaves = _grad_leaves(args)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 4 * T_in)).astype(np.float32)).to(cuda)
    want = _plain_vjp(leaves, dy, ks, dils)
    before = (launches(fused_tail.fused_tail_stage), launches(fused_tail.fused_tail_stage_grad))
    got = _kernel_vjp(leaves, dy, ks, dils)
    again = _kernel_vjp(leaves, dy, ks, dils)
    torch.cuda.synchronize()
    assert (launches(fused_tail.fused_tail_stage), launches(fused_tail.fused_tail_stage_grad)) \
        == (before[0] + 2, before[1] + 2)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g.shape == w_.shape, i
        torch.testing.assert_close(g, w_, rtol=2e-4, atol=2e-4, msg=f"grad {i}")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_fused_tail_grad_phase_clocks(cuda):
    """B2's optional clock profile: every phase of block 0's tiles takes clocks, and the
    grads are bit-equal to a launch without the profile."""
    args = _case(2, 701, seed=5, device=cuda)
    w = fused_tail.pack_tail_weights(*args[1:], kernel_sizes=KS, dilations=DILS)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 2804))
                          .astype(np.float32)).to(cuda)
    clocks = torch.zeros(fused_tail.GRAD_LIMITS["n_phases"], dtype=torch.int64, device=cuda)
    got = fused_tail.fused_tail_stage_grad(args[0], w, dy, phase_clocks=clocks)
    plain = fused_tail.fused_tail_stage_grad(args[0], w, dy)
    torch.cuda.synchronize()
    assert len(fused_tail.GRAD_PHASES) == clocks.numel() and bool((clocks > 0).all())
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="phase_clocks"):
        fused_tail.fused_tail_stage_grad(args[0], w, dy, phase_clocks=clocks.int())


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
@pytest.mark.parametrize("B,T_in", [(16, 3000), (4, 3000), (1, 3000), (4, 2999)])
def test_fused_tail_grad_kernel_at_the_training_shape(cuda, B, T_in):
    """B = 16 windows of 12,000 samples (and the trainer's B = 4, one window, and a
    T_in whose last tile is cut). Here no fp32 VJP of the stage, the plain one
    included, meets rtol = atol = 2e-4 against the exact (fp64) VJP: where an activation
    lies within fp32 noise of a leaky kink, the fp32 forward takes the other slope there
    and the grads of every conv upstream of it move. So each grad is held to the exact
    VJP within GRAD_REL_RMS in relative RMS (chip_smoke.py's limit, set from several
    seeds there): the kernel and the plain fp32 version (the witness) must meet it, the
    plain version under TF32 (the control) must not. Two launches give bit-equal grads."""
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
    before = launches(fused_mrf.fused_mrf1)
    got32, again = fused_mrf.fused_mrf1(x, w32), fused_mrf.fused_mrf1(x, w32)
    got16 = fused_mrf.fused_mrf1(x, w16)
    want32, want16 = fused_mrf.fused_mrf_plain(x, w32), fused_mrf.fused_mrf_plain(x, w16)
    torch.cuda.synchronize()
    assert launches(fused_mrf.fused_mrf1) == before + 3
    assert got32.shape == want32.shape == (B, T, C)
    assert torch.equal(got32, again)
    assert (got32 - want32).abs().max().item() <= _fp32_limit(want32)
    _check_bf16(got16, want16, got32, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C", [(2, 333, 96), (1, 517, 160)])
def test_fused_mrf_kernel_odd_channel_tiles(cuda, B, T, C):
    """B3 at channel counts of an odd number of 32-channel tiles and a T that no
    128-row tile divides: fp32 (TF32 off) within the MRF limit, bf16 by the floor
    scheme; two launches bit-equal in either form."""
    from ttscube_tpu_torch.ops import fused_mrf

    x, kernels, biases = _mrf_case(B, T, C, seed=T + C, device=cuda, **V1)
    pack = lambda cd: fused_mrf.pack_mrf_weights(kernels, biases, kernel_sizes=KS,
                                                 dilations=DILS, compute_dtype=cd)
    w32, w16 = pack(None), pack(torch.bfloat16)
    got32, again32 = (fused_mrf.fused_mrf1(x, w32) for _ in range(2))
    got16, again16 = (fused_mrf.fused_mrf1(x, w16) for _ in range(2))
    want32, want16 = fused_mrf.fused_mrf_plain(x, w32), fused_mrf.fused_mrf_plain(x, w16)
    torch.cuda.synchronize()
    assert got16.shape == want16.shape == (B, T, C)
    assert torch.equal(got32, again32) and torch.equal(got16, again16)
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
    before = launches(fused_tail.fused_tail_stage_mid)
    got32 = fused_tail.fused_tail_stage_mid(x, w32)
    again = fused_tail.fused_tail_stage_mid(x, w32)
    got16 = fused_tail.fused_tail_stage_mid(x, w16)
    want32 = fused_tail.fused_tail_stage_plain(x, w32)
    want16 = fused_tail.fused_tail_stage_plain(x, w16)
    torch.cuda.synchronize()
    assert launches(fused_tail.fused_tail_stage_mid) == before + 3
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
    before = [launches(c) for c in counters]
    with torch.no_grad():
        got = generator_apply_fused(gen, mel, gen.config, fuse_channels=(256, 128, 64, 32))
        want = gen(mel)
    assert [launches(c) - b for c, b in zip(counters, before)] == [2, 1, 1]
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
    before = launches(fused_resblock.fused_resblock1)
    got32, again = run(fused_resblock.fused_resblock1), run(fused_resblock.fused_resblock1)
    got16 = run(fused_resblock.fused_resblock1, torch.bfloat16)
    want32 = run(fused_resblock.fused_resblock1_plain)
    want16 = run(fused_resblock.fused_resblock1_plain, torch.bfloat16)
    torch.cuda.synchronize()
    assert launches(fused_resblock.fused_resblock1) == before + 3
    assert got32.shape == want32.shape == (B, T, C) and got32.dtype == torch.float32
    assert torch.equal(got32, again)
    assert (got32 - want32).abs().max().item() <= 2e-5 * max(1.0, want32.abs().max().item())
    _check_bf16(got16, want16, got32, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,C,k", [(2, 1000, 64, 7), (1, 4096, 256, 3), (2, 77, 32, 4),
                                     (1, 500, 96, 15), (1, 300, 256, 15),
                                     (8, 122880, 32, 11),  # the Pallas kernel's docstring
                                     (3, 1000, 32, 11), (2, 700, 96, 6), (1, 2000, 256, 15),
                                     (2, 513, 160, 2)])
def test_narrow_conv_kernel_matches_plain(cuda, B, T, C, k):
    """B5 against `F.conv1d` over the same operands: fp32 (TF32 off) within 1e-5 (the
    JAX test's atol) scaled to the output's range; bf16 operands against the plain fp32
    conv of the same bf16-rounded values (products exact in fp32) within the same;
    two launches bit-equal in each. T need not be a multiple of the bf16 form's
    256-row tile; C = 96 and 160 leave an odd count of 16-channel MMA columns; an even
    k pads (k − 1)//2 on the left; C = 256 at k = 15 (and bf16 at C = 256, k = 3) walks
    input-channel chunks, over several tiles at T = 2000."""
    from ttscube_tpu_torch.ops import narrow_conv

    rng = np.random.default_rng(T + C + k)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((k, C, C)) / np.sqrt(k * C))
                         .astype(np.float32)).to(cuda)
    before = launches(narrow_conv.narrow_conv_blocked)
    got, again = narrow_conv.narrow_conv_blocked(x, w), narrow_conv.narrow_conv_blocked(x, w)
    got16, again16 = (narrow_conv.narrow_conv_blocked(x.bfloat16(), w.bfloat16())
                      for _ in range(2))
    want, want16 = (narrow_conv.narrow_conv_plain(x, w),
                    narrow_conv.narrow_conv_plain(x.bfloat16(), w.bfloat16()))
    torch.cuda.synchronize()
    assert launches(narrow_conv.narrow_conv_blocked) == before + 4
    assert got.shape == (B, T, C) and got16.dtype == torch.float32
    assert torch.equal(got, again) and torch.equal(got16, again16)
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


# -- batched and chunked serving, bf16 training ----------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B,frames", [(128, 512), (256, 320)], ids=["B128 F512", "B256 W320"])
def test_fused_tail_kernel_at_the_batched_serving_shapes(cuda, B, frames):
    """B1 at the serving batch of bench.py (128 items of 512 frames: z (128, 30,736,
    64)) and at one window of its chunked run (256 items, 256 + 2·32 frames): the batch
    offsets and tile counts of B·T rows. fp32 within 5e-5 (TF32 off), bf16 by the floor
    rule; every launch counted."""
    args = _case(B, 60 * frames + 16, seed=frames, device=cuda)
    pack = lambda cd: fused_tail.pack_tail_weights(*args[1:], kernel_sizes=KS, dilations=DILS,
                                                   compute_dtype=cd)
    w32, w16 = pack(None), pack(torch.bfloat16)
    before = launches(fused_tail.fused_tail_stage)
    got32, got16 = fused_tail.fused_tail_stage(args[0], w32), fused_tail.fused_tail_stage(args[0], w16)
    want32 = fused_tail.fused_tail_stage_plain(args[0], w32)
    want16 = fused_tail.fused_tail_stage_plain(args[0], w16)
    torch.cuda.synchronize()
    assert launches(fused_tail.fused_tail_stage) == before + 2
    assert got32.shape == got16.shape == want32.shape == (B, 4 * args[0].shape[1])
    assert bool(torch.isfinite(got16).all())
    assert (got32 - want32).abs().max().item() <= 5e-5
    _check_bf16(got16, want16, got32, want32)


def _bench_models(cuda, fuse_channels):
    """bench.py's serving Cubegan (v1, 64 phones, 8 speakers, fused tail) from seeded
    random weights, with bf16 and with fp32 storage, and 4 seeded items of 64
    characters."""
    import dataclasses

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig

    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=64, num_speakers=8, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(fused_tail=True, storage_dtype="bfloat16",
                              fuse_channels=fuse_channels))
    m16 = init_random(tcg.Cubegan(cfg), 0).to(cuda).eval()
    m32 = tcg.Cubegan(dataclasses.replace(cfg, hifigan=dataclasses.replace(
        cfg.hifigan, storage_dtype="float32"))).to(cuda).eval()
    m32.load_state_dict(m16.state_dict())
    rng = np.random.default_rng(4)
    X = {"x_char": torch.from_numpy(rng.integers(1, 64, (4, 64))).to(cuda),
         "x_speaker": torch.from_numpy(rng.integers(1, 8, (4, 1))).to(cuda)}
    return m16, m32, X


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_channels", [(32,), (256, 128, 64, 32)], ids=["tail", "wide"])
def test_chunked_serving_matches_whole_on_the_card(cuda, monkeypatch, fuse_channels):
    """Cubegan.infer at 512 frames in windows of 256 (+ 2·32) frames against the whole
    run, 4 items: fp32 within 5e-5 (TF32 off), bf16 storage by the floor rule; the fused
    kernels launch once per window (B3 twice and B1-mid once more with every stage
    fused); two chunked runs bit-equal under cuDNN's deterministic algorithms."""
    from ttscube_tpu_torch.ops import fused_mrf

    m16, m32, X = _bench_models(cuda, fuse_channels)
    # cuDNN may run the transposed convs with atomic adds; relaunches are bit-equal only
    # under deterministic algorithms
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    counters = (fused_tail.fused_tail_stage, fused_mrf.fused_mrf1, fused_tail.fused_tail_stage_mid)
    whole32, whole16 = (m.infer(X, max_frames=512)[0] for m in (m32, m16))
    before = [launches(c) for c in counters]
    chunk16 = m16.infer(X, max_frames=512, chunk_frames=256)[0]
    rise = [launches(c) - b for c, b in zip(counters, before)]
    chunk32, again16 = m32.infer(X, max_frames=512, chunk_frames=256)[0], \
        m16.infer(X, max_frames=512, chunk_frames=256)[0]
    torch.cuda.synchronize()
    assert rise == ([2, 0, 0] if fuse_channels == (32,) else [2, 4, 2])
    assert chunk16.shape == whole16.shape == (4, 512 * 240)
    assert bool(torch.isfinite(chunk16).all()) and torch.equal(chunk16, again16)
    assert (chunk32 - whole32).abs().max().item() <= 5e-5
    _check_bf16(chunk16, whole16, chunk32, whole32)


@pytest.mark.gpu
def test_bf16_train_step_on_the_card(cuda):
    """One GAN step with bf16 convs in the generator and the discriminators (a small
    config, no fused tail): finite losses within the floor scheme of the same step on
    the CPU, every parameter and Adam moment still fp32."""
    import dataclasses

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig

    cfg16 = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=30, num_speakers=3, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), compute_dtype="bfloat16"),
        mpd_channels=(8, 16), msd_width=8, disc_compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg16, hifigan=dataclasses.replace(
        cfg16.hifigan, compute_dtype="float32"), disc_compute_dtype="float32")
    weights = init_random(tcg.Cubegan(cfg16, train=True), 0).state_dict()
    rng = np.random.default_rng(1)
    B, N, F = 2, 16, 60
    durs = rng.integers(2, 6, (B, N))
    f2p = np.stack([np.concatenate([np.repeat(np.arange(N), d), np.full(F, N - 1)])[:F]
                    for d in durs])
    batch = {"x_char": rng.integers(1, 30, (B, N)), "x_speaker": rng.integers(1, 3, (B, 1)),
             "y_frame2phone": f2p, "y_frame_mask": np.ones((B, F), bool),
             "y_pitch": rng.uniform(80, 300, (B, F)).astype(np.float32), "y_dur": durs,
             "y_audio": (0.2 * rng.standard_normal((B, F * 240))).astype(np.float32),
             "n_frames": np.full(B, F)}
    starts = torch.tensor([0, 5])
    runs = {}
    for label, cfg, where in (("card16", cfg16, "cuda"), ("card32", cfg32, "cuda"),
                              ("cpu16", cfg16, "cpu")):
        m = tcg.Cubegan(cfg, train=True)
        m.load_state_dict(weights)
        st = tcg.create_train_state(m.to(where))
        with torch.backends.mkldnn.flags(enabled=False):
            _, met = tcg.train_step(st, tcg.batch_to_torch(batch, where), starts=starts)
        runs[label] = ({k: v.item() for k, v in met.items()}, st)
    ref = runs["card32"][0]
    rel = {k: torch.tensor([v[0][n] / abs(ref[n]) for n in sorted(ref)], dtype=torch.float64)
           for k, v in runs.items()}
    assert all(np.isfinite(list(runs["card16"][0].values())))
    # the floor scheme with the CPU's bf16 step as the reference; the card's fp32 step
    # is both the control and the other end of the floor
    _check_bf16(rel["card16"], rel["cpu16"], rel["card32"], rel["card32"])
    st = runs["card16"][1]
    moments = [v for opt in st.optimizers.values() for s in opt.state.values()
               for v in s.values() if isinstance(v, torch.Tensor) and v.dim() > 0]
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert moments and all(v.dtype == torch.float32 for v in moments)


# -- the mesh and the corpus import ---------------------------------------------------------

@pytest.mark.gpu
def test_mesh_step_on_one_card(cuda):
    """A (1, 1) mesh on the card (FSDP2 over NCCL, one rank, parallel/mesh.py): two train
    steps of a small config with the fused tail (B1 forward and B2 backward under the
    mesh) against the same steps without the mesh, under deterministic algorithms with
    TF32 off: each step's losses 1e-4 relative, the parameters after the first within 2
    lr plus rounding and at most 0.1 % of them beyond 0.01 lr (chip_smoke.py's limits
    for a resumed step). The second step fails these where the LSTMs run on the first
    step's weights (nn.LSTM's flatten_parameters under FSDP2, `_keep_rnn_weights`)."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.entry import _example_batch
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.ops import fused_tail
    from ttscube_tpu_torch.parallel import mesh as pm

    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=30, num_speakers=3, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(upsample_rates=(5, 3, 4, 4), upsample_kernel_sizes=(16, 16, 4, 4),
                              upsample_initial_channel=512, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), fused_tail_train=True),
        mpd_channels=(8, 16), msd_width=8)
    batch = tcg.batch_to_torch(_example_batch(B=2), cuda)

    def steps(rank, world, device, mesh_shape):
        model = init_random(tcg.Cubegan(cfg, train=True), 0).to(device)
        step = tcg.train_step
        if mesh_shape is not None:
            step = pm.make_parallel_train_step(model, pm.make_mesh(*mesh_shape,
                                                                   device=device), step)
        state = tcg.create_train_state(model)
        out, first = [], None
        grads = launches(fused_tail.fused_tail_stage_grad)
        for _ in range(2):
            state, m = step(state, batch)
            out.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                         .detach().cpu() for n, p in model.named_parameters()}
        return out, first, launches(fused_tail.fused_tail_stage_grad) - grads

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain, p_first, _ = steps(0, 1, cuda, None)
        meshed, m_first, b2 = pm.run_ranks(steps, 1, "cuda", args=((1, 1),))
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags[:3]
        torch.use_deterministic_algorithms(flags[3])
    assert b2 == 2
    for i in range(2):
        for k, v in plain[i].items():
            assert abs(meshed[i][k] - v) <= 1e-4 * abs(v), (i, k)
    lr, far, total = cfg.lr, 0, 0
    for n, w in p_first.items():
        d = (m_first[n] - w).abs()
        spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        assert bool((d <= 2 * lr + 2 * spacing).all()), n
        far += int((d > 0.01 * lr).sum())
        total += d.numel()
    assert far <= 1e-3 * total


@pytest.mark.gpu
def test_import_on_the_card_matches_the_cpu(cuda, tmp_path):
    """`import_blizzard_2023` of a small demo corpus with the mel on the card and on the
    CPU: every .mgc within 1e-4 (fp64 transforms), every other file equal."""
    from ttscube_tpu_torch.scripts import import_blizzard_2023, make_demo_corpus

    make_demo_corpus.main(make_demo_corpus.parser().parse_args(
        ["--output", str(tmp_path / "corpus"), "--sentences", "4"]))
    for where, flags in (("card", []), ("cpu", ["--device", "cpu"])):
        import_blizzard_2023.main(["--input-file", str(tmp_path / "corpus" / "align.txt"),
                                   "--dev-ratio", "0.25", "--train-output",
                                   str(tmp_path / where / "train"), "--dev-output",
                                   str(tmp_path / where / "dev"), *flags])
    names = sorted(p.relative_to(tmp_path / "card") for p in (tmp_path / "card").rglob("*")
                   if p.is_file())
    assert len(names) == 4 * 5
    for n in names:
        a, b = tmp_path / "card" / n, tmp_path / "cpu" / n
        if n.suffix == ".mgc":
            assert float(np.abs(np.load(a) - np.load(b)).max()) <= 1e-4, n
        else:
            assert a.read_bytes() == b.read_bytes(), n


# -- S1: one conv of an unfused serving stage ------------------------------------------------

S1_CASES = [(C, k, d) for C in (256, 128, 64) for k in (3, 7, 11) for d in (1, 3, 5)]


def _ulps(got, want, scale):
    """(max |got − want| in bf16 ulps of `scale`, the share of elements that differ)."""
    ulp = torch.exp2(torch.floor(torch.log2(scale.float().clamp_min(2.0 ** -126))) - 7)
    d = (got.float() - want.float()).abs()
    return (d / ulp).max().item(), (d > 0).float().mean().item()


def _check_s1(device, C, k, d, B, T):
    """S1 against its plain version (cuDNN, TF32 off) on seeded x, residual and sum of
    (B, T, C), in each epilogue: the first conv's (the leaky on its output), the
    residual's (its input activated already), the residual and the blocks' sum and mean.
    Within 2 bf16 ulps of the element's scale (the largest of the plain result, the
    conv's own output, the residual, the sum and the conv output's RMS), and at most 1 %
    of the elements differ (a sum that rounds the other way); the control, the plain
    version with fp32 storage (no rounding after the conv), differs in more. Two launches
    bit-equal; one launch counted per call."""
    from ttscube_tpu_torch.models.hifigan import LRELU_SLOPE
    from ttscube_tpu_torch.ops import stage_conv as sc

    g = torch.Generator().manual_seed(C + 10 * k + d + B)
    n = lambda scale, *s: (scale * torch.randn(*s, generator=g)).to(device)
    x, res, acc = (n(1.0, B, T, C).bfloat16() for _ in range(3))
    w, b = n((C * k) ** -0.5, C, C, k), n(0.1, C)
    plain = lambda x, **kw: sc.stage_conv_plain(x, w, b, dilation=d, slope=LRELU_SLOPE, **kw)
    conv = plain(x).float().abs()
    floor = conv.square().mean().sqrt()
    cw = sc.pack_conv(w, b)
    for kw in (dict(leaky_out=True), dict(residual=res, leaky_in=False),
               dict(residual=res, accum=acc, n_mean=3)):
        want = plain(x, **kw)
        ctl = plain(x.float(), **{key: v.float() if torch.is_tensor(v) else v
                                  for key, v in kw.items()})
        scale = torch.maximum(want.float().abs() * kw.get("n_mean", 1), conv).maximum(floor)
        for t in (res, acc) if "residual" in kw else ():
            scale = scale.maximum(t.float().abs())
        before = launches(sc.stage_conv)
        got = sc.stage_conv(x, cw, dilation=d, slope=LRELU_SLOPE, **kw)
        again = sc.stage_conv(x, cw, dilation=d, slope=LRELU_SLOPE, **kw)
        torch.cuda.synchronize()
        assert launches(sc.stage_conv) == before + 2
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        most, share = _ulps(got, want, scale)
        assert most <= 2 and share <= 0.01, (kw.keys(), most, share)
        assert _ulps(ctl, want, scale)[1] > 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("C,k,d", S1_CASES)
def test_stage_conv_kernel_matches_plain(cuda, C, k, d):
    """S1 against its plain version (`_check_s1`) at each (C, k, d) of v1's stages 0-2,
    B = 2, T = 700 (not a multiple of the 512-row tile)."""
    _check_s1(cuda, C, k, d, 2, 700)


@pytest.mark.gpu
@pytest.mark.parametrize("C,k,d", [(256, 11, 5), (128, 7, 3), (64, 3, 1)])
def test_stage_conv_kernel_walks_many_items(cuda, C, k, d):
    """S1 against its plain version (`_check_s1`) where each persistent block walks
    several (row tile, channel block) items: B = 96, T = 1,300 (two whole tiles and one
    of 276 rows) gives 288 · C / 64 items, 2 to 9 for each of the card's blocks, so the
    walk to the next item, its slab fetched ahead, the sums reset per item and the slab
    buffers alternating across items all run."""
    _check_s1(cuda, C, k, d, 96, 1300)


@pytest.mark.gpu
def test_serving_generator_runs_s1_on_the_unfused_stages(cuda, monkeypatch):
    """generator_apply_fused at bf16 storage, B = 2, with S1 on stages 0-2 (18 launches a
    stage) against the same path with stock convs there (S1's dispatch turned off). Each
    of the 54 convs rounds to bf16 where the stock path does, but sums in another order,
    and the chain turns those few flipped roundings into bf16 noise of its own: on the
    card S1's audio lies 0.8-0.95 of the floor (the stock path at bf16 against it at fp32
    storage) from the stock path's, and 0.86-1.06 of it from the fp32 audio. Both within
    1.25 of the floor, in max and RMS (the per-conv test above holds the rounding points).
    A training forward and backward (generator_apply_fused_train) launches no S1."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models import hifigan_fused
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
    from ttscube_tpu_torch.ops import stage_conv

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = init_random(Generator(HifiganConfig()), 0).to(cuda)
    cfg = gen.config
    mel = torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, 37, 80)).astype(np.float32)).to(cuda)
    apply = lambda st: hifigan_fused.generator_apply_fused(gen, mel, cfg, storage_dtype=st)
    with torch.no_grad():
        before = launches(stage_conv.stage_conv)
        got16 = apply(torch.bfloat16)
        assert launches(stage_conv.stage_conv) == before + 54
        with monkeypatch.context() as stock:
            stock.setattr(hifigan_fused, "takes", lambda *a: False)
            want16, want32 = apply(torch.bfloat16), apply(None)
    assert launches(stage_conv.stage_conv) == before + 54
    assert got16.shape == want16.shape == (2, 37 * 240)
    floor = _distance(want16, want32)
    assert floor[0] > 1e-4
    for d in (_distance(got16, want16), _distance(got16, want32)):
        assert d[0] <= 1.25 * floor[0] and d[1] <= 1.25 * floor[1], (d, floor)
    before = launches(stage_conv.stage_conv)
    hifigan_fused.generator_apply_fused_train(gen, mel, cfg).square().mean().backward()
    torch.cuda.synchronize()
    assert launches(stage_conv.stage_conv) == before
