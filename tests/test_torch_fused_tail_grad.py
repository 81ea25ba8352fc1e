"""The VJP of the port's fused tail stage (`FusedTailStageGrad`; on the CPU autograd
through its plain version) and the training generator
(`models/hifigan_fused.generator_apply_fused_train`) against JAX autodiff, on the CPU,
at the JAX package's grad tolerance rtol = atol = 2e-4 (tests/test_pallas_resblock.py).
The CUDA kernel B2 itself is held against the plain VJP in tests/test_torch_gpu.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.models.hifigan_fused import _plain_resblock1, generator_apply_fused_train
from ttscube_tpu.ops.conv import _conv, _conv_transpose
from ttscube_tpu_torch.convert import jax_to_state_dict
from ttscube_tpu_torch.models import hifigan_fused as thf
from ttscube_tpu_torch.ops import fused_tail
from tests.torch_parity import (assert_close, exact_cpu_convs, gen_pair,  # noqa: F401
                                one_cpu_thread, t)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

V1 = ((3, 7, 11), ((1, 3, 5),) * 3)
# the chains of tests/test_pallas_resblock.py::test_fused_tail_stage_grad_matches_xla
PALLAS_TEST = ((3, 7), ((1, 3), (1, 3, 5)))
C_IN, C, FOLD = 64, 32, 4


def _case(B, T_in, ks, dils, seed):
    """z, the cotangent and the weights in JAX layouts (numpy)."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return dict(z=n(1.0, B, T_in, C_IN), cot=n(1.0, B, FOLD * T_in),
                up=n(0.2 / np.sqrt(C_IN), FOLD, C, C_IN), up_b=n(0.1, C),
                kernels=[n(0.5 / np.sqrt(k * C), k, C, C)
                         for k, d in zip(ks, dils) for _ in range(2 * len(d))],
                biases=[n(0.1, C) for k, d in zip(ks, dils) for _ in range(2 * len(d))],
                post=n(0.3, 7, C, 1), post_b=np.asarray([0.05], np.float32))


def _jax_grads(c, ks, dils):
    """JAX autodiff of the plain op chain (the `ref_loss` of the JAX package's test)."""
    def ref_loss(z, up_kernel, up_bias, kernels, biases, post_kernel, post_bias):
        x = _conv_transpose(jax.nn.leaky_relu(z, 0.1), up_kernel, FOLD, 0) + up_bias
        acc, i = None, 0
        for j in range(len(ks)):
            n = 2 * len(dils[j])
            h = _plain_resblock1(x, kernels[i:i + n], biases[i:i + n], dils[j])
            acc = h if acc is None else acc + h
            i += n
        y = jax.nn.leaky_relu(acc / len(ks), 0.01)
        audio = jnp.tanh(_conv(y, post_kernel, 1, 3, 1, 1) + post_bias)[..., 0]
        return jnp.sum(audio * c["cot"])

    args = (c["z"], c["up"], c["up_b"], c["kernels"], c["biases"], c["post"], c["post_b"])
    return jax.grad(ref_loss, tuple(range(7)))(*args)


def _port_grads(c, ks, dils):
    """Grads through FusedTailStageGrad, in the JAX layouts."""
    tr = lambda a: t(np.ascontiguousarray(np.transpose(a, (2, 1, 0)))).requires_grad_()
    leaves = dict(z=t(c["z"]).requires_grad_(), up=tr(c["up"]),
                  up_b=t(c["up_b"]).requires_grad_(),
                  kernels=[tr(w) for w in c["kernels"]],
                  biases=[t(b).requires_grad_() for b in c["biases"]],
                  post=tr(c["post"]), post_b=t(c["post_b"]).requires_grad_())
    audio = fused_tail.fused_tail_stage_train(
        leaves["z"], leaves["up"], leaves["up_b"], leaves["kernels"], leaves["biases"],
        leaves["post"], leaves["post_b"], kernel_sizes=ks, dilations=dils)
    (audio * t(c["cot"])).sum().backward()
    back = lambda p: np.transpose(p.grad.numpy(), (2, 1, 0))
    return (leaves["z"].grad.numpy(), back(leaves["up"]), leaves["up_b"].grad.numpy(),
            [back(w) for w in leaves["kernels"]], [b.grad.numpy() for b in leaves["biases"]],
            back(leaves["post"]), leaves["post_b"].grad.numpy())


def _compare(piece, got, want):
    flat_g, flat_w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    worst = 0.0
    for i, (a, b) in enumerate(zip(flat_g, flat_w)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=f"{piece} leaf {i}")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"\nparity {piece}: max_abs_diff={worst:.3e} tol=2e-4 (rtol 2e-4)")


@pytest.mark.parametrize("B,T_in,chains", [(2, 300, PALLAS_TEST), (1, 200, V1)])
def test_tail_vjp_matches_jax_autodiff(B, T_in, chains):
    c = _case(B, T_in, *chains, seed=T_in)
    _compare(f"tail VJP B={B} T_in={T_in} chains={chains[0]}",
             _port_grads(c, *chains), _jax_grads(c, *chains))


def test_fused_train_generator_matches_jax():
    """Value and grads of every v, g and bias of the full-width generator (the shapes of
    tests/test_pallas_resblock.py::test_fused_train_generator_grad_matches_flax): the
    port's generator_apply_fused_train (the fused Function on its last stage) against
    JAX's generator_apply_fused_train (plain XLA off the TPU)."""
    hifi = dict(resblock_kernel_sizes=(3, 11), resblock_dilation_sizes=((1, 3), (1, 3, 5)))
    jcfg, _, params, tg = gen_pair(hifi, seed=8)
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((2, 6, 80)).astype(np.float32)
    cot = rng.standard_normal((2, 6 * jcfg.total_upsample)).astype(np.float32)

    def loss(p):
        return jnp.sum(generator_apply_fused_train(p, jnp.asarray(mel), jcfg) * cot)

    want_l, want_g = jax.value_and_grad(loss)(params)
    audio = thf.generator_apply_fused_train(tg, t(mel), tg.config)
    got_l = (audio * t(cot)).sum()
    got_l.backward()
    assert abs(got_l.item() - float(want_l)) <= 1e-5 * abs(float(want_l))
    want_sd = jax_to_state_dict(tg, jax.tree_util.tree_map(np.asarray, want_g))
    worst = 0.0
    for name, p in tg.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
        worst = max(worst, float((p.grad - want_sd[name]).abs().max()))
    print(f"\nparity generator_apply_fused_train grads: max_abs_diff={worst:.3e} tol=2e-4")


def test_tail_grad_flops_counts_the_v1_stage():
    """Recompute + input cotangents + weight grads: 3 × 262,592 = 787,776 FLOP per output
    sample; 151.3 GFLOP for B = 16 windows of 12,000 samples."""
    assert fused_tail.tail_grad_flops(1, 1, C_IN, *V1) == 4 * 787_776
    assert fused_tail.tail_grad_flops(16, 3000, C_IN, *V1) == 16 * 12_000 * 787_776


@pytest.mark.parametrize("chains,n_convs", [(V1, 18), (PALLAS_TEST, 10)])
def test_grad_workspace_holds_every_saved_slab(chains, n_convs):
    """B2's workspace for one thread block: a slab of 256 + 2·64 samples × 32 channels
    for each conv's saved input, one for the upsample's output and one for its
    cotangent, and the chain sum over the 262 rows conv_post reads. At v1 (18 convs)
    that is 254,144 floats, 134.2 MB for 132 blocks."""
    assert sum(2 * len(d) for d in chains[1]) == n_convs
    floats = fused_tail.grad_workspace_floats(n_convs)
    assert floats == (n_convs + 2) * 384 * 32 + 262 * 32
    assert floats % 4 == 0  # each block's workspace starts on a 16-byte boundary
    if n_convs == 18:
        assert floats == 254_144 and round(132 * floats * 4 / 1e6, 1) == 134.2


@pytest.mark.parametrize("chains,want", [
    # one chain of 1 tap: every pass covers the 262 rows conv_post reads, 17 items of
    # 16 rows x 2 halves x 1 tap x 4 steps x 2 n-tiles x 3 products; a weight grad 4
    # tiles x 33 steps of 8 rows x 6
    (((1,), ((1,),)), dict.fromkeys(("forward conv_d", "forward conv_1",
                                     "conv_1 input cotangent", "conv_d input cotangent"),
                                    816) | {"weight grads": 2 * 792}),
    (V1, {"forward conv_d": 59_520, "forward conv_1": 58_992, "weight grads": 116_928,
          "conv_1 input cotangent": 59_520, "conv_d input cotangent": 64_176}),
])
def test_grad_mma_counts(chains, want):
    """The mma.sync instructions of one B2 tile by phase, which chip_smoke.py divides
    the phases' clocks by; at v1 359,136, 3.65 x the counted operations (3 products for
    each, and the rows of the halo each conv still needs)."""
    got = fused_tail.tail_grad_mma_counts(*chains)
    assert got == want
    assert set(got) <= set(fused_tail.GRAD_PHASES)
    if chains == V1:
        per_tile = fused_tail.tail_grad_flops(1, 64, C_IN, *V1)  # one tile: 256 samples
        assert round(sum(got.values()) * 2 * 16 * 8 * 8 / per_tile, 2) == 3.65


def test_grad_wrapper_runs_only_on_the_card():
    c = _case(1, 16, *V1, seed=1)
    tr = lambda a: t(np.ascontiguousarray(np.transpose(a, (2, 1, 0))))
    w = fused_tail.pack_tail_weights(tr(c["up"]), t(c["up_b"]), [tr(k) for k in c["kernels"]],
                                     [t(b) for b in c["biases"]], tr(c["post"]),
                                     t(c["post_b"]), kernel_sizes=V1[0], dilations=V1[1])
    with pytest.raises(ValueError, match="CUDA"):
        fused_tail.fused_tail_stage_grad(t(c["z"]), w, t(c["cot"]))


@pytest.mark.slow
def test_tail_vjp_matches_pallas_interpret():
    """The port's VJP against the JAX package's fused_tail_stage_grad, whose backward
    is the Pallas kernel `_tail_bwd_kernel` run in interpret mode (minutes of XLA:CPU
    compile)."""
    from ttscube_tpu.ops.pallas_resblock import fused_tail_stage_grad

    ks, dils = PALLAS_TEST
    c = _case(2, 300, ks, dils, seed=11)

    def loss(z, up_kernel, up_bias, kernels, biases, post_kernel, post_bias):
        audio = fused_tail_stage_grad(
            z, up_kernel, up_bias, kernels, biases, kernel_sizes=ks, dilations=dils,
            fold=FOLD, post_kernel=post_kernel, post_bias=post_bias, with_post=True,
            rows_per_tile=128, bwd_rows_per_tile=128, interpret=True)
        return jnp.sum(audio * c["cot"])

    args = (c["z"], c["up"], c["up_b"], c["kernels"], c["biases"], c["post"], c["post_b"])
    want = jax.grad(loss, tuple(range(7)))(*args)
    _compare("tail VJP vs Pallas interpret", _port_grads(c, ks, dils), want)
