"""Pieces of the port's GAN training step against the JAX package on the CPU, and
torch twins of tests/test_cubegan.py's sequencing, partition and gate tests.

  * d_loss and gt_losses from fixed forward outputs: losses at 1e-5 relative, grads at
    rtol = atol = 2e-4, the spectral u written by d_loss at 1e-5;
  * AdamW with the inverse-decay schedule against optax's adamw over two steps, and
    the optimizer partitions against JAX's `partition_labels`;
  * val_step against JAX's val_step (metrics at 1e-5 relative);
  * the parameter and spectral trees of a JAX TrainState through the port and back,
    bit-exact."""

import copy
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu_torch.convert import jax_to_state_dict, spectral_to_jax, state_dict_to_jax
from ttscube_tpu_torch.models import cubegan as tcg
from tests.torch_parity import (TINY_HIFI, exact_cpu_convs, one_cpu_thread,  # noqa: F401
                                jax_crop_starts, toy_train_batch, train_pair)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")


@pytest.fixture(scope="module")
def tiny():
    batch = toy_train_batch()
    jm, jstate, tm = train_pair(TINY_HIFI, batch, seed=3)
    return batch, jm, jstate, tm


def _outputs(batch, seed):
    """Fixed forward outputs (dur_logits, pitch, vuv, ŷ) and a real window y_w."""
    rng = np.random.default_rng(seed)
    B, N = batch["x_char"].shape
    F = batch["y_pitch"].shape[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    sig = lambda *s: (1 / (1 + np.exp(-f(*s)))).astype(np.float32)
    return (f(B, N, 101), sig(B, F), sig(B, F), 0.3 * f(B, 12000)), 0.3 * f(B, 12000)


def test_d_loss_and_gt_losses_match_jax(tiny):
    batch, jm, jstate, tm = tiny
    tm = copy.deepcopy(tm)
    outs, y_w = _outputs(batch, seed=4)
    params = jstate.params
    pd = {"mpd": params["mpd"], "msd": params["msd"]}

    def jax_side(pd, outs):
        (ld, spec), gd = jax.value_and_grad(
            lambda p: jm.d_loss(p, jstate.spectral, y_w, outs[3], True), has_aux=True)(pd)
        (lgt, met), go = jax.value_and_grad(
            lambda o: jm.gt_losses(pd, spec, batch, o, y_w), has_aux=True)(outs)
        return ld, spec, gd, lgt, met, go

    ld, spec, gd, lgt, met, go = jax.jit(jax_side)(pd, outs)

    tb = tcg.batch_to_torch(batch, "cpu")
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    t_ld = tm.d_loss(torch.from_numpy(y_w), touts[3].detach(), update_spectral=True)
    t_ld.backward()
    t_lgt, t_met = tm.gt_losses(tb, touts, torch.from_numpy(y_w))
    d_grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}
    t_lgt.backward()
    for name, got, want in [("d_loss", t_ld, ld), ("gt loss", t_lgt, lgt)] + [
            (k, t_met[k], met[k]) for k in met]:
        want = float(want)
        print(f"\nparity {name}: rel_diff={abs(got.item() - want) / abs(want):.3e} tol=1e-05")
        assert abs(got.item() - want) <= 1e-5 * abs(want), name
    # D grads come from d_loss alone (gt_losses adds none); output grads from gt_losses
    want_d = jax_to_state_dict(tm, dict(jax.tree_util.tree_map(np.asarray, gd),
                                        lang=state_dict_to_jax(tm.lang),
                                        gen=state_dict_to_jax(tm.gen)))
    assert set(d_grads) == {n for n, _ in tm.named_parameters()
                            if n.startswith(("mpd.", "msd."))}
    for n, p in tm.named_parameters():
        if n.startswith(("mpd.", "msd.")):
            assert torch.equal(p.grad, d_grads[n]), n
            np.testing.assert_allclose(p.grad.numpy(), want_d[n].numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=n)
    for i, (o, w) in enumerate(zip(touts, go)):
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=f"output {i}")
    worst_u = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(spectral_to_jax(tm)["msd"]),
        jax.tree_util.tree_leaves(spec)))
    assert worst_u <= 1e-5


def test_adamw_schedule_matches_optax():
    """Two steps: torch AdamW at lr/(1 + lr_decay·step) set before each step (the
    port's `_step`) against optax.adamw with the same schedule (count from 0)."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((3, 7)).astype(np.float32)
    grads = [rng.standard_normal((3, 7)).astype(np.float32) for _ in range(2)]
    lr, decay = 2e-4, 1e-5
    tx = optax.adamw(learning_rate=lambda c: lr / (1.0 + decay * c), b1=0.8, b2=0.99,
                     weight_decay=0.01)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([tp], lr=lr, betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01)
    for step, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        opt.param_groups[0]["lr"] = lr / (1.0 + decay * step)
        tp.grad = torch.from_numpy(g)
        opt.step()
        # two float32 steps at |p| < 2; a missing weight decay would be 10× that
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=0, atol=2.5e-7)


def test_partitions_match_jax(tiny):
    _, _, jstate, tm = tiny
    jl = jax_to_state_dict(tm, jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, "gdtb".index(lab), np.float32),
        jcg.partition_labels(jstate.params), jstate.params))
    labels = tcg.partition_labels(tm)
    for n, p in tm.named_parameters():
        if not p.requires_grad:
            assert ".bias_hh_" in n  # the LSTMs' pinned zero second bias
            continue
        assert "gdtb"[int(jl[n].reshape(-1)[0])] == labels[n], n
    assert {part for part in labels.values()} == {"g", "d", "t"}
    assert set(tcg.make_optimizer(tm)) == {"g", "d", "t"}  # b is empty without an LM


def test_trainstate_round_trip(tiny):
    """JAX params + spectral → port (parameters and u buffers) → JAX, bit-exact."""
    _, _, jstate, tm = tiny
    back = state_dict_to_jax(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    spec = spectral_to_jax(tm)["msd"]
    for a, b in zip(jax.tree_util.tree_leaves(spec),
                    jax.tree_util.tree_leaves(jstate.spectral)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_d_then_g_sequencing(tiny):
    """Twin of tests/test_cubegan.py::test_d_then_g_sequencing: train_step equals a
    manual composition in which D steps first and G's losses see the updated D (and
    the u D's pass wrote), and differs from the Jacobi variant (G against the D from
    before the step)."""
    batch, _, _, tm0 = tiny
    tb = tcg.batch_to_torch(batch, "cpu")
    starts = torch.tensor([3, 1])
    ref = tcg.create_train_state(copy.deepcopy(tm0))
    tcg.train_step(ref, tb, starts=starts)

    def manual(jacobi: bool):
        st = tcg.create_train_state(copy.deepcopy(tm0))
        m = st.model
        d_before = copy.deepcopy((m.mpd, m.msd))
        outs, y_w = m.gan_forward(tb, tcg.TRAIN_FRAMES, starts)
        m.d_loss(y_w, outs[3].detach(), update_spectral=True).backward()
        tcg._step(st, "d")
        if jacobi:  # G's losses against the pre-step D weights (same u)
            u = {n: b.clone() for n, b in m.named_buffers()}
            m.mpd, m.msd = copy.deepcopy(d_before)
            for n, b in m.named_buffers():
                b.copy_(u[n])
        m.gt_losses(tb, outs, y_w)[0].backward()
        tcg._step(st, "gtb")
        return m

    seq, jac = manual(False), manual(True)
    ref_p = dict(ref.model.named_parameters())
    for n, p in seq.named_parameters():
        torch.testing.assert_close(p, ref_p[n], rtol=0, atol=2e-5, msg=n)
    diffs = [float((p - ref_p[n]).abs().max()) for n, p in jac.named_parameters()
             if n.startswith("gen.")]
    assert max(diffs) > 0, "G grads insensitive to the D update: the test is vacuous"


def test_gradient_partition_isolation(tiny):
    """Twin of tests/test_cubegan.py::test_gradient_partition_isolation: D takes only
    the disc loss's grads; the disc loss sends nothing into the generator; tower_t
    takes only the text losses' grads; the text losses do not touch tower_g; the
    generator does get grads from the total."""
    batch, _, _, tm = tiny
    tm = copy.deepcopy(tm)
    tb = tcg.batch_to_torch(batch, "cpu")
    params = dict(tm.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]

    def grads(term):
        total, metrics = tm.losses(tb, 50, update_spectral=False, starts=torch.tensor([2, 0]))
        out = total if term is None else metrics[term]
        g = torch.autograd.grad(out, [params[n] for n in names], allow_unused=True)
        return {n: torch.zeros_like(params[n]) if x is None else x for n, x in zip(names, g)}

    g_total, g_d, g_t = grads(None), grads("loss_d"), grads("loss_t")
    for n in names:
        if n.startswith(("mpd.", "msd.")):
            torch.testing.assert_close(g_total[n], g_d[n], rtol=0, atol=1e-6)
        if n.startswith("gen."):
            assert float(g_d[n].abs().max()) == 0, n
        if n.startswith("lang.tower_t."):
            torch.testing.assert_close(g_total[n], g_t[n], rtol=0, atol=1e-6)
        if n.startswith("lang.tower_g."):
            assert float(g_t[n].abs().max()) == 0, n
    assert any(float(g_total[n].abs().max()) > 0 for n in names if n.startswith("gen."))


def _gated(tm, **hifi):
    import dataclasses

    m = copy.deepcopy(tm)
    m.config = dataclasses.replace(m.config, hifigan=dataclasses.replace(
        m.config.hifigan, fused_tail_train=True, **hifi))
    return m


def test_fused_train_has_no_batch_cap(tiny, monkeypatch):
    """Above fused_train_max_batch the JAX package runs the plain generator
    (tests/test_cubegan.py::test_fused_train_batch_gate_falls_back_with_warning); that
    cap was set on the TPU. The port's fused path has none, since B2's blocks walk the
    tiles of all B windows: at B = 17 the step goes through generator_apply_fused_train
    (which `Generator.fused_train` calls) and gives the plain generator's audio."""
    from ttscube_tpu_torch.models import hifigan_fused

    _, _, _, tm = tiny
    tb = tcg.batch_to_torch(toy_train_batch(B=17, seed=5), "cpu")
    starts = torch.arange(17) % 5
    calls, fused_apply = [], hifigan_fused.generator_apply_fused_train
    monkeypatch.setattr(hifigan_fused, "generator_apply_fused_train",
                        lambda gen, cond, h: calls.append(cond.shape[0]) or
                        fused_apply(gen, cond, h))
    with torch.no_grad():
        fused, y_w = _gated(tm).gan_forward(tb, 50, starts)
        plain, y_w2 = tm.gan_forward(tb, 50, starts)
    assert calls == [17]
    torch.testing.assert_close(fused[3], plain[3], rtol=0, atol=1e-6)
    assert torch.equal(y_w, y_w2)


def test_fused_train_bf16_refuses(tiny):
    """With compute_dtype bfloat16 the JAX package warns and trains the plain bf16
    generator (tests/test_cubegan.py::test_fused_tail_train_bf16_falls_back_with_warning).
    The fused tail's backward (B2) has no bf16 form, and on the card the port may not
    fall back to the plain path, so fused_tail_train with bf16 raises, naming the flag
    to drop, in the step and when the training model is built. bf16 without the fused
    tail, and a bf16 discriminator, train (tests/test_torch_bf16_train.py)."""
    batch, _, _, tm = tiny
    tb = tcg.batch_to_torch(batch, "cpu")
    with pytest.raises(ValueError, match="--fused-tail-train"):
        _gated(tm, compute_dtype="bfloat16").gan_forward(tb, 50, torch.tensor([0, 0]))
    cfg = tcg.CubeganConfig(languasito=tm.config.languasito, disc_compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="B2"):
        tcg.Cubegan(dataclasses.replace(cfg, hifigan=tcg.HifiganConfig(
            compute_dtype="bfloat16", fused_tail_train=True)), train=True)
    m = tcg.Cubegan(cfg, train=True)
    assert m.msd.s0.conv_0.compute_dtype == m.mpd.p2.conv_post.compute_dtype == torch.bfloat16


def test_val_step_matches_jax(tiny):
    """JAX val_step on the toy batch padded to 210 frames (200-frame window), against
    the port's at the same window starts; no spectral u is written."""
    batch, jm, jstate, tm = tiny
    pad = 210 - batch["y_pitch"].shape[1]
    b = dict(batch)
    b["y_frame2phone"] = np.pad(batch["y_frame2phone"], ((0, 0), (0, pad)), mode="edge")
    b["y_frame_mask"] = np.pad(batch["y_frame_mask"], ((0, 0), (0, pad)))
    b["y_pitch"] = np.pad(batch["y_pitch"], ((0, 0), (0, pad)))
    b["y_audio"] = np.pad(batch["y_audio"], ((0, 0), (0, pad * 240)))
    rng = jax.random.PRNGKey(0)
    want = jax.jit(lambda s, x, r: jcg.val_step(jm, s, x, r))(jstate, b, rng)
    starts = jax_crop_starts(b["n_frames"], 200, rng)
    st = tcg.create_train_state(copy.deepcopy(tm))
    u = [x.clone() for x in st.model.buffers()]
    got = tcg.val_step(st, tcg.batch_to_torch(b, "cpu"), starts=torch.from_numpy(starts))
    assert all(torch.equal(a, x) for a, x in zip(u, st.model.buffers()))
    for k, v in want.items():
        w = float(v)
        print(f"\nparity val_step {k}: rel_diff={abs(got[k].item() - w) / abs(w):.3e} tol=1e-05")
        assert abs(got[k].item() - w) <= 1e-5 * abs(w), k
