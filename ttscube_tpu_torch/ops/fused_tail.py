"""A whole generator stage as one kernel: counterpart of
`ttscube_tpu/ops/pallas_resblock.py::fused_tail_stage`, in both of its forms.

    leaky(0.1) → ConvTranspose1d (kernel == stride == 4) → each MRF ResBlock1 chain
    → mean of the chains [→ leaky(0.01) → conv_post → tanh → audio]

- with_post=True, the generator's last stage (C = 32): kernel B1,
  `csrc/fused_tail_stage.cu`, through `fused_tail_stage(z, weights)` → audio
  (B, 4·T_in). `LIMITS` holds its limits.
- with_post=False, a middle stage (C = 64 in HiFi-GAN v1): kernel B1-mid, the
  upsample prologue and MRF phases of `csrc/fused_mrf_stage.cu` (the source of B3,
  `ops/fused_mrf.py`), through `fused_tail_stage_mid(z, weights)` → the stage's output
  (B, 4·T_in, C) fp32. `MID_LIMITS` holds its limits.

`pack_tail_weights` checks the weights once against the limits of their form (the form
follows from whether conv_post's weights are given) and lays them out for the kernel.
On a CUDA tensor each wrapper launches its kernel (and raises if it cannot), on a CPU
tensor it runs `fused_tail_stage_plain`, the same function in stock PyTorch ops. Both
follow the kernel's dtype rule: with bf16 compute every conv operand is rounded to
bf16 while products, sums, biases, residuals and the inter-conv activations stay fp32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.ops import _build, fused_mrf
from ttscube_tpu_torch.ops.fused_mrf import (chain_spec, check_chains, mrf_chains_plain,
                                             pack_convs, rounder)

KERNEL_SOURCE = "fused_tail_stage"
# the with_post=True form's tiling limits (csrc/fused_tail_stage.cu; checked against
# the library when it is loaded)
LIMITS = {"channels": 32, "fold": 4, "post_k": 7, "max_blocks": 4, "max_dils": 4,
          "max_halo": 61, "max_c_in": 128}
# the with_post=False form's limits (csrc/fused_mrf_stage.cu): those of B3's MRF
# phases, the upsample's fold, and input channels a multiple of the quantum up to
# `max_c_in`
MID_KERNEL_SOURCE = fused_mrf.KERNEL_SOURCE
MID_LIMITS = dict(fused_mrf.LIMITS, fold=4, max_c_in=512)


class TailWeights(NamedTuple):
    """Weights in the kernel's layouts: up [fold][C_in][C]; each conv [k][C_in][C_out],
    concatenated in chain order; biases [n_convs][C]; post [k_post][C] (None in the
    form without conv_post). With bf16 compute the conv weights are already rounded to
    bf16 (kept in fp32)."""

    wup: torch.Tensor
    bup: torch.Tensor
    wmrf: torch.Tensor
    bmrf: torch.Tensor
    wpost: torch.Tensor | None
    bpost: torch.Tensor | None
    kernel_sizes: tuple
    dilations: tuple
    compute_dtype: torch.dtype | None

    @property
    def with_post(self) -> bool:
        return self.wpost is not None

    @property
    def spec(self) -> list:
        """n_chains, then per chain k, n_dilations and the dilations padded to 4."""
        return chain_spec(self.kernel_sizes, self.dilations, LIMITS["max_dils"])


def pack_tail_weights(up_kernel, up_bias, kernels, biases, post_kernel=None, post_bias=None,
                      *, kernel_sizes, dilations, compute_dtype=None,
                      dtype=torch.float32) -> TailWeights:
    """Check the stage's weights against the kernel's limits and pack them, in `dtype`
    (the kernels take fp32; the plain version also runs in fp64, as an exact
    reference). Without `post_kernel` the stage is packed in the form without conv_post.

    up_kernel (C_in, C, 4) is PyTorch's ConvTranspose1d layout; kernels[i] (C, C, k) and
    post_kernel (1, C, 7) are Conv1d layouts; kernels run chain by chain, two convs
    (dilated, then d = 1) per dilation."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"fused_tail_stage: compute_dtype {compute_dtype} not supported")
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C_in, C, fold = up_kernel.shape
    if post_kernel is None:
        M = MID_LIMITS
        q = M["quantum"]
        if (fold != M["fold"] or C % q or not q <= C <= M["max_channels"] or C_in % q
                or not q <= C_in <= M["max_c_in"]):
            raise ValueError(f"fused_tail_stage (no conv_post): up_kernel "
                             f"{tuple(up_kernel.shape)} does not fit the kernel (C_in and C "
                             f"multiples of {q}, C_in ≤ {M['max_c_in']}, C ≤ "
                             f"{M['max_channels']}, kernel == stride == {M['fold']})")
        check_chains("fused_tail_stage (no conv_post)", kernels, biases, C, kernel_sizes,
                     dilations)
    else:
        if C != LIMITS["channels"] or fold != LIMITS["fold"] or C_in > LIMITS["max_c_in"]:
            raise ValueError(f"fused_tail_stage: up_kernel {tuple(up_kernel.shape)} does not "
                             f"fit the kernel (C_in ≤ {LIMITS['max_c_in']}, C = "
                             f"{LIMITS['channels']}, kernel == stride == {LIMITS['fold']})")
        if tuple(post_kernel.shape) != (1, C, LIMITS["post_k"]):
            raise ValueError(f"fused_tail_stage: post_kernel {tuple(post_kernel.shape)} must "
                             f"be (1, {C}, {LIMITS['post_k']})")
        if not 1 <= len(kernel_sizes) <= LIMITS["max_blocks"] or len(dilations) != len(kernel_sizes):
            raise ValueError(f"fused_tail_stage: 1 to {LIMITS['max_blocks']} resblock chains")
        for k, dils in zip(kernel_sizes, dilations):
            halo = sum((d + 1) * ((k - 1) // 2) for d in dils)
            if k % 2 != 1 or not 1 <= len(dils) <= LIMITS["max_dils"] or halo > LIMITS["max_halo"]:
                raise ValueError(f"fused_tail_stage: chain k={k} dilations={dils} exceeds the "
                                 f"kernel's halo ({LIMITS['max_halo']} samples) or dilation "
                                 "count")
        per_conv = fused_mrf.conv_sizes(kernel_sizes, dilations)
        if (len(kernels) != len(per_conv) or len(biases) != len(per_conv)
                or any(tuple(w.shape) != (C, C, k) for w, k in zip(kernels, per_conv))):
            raise ValueError("fused_tail_stage: kernels must be (C, C, k) for each conv of "
                             "each chain, in chain order")
    r = rounder(compute_dtype)
    cast = lambda t: t.to(dtype)  # differentiable: the plain VJP runs autograd through it
    wmrf, bmrf = pack_convs(kernels, biases, compute_dtype, dtype)
    return TailWeights(
        wup=r(cast(up_kernel)).permute(2, 0, 1).contiguous(),
        bup=cast(up_bias).contiguous(),
        wmrf=wmrf, bmrf=bmrf,
        wpost=None if post_kernel is None else r(cast(post_kernel))[0].t().contiguous(),
        bpost=None if post_kernel is None else cast(post_bias).reshape(1).contiguous(),
        kernel_sizes=kernel_sizes, dilations=dilations, compute_dtype=compute_dtype)


def fused_tail_stage_plain(z, w: TailWeights):
    """Stock-op version: z (B, T_in, C_in) → audio (B, 4·T_in), or in the form without
    conv_post the stage's output (B, 4·T_in, C); in the packed weights' dtype (fp32
    unless packed otherwise)."""
    r = rounder(w.compute_dtype)
    fold = w.wup.shape[0]
    x = F.leaky_relu(z.to(w.wup.dtype).transpose(1, 2), 0.1)
    x = F.conv_transpose1d(r(x), w.wup.permute(1, 2, 0), w.bup, stride=fold)
    y = mrf_chains_plain(x, w.wmrf, w.bmrf, w.kernel_sizes, w.dilations, w.compute_dtype)
    if not w.with_post:
        return y.transpose(1, 2)
    y = F.leaky_relu(y, 0.01)
    kp = w.wpost.shape[0]
    audio = F.conv1d(r(y), w.wpost.t()[None], w.bpost, padding=(kp - 1) // 2)
    return torch.tanh(audio)[:, 0, :]


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(KERNEL_SOURCE, "ttscube_fused_tail_stage",
                       [p, i, i, i, p, p, p, p, p, p, p, i, p, p], LIMITS)


def _check_stage_input(what: str, z, w: TailWeights, tensors) -> None:
    if (z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous()
            or z.shape[2] != w.wup.shape[1]):
        raise ValueError(f"{what}: z must be a contiguous fp32 (B, T_in, {w.wup.shape[1]}) "
                         f"tensor, got {z.dtype} {tuple(z.shape)}")
    if any(t.device != z.device or not t.is_contiguous() or t.dtype != torch.float32
           for t in tensors):
        raise ValueError(f"{what}: packed weights must be contiguous fp32 on the input's "
                         "device")


def fused_tail_stage(z, w: TailWeights):
    """Audio (B, 4·T_in) fp32 from the last stage's input z (B, T_in, C_in).

    CPU tensors take `fused_tail_stage_plain`; CUDA tensors launch the kernel on z's
    device (set around the launch; untested on a machine with more than one card) or
    raise. `fused_tail_stage.launches` counts kernel launches."""
    if not w.with_post:
        raise ValueError("fused_tail_stage: these weights have no conv_post; the stage "
                         "without it runs through fused_tail_stage_mid")
    if z.device.type == "cpu":
        return fused_tail_stage_plain(z, w)
    if z.device.type != "cuda":
        raise ValueError(f"fused_tail_stage: unsupported device {z.device}")
    tensors = (w.wup, w.bup, w.wmrf, w.bmrf, w.wpost, w.bpost)
    _check_stage_input("fused_tail_stage", z, w, tensors)
    lib = _lib()
    B, T_in, C_in = z.shape
    out = torch.empty(B, T_in * LIMITS["fold"], device=z.device, dtype=torch.float32)
    spec = w.spec
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    with torch.cuda.device(z.device):
        err = lib.ttscube_fused_tail_stage(
            z.data_ptr(), B, T_in, C_in, *[t.data_ptr() for t in tensors],
            ctypes.cast(spec_arr, ctypes.c_void_p), int(w.compute_dtype is not None),
            out.data_ptr(), torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_stage: kernel launch failed with CUDA error {err}")
    fused_tail_stage.launches += 1
    return out


fused_tail_stage.launches = 0


def _lib_mid():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(MID_KERNEL_SOURCE, "ttscube_fused_stage_mid",
                       [p, i, i, i, p, p, p, p, i, p, i, p, p, p, p], MID_LIMITS)


def fused_tail_stage_mid(z, w: TailWeights):
    """A middle stage's output (B, 4·T_in, C) fp32 from its input z (B, T_in, C_in),
    weights packed without conv_post.

    CPU tensors take `fused_tail_stage_plain`; CUDA tensors launch kernel B1-mid on z's
    device (set around the launch; untested on a machine with more than one card) or
    raise. `fused_tail_stage_mid.launches` counts kernel launches,
    `fused_tail_stage_mid.last_grid` holds the thread blocks of the last one."""
    if w.with_post:
        raise ValueError("fused_tail_stage_mid: these weights have conv_post; the last "
                         "stage runs through fused_tail_stage")
    if z.device.type == "cpu":
        return fused_tail_stage_plain(z, w)
    if z.device.type != "cuda":
        raise ValueError(f"fused_tail_stage_mid: unsupported device {z.device}")
    _check_stage_input("fused_tail_stage_mid", z, w, (w.wup, w.bup, w.wmrf, w.bmrf))
    B, T_in, C_in = z.shape
    fold, _, C = w.wup.shape
    out = torch.empty(B, fold * T_in, C, device=z.device, dtype=torch.float32)
    workspace = torch.empty((1 + 2 * len(w.kernel_sizes)) * out.numel(), device=z.device)
    spec = w.spec
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    grid = ctypes.c_int(0)
    lib = _lib_mid()
    with torch.cuda.device(z.device):
        err = lib.ttscube_fused_stage_mid(
            z.data_ptr(), B, T_in, C_in, w.wup.data_ptr(), w.bup.data_ptr(),
            w.wmrf.data_ptr(), w.bmrf.data_ptr(), C, ctypes.cast(spec_arr, ctypes.c_void_p),
            int(w.compute_dtype is not None), workspace.data_ptr(), out.data_ptr(),
            ctypes.addressof(grid), torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_stage_mid: kernel launch failed with CUDA error {err}")
    fused_tail_stage_mid.launches += 1
    fused_tail_stage_mid.last_grid = grid.value
    return out


fused_tail_stage_mid.launches = 0
fused_tail_stage_mid.last_grid = 0


def tail_flops(batch: int, t_in: int, c_in: int, kernel_sizes, dilations,
               channels: int = LIMITS["channels"], with_post: bool = True) -> int:
    """Operations (2 per multiply-add) the stage needs for this input: upsample, every
    MRF conv and (with_post) conv_post, per output sample, times the output samples."""
    C = channels
    per_sample = c_in * C                                                    # upsample
    per_sample += sum(2 * len(d) * k * C * C for k, d in zip(kernel_sizes, dilations))
    per_sample += LIMITS["post_k"] * C if with_post else 0                   # conv_post
    return 2 * per_sample * batch * t_in * LIMITS["fold"]


# -- the backward: kernel B2 -----------------------------------------------------------

GRAD_KERNEL_SOURCE = "fused_tail_stage_grad"
GRAD_LIMITS = dict(LIMITS, tile=256, halo=64, margin=32)
# thread blocks of the backward kernel: one per SM of an H100. Each walks a fixed list
# of tiles and keeps its own weight-grad partial, so the grads' summation order, and so
# their bits, depend on this number and never on scheduling.
GRAD_BLOCKS = 132


def _lib_grad():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(GRAD_KERNEL_SOURCE, "ttscube_fused_tail_stage_grad",
                       [p, i, i, i] + [p] * 9 + [i, p, p, ctypes.c_longlong, p, p],
                       GRAD_LIMITS)


def _flip_transpose_mrf(w: TailWeights):
    """Each packed MRF kernel [k][c_in][c_out] as [k][c_out][c_in] with the taps
    reversed: the kernel of the conv that pulls a cotangent back through it."""
    C = LIMITS["channels"]
    out, off = [], 0
    for k in fused_mrf.conv_sizes(w.kernel_sizes, w.dilations):
        out.append(w.wmrf[off: off + k * C * C].view(k, C, C).flip(0).transpose(1, 2)
                   .reshape(-1))
        off += k * C * C
    return torch.cat(out)


def fused_tail_stage_grad(z, w: TailWeights, dy):
    """The VJP of `fused_tail_stage` (fp32): from z (B, T_in, C_in) and the audio's
    cotangent dy (B, 4·T_in), (dz, d wup, d bup, d wmrf, d bmrf, d wpost, d bpost), the
    weight grads in the packed layouts of `TailWeights`.

    It launches the kernel `csrc/fused_tail_stage_grad.cu` on z's device (set around the
    launch; untested on a machine with more than one card) and raises for anything
    else: CPU tensors take autograd through `fused_tail_stage_plain`
    (`FusedTailStageGrad.backward`). The sum of the blocks' grad partials and the
    overlap-add of the tiles' halo rows into dz are torch ops in a fixed order.
    `fused_tail_stage_grad.launches` counts kernel launches."""
    if z.device.type != "cuda":
        raise ValueError(f"fused_tail_stage_grad: the kernel runs on CUDA tensors, got {z.device}")
    if w.compute_dtype is not None or not w.with_post:
        raise ValueError("fused_tail_stage_grad: fp32 weights with conv_post only (bf16 "
                         "training waits)")
    B, T_in, C_in = z.shape if z.dim() == 3 else (0, 0, 0)
    fold = LIMITS["fold"]
    if (z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous()
            or C_in != w.wup.shape[1]):
        raise ValueError("fused_tail_stage_grad: z must be a contiguous fp32 (B, T_in, "
                         f"{w.wup.shape[1]}) tensor, got {z.dtype} {tuple(z.shape)}")
    if (dy.dtype != torch.float32 or tuple(dy.shape) != (B, fold * T_in)
            or not dy.is_contiguous() or dy.device != z.device):
        raise ValueError(f"fused_tail_stage_grad: dy must be a contiguous fp32 ({B}, "
                         f"{fold * T_in}) tensor on z's device, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    tensors = (w.wup, w.bup, w.wmrf, w.bmrf, w.wpost, w.bpost)
    if any(t.device != z.device or not t.is_contiguous() or t.dtype != torch.float32
           for t in tensors):
        raise ValueError("fused_tail_stage_grad: packed weights must be contiguous fp32 "
                         "on the input's device")
    lib = _lib_grad()
    G = GRAD_LIMITS
    C, tile, slab = G["channels"], G["tile"], G["tile"] + 2 * G["halo"]
    zrows, core, lo = slab // fold, tile // fold, G["halo"] // fold
    n_tiles = -(-fold * T_in // tile)
    n_blocks = min(GRAD_BLOCKS, B * n_tiles)
    n_convs = w.bmrf.shape[0]
    sizes = [t.numel() for t in tensors]
    wt = _flip_transpose_mrf(w)
    dev = z.device
    workspace = torch.empty(n_blocks * (n_convs + 1) * slab * C, device=dev)
    stride = -(-sum(sizes) // 4) * 4  # each block's partial 16-byte aligned
    partials = torch.zeros(n_blocks, stride, device=dev)
    dzs = torch.empty(B, n_tiles, zrows, C_in, device=dev)
    spec = w.spec
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    with torch.cuda.device(dev):
        err = lib.ttscube_fused_tail_stage_grad(
            z.data_ptr(), B, T_in, C_in, dy.data_ptr(), w.wup.data_ptr(), w.bup.data_ptr(),
            w.wmrf.data_ptr(), wt.data_ptr(), w.bmrf.data_ptr(), w.wpost.data_ptr(),
            w.bpost.data_ptr(), ctypes.cast(spec_arr, ctypes.c_void_p), n_blocks,
            workspace.data_ptr(), partials.data_ptr(), stride, dzs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_stage_grad: kernel launch failed with CUDA error {err}")
    fused_tail_stage_grad.launches += 1
    grads = [g.view_as(t) for g, t in
             zip(partials.sum(0)[: sum(sizes)].split(sizes), tensors)]
    # tile i holds the cotangent of z rows [core·i − lo, core·i + core + lo): its core
    # rows, plus its halo rows overlapping the neighbouring tiles' cores
    dz = dzs[:, :, lo: lo + core].clone()
    dz[:, :-1, core - lo:] += dzs[:, 1:, :lo]
    dz[:, 1:, :lo] += dzs[:, :-1, lo + core:]
    dz = dz.reshape(B, n_tiles * core, C_in)[:, :T_in]
    return (dz, *grads)


fused_tail_stage_grad.launches = 0


class FusedTailStageGrad(torch.autograd.Function):
    """The stage (fp32, with conv_post) as an autograd Function: forward through
    kernel B1, backward through kernel B2. It takes the stage's weights in PyTorch's
    layouts (ConvTranspose1d (C_in, C, 4), Conv1d (C, C, k) and (1, C, 7)), already
    weight-normed and carrying their graph, packs them in every call (they change every
    step) and hands the grads back in the same layouts. It saves z and the weights, no
    activation: B2 recomputes them.

    On CPU tensors the forward is the plain version and the backward autograd through
    it; on CUDA tensors the kernels run or the call raises."""

    @staticmethod
    def forward(ctx, kernel_sizes, dilations, z, up_kernel, up_bias, post_kernel,
                post_bias, *kernels_biases):
        n = len(kernels_biases) // 2
        kernels, biases = kernels_biases[:n], kernels_biases[n:]
        w = pack_tail_weights(up_kernel, up_bias, kernels, biases, post_kernel, post_bias,
                              kernel_sizes=kernel_sizes, dilations=dilations)
        ctx.spec = (kernel_sizes, dilations)
        ctx.packed = w
        ctx.save_for_backward(z, up_kernel, up_bias, post_kernel, post_bias,
                              *kernels_biases)
        return fused_tail_stage(z.contiguous(), w)

    @staticmethod
    def backward(ctx, daudio):
        z, up_kernel, up_bias, post_kernel, post_bias, *kb = ctx.saved_tensors
        n = len(kb) // 2
        if z.device.type == "cpu":
            leaves = [t.detach().requires_grad_() for t in
                      (z, up_kernel, up_bias, post_kernel, post_bias, *kb)]
            with torch.enable_grad():
                lz, lup, lub, lpk, lpb, *lkb = leaves
                w = pack_tail_weights(lup, lub, lkb[:n], lkb[n:], lpk, lpb,
                                      kernel_sizes=ctx.spec[0], dilations=ctx.spec[1])
                out = fused_tail_stage_plain(lz, w)
            grads = torch.autograd.grad(out, leaves, daudio)
            return (None, None, *grads)
        dz, dwup, dbup, dwmrf, dbmrf, dwpost, dbpost = fused_tail_stage_grad(
            z.contiguous(), ctx.packed, daudio.contiguous())
        C = LIMITS["channels"]
        d_kernels, off = [], 0
        for k in fused_mrf.conv_sizes(ctx.packed.kernel_sizes, ctx.packed.dilations):
            d_kernels.append(dwmrf[off: off + k * C * C].view(k, C, C).permute(2, 1, 0))
            off += k * C * C
        return (None, None, dz, dwup.permute(1, 2, 0), dbup, dwpost.t()[None],
                dbpost.view_as(post_bias), *d_kernels, *dbmrf.unbind(0))


def fused_tail_stage_train(z, up_kernel, up_bias, kernels, biases, post_kernel, post_bias,
                           *, kernel_sizes, dilations):
    """Audio (B, 4·T_in) of the stage, differentiable in z and every weight, through
    `FusedTailStageGrad`."""
    return FusedTailStageGrad.apply(
        tuple(kernel_sizes), tuple(tuple(d) for d in dilations), z, up_kernel, up_bias,
        post_kernel, post_bias, *kernels, *biases)


def tail_grad_flops(batch: int, t_in: int, c_in: int, kernel_sizes, dilations) -> int:
    """Operations of the stage's VJP for this input: the forward recomputed, then for
    every conv (upsample, MRF, conv_post) its input's cotangent and its weight grad,
    each as many multiply-adds as the conv itself; so 3 × `tail_flops`."""
    return 3 * tail_flops(batch, t_in, c_in, kernel_sizes, dilations)
