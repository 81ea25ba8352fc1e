"""A whole MRF stage of the HiFi-GAN generator as one kernel (B3): counterpart of
`ttscube_tpu/ops/pallas_resblock.py::fused_mrf1`.

    for each ResBlock1 chain j (kernel k_j, dilations d...):
        x_j = x;  per dilation d:  x_j += conv_1(leaky(conv_d(leaky(x_j))))
    out = mean over the chains of x_j

All convs are 'same' C → C convs with zero padding (positions outside [0, T) read as
zero, as the TPU kernel's mask after every conv gives). `pack_mrf_weights` checks the
stage against the kernel's limits and packs its weights once; `fused_mrf1(x, weights)`
is the wrapper: on a CUDA tensor it launches the hand-written kernel
`csrc/fused_mrf_stage.cu` (and raises if it cannot), on a CPU tensor it runs
`fused_mrf_plain`, the same function in stock PyTorch ops.

Dtype rule, as in the TPU kernel: with bf16 compute every conv operand (the activation
after leaky, and the weight) is rounded to bf16, while products, sums, biases, the
residual stream, the inter-conv activations and the chain mean stay fp32. The output
is fp32; the caller rounds it for storage.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.ops import _build
from ttscube_tpu_torch.utils.profiling import count

KERNEL_SOURCE = "fused_mrf_stage"
# the kernel's limits (csrc/fused_mrf_stage.cu; checked against the library when it is
# loaded): channels a multiple of `quantum` up to `max_channels`; 1 to `max_blocks`
# chains of odd kernel size ≤ `max_k`, 1 to `max_dils` dilations each, and at most
# `max_reach` = (k − 1)/2·d samples read on each side by any conv
LIMITS = {"quantum": 32, "max_channels": 256, "max_blocks": 4, "max_dils": 4,
          "max_k": 15, "max_reach": 64}


class MrfWeights(NamedTuple):
    """An MRF stage's weights in the kernel's layouts: each conv [k][C_in][C_out],
    concatenated in chain order (per dilation the dilated conv, then the d = 1 conv);
    biases [n_convs][C]. With bf16 compute the conv weights are already rounded to bf16
    (kept in fp32)."""

    w: torch.Tensor
    b: torch.Tensor
    kernel_sizes: tuple
    dilations: tuple
    compute_dtype: torch.dtype | None

    @property
    def channels(self) -> int:
        return self.b.shape[1]

    @property
    def spec(self) -> list:
        return chain_spec(self.kernel_sizes, self.dilations)


def rounder(compute_dtype):
    """Rounding of a conv operand to the compute dtype, kept in its own dtype."""
    if compute_dtype is None:
        return lambda t: t
    return lambda t: t.to(compute_dtype).to(t.dtype)


def chain_spec(kernel_sizes, dilations, max_dils: int = 4) -> list:
    """The chains as the kernels read them: n_chains, then per chain k, n_dilations and
    the dilations padded to `max_dils`."""
    out = [len(kernel_sizes)]
    for k, dils in zip(kernel_sizes, dilations):
        out += [k, len(dils)] + list(dils) + [0] * (max_dils - len(dils))
    return out


def conv_sizes(kernel_sizes, dilations) -> list:
    """Kernel size of each conv of the chains, in chain order."""
    return [k for k, dils in zip(kernel_sizes, dilations) for _ in range(2 * len(dils))]


def check_chains(what: str, kernels, biases, C: int, kernel_sizes, dilations,
                 limits=LIMITS) -> None:
    """Raise ValueError, naming the limit, unless the chains and their weights fit."""
    if len(dilations) != len(kernel_sizes) or not 1 <= len(kernel_sizes) <= limits["max_blocks"]:
        raise ValueError(f"{what}: 1 to {limits['max_blocks']} resblock chains, got "
                         f"kernel sizes {kernel_sizes} with dilations {dilations}")
    for k, dils in zip(kernel_sizes, dilations):
        if (k % 2 != 1 or not 1 <= k <= limits["max_k"]
                or not 1 <= len(dils) <= limits["max_dils"]
                or any(d < 1 or (k - 1) // 2 * d > limits["max_reach"] for d in dils)):
            raise ValueError(f"{what}: chain k={k} dilations={dils} is beyond the kernel's "
                             f"limits (odd k ≤ {limits['max_k']}, 1 to {limits['max_dils']} "
                             f"dilations, (k − 1)/2·d ≤ {limits['max_reach']})")
    sizes = conv_sizes(kernel_sizes, dilations)
    if (len(kernels) != len(sizes) or len(biases) != len(sizes)
            or any(tuple(w.shape) != (C, C, k) for w, k in zip(kernels, sizes))
            or any(tuple(b.shape) != (C,) for b in biases)):
        raise ValueError(f"{what}: kernels must be (C, C, k) and biases (C,) for each conv "
                         "of each chain, in chain order")


def pack_convs(kernels, biases, compute_dtype, dtype):
    """Conv1d kernels (C, C, k) → one flat [k][C_in][C_out] per conv, rounded to the
    compute dtype; biases stacked [n_convs][C]. Differentiable in the inputs."""
    r = rounder(compute_dtype)
    return (torch.cat([r(w.to(dtype)).permute(2, 1, 0).reshape(-1) for w in kernels]),
            torch.stack([b.to(dtype) for b in biases]).contiguous())


def pack_mrf_weights(kernels, biases, *, kernel_sizes, dilations, compute_dtype=None,
                     dtype=torch.float32) -> MrfWeights:
    """Check an MRF stage against the kernel's limits and pack its weights, in `dtype`
    (the kernel takes fp32; the plain version also runs in fp64). kernels[i] (C, C, k)
    are Conv1d layouts, chain by chain, two convs (dilated, then d = 1) per dilation."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"fused_mrf1: compute_dtype {compute_dtype} not supported")
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C = kernels[0].shape[0] if len(kernels) else 0
    q, top = LIMITS["quantum"], LIMITS["max_channels"]
    if C % q or not q <= C <= top:
        raise ValueError(f"fused_mrf1: {C} channels is beyond the kernel's limits (a "
                         f"multiple of {q} up to {top})")
    check_chains("fused_mrf1", kernels, biases, C, kernel_sizes, dilations)
    w, b = pack_convs(kernels, biases, compute_dtype, dtype)
    return MrfWeights(w=w, b=b, kernel_sizes=kernel_sizes, dilations=dilations,
                      compute_dtype=compute_dtype)


def mrf_chains_plain(x, w, b, kernel_sizes, dilations, compute_dtype):
    """The MRF chains' mean in stock ops on x (B, C, T), from convs packed by
    `pack_convs`. Shared by `fused_mrf_plain` and the fused tail stage's plain
    version."""
    r = rounder(compute_dtype)
    C = b.shape[1]
    acc = None
    off = i = 0
    for k, dils in zip(kernel_sizes, dilations):
        xr = x
        for d in dils:
            w1 = w[off: off + k * C * C].view(k, C, C).permute(2, 1, 0)
            w2 = w[off + k * C * C: off + 2 * k * C * C].view(k, C, C).permute(2, 1, 0)
            h = F.conv1d(r(F.leaky_relu(xr, 0.1)), w1, b[i], padding=d * (k - 1) // 2,
                         dilation=d)
            h = F.conv1d(r(F.leaky_relu(h, 0.1)), w2, b[i + 1], padding=(k - 1) // 2)
            xr = xr + h
            off += 2 * k * C * C
            i += 2
        acc = xr if acc is None else acc + xr
    return acc / len(kernel_sizes)


def fused_mrf_plain(x, w: MrfWeights):
    """Stock-op version: x (B, T, C) → (B, T, C), in the packed weights' dtype."""
    y = mrf_chains_plain(x.to(w.w.dtype).transpose(1, 2), w.w, w.b, w.kernel_sizes,
                         w.dilations, w.compute_dtype)
    return y.transpose(1, 2)


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(KERNEL_SOURCE, "ttscube_fused_mrf1",
                       [p, i, i, i, p, p, p, i, p, p, p, p], LIMITS)


def fused_mrf1(x, w: MrfWeights):
    """The stage's output (B, T, C) fp32 from its input x (B, T, C).

    CPU tensors take `fused_mrf_plain`; CUDA tensors launch the kernel on x's device
    (set around the launch; untested on a machine with more than one card) or raise.
    Each launch counts `launches.fused_mrf1` (`utils/profiling.count`);
    `fused_mrf1.last_grid` holds the thread blocks of the last one."""
    if x.device.type == "cpu":
        return fused_mrf_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf1: unsupported device {x.device}")
    C = w.channels
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous() or x.shape[2] != C:
        raise ValueError(f"fused_mrf1: x must be a contiguous fp32 (B, T, {C}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if any(t.device != x.device or not t.is_contiguous() or t.dtype != torch.float32
           for t in (w.w, w.b)):
        raise ValueError("fused_mrf1: packed weights must be contiguous fp32 on the input's "
                         "device")
    B, T, _ = x.shape
    out = torch.empty_like(x)
    workspace = torch.empty(2 * len(w.kernel_sizes) * x.numel(), device=x.device)
    spec = w.spec
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ttscube_fused_mrf1(
            x.data_ptr(), B, T, C, w.w.data_ptr(), w.b.data_ptr(),
            ctypes.cast(spec_arr, ctypes.c_void_p), int(w.compute_dtype is not None),
            workspace.data_ptr(), out.data_ptr(), ctypes.addressof(grid),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mrf1: kernel launch failed with CUDA error {err}")
    count("launches.fused_mrf1")
    fused_mrf1.last_grid = grid.value
    return out


fused_mrf1.last_grid = 0


def mrf_flops(batch: int, t: int, channels: int, kernel_sizes, dilations) -> int:
    """Operations (2 per multiply-add) of the stage on this input: every conv of every
    chain, C·C·k multiply-adds per sample."""
    per_sample = sum(channels * channels * k for k in conv_sizes(kernel_sizes, dilations))
    return 2 * per_sample * batch * t
