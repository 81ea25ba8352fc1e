"""The generator's final stage as one kernel: counterpart of
`ttscube_tpu/ops/pallas_resblock.py::fused_tail_stage` (with_post=True, the serving
path).

    leaky(0.1) → ConvTranspose1d (kernel == stride == 4) → each MRF ResBlock1 chain
    → mean of the chains → leaky(0.01) → conv_post → tanh → audio

`pack_tail_weights` checks the weights once and lays them out for the kernel;
`fused_tail_stage(z, weights)` is the wrapper: on a CUDA tensor it launches the
hand-written kernel `csrc/fused_tail_stage.cu` (and raises if it cannot), on a CPU
tensor it runs `fused_tail_stage_plain`, the same function in stock PyTorch ops. Both
follow the kernel's dtype rule: with bf16 compute every conv operand is rounded to
bf16 while products, sums, biases and residuals stay fp32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

KERNEL_SOURCE = "fused_tail_stage"
# the kernel's tiling limits (csrc/fused_tail_stage.cu; checked against the library
# when it is loaded)
LIMITS = {"channels": 32, "fold": 4, "post_k": 7, "max_blocks": 4, "max_dils": 4,
          "max_halo": 61, "max_c_in": 128}


class TailWeights(NamedTuple):
    """Weights in the kernel's layouts: up [fold][C_in][C]; each conv [k][C_in][C_out],
    concatenated in chain order; biases [n_convs][C]; post [k_post][C]. With bf16
    compute the conv weights are already rounded to bf16 (kept in fp32)."""

    wup: torch.Tensor
    bup: torch.Tensor
    wmrf: torch.Tensor
    bmrf: torch.Tensor
    wpost: torch.Tensor
    bpost: torch.Tensor
    kernel_sizes: tuple
    dilations: tuple
    compute_dtype: torch.dtype | None

    @property
    def spec(self) -> list:
        """n_chains, then per chain k, n_dilations and the dilations padded to 4."""
        out = [len(self.kernel_sizes)]
        for k, dils in zip(self.kernel_sizes, self.dilations):
            out += [k, len(dils)] + list(dils) + [0] * (LIMITS["max_dils"] - len(dils))
        return out


def _rounder(compute_dtype):
    if compute_dtype is None:
        return lambda t: t
    return lambda t: t.to(compute_dtype).float()


def pack_tail_weights(up_kernel, up_bias, kernels, biases, post_kernel, post_bias, *,
                      kernel_sizes, dilations, compute_dtype=None) -> TailWeights:
    """Check the stage's weights against the kernel's limits and pack them.

    up_kernel (C_in, C, 4) is PyTorch's ConvTranspose1d layout; kernels[i] (C, C, k) and
    post_kernel (1, C, 7) are Conv1d layouts; kernels run chain by chain, two convs
    (dilated, then d = 1) per dilation."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"fused_tail_stage: compute_dtype {compute_dtype} not supported")
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C_in, C, fold = up_kernel.shape
    if C != LIMITS["channels"] or fold != LIMITS["fold"] or C_in > LIMITS["max_c_in"]:
        raise ValueError(f"fused_tail_stage: up_kernel {tuple(up_kernel.shape)} does not fit "
                         f"the kernel (C_in ≤ {LIMITS['max_c_in']}, C = {LIMITS['channels']}, "
                         f"kernel == stride == {LIMITS['fold']})")
    if tuple(post_kernel.shape) != (1, C, LIMITS["post_k"]):
        raise ValueError(f"fused_tail_stage: post_kernel {tuple(post_kernel.shape)} must be "
                         f"(1, {C}, {LIMITS['post_k']})")
    if not 1 <= len(kernel_sizes) <= LIMITS["max_blocks"] or len(dilations) != len(kernel_sizes):
        raise ValueError(f"fused_tail_stage: 1 to {LIMITS['max_blocks']} resblock chains")
    per_conv = []
    for k, dils in zip(kernel_sizes, dilations):
        halo = sum((d + 1) * ((k - 1) // 2) for d in dils)
        if k % 2 != 1 or not 1 <= len(dils) <= LIMITS["max_dils"] or halo > LIMITS["max_halo"]:
            raise ValueError(f"fused_tail_stage: chain k={k} dilations={dils} exceeds the "
                             f"kernel's halo ({LIMITS['max_halo']} samples) or dilation count")
        per_conv += [k] * (2 * len(dils))
    if (len(kernels) != len(per_conv) or len(biases) != len(per_conv)
            or any(tuple(w.shape) != (C, C, k) for w, k in zip(kernels, per_conv))):
        raise ValueError("fused_tail_stage: kernels must be (C, C, k) for each conv of each "
                         "chain, in chain order")
    r = _rounder(compute_dtype)
    f32 = lambda t: t.detach().float()
    return TailWeights(
        wup=r(f32(up_kernel)).permute(2, 0, 1).contiguous(),
        bup=f32(up_bias).contiguous(),
        wmrf=torch.cat([r(f32(w)).permute(2, 1, 0).reshape(-1) for w in kernels]),
        bmrf=torch.stack([f32(b) for b in biases]).contiguous(),
        wpost=r(f32(post_kernel))[0].t().contiguous(),
        bpost=f32(post_bias).reshape(1).contiguous(),
        kernel_sizes=kernel_sizes, dilations=dilations, compute_dtype=compute_dtype)


def fused_tail_stage_plain(z, w: TailWeights):
    """Stock-op version: z (B, T_in, C_in) → audio (B, 4·T_in) fp32."""
    r = _rounder(w.compute_dtype)
    fold, C_in, C = w.wup.shape
    x = F.leaky_relu(z.float().transpose(1, 2), 0.1)
    x = F.conv_transpose1d(r(x), w.wup.permute(1, 2, 0), w.bup, stride=fold)
    acc = None
    off = i = 0
    for k, dils in zip(w.kernel_sizes, w.dilations):
        xr = x
        for d in dils:
            w1 = w.wmrf[off: off + k * C * C].view(k, C, C).permute(2, 1, 0)
            w2 = w.wmrf[off + k * C * C: off + 2 * k * C * C].view(k, C, C).permute(2, 1, 0)
            h = F.conv1d(r(F.leaky_relu(xr, 0.1)), w1, w.bmrf[i],
                         padding=d * (k - 1) // 2, dilation=d)
            h = F.conv1d(r(F.leaky_relu(h, 0.1)), w2, w.bmrf[i + 1], padding=(k - 1) // 2)
            xr = xr + h
            off += 2 * k * C * C
            i += 2
        acc = xr if acc is None else acc + xr
    y = F.leaky_relu(acc / len(w.kernel_sizes), 0.01)
    kp = w.wpost.shape[0]
    audio = F.conv1d(r(y), w.wpost.t()[None], w.bpost, padding=(kp - 1) // 2)
    return torch.tanh(audio)[:, 0, :]


def _lib():
    from ttscube_tpu_torch.ops import _build

    lib = _build.load(KERNEL_SOURCE)
    if not getattr(_lib, "bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ttscube_fused_tail_stage.argtypes = [p, i, i, i, p, p, p, p, p, p, p, i, p, p]
        lib.ttscube_fused_tail_stage.restype = ctypes.c_int
        lib.ttscube_fused_tail_stage_limits.argtypes = [p]
        lib.ttscube_fused_tail_stage_limits.restype = ctypes.c_int
        vals = (ctypes.c_int * len(LIMITS))()
        lib.ttscube_fused_tail_stage_limits(ctypes.cast(vals, p))
        if dict(zip(LIMITS, vals)) != LIMITS:
            raise RuntimeError(f"fused_tail_stage: the library's limits {list(vals)} differ "
                               f"from the wrapper's {LIMITS}")
        _lib.bound = True
    return lib


def fused_tail_stage(z, w: TailWeights):
    """Audio (B, 4·T_in) fp32 from the last stage's input z (B, T_in, C_in).

    CPU tensors take `fused_tail_stage_plain`; CUDA tensors launch the kernel or
    raise. `fused_tail_stage.launches` counts kernel launches."""
    if z.device.type == "cpu":
        return fused_tail_stage_plain(z, w)
    if z.device.type != "cuda":
        raise ValueError(f"fused_tail_stage: unsupported device {z.device}")
    if (z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous()
            or z.shape[2] != w.wup.shape[1]):
        raise ValueError("fused_tail_stage: z must be a contiguous fp32 (B, T_in, "
                         f"{w.wup.shape[1]}) tensor, got {z.dtype} {tuple(z.shape)}")
    tensors = (w.wup, w.bup, w.wmrf, w.bmrf, w.wpost, w.bpost)
    if any(t.device != z.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_tail_stage: packed weights must be contiguous and on the "
                         "input's device")
    lib = _lib()
    B, T_in, C_in = z.shape
    out = torch.empty(B, T_in * LIMITS["fold"], device=z.device, dtype=torch.float32)
    spec = w.spec
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    err = lib.ttscube_fused_tail_stage(
        z.data_ptr(), B, T_in, C_in, *[t.data_ptr() for t in tensors],
        ctypes.cast(spec_arr, ctypes.c_void_p), int(w.compute_dtype is not None),
        out.data_ptr(), torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_stage: kernel launch failed with CUDA error {err}")
    fused_tail_stage.launches += 1
    return out


fused_tail_stage.launches = 0


def tail_flops(batch: int, t_in: int, c_in: int, kernel_sizes, dilations) -> int:
    """Operations (2 per multiply-add) the stage needs for this input: upsample, every
    MRF conv and conv_post, per output sample, times the output samples."""
    C = LIMITS["channels"]
    per_sample = c_in * C                                                    # upsample
    per_sample += sum(2 * len(d) * k * C * C for k, d in zip(kernel_sizes, dilations))
    per_sample += LIMITS["post_k"] * C                                       # conv_post
    return 2 * per_sample * batch * t_in * LIMITS["fold"]
