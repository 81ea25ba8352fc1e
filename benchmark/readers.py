"""What several metric readers (`benchmark/metrics/`) share: a span's device ms per unit
of the traced slice, the device's idle share of the slice, the synthesis step's share of
the bf16 peak, and kernel B1's share of its roofline in synthesis."""

from __future__ import annotations

from benchmark.counts.flops import synthesis_batch, tail
from benchmark.counts.roofline import bound_ms, mfu_percent


def span_ms_per_unit(run, span: str):
    """Device ms of the operations launched inside `span`, per unit of the slice."""
    ms = run.trace.span_ms(span)
    return None if ms is None else ms / len(run.sliced)


def idle_percent(run) -> float:
    """100 × (1 − the union of the device's operations / the slice's length)."""
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def synthesis_mfu(run) -> float:
    """The text model's and the generator's operations over every frame of the window's
    batches (counted from the configuration's shapes, no window halo), over the window's
    seconds outside the profiler, as a share of the bf16 peak."""
    flops = sum(synthesis_batch(run.config, **u["shape"]) for u in run.units)
    return mfu_percent(flops, run.elapsed_s)


def windows(params) -> list:
    """Frames of each generator call of one synthesis batch."""
    frames, chunk = params["max_frames"], params.get("chunk_frames")
    if chunk is None or frames <= chunk + 2 * params["halo_frames"]:
        return [frames]
    return [chunk + 2 * params["halo_frames"]] * -(-frames // chunk)


def tail_synthesis_roofline(run, kernels):
    """B1's bound (operations at the bf16 peak with bf16 storage, else fp32's; or bytes
    at the memory's rate, whichever is larger) over the device time of its launches."""
    ms = run.trace.kernel_ms(kernels)
    if ms is None:
        return None
    c, p = run.config, run.cell["params"]
    mode = "bf16" if c["serving"]["storage_dtype"] == "bfloat16" else "fp32"
    bound = sum(bound_ms(*tail(c, u["shape"]["batch"], f), mode)
                for u in run.sliced for f in windows(p))
    return 100.0 * bound / ms
