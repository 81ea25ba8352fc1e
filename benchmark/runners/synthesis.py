"""Bulk synthesis: `Cubegan.infer` over the traffic's batches, back to back. A batch
starts with its inputs' copy to the card and ends when its int16 audio is on the host.

The check compares a sample of the window's batches (`traffic.keep`), a few rows of
each (`traffic.rows`): what `infer` returned for them, the outputs of the text model's
three heads (duration logits, pitch and VUV logits, the conditioning; caught by forward
hooks on those layers as `infer` makes them) and the int16 audio, against the
reference, after the window, with the program's model freed."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import weights
from benchmark.runners.common import build, free_cuda
from benchmark.reference.ops import no_tf32
from benchmark.reference.synthesis import judge, produce


# the text model's heads whose outputs the check reads, and the names it reads them by
HEADS = {"dur_output": "dur_logits", "pitch_output": "pitch_logits", "cond_output": "cond"}


def to_device(X: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in X.items()}


class Runner:
    def __init__(self, cell: dict, config: dict, traffic, seed: int, device):
        self.cell, self.c, self.traffic, self.seed, self.device = cell, config, traffic, seed, device
        p = cell["params"]
        self.frames, self.chunk = p["max_frames"], p.get("chunk_frames")
        self.kept = {}
        self.first_unit = 0
        self._catch = False
        self._heads = {}

    # -- set-up -----------------------------------------------------------------------

    def setup(self) -> None:
        if self.c["languasito"].get("cond_type"):
            raise ValueError("synthesis cells run configurations without LM conditioning")
        t = time.perf_counter()
        self.model, self.shapes, W = build(self.c, self.seed, self.device, train=False)
        del W
        self.model.eval()
        for head in HEADS:
            getattr(self.model.lang, head).register_forward_hook(self._hook(head))
        self.phases = {"model and weights": time.perf_counter() - t}
        t = time.perf_counter()
        for X in self.traffic.warmup():
            self._synthesize(X)
        self.phases["warm-up batches"] = time.perf_counter() - t

    def _hook(self, head: str):
        def keep(module, args, out):
            if self._catch:
                self._heads[head] = out
        return keep

    def _synthesize(self, X: dict):
        """(int16 audio on the host, `infer`'s aux, whether every sample was finite)."""
        Xd = to_device(X, self.device)
        audio, aux = self.model.infer(Xd, max_frames=self.frames, chunk_frames=self.chunk)
        finite = torch.isfinite(audio).all()
        pcm = (audio.clamp(-1, 1) * 32767).to(torch.int16).cpu()
        return pcm, aux, bool(finite)

    # -- the window ------------------------------------------------------------------------

    def unit(self, i: int) -> dict:
        """Batch i: returns its record (its shape and audio seconds); keeps what the
        check reads where the batch is in the sample."""
        X = self.traffic.batch(i)
        self._catch = self.traffic.keep(i)
        pcm, aux, finite = self._synthesize(X)
        if self._catch:
            rows = self.traffic.rows(i)
            r = torch.from_numpy(rows).to(self.device)
            self.kept[i] = {
                "X": {k: v[rows] for k, v in X.items()},
                "out": {"durations": aux["durations"][r], "frame2phone": aux["frame2phone"][r],
                        "vuv": aux["vuv"][r], "pitch": aux["pitch"][r],
                        **{HEADS[h]: v[r] for h, v in self._heads.items()},
                        "audio": pcm[torch.from_numpy(rows)].float() / 32767}}
            self._catch, self._heads = False, {}
        return {"shape": {"batch": X["x_char"].shape[0], "phones": X["x_char"].shape[1],
                          "frames": self.frames},
                "work": self.traffic.audio_s(), "failed": not finite}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self, records: list) -> int:
        """Batches of the window whose audio was not all finite."""
        return sum(r["failed"] for r in records)

    # -- the check -----------------------------------------------------------------------

    def free(self) -> None:
        del self.model
        free_cuda()

    def groups(self) -> list:
        """The kept rows, grouped by padded phone length: (X, outputs) on the card."""
        by = {}
        for i, k in sorted(self.kept.items()):
            by.setdefault(k["X"]["x_char"].shape[1], []).append(k)
        out = []
        for ks in by.values():
            X = {n: torch.from_numpy(np.concatenate([k["X"][n] for k in ks])).to(self.device)
                 for n in ks[0]["X"]}
            outs = {n: torch.cat([k["out"][n].to(self.device) for k in ks]) for n in ks[0]["out"]}
            out.append((X, outs))
        return out

    def check(self) -> dict:
        """The largest of each number over the groups of sampled rows."""
        W = weights.make(self.shapes, self.seed, self.device)
        numbers = {}
        with no_tf32(), torch.no_grad():
            for X, outs in self.groups():
                for name, v in judge(W, self.c, X, outs, self.frames).items():
                    numbers[name] = max(numbers.get(name, 0.0), v)
        return numbers

    def control(self, text: str, gen: str) -> dict:
        """The check's numbers with the reference at `text`/`gen` precisions put in the
        program's place, on the same sampled rows."""
        W = weights.make(self.shapes, self.seed, self.device)
        numbers = {}
        with no_tf32(), torch.no_grad():
            for X, _ in self.groups():
                out = produce(W, self.c, X, self.frames, text, gen)
                for name, v in judge(W, self.c, X, out, self.frames).items():
                    numbers[name] = max(numbers.get(name, 0.0), v)
        return numbers
