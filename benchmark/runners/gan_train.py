"""GAN training: the program's `train_step` on one training state, over the traffic's
pool of batches (built by the program's `CubeganCollate` in set-up), cycled, each step
with its own crop starts. A step includes its batch's copy to the card.

Set-up makes the one training state and drives it through one step on each batch of the
pool, through the window's own call and feed: those steps warm every shape, and their
first three are what the check holds against the reference, which follows them from the
same seeded weights after the window. The record of those steps: each step's losses, each
leaf's first gradient norm (from the optimizers' first moments after step one) and each
leaf's change over the three.

One step of the measured window, drawn from the seed (`traffic.watched`), is followed
too: the runner copies the program's state just before it (parameters and buffers,
moments, counts, step number) and its parameters just after it, and after the window the
reference goes one step from that copy on the same batch and crop starts."""

from __future__ import annotations

import time

import torch

from benchmark import weights
from benchmark.runners.common import build, free_cuda
from benchmark.reference.collate import collate
from benchmark.reference.ops import no_tf32
from benchmark.reference.training import compare, compare_step, follow, follow_from

FOLLOWED = 3  # steps the reference follows


def grad_norms_from_moments(optimizers: dict, names: dict) -> dict:
    """Each leaf's first-step gradient norm from its optimizer's state after one step:
    the first moment is then (1 − β1)·g."""
    out = {}
    for opt in optimizers.values():
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                st = opt.state.get(p)
                if st and "exp_avg" in st:
                    out[names[id(p)]] = float(st["exp_avg"].norm()) / (1.0 - b1)
    return out


class Runner:
    def __init__(self, cell: dict, config: dict, traffic, seed: int, device):
        self.cell, self.c, self.traffic, self.seed, self.device = cell, config, traffic, seed, device
        self.metrics = []

    def setup(self) -> None:
        from ttscube_tpu_torch.data.collate import CubeganCollate
        from ttscube_tpu_torch.data.encodings import CubeganEncodings
        from ttscube_tpu_torch.models.cubegan import create_train_state

        c, tr = self.c, self.traffic
        k = c["collate"]
        t = time.perf_counter()
        enc = CubeganEncodings()
        enc.phon2int = {p: i for i, p in enumerate(tr.phones())}
        enc.speaker2int = {s: i for i, s in enumerate(tr.speakers())}
        enc.max_pitch, enc.max_duration = c["languasito"]["max_pitch"], k["duration_cap"]
        self.hf = c["languasito"].get("cond_type") == "hf"
        collate_fn = CubeganCollate(enc, bucket_phones=k["bucket_phones"],
                                    bucket_frames=k["bucket_frames"], hop=c["hop_size"],
                                    min_frames=k["min_frames"], hf_conditioning=self.hf,
                                    bucket_tokens=k["bucket_tokens"])
        self.pool = [collate_fn(tr.batch(j)) for j in range(self.cell["params"]["pool"])]
        if len(self.pool) < FOLLOWED:
            raise ValueError(f"the pool holds fewer than the {FOLLOWED} batches the check follows")
        self.phases = {"utterances and collate": time.perf_counter() - t}
        t = time.perf_counter()
        self.model, self.shapes, W = build(c, self.seed, self.device, train=True)
        self.model.train()
        self.state = create_train_state(self.model, seed=self.seed)
        named = self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.trainable = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.phases["model, weights and optimizers"] = time.perf_counter() - t
        t = time.perf_counter()
        losses = []
        for j in range(len(self.pool)):
            self.unit(j)
            if j < FOLLOWED:
                losses.append({k: float(v) for k, v in self.metrics[-1].items()})
            if j == 0:
                grads = grad_norms_from_moments(self.state.optimizers, named)
            if j == FOLLOWED - 1:
                params = dict(self.model.named_parameters())
                change = {n: float((params[n].detach() - W[n]).norm()) for n in self.trainable}
        del W
        self.record = {"losses": losses, "grad_norms": grads, "change_norms": change}
        self.first_unit = len(self.pool)
        self.watch = self.first_unit + tr.watched()
        self.min_units = self.watch - self.first_unit + 1
        self.sync()
        self.phases["first steps (one per pool batch)"] = time.perf_counter() - t

    def starts(self, k: int):
        tr = self.traffic
        return torch.from_numpy(tr.starts(k, tr.lengths[k % len(tr.lengths)]))

    def unit(self, k: int) -> dict:
        from ttscube_tpu_torch.models.cubegan import batch_to_torch, train_step

        b = self.pool[k % len(self.pool)]
        if k == getattr(self, "watch", None):
            self.snap = self._snapshot()
        _, met = train_step(self.state, batch_to_torch(b, self.device), starts=self.starts(k))
        self.metrics.append(met)
        if k == getattr(self, "watch", None):
            self.after = {n: p.detach().clone() for n, p in self.model.named_parameters()
                          if p.requires_grad}
        shape = {"batch": b["x_char"].shape[0], "phones": b["x_char"].shape[1],
                 "frames": b["y_frame2phone"].shape[1],
                 "words": b["x_word2tok"].shape[1] if self.hf else 0,
                 "tokens": b["x_tok_ids"].shape[1] if self.hf else 0}
        return {"shape": shape, "work": 1.0}

    def _snapshot(self) -> dict:
        """The program's state just before a step: parameters and buffers, each trained
        leaf's moments, each optimizer's count of updates, the step number."""
        st = self.state
        W = {n: t.detach().clone() for n, t in st.model.state_dict().items()}
        m, v, count = {}, {}, {}
        for part, opt in st.optimizers.items():
            for group in opt.param_groups:
                for p in group["params"]:
                    s = opt.state.get(p)
                    if s:
                        n = self.names[id(p)]
                        m[n], v[n] = s["exp_avg"].clone(), s["exp_avg_sq"].clone()
                        count[part] = int(s["step"])
        return {"W": W, "m": m, "v": v, "count": count, "step_no": st.step}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self, records: list) -> int:
        """Steps of the window whose losses were not all finite."""
        window = self.metrics[self.first_unit: self.first_unit + len(records)]
        if not window:
            return 0
        losses = torch.stack([torch.stack(list(m.values())) for m in window])
        return int((~torch.isfinite(losses)).any(-1).sum())

    def free(self) -> None:
        del self.model, self.state
        free_cuda()

    def _batch(self, k: int) -> dict:
        """Step k's batch as the reference's own collate builds it, on the card."""
        tr, c = self.traffic, self.c
        arrays = collate(tr.batch(k % len(self.pool)), tr.phones(), tr.speakers(),
                         c["collate"], c["hop_size"], self.hf)
        return {n: torch.from_numpy(v).to(self.device) for n, v in arrays.items()}

    def _reference(self) -> tuple:
        """The reference's records of the first steps and of the watched window step."""
        W = weights.make(self.shapes, self.seed, self.device)
        batches = [self._batch(j) for j in range(FOLLOWED)]
        starts = [self.starts(j) for j in range(FOLLOWED)]
        with no_tf32():
            first = follow(W, self.c, self.trainable, batches, starts)
            del W, batches
            step = follow_from(self.snap, self.c, self.trainable, self._batch(self.watch),
                               self.starts(self.watch))
        return first, step

    def _watched(self) -> dict:
        """The program's record of the watched window step."""
        if not hasattr(self, "after"):
            raise RuntimeError("the window ended before the step the check follows")
        met = self.metrics[self.watch]
        return {"losses": [{k: float(v) for k, v in met.items()}],
                "change_norms": {n: float((p - self.snap["W"][n]).norm())
                                 for n, p in self.after.items()}}

    def check(self) -> dict:
        first, step = self._reference()
        a, b = compare(self.record, first), compare_step(self._watched(), step)
        self.detail = {**a.pop("detail"), **b.pop("detail")}
        return {**a, **b}
