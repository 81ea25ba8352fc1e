"""The reference's side of a synthesis check: `judge` reads what a synthesis produced
(durations, frame map, VUV, pitch, conditioning, audio) against the fp32 reference, and
`produce` is the reference put in the program's place, at the precisions of a control.

The two discrete choices of free synthesis, each phone's duration (an argmax over the
duration classes) and each frame's VUV (a rounded sigmoid), are read as a served
model's tokens are: by how far the judged choice's logit lies below the reference's
best, after which the reference follows the judged choices, so that one near tie cannot
move every later frame. The heads' outputs themselves (the duration logits, the VUV
probability) are compared too, so that a change of precision shows where it moves no
choice. Everything continuous is worked out again from those choices."""

from __future__ import annotations

import torch

from benchmark.reference import cubegan as ref
from benchmark.reference.ops import Precision


def judge(W, c, X, out, max_frames: int, block: int = 8) -> dict:
    """Numbers of one judged synthesis over the rows of X (tensors on the card):
    dur_err (logit units: the larger of how far a chosen duration's logit lies below the
    reference's best and the largest error of a duration logit, over real phones),
    f2p_diff (frames whose map differs from the one the durations give), vuv_err (the
    larger of how far the reference's VUV probability lies on the other side of 0.5
    where the judged VUV differs and the largest error of the VUV probability),
    pitch_err (the larger of the largest error of the pitch head's output and of the
    pitch after the VUV mask, both over max_pitch), cond_err (the largest
    conditioning error over the reference's largest value) and audio_err (the RMS of
    the audio's error over the reference's RMS).
    The generator runs `block` rows at a time."""
    lc = c["languasito"]
    max_pitch = lc["max_pitch"]
    Xc = ref.lm_condition(W, c, X)
    h_t = ref.tower(W, c, Xc, "tower_t")
    logits = ref.dur_logits(W, c, h_t)
    valid = X["x_char"] != 0
    durs = out["durations"].long()
    chosen = torch.gather(logits, -1, durs[..., None])[..., 0]
    logit_err = ((logits - out["dur_logits"].float()).abs().amax(-1) * valid).amax()
    dur_err = torch.maximum(((logits.amax(-1) - chosen) * valid).amax(), logit_err)
    f2p, _ = ref.frame2phone(durs * valid, valid.sum(-1), max_frames)
    f2p_diff = (f2p != out["frame2phone"].long()).sum()
    po = ref.pitch_head(W, c, h_t, f2p)
    p_vuv = torch.sigmoid(po[..., 1])
    vuv = out["vuv"].float()
    vuv_err = torch.maximum(((torch.round(p_vuv) != vuv) * (p_vuv - 0.5).abs()).amax(),
                            (p_vuv - torch.sigmoid(out["pitch_logits"][..., 1].float())).abs().amax())
    p_pitch = torch.sigmoid(po[..., 0])
    pitch = p_pitch * max_pitch * vuv
    pitch_err = torch.maximum(
        (pitch - out["pitch"].float()).abs().amax() / max_pitch,
        (p_pitch - torch.sigmoid(out["pitch_logits"][..., 0].float())).abs().amax())
    cond = ref.cond_forward(W, c, Xc, f2p, pitch)
    cond_err = (cond - out["cond"].float()).abs().amax() / cond.abs().amax()
    err2 = ref2 = 0.0
    for a in range(0, cond.shape[0], block):
        audio = ref.generator(W, c, cond[a:a + block])
        got = out["audio"][a:a + block].to(audio.device).float()
        err2 += float(((got - audio) ** 2).sum())
        ref2 += float((audio ** 2).sum())
    return {"dur_err": float(dur_err), "f2p_diff": float(f2p_diff), "vuv_err": float(vuv_err),
            "pitch_err": float(pitch_err), "cond_err": float(cond_err),
            "audio_err": (err2 / max(ref2, 1e-30)) ** 0.5}


def produce(W, c, X, max_frames: int, text: str | None, gen: str | None,
            block: int = 8) -> dict:
    """Free synthesis by the reference with the text model's operands in `text` and
    the generator's in `gen` (`Precision` kinds): what `judge` reads, audio as int16
    values over 32767."""
    qt, qg = Precision(text), Precision(gen)
    Xc = ref.lm_condition(W, c, X, qt)
    h_t = ref.tower(W, c, Xc, "tower_t", qt)
    valid = X["x_char"] != 0
    logits = ref.dur_logits(W, c, h_t, qt)
    durs = logits.argmax(-1) * valid
    f2p, _ = ref.frame2phone(durs, valid.sum(-1), max_frames)
    po = ref.pitch_head(W, c, h_t, f2p, qt)
    vuv = torch.round(torch.sigmoid(po[..., 1]))
    pitch = torch.sigmoid(po[..., 0]) * c["languasito"]["max_pitch"] * vuv
    cond = ref.cond_forward(W, c, Xc, f2p, pitch, qt)
    audio = torch.cat([ref.generator(W, c, cond[a:a + block], qg)
                       for a in range(0, cond.shape[0], block)])
    audio = (audio.clamp(-1, 1) * 32767).to(torch.int16).float() / 32767
    return {"durations": durs, "frame2phone": f2p, "vuv": vuv, "pitch": pitch, "cond": cond,
            "dur_logits": logits, "pitch_logits": po, "audio": audio}
