"""Quality metrics of a folder of synthesized utterances: the port's copy of
`scripts/eval_drive_quality.py`, with the same flags, the same printed lines and the same
`quality_metrics.json`, and no JAX.

    python -m ttscube_tpu_torch.scripts.eval_drive_quality --dir D \
        [--baseline OLD/quality_metrics.json] [--protocol artifacts/eval_protocol.json] \
        [--device cpu]

For each pair ``orig_<id>.wav`` / ``synth_<id>.wav`` under ``--dir``:

- **MCD-DTW** (dB): mel-cepstral distortion (c1..c12 of the natural-log mel) over a DTW
  alignment of the two log-mel sequences, which differ in length because free synthesis
  predicts its durations;
- **F0-RMSE** (Hz) over the aligned frames voiced in both signals (RAPT pitch,
  `dsp/pitch.py`, the importers' extractor);
- **VUV error** (%): the share of aligned frames whose voicing decisions disagree;
- **duration error** (%): |len(synth) − len(orig)| / len(orig);
- **voiced ratio**: the share of frames above a near-silence floor, a guard against
  silent output, which scores deceptively well on distances.

The summary adds the means, a chance floor (MCD-DTW between mismatched originals, same
speaker where possible), the evaluated pair list checked against the pinned protocol
manifest, and with ``--baseline`` a trend against an earlier run's json, marked
``comparable: false`` with a reason where the two pair lists differ.

The log-mel (`dsp/mel.MelSpec` at the feature config: fp32 DFT matmuls, without TF32
at PyTorch's default matmul precision) runs on the card unless ``--device cpu``; without
a card and without ``--device cpu`` the script raises. This departs from the JAX script,
which pins its mel to the host so that the metric never occupies the TPU: the port's
entry points run on the card unless asked. RAPT, the cepstra, DTW and the pitch metrics
stay numpy on the host, as in the JAX script. `dtw_path` runs over anti-diagonals, each
one vectorised, with the JAX script's recursion, arithmetic and first-minimum tie-break
(diagonal, up, left), so it gives the same costs and paths as its double loop.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

PROTOCOL = str(Path(__file__).resolve().parents[2] / "artifacts" / "eval_protocol.json")

_mel_specs = {}


def log_mel(wav: np.ndarray, sr: int, device="cpu") -> np.ndarray:
    """(T, 80) log10-mel at the feature extractor's config, computed on `device`."""
    import torch

    from ttscube_tpu_torch.dsp.mel import MelSpec, feature_mel_config

    if sr not in _mel_specs:
        _mel_specs[sr] = MelSpec(feature_mel_config(sr))
    y = torch.from_numpy(np.asarray(wav, np.float32)).to(device)
    with torch.no_grad():
        return _mel_specs[sr](y).cpu().numpy()


def mel_to_cepstra(logmel10: np.ndarray, n_coef: int = 13) -> np.ndarray:
    """Orthonormal DCT-II of the natural-log mel → mel cepstra (the feature mel is
    log10, so it is scaled by ln 10 first)."""
    n_mels = logmel10.shape[1]
    k = np.arange(n_mels)
    basis = np.cos(np.pi * np.outer(np.arange(n_coef), (k + 0.5) / n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[0] /= np.sqrt(2.0)
    return (logmel10 * np.log(10.0)) @ basis.T  # (T, n_coef)


def dtw_path(a: np.ndarray, b: np.ndarray):
    """Classic O(T1·T2) DTW over euclidean frame distances; returns (total cost, path),
    the path a list of (i, j) frame index pairs along the alignment.

    acc[i, j] = d[i−1, j−1] + min(acc[i−1, j−1], acc[i−1, j], acc[i, j−1]), the first
    of equal minima taken in that order. A cell needs only the two anti-diagonals before
    its own, so each anti-diagonal i + j = s is computed at once."""
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))  # (T1, T2)
    T1, T2 = d.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    move = np.zeros((T1 + 1, T2 + 1), np.int8)  # 0=diag 1=up(i-1) 2=left(j-1)
    acc[0, 0] = 0.0
    for s in range(2, T1 + T2 + 1):
        i = np.arange(max(1, s - T2), min(T1, s - 1) + 1)
        j = s - i
        cands = np.stack((acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]))
        k = np.argmin(cands, axis=0)
        acc[i, j] = d[i - 1, j - 1] + cands[k, np.arange(len(i))]
        move[i, j] = k
    path = []
    i, j = T1, T2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        k = move[i, j]
        if k == 0:
            i, j = i - 1, j - 1
        elif k == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return float(acc[T1, T2]), path


def mcd_dtw(logmel_a: np.ndarray, logmel_b: np.ndarray):
    """MCD in dB: (10/ln10)·sqrt(2) · mean path distance over cepstra c1..c12.
    Returns (mcd_db, path), so that the pitch metrics reuse the alignment."""
    ca = mel_to_cepstra(logmel_a)[:, 1:]
    cb = mel_to_cepstra(logmel_b)[:, 1:]
    cost, path = dtw_path(ca, cb)
    return (10.0 / np.log(10.0)) * np.sqrt(2.0) * cost / max(len(path), 1), path


def f0_metrics(f0_a: np.ndarray, f0_b: np.ndarray, path) -> tuple[float, float]:
    """(F0-RMSE over the aligned frames voiced in both, VUV disagreement rate) along a
    DTW path over mel frames (the pitch tracks share the mel's hop)."""
    ii = np.array([min(i, len(f0_a) - 1) for i, _ in path])
    jj = np.array([min(j, len(f0_b) - 1) for _, j in path])
    va, vb = f0_a[ii] > 0, f0_b[jj] > 0
    vuv_err = float((va != vb).mean()) if len(path) else 0.0
    both = va & vb
    if both.sum() == 0:
        return float("nan"), vuv_err
    rmse = float(np.sqrt(((f0_a[ii][both] - f0_b[jj][both]) ** 2).mean()))
    return rmse, vuv_err


def voiced_ratio(logmel: np.ndarray, floor_db: float = -4.0) -> float:
    """Share of frames whose mean log10-mel exceeds a near-silence floor."""
    return float((logmel.mean(axis=1) > floor_db).mean())


def chance_floor_pairs(uids: list) -> list:
    """Mismatched pairs for the chance floor: each uid scored against a different uid,
    of the same speaker where possible (uids ``<speaker>_<sentence>``); deterministic."""
    out = []
    for uid in uids:
        spk = uid.split("_")[0]
        same_spk = [u for u in uids if u != uid and u.split("_")[0] == spk]
        pool = same_spk or [u for u in uids if u != uid]
        if not pool:
            continue
        partner = pool[(uids.index(uid) + 1) % len(pool)] if len(pool) > 1 else pool[0]
        out.append((uid, partner))
    return out


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch quality metrics of orig_/synth_ pairs")
    p.add_argument("--dir", required=True)
    p.add_argument("--baseline", default=None,
                   help="an earlier run's quality_metrics.json for a trend table")
    p.add_argument("--protocol", default=PROTOCOL,
                   help="pinned corpus/devset manifest; pass '' to skip")
    p.add_argument("--device", default=None,
                   help="cpu to compute the mel on the CPU (default: the card)")
    return p


def main(argv=None) -> dict:
    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.dsp.pitch import rapt_pitch
    from ttscube_tpu_torch.utils.wavio import read_wav

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    pairs = []
    for orig in sorted(glob.glob(os.path.join(args.dir, "orig_*.wav"))):
        uid = os.path.basename(orig)[len("orig_"):-len(".wav")]
        synth = os.path.join(args.dir, f"synth_{uid}.wav")
        if os.path.exists(synth):
            pairs.append((uid, orig, synth))
    if not pairs:
        raise SystemExit(f"no orig_/synth_ wav pairs under {args.dir}")

    rows = []
    orig_mels = {}  # uid -> log-mel of the original (reused for the chance floor)
    for uid, orig, synth in pairs:
        wo, sr = read_wav(orig)
        ws, sr2 = read_wav(synth)
        assert sr == sr2, (sr, sr2)
        mo, ms = log_mel(wo, sr, device), log_mel(ws, sr, device)
        orig_mels[uid] = mo
        mcd, path = mcd_dtw(mo, ms)
        f0o = rapt_pitch(np.asarray(wo, np.float32), sr=sr)
        f0s = rapt_pitch(np.asarray(ws, np.float32), sr=sr)
        f0_rmse, vuv_err = f0_metrics(f0o, f0s, path)
        dur_o, dur_s = len(wo) / sr, len(ws) / sr
        row = {
            "id": uid,
            "mcd_dtw_db": round(mcd, 3),
            "f0_rmse_hz": round(f0_rmse, 2) if np.isfinite(f0_rmse) else None,
            "vuv_error_pct": round(100.0 * vuv_err, 2),
            "dur_error_pct": round(100.0 * abs(dur_s - dur_o) / max(dur_o, 1e-9), 2),
            "dur_orig_s": round(dur_o, 2),
            "dur_synth_s": round(dur_s, 2),
            "voiced_ratio_synth": round(voiced_ratio(ms), 3),
            "voiced_ratio_orig": round(voiced_ratio(mo), 3),
        }
        rows.append(row)
        print(f"{uid}: MCD-DTW {row['mcd_dtw_db']:.2f} dB  "
              f"F0-RMSE {row['f0_rmse_hz'] if row['f0_rmse_hz'] is not None else 'n/a'} Hz  "
              f"VUV-err {row['vuv_error_pct']:.1f}%  "
              f"dur {row['dur_orig_s']:.2f}s->{row['dur_synth_s']:.2f}s "
              f"({row['dur_error_pct']:.1f}%)  "
              f"voiced {row['voiced_ratio_orig']:.2f}->{row['voiced_ratio_synth']:.2f}")

    def _mean(key):
        vals = [r[key] for r in rows if r[key] is not None]
        return round(float(np.mean(vals)), 3) if vals else None

    summary = {
        "pairs": rows,
        "n_pairs": len(rows),
        "mean_mcd_dtw_db": _mean("mcd_dtw_db"),
        "mean_f0_rmse_hz": _mean("f0_rmse_hz"),
        "mean_vuv_error_pct": _mean("vuv_error_pct"),
        "mean_dur_error_pct": _mean("dur_error_pct"),
        "mean_voiced_ratio_synth": _mean("voiced_ratio_synth"),
    }
    # the chance floor: MCD-DTW between mismatched originals; a mean MCD near it means
    # no better than comparing arbitrary corpus audio
    uids = [r["id"] for r in rows]
    chance_pairs, chance_vals = [], []
    for uid, partner in chance_floor_pairs(uids):
        mcd_x, _ = mcd_dtw(orig_mels[uid], orig_mels[partner])
        chance_pairs.append([uid, partner])
        chance_vals.append(mcd_x)
    if chance_vals:
        floor = round(float(np.mean(chance_vals)), 3)
        summary["calibration"] = {
            "chance_floor_mcd_dtw_db": floor,
            "chance_pairs": chance_pairs,
            "margin_below_chance_db": (round(floor - summary["mean_mcd_dtw_db"], 3)
                                       if summary["mean_mcd_dtw_db"] is not None
                                       else None),
        }
        print(f"chance floor (mismatched originals): {floor:.2f} dB — "
              f"mean MCD margin below it: "
              f"{summary['calibration']['margin_below_chance_db']:+.2f} dB")
    pair_ids = sorted(r["id"] for r in rows)
    summary["protocol"] = {"pair_ids": pair_ids}
    if args.protocol and os.path.exists(args.protocol):
        with open(args.protocol) as f:
            manifest = json.load(f)
        summary["protocol"]["manifest_file"] = args.protocol
        summary["protocol"]["corpus"] = manifest.get("corpus")
        want = sorted(manifest.get("pair_ids", []))
        if want and want != pair_ids:
            summary["protocol"]["matches_manifest"] = False
            print(f"WARNING: evaluated pairs deviate from {args.protocol} — "
                  f"extra={sorted(set(pair_ids) - set(want))} "
                  f"missing={sorted(set(want) - set(pair_ids))}", file=sys.stderr)
        else:
            summary["protocol"]["matches_manifest"] = bool(want)
    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline) as f:
            base = json.load(f)
        base_ids = sorted(p.get("id") for p in base.get("pairs", []))
        comparable = base_ids == pair_ids
        trend = {}
        for k in ("mean_mcd_dtw_db", "mean_f0_rmse_hz", "mean_vuv_error_pct",
                  "mean_dur_error_pct"):
            if base.get(k) is not None and summary.get(k) is not None:
                trend[k] = {"baseline": base[k], "now": summary[k],
                            "delta": round(summary[k] - base[k], 3)}
        summary["trend_vs_baseline"] = {"baseline_file": args.baseline,
                                        "baseline_n_pairs": base.get("n_pairs",
                                                                     len(base.get("pairs", []))),
                                        "comparable": comparable,
                                        "metrics": trend}
        if not comparable:
            summary["trend_vs_baseline"]["reason"] = (
                "baseline was evaluated on a different devset pair list — deltas are "
                "not meaningful (VERDICT r4: r4-vs-r2 compared incomparables)")
            print(f"WARNING: baseline {args.baseline} pair list differs from this "
                  f"eval's — trend marked non-comparable", file=sys.stderr)
        for k, t in trend.items():
            arrow = ("improved" if t["delta"] < 0
                     else "flat" if t["delta"] == 0 else "regressed")
            if not comparable:
                arrow = "NOT COMPARABLE (different pair list)"
            print(f"trend {k}: {t['baseline']} -> {t['now']} ({t['delta']:+.3f}, {arrow})")
    out = os.path.join(args.dir, "quality_metrics.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"mean MCD-DTW {summary['mean_mcd_dtw_db']:.2f} dB over {len(rows)} pairs "
          f"-> {out}")
    return summary


if __name__ == "__main__":
    main()
