"""The port's quality metric (`ttscube_tpu_torch/scripts/eval_drive_quality.py`) and
`.pitch` regeneration (`ttscube_tpu_torch/scripts/patch.py`) on the CPU, against the JAX
package's scripts and the committed `artifacts/quality_drive_r5/quality_metrics.json`,
which the JAX script wrote.

Every run works on copies in a temporary folder; nothing is written under `artifacts/`.

- Per pair, on 3 of the r5 pairs: MCD-DTW within 0.002 dB of the committed row (its
  rounding to 3 decimals plus the 2e-4 dB that the two packages' fp32 mels move it),
  every other field equal; the DTW path equal to the one JAX's `mcd_dtw` finds on JAX's
  log-mels.
- `dtw_path` (anti-diagonals) equal to the JAX script's double loop, cost and path, on
  inputs full of ties.
- The log-mel on the 3 pairs: the port's within 1e-5 of the peak of JAX's in linear mel,
  and within 1e-4 of JAX's in log10 where JAX's value is above -3. Just above -4 neither
  fp32 transform meets 1e-4 against the other or against the exact (fp64) transform of
  the same constants: JAX sits 1.4-2.0e-4 from it, the port 1.3e-5-4.6e-4, the two
  1.4-4.1e-4 apart (the bins of a frame far below its loudest, where fp32's rounding of
  the frame's DFT is a large part of the bin). Readings, one CPU thread: linear
  3.4-6.4e-7 of the peak; above -3, 2.1-4.5e-5.
- `slow`: all 12 pairs against the whole committed summary (~6 s alone).
- The trend protocol: a baseline with another pair list gives `comparable: false` and
  its reason; the same list gives `comparable: true` and the deltas.
- `patch`: the port's `.pitch` files byte-equal to JAX's `scripts/patch.py` `_patch`.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ttscube_tpu_torch.scripts import eval_drive_quality as tq
from ttscube_tpu_torch.scripts import patch as tpatch
from ttscube_tpu_torch.utils.wavio import read_wav, write_wav
from tests.torch_parity import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
R5 = ROOT / "artifacts" / "quality_drive_r5"
PAIRS = ("SPK0_00000000", "SPK1_00000002", "SPK2_00000003")
TOL_MCD = 0.002
TOL_LINEAR = 1e-5  # of the peak, linear mel
TOL_LOG = 1e-4
EQUAL_FIELDS = ("f0_rmse_hz", "vuv_error_pct", "dur_error_pct", "dur_orig_s", "dur_synth_s",
                "voiced_ratio_synth", "voiced_ratio_orig")

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jq():
    return jax_script("eval_drive_quality")


@pytest.fixture(scope="module")
def committed():
    return json.loads((R5 / "quality_metrics.json").read_text())


def copy_pairs(dest: Path, uids) -> Path:
    dest.mkdir(parents=True, exist_ok=True)
    for uid in uids:
        for kind in ("orig", "synth"):
            shutil.copyfile(R5 / f"{kind}_{uid}.wav", dest / f"{kind}_{uid}.wav")
    return dest


def assert_rows(rows, committed):
    want = {p["id"]: p for p in committed["pairs"]}
    for row in rows:
        ref = want[row["id"]]
        assert set(row) == set(ref), row["id"]
        assert abs(row["mcd_dtw_db"] - ref["mcd_dtw_db"]) <= TOL_MCD, row["id"]
        for k in EQUAL_FIELDS:
            assert row[k] == ref[k], (row["id"], k)


@pytest.fixture(scope="module")
def three_pairs(tmp_path_factory):
    """The port's script on a copy of 3 r5 pairs, with --device cpu: (folder, summary)."""
    folder = copy_pairs(tmp_path_factory.mktemp("q3"), PAIRS)
    return folder, tq.main(["--dir", str(folder), "--device", "cpu"])


_jax_mels = {}


def jax_log_mels(jq, uid):
    if uid not in _jax_mels:
        _jax_mels[uid] = [jq.log_mel(*read_wav(str(R5 / f"{kind}_{uid}.wav")))
                          for kind in ("orig", "synth")]
    return _jax_mels[uid]


def test_rows_match_the_committed_metrics(three_pairs, committed, jq):
    folder, summary = three_pairs
    assert [r["id"] for r in summary["pairs"]] == list(PAIRS)
    assert_rows(summary["pairs"], committed)
    written = json.loads((folder / "quality_metrics.json").read_text())
    assert written == summary
    assert set(summary) == set(committed) - {"trend_vs_baseline"}
    # three speakers: each original is scored against one of the others, as in JAX
    assert summary["calibration"]["chance_pairs"] == [
        list(p) for p in jq.chance_floor_pairs(list(PAIRS))]
    assert summary["protocol"]["pair_ids"] == list(PAIRS)
    assert summary["protocol"]["matches_manifest"] is False
    assert summary["protocol"]["corpus"] == committed["protocol"]["corpus"]


@pytest.mark.parametrize("uid", PAIRS)
def test_dtw_path_matches_jax(jq, uid):
    """The port's log-mels and DTW find the alignment JAX's log-mels and double loop
    find, and the same MCD within 1e-3 dB (2.0e-4 on SPK1_00000002)."""
    jm = jax_log_mels(jq, uid)
    pm = [tq.log_mel(*read_wav(str(R5 / f"{kind}_{uid}.wav"))) for kind in ("orig", "synth")]
    want_mcd, want_path = jq.mcd_dtw(*jm)
    got_mcd, got_path = tq.mcd_dtw(*pm)
    assert got_path == want_path
    assert abs(got_mcd - want_mcd) <= TOL_MCD / 2


@pytest.mark.parametrize("uids", [[], ["A_1"], ["A_1", "A_2"], ["A_1", "B_1"],
                                  ["A_1", "A_2", "A_3", "B_1", "C_1", "C_2"]])
def test_chance_floor_pairs_match_jax(jq, uids):
    assert tq.chance_floor_pairs(uids) == jq.chance_floor_pairs(uids)


@pytest.mark.parametrize("shape", [(1, 1), (1, 6), (7, 1), (5, 8), (13, 9), (40, 37)])
def test_dtw_path_is_the_double_loop(jq, shape):
    """Integer features in {0, 1, 2} make many equal costs: the first minimum in the
    order diagonal, up, left decides, as in the JAX script's loop."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    a = rng.integers(0, 3, (shape[0], 2)).astype(np.float64)
    b = rng.integers(0, 3, (shape[1], 2)).astype(np.float64)
    assert tq.dtw_path(a, b) == jq.dtw_path(a, b)


@pytest.mark.parametrize("uid", PAIRS)
def test_log_mel_matches_jax(jq, uid):
    for (wav, sr), want in zip((read_wav(str(R5 / f"{k}_{uid}.wav")) for k in ("orig", "synth")),
                               jax_log_mels(jq, uid)):
        got = tq.log_mel(wav, sr, "cpu")
        assert got.shape == want.shape == (len(wav) // 240 + 1, 80) and got.dtype == np.float32
        lin_got, lin_want = 10.0 ** got.astype(np.float64), 10.0 ** want.astype(np.float64)
        assert np.abs(lin_got - lin_want).max() <= TOL_LINEAR * lin_want.max()
        assert np.abs(got - want)[want > -3].max() <= TOL_LOG


@pytest.mark.slow
def test_the_whole_r5_set_matches_the_committed_summary(tmp_path, committed):
    uids = committed["protocol"]["pair_ids"]
    summary = tq.main(["--dir", str(copy_pairs(tmp_path, uids)), "--device", "cpu"])
    assert [r["id"] for r in summary["pairs"]] == uids
    assert_rows(summary["pairs"], committed)
    assert summary["n_pairs"] == committed["n_pairs"] == 12
    assert abs(summary["mean_mcd_dtw_db"] - committed["mean_mcd_dtw_db"]) <= TOL_MCD
    for k in ("mean_f0_rmse_hz", "mean_vuv_error_pct", "mean_dur_error_pct",
              "mean_voiced_ratio_synth"):
        assert summary[k] == committed[k], k
    cal, want = summary["calibration"], committed["calibration"]
    assert cal["chance_pairs"] == want["chance_pairs"]
    assert abs(cal["chance_floor_mcd_dtw_db"] - want["chance_floor_mcd_dtw_db"]) <= TOL_MCD
    assert abs(cal["margin_below_chance_db"] - want["margin_below_chance_db"]) <= 2 * TOL_MCD
    assert summary["protocol"]["matches_manifest"] is True
    assert summary["protocol"]["pair_ids"] == committed["protocol"]["pair_ids"]


def test_trend_against_a_baseline_of_another_pair_list(tmp_path, committed, capsys):
    folder = copy_pairs(tmp_path / "one", PAIRS[:1])
    base = tmp_path / "base.json"
    base.write_text(json.dumps(committed))
    summary = tq.main(["--dir", str(folder), "--device", "cpu", "--baseline", str(base),
                       "--protocol", ""])
    trend = summary["trend_vs_baseline"]
    assert trend["comparable"] is False and "different devset pair list" in trend["reason"]
    assert trend["baseline_n_pairs"] == 12
    assert trend["metrics"]["mean_mcd_dtw_db"]["baseline"] == committed["mean_mcd_dtw_db"]
    assert "calibration" not in summary  # one pair: no mismatched partner
    assert summary["protocol"] == {"pair_ids": list(PAIRS[:1])}
    assert "NOT COMPARABLE" in capsys.readouterr().out
    # the same pair list: comparable, with the deltas
    again = dict(summary, mean_mcd_dtw_db=summary["mean_mcd_dtw_db"] + 1.0)
    base.write_text(json.dumps(again))
    trend = tq.main(["--dir", str(folder), "--device", "cpu", "--baseline", str(base),
                     "--protocol", ""])["trend_vs_baseline"]
    assert trend["comparable"] is True and "reason" not in trend
    assert trend["metrics"]["mean_mcd_dtw_db"]["delta"] == -1.0


def test_the_script_takes_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    folder = copy_pairs(tmp_path, PAIRS[:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.main(["--dir", str(folder)])
    assert not (folder / "quality_metrics.json").exists()


def test_patch_matches_jax(tmp_path):
    """Two wavs, one at the target rate and one resampled to it: the port's `.pitch`
    files byte-equal to JAX's."""
    rng = np.random.default_rng(3)
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
    for name, sr, seconds in (("a", 24000, 0.9), ("b", 16000, 0.7)):
        t = np.arange(int(sr * seconds)) / sr
        f0 = 110 + 60 * t
        y = 0.5 * np.sin(2 * np.pi * np.cumsum(f0) / sr) + 0.01 * rng.standard_normal(len(t))
        y[: len(y) // 4] = 0.002 * rng.standard_normal(len(y) // 4)  # an unvoiced start
        for who in ("port", "jax"):
            write_wav(str(tmp_path / who / f"{name}.wav"), y.astype(np.float32), sr)
    (tmp_path / "port" / "notes.txt").write_text("not a wav")
    done = tpatch.main(["--folder", str(tmp_path / "port"), "--sample-rate", "24000",
                        "--hop-size", "240"])
    jax_script("patch")._patch(str(tmp_path / "jax"), 24000, 240)
    assert [Path(b).name for b in done] == ["a", "b"]
    for name in ("a", "b"):
        got = (tmp_path / "port" / f"{name}.pitch").read_bytes()
        assert got == (tmp_path / "jax" / f"{name}.pitch").read_bytes(), name
        pitch = np.load(tmp_path / "port" / f"{name}.pitch")
        assert (pitch > 0).any() and (pitch == 0).any()
