"""Model packaging of the port: counterpart of `scripts/export_model.py`, with the same
flags and the same files, and no JAX, flax or yaml.

    python -m ttscube_tpu_torch.scripts.export_model --input-model data/cubegan \
        --input-phonemizer data/phonemizer --output-model dist/model

Keeps the text model and the generator of `{input-model}.last` as `{input-model}.model`
(the flax msgpack the JAX exporter writes, through `utils/serialization.py`), checks that
the phonemizer weights load into the aligned Phonemizer that TTSCube builds, tars
cubegan.{model,yaml,encodings} and phonemizer.{model,encodings}, splits the archive into
49 MB volumes `{output-model}-NN`, and writes the descriptor `{output-model}.yaml`
(`utils/config_io.py`). Conditioned models (fastText or HF, in the model's yaml) need LM
conditioning, which is not ported yet (ROADMAP.md A11.2), and raise.
"""

import os
import sys
import tarfile
from argparse import ArgumentParser


def _validate_phonemizer(base: str, weights_ext: str):
    """Fail early if the packaged weights do not load into the aligned Phonemizer that
    TTSCube builds (an M2M checkpoint, say)."""
    from ttscube_tpu_torch.api import phonemizer_config
    from ttscube_tpu_torch.convert import load_jax_params, read_msgpack
    from ttscube_tpu_torch.data.encodings import PhonemizerEncodings
    from ttscube_tpu_torch.models.phonemizer import Phonemizer

    penc = PhonemizerEncodings(base + ".encodings")
    try:
        load_jax_params(Phonemizer(phonemizer_config(penc)),
                        read_msgpack(f"{base}.{weights_ext}"))
    except Exception as e:
        raise SystemExit(
            f"'{base}.{weights_ext}' does not match the aligned Phonemizer template "
            f"the TTSCube API deserializes into ({e}).\nPackage a checkpoint trained "
            "with train_phonemizer.py --model-type aligned, or pass "
            "--phonemizer-weights pointing at one.") from e


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch model export")
    p.add_argument("--input-model", dest="input_model", required=True)
    p.add_argument("--input-phonemizer", dest="input_phonemizer", required=True)
    p.add_argument("--phonemizer-weights", dest="phonemizer_weights", default="sacc.best",
                   help="which phonemizer checkpoint to package (default sacc.best)")
    p.add_argument("--output-model", dest="output_model", required=True)
    p.add_argument("--wordvec", dest="wordvec", default=None,
                   help="word-vector table of a fastText-conditioned model (not ported "
                        "yet: A11.2)")
    p.add_argument("--version", dest="version", default="1.0.0")
    p.add_argument("--language", dest="language", default="multi")
    p.add_argument("--description", dest="description", default="")
    return p


def main(argv=None) -> int:
    """Export as the flags say; returns the number of volumes."""
    from ttscube_tpu_torch.convert import read_msgpack
    from ttscube_tpu_torch.utils import config_io
    from ttscube_tpu_torch.utils.repository import split_volumes
    from ttscube_tpu_torch.utils.serialization import msgpack_serialize, sorted_maps

    args = parser().parse_args(argv)
    conditioning = (config_io.load(args.input_model + ".yaml") or {}).get("conditioning")
    if conditioning:
        raise NotImplementedError(f"a model conditioned on {conditioning} is not ported "
                                  "yet (ROADMAP.md A11.2: HF and fastText conditioning)")

    sys.stdout.write("Loading model and removing discriminators... ")
    state = read_msgpack(args.input_model + ".last")
    slim = {k: v for k, v in state.items() if k in ("lang", "gen", "hf")}
    with open(args.input_model + ".model", "wb") as f:
        f.write(msgpack_serialize(sorted_maps(slim)))  # flax's msgpack_serialize
    sys.stdout.write("done\nCreating archive...\n")

    _validate_phonemizer(args.input_phonemizer, args.phonemizer_weights)

    tar_path = args.output_model + ".tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        for base, ext, out in ((args.input_model, "model", "cubegan.model"),
                               (args.input_model, "yaml", "cubegan.yaml"),
                               (args.input_model, "encodings", "cubegan.encodings"),
                               (args.input_phonemizer, args.phonemizer_weights,
                                "phonemizer.model"),
                               (args.input_phonemizer, "encodings", "phonemizer.encodings")):
            src = f"{base}.{ext}"
            sys.stdout.write(f"\t{src}\n")
            tar.add(src, out)

    sys.stdout.write("Splitting the model into multiple volumes... ")
    n = split_volumes(tar_path, args.output_model)
    os.unlink(tar_path)
    sys.stdout.write(f"{n} volumes\n")

    config_io.dump({"version": args.version, "phonemizer": "sentence",
                    "synthesis": "cubegan", "language": args.language,
                    "description": args.description}, args.output_model + ".yaml")
    return n


if __name__ == "__main__":
    main()
