"""The port's word-level front end (`ttscube_tpu_torch/data/text.py`: `Lexicon`,
`Text2Feat`) and its host twin of length regulation (`ops/length_regulator.py`:
`durations_to_frame2phone_np`, `expand_with_durations`) on the CPU against the JAX
package.

`Text2Feat` is held against JAX's with the same recording hook and the same lexicon:
`words`, `phones`, `phon2word`, `orig_text` and the lists the hook was called with must
be equal, on texts that cover the lexicon's override, repeated and mixed-case words,
newlines, punctuation, a text the lexicon covers whole (no call) and '_' phones. One
case takes the port's word G2P (`G2P("cpu").transcribe`, tiny widths) as the hook. The
numpy twin must equal JAX's twin (values and dtypes) and the port's torch function
exactly; `expand_with_durations` JAX's within 1e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as jentry
from ttscube_tpu.data import text as jtext
from ttscube_tpu.ops import length_regulator as jlr
from ttscube_tpu_torch import entry
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data import text as ttext
from ttscube_tpu_torch.models import g2p as tg
from ttscube_tpu_torch.ops import length_regulator as tlr
from tests.torch_parity import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

LEXICON = {"hello": ["h", "@", "l", "oU"], "it's": ["I", "t", "s"],
           "cat": ["k", "_", "{", "t"]}
TEXTS = {
    # tests/test_data.py's override case
    "override": "Hello world",
    "repeated": "the cat saw the dog and the dog saw the bird",
    "mixed_case": "HeLLo WORLD, World and world; HELLO",
    "newlines": "first line\nsecond line\n\nthird paragraph\n",
    "punctuation": "Hello, world! It's a test-case (really?): \"yes\" -- ok...",
    "lexicon_only": "Hello cat, it's hello.",
    "underscores": "a_b cat under_score",
    "no_words": "  ... ?! ",
    "empty": "",
}


class Recorder:
    """A G2P stub that records its calls: each word's phones are its upper-cased
    letters, with a '_' after every second one."""

    def __init__(self):
        self.calls = []

    def __call__(self, words):
        self.calls.append(list(words))
        return [[ph for k, c in enumerate(w) for ph in ([c.upper(), "_"] if k % 2 else
                                                       [c.upper()])] for w in words]


def _lexicons(lexicon):
    j, t = jtext.Lexicon(), ttext.Lexicon()
    j.word2phones, t.word2phones = dict(lexicon), dict(lexicon)
    return j, t


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_text2feat_matches_jax(case):
    jlex, tlex = _lexicons(LEXICON)
    jhook, thook = Recorder(), Recorder()
    want = jtext.Text2Feat(jhook, jlex)(TEXTS[case])
    got = ttext.Text2Feat(thook, tlex)(TEXTS[case])
    assert got == want
    assert thook.calls == jhook.calls
    assert set(got) == {"orig_text", "words", "phones", "phon2word"}
    assert "_" not in got["phones"]
    assert all(got["words"][i] for i in got["phon2word"])
    if case == "lexicon_only" or case in ("no_words", "empty"):
        assert thook.calls == []
    if case == "override":
        assert got["phones"][:5] == [" ", "h", "@", "l", "oU"]
        assert thook.calls == [["world"]]
    if case == "repeated":
        assert thook.calls == [["the", "saw", "the", "dog", "and", "the", "dog", "saw", "the",
                                "bird"]]
    if case == "newlines":
        assert "\n" not in got["orig_text"]


def test_text2feat_without_a_lexicon_calls_the_hook_for_every_word():
    jhook, thook = Recorder(), Recorder()
    want = jtext.Text2Feat(jhook)("Hello, it's me")
    got = ttext.Text2Feat(thook)("Hello, it's me")
    assert got == want and thook.calls == jhook.calls == [["Hello", "it's", "me"]]


def test_lexicon_files_load_in_either_package(tmp_path):
    jlex, tlex = _lexicons(LEXICON)
    jlex.word2phones["über"] = ["y", "b", "6"]
    jlex.save(str(tmp_path / "jax.json"))
    tlex.word2phones = {"zeta": ["z", "e", "t", "a"], "Upper": ["U"]}
    tlex.save(str(tmp_path / "port.json"))
    assert ttext.Lexicon(str(tmp_path / "jax.json")).word2phones == jlex.word2phones
    assert jtext.Lexicon(str(tmp_path / "port.json")).word2phones == tlex.word2phones
    back = ttext.Lexicon(str(tmp_path / "jax.json"))
    for word in ("HELLO", "Über", "cat", "dog", "upper"):
        assert (word in back) == (word in jlex)
    assert back["HeLLo"] == jlex["HeLLo"] == LEXICON["hello"]
    with pytest.raises(KeyError):
        back["dog"]


@pytest.fixture(scope="module")
def tiny_g2p(tmp_path_factory):
    """The port's word G2P on the CPU at tiny widths with seeded random weights,
    its vocabularies from a small lexicon."""
    lex = tmp_path_factory.mktemp("g2p") / "lexicon.tsv"
    lex.write_text("".join(f"{w}\t{' '.join(p)}\n" for w, p in (
        ("hello", "h @ l oU"), ("world", "w 3r l d"), ("wide", "w aI d"),
        ("dog", "d O g"), ("bird", "b 3r d"), ("the", "D @"), ("cat", "k { t"),
        ("old", "oU l d"), ("low", "l oU"))))
    g = tg.G2P("cpu")
    g.update_encodings(tg.G2PDataset(str(lex)), cutoff=1)
    g.model = init_random(tg.Seq2Seq(tg.Seq2SeqConfig(
        num_input_tokens=len(g.token2int), num_output_tokens=len(g.label2int),
        embedding_size=8, encoder_size=16, decoder_size=16)), 0)
    return g


def test_text2feat_with_the_ports_g2p_as_the_hook(tiny_g2p):
    """`G2P.transcribe` fits the hook as it is: the port and JAX give the same result
    with it, and each out-of-lexicon word carries the G2P's own transcription of it."""
    text = "Hello old world, the wide world of the bird!"
    jlex, tlex = _lexicons(LEXICON)
    seen = []

    def hook(words):
        seen.append(list(words))
        return tiny_g2p.transcribe(words)

    got = ttext.Text2Feat(hook, tlex)(text)
    want = jtext.Text2Feat(hook, jlex)(text)
    assert got == want
    assert seen[0] == seen[1] == ["old", "world", "the", "wide", "world", "of", "the", "bird"]
    own = dict(zip(seen[0], tiny_g2p.transcribe(seen[0])))
    for i, word in enumerate(got["words"]):
        phones = [p for p, k in zip(got["phones"], got["phon2word"]) if k == i]
        if word in own:
            assert phones == [p for p in own[word] if p != "_"], word
        elif word == "Hello":
            assert phones == LEXICON["hello"]
    assert any(own.values()), "the G2P transcribed every word to nothing"


def _ragged(B: int, N: int, seed: int):
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, N + 1, B).astype(np.int32)
    durs = rng.integers(0, 7, (B, N)).astype(np.int32)
    durs[np.arange(N)[None, :] >= n_valid[:, None]] = 0
    return durs, n_valid


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("frames", ["short", "long"])
def test_numpy_twin_matches_jax_and_torch(B, frames):
    durs, n_valid = _ragged(B, 12, seed=B)
    total = int(durs.sum(axis=1).max())
    F = max(total // 2, 1) if frames == "short" else total + 9
    got = tlr.durations_to_frame2phone_np(durs, n_valid, F)
    want = jlr.durations_to_frame2phone_np(durs, n_valid, F)
    f2p, mask = tlr.durations_to_frame2phone(torch.from_numpy(durs), torch.from_numpy(n_valid), F)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert np.array_equal(got[0], f2p.numpy()) and np.array_equal(got[1], mask.numpy())
    assert (got[1].sum(axis=1) == np.minimum(durs.sum(axis=1), F)).all()

    x = np.random.default_rng(B + 7).standard_normal((B, 12, 3)).astype(np.float32)
    jf, jp, jm = jlr.expand_with_durations(jnp.asarray(x), jnp.asarray(durs),
                                           jnp.asarray(n_valid), F)
    tf, tp, tm = tlr.expand_with_durations(torch.from_numpy(x), torch.from_numpy(durs),
                                           torch.from_numpy(n_valid), F)
    assert tf.shape == (B, F, 3)
    assert float(np.abs(tf.numpy() - np.asarray(jf)).max()) <= 1e-7
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(tm.numpy(), np.asarray(jm))


def test_example_batch_takes_the_twin():
    """`entry._example_batch` builds its frame map with the twin: every array equal to
    the JAX entry's, dtypes included."""
    want = jentry._example_batch(B=3)
    got = entry._example_batch(B=3)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
