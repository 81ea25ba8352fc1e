"""The port's tokenizer (`ttscube_tpu_torch/utils/hf.py`, which reads `tokenizer.json`
itself) against the JAX package's `HFTokenizer` (`transformers.AutoTokenizer`) on local
fixtures built here with `tokenizers`: WordPiece + Metaspace, and Unigram + Metaspace
with "▁" a piece of its own (the only vocabulary that reaches the JAX walk's merge of a
lone "▁" with the next token). `tok_ids`, `toks` and `word2tok` must be equal. The
directory the port's `make_demo_lm` writes must load in `AutoTokenizer` and give the
same ids."""

import random

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from tokenizers import Tokenizer, normalizers  # noqa: E402
from tokenizers.models import BPE, Unigram, WordPiece  # noqa: E402
from tokenizers.pre_tokenizers import BertPreTokenizer, Metaspace  # noqa: E402

from ttscube_tpu.utils.hf import HFTokenizer as JaxHFTokenizer  # noqa: E402
from ttscube_tpu_torch.utils.hf import HFTokenizer  # noqa: E402

WP_VOCAB = ["[UNK]", "[PAD]", "▁hel", "##lo", "▁world", "▁w", "##1", "##2",
            "▁left", "▁words", "▁here", "▁right", "▁_", "▁x", "##x", "▁again"]
UNI_VOCAB = [("<unk>", 0.0), ("[PAD]", 0.0), ("▁", -1.0), ("hel", -3.0), ("lo", -3.5),
             ("▁hello", -8.0), ("▁world", -4.0), ("wor", -4.5), ("ld", -4.5),
             ("_", -5.0), ("h", -6.0), ("e", -6.0), ("l", -6.0), ("o", -6.0), ("x", -7.0)]
# " " words, out-of-vocabulary words, the empty sentence, a last word of several tokens
SENTENCES = ([], ["hello"], ["hello", "world", "hello"], ["hello", " ", "world"],
             [" ", "hello", " "], ["qq", "hello", "zz9"], ["world", "w12"],
             ["left", "words", "here", "xx", "hello"], ["HELLO", "World"], ["x", "lo"],
             ["hel[PAD]lo", "again"], ["hellohello"])


def _save(tok, tmp_path, name, unk):
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token=unk,
                                                pad_token="[PAD]")
    path = tmp_path / name
    fast.save_pretrained(str(path))
    return str(path)


def wordpiece_dir(tmp_path, scheme="always", lowercase=False, vocab=WP_VOCAB, name="wp"):
    tok = Tokenizer(WordPiece({w: i for i, w in enumerate(vocab)}, unk_token="[UNK]",
                              max_input_chars_per_word=8))
    tok.pre_tokenizer = Metaspace(prepend_scheme=scheme)
    if lowercase:
        tok.normalizer = normalizers.Lowercase()
    return _save(tok, tmp_path, name, "[UNK]")


def unigram_dir(tmp_path, scheme="always", lowercase=False, vocab=UNI_VOCAB, name="uni"):
    tok = Tokenizer(Unigram(vocab, unk_id=0))
    tok.pre_tokenizer = Metaspace(prepend_scheme=scheme)
    if lowercase:
        tok.normalizer = normalizers.Lowercase()
    return _save(tok, tmp_path, name, "<unk>")


def _same(path, sentences):
    jt, pt = JaxHFTokenizer(path), HFTokenizer(path)
    for words in sentences:
        want, got = jt(list(words)), pt(list(words))
        assert got == want, (words, got, want)


@pytest.mark.parametrize("lowercase", [False, True], ids=["raw", "lowercase"])
@pytest.mark.parametrize("kind", ["wordpiece", "unigram"])
def test_tokenizer_matches_jax_on_fixtures(tmp_path, kind, lowercase):
    path = (wordpiece_dir if kind == "wordpiece" else unigram_dir)(tmp_path,
                                                                  lowercase=lowercase)
    _same(path, SENTENCES)
    got = HFTokenizer(path)(["hello", "world", "hello"])
    print(f"\nparity tokenizer {kind} {'lowercase' if lowercase else 'raw'}: "
          f"{len(SENTENCES)} sentences equal; e.g. {got['toks']} {got['word2tok']}")
    if kind == "unigram":  # "▁" is a token of its own, merged with the next by the walk
        out = HFTokenizer(path)(["hel", "lo"])
        assert JaxHFTokenizer(path)._tok.convert_ids_to_tokens(
            JaxHFTokenizer(path)._tok(["hel"], is_split_into_words=True,
                                      add_special_tokens=False)["input_ids"]) == ["▁", "hel"]
        assert out == {"toks": ["hel", "lo"], "tok_ids": [3, 4], "word2tok": {0: 0, 1: 1}}


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
@pytest.mark.parametrize("kind", ["wordpiece", "unigram"])
def test_tokenizer_matches_jax_on_random_words(tmp_path, kind, scheme):
    """Seeded random vocabularies and sentences: letters of a small alphabet, " "
    words, upper case, an added token inside a word, words longer than WordPiece's
    max_input_chars_per_word."""
    rng = random.Random(f"{kind}-{scheme}")
    pieces = sorted({"".join(rng.choice("abdehlo") for _ in range(rng.randint(1, 4)))
                     for _ in range(40)})
    if kind == "wordpiece":
        vocab = list(dict.fromkeys(["[PAD]", "[UNK]", "▁", "▁_"]
                                   + ["▁" + p for p in pieces[:20]]
                                   + ["##" + p for p in pieces[10:]] + pieces[:5]))
        path = wordpiece_dir(tmp_path, scheme, vocab=vocab, name="rand")
    else:
        vocab = list({p: (p, s) for p, s in
                      [("<unk>", 0.0), ("[PAD]", 0.0), ("▁", -1.5)]
                      + [("▁" + p, -rng.uniform(2, 12)) for p in pieces[:15]]
                      + [(p, -rng.uniform(2, 12)) for p in pieces[8:] if p not in "ao"]
                      }.values())
        path = unigram_dir(tmp_path, scheme, vocab=vocab, name="rand")

    def word():
        w = "".join(rng.choice("abdehlo") for _ in range(rng.randint(0, 9)))
        r = rng.random()
        return " " if r < 0.1 else w + "[PAD]" + w[:2] if r < 0.15 else \
            w.upper() if r < 0.2 else w

    _same(path, [[word() for _ in range(rng.randint(0, 6))] for _ in range(200)])


def test_demo_lm_directory_loads_in_auto_tokenizer(tmp_path):
    """The port's make_demo_lm writes a directory that AutoTokenizer loads (and
    BertModel, with the port's weights), giving the port's ids."""
    from ttscube_tpu_torch.scripts import make_demo_corpus, make_demo_lm

    path = make_demo_lm.main(["--output", str(tmp_path / "lm"), "--pad-vocab", "300"])
    auto = transformers.AutoTokenizer.from_pretrained(path)
    assert len(auto) == 300
    words = sorted(make_demo_corpus.WORDS) + [" ", "zzz", "ama."]
    want = auto(words, is_split_into_words=True, add_special_tokens=False)["input_ids"]
    assert HFTokenizer(path)._tok(words) == want
    _same(path, [words, words[:5], ["selami", "tokun"], []])
    assert max(len(v) for v in (auto.tokenize(w) for w in make_demo_corpus.WORDS)) == 2


@pytest.mark.parametrize("part,spec", [
    ("model", BPE(unk_token="[UNK]")), ("pre_tokenizer", BertPreTokenizer()),
    ("normalizer", normalizers.NFKC())], ids=["BPE", "BertPreTokenizer", "NFKC"])
def test_unported_components_raise(tmp_path, part, spec):
    tok = Tokenizer(spec if part == "model" else WordPiece({"[UNK]": 0, "[PAD]": 1},
                                                           unk_token="[UNK]"))
    if part != "model":
        setattr(tok, part, spec)
    path = _save(tok, tmp_path, "x", "[UNK]")
    with pytest.raises(NotImplementedError, match=type(spec).__name__):
        HFTokenizer(path)


def test_added_token_flags_not_ported_raise(tmp_path):
    """A user-added token (`normalized` set, matched after the normalizer) is refused
    by name rather than split in the wrong place."""
    tok = Tokenizer(WordPiece({w: i for i, w in enumerate(WP_VOCAB)}, unk_token="[UNK]"))
    tok.pre_tokenizer = Metaspace()
    tok.add_tokens(["lohel"])
    path = _save(tok, tmp_path, "added", "[UNK]")
    with pytest.raises(NotImplementedError, match="normalized"):
        HFTokenizer(path)
