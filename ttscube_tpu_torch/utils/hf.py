"""HF tokenizer with a word→token map: counterpart of `ttscube_tpu/utils/hf.py`, which
delegates to `transformers.AutoTokenizer`. The port reads the model directory's
`tokenizer.json` itself (the card's machine has neither `transformers` nor
`tokenizers`) and reproduces `AutoTokenizer(words, is_split_into_words=True,
add_special_tokens=False)` for the components that file names:

  * the added tokens (`[UNK]`, `[PAD]`, ...), split out of each word before it is
    normalized, leftmost and longest first, as `tokenizers` does (`lstrip`/`rstrip`
    are moot: a word holds no whitespace once " " is mapped to "_");
  * normalizer: none or `Lowercase`;
  * pre-tokenizer: none or `Metaspace` (`replacement`, `prepend_scheme` always / first /
    never, `split`). Each word is pre-tokenized on its own, so under "always" and
    "first" each word gets its "▁";
  * model: `WordPiece` (greedy longest match first, `continuing_subword_prefix`,
    `unk_token`, `max_input_chars_per_word`) or `Unigram` (SentencePiece's Viterbi over
    the pieces' scores, an unknown character scored min − 10, runs of unknowns fused
    into one `unk_id`; no `byte_fallback`).

Any other component, and an added token with `normalized` or `single_word` set, raises
NotImplementedError naming it; the post-processor, the decoder, truncation and padding
change nothing here (no special tokens are added, and the call neither truncates nor
pads).

`HFTokenizer.__call__` then walks the tokens as the JAX class does, line for line: " "
words become "_", a lone "▁" token marks the next token as a word start, and
`word2tok` maps each word to its word-start token (with the walk's trailing sentinel
entry when the last word has continuation tokens).
"""

from __future__ import annotations

import json
import os

UNIGRAM_UNK_PENALTY = 10.0  # tokenizers' K_UNK_PENALTY


def _normalizer(spec):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Lowercase":
        return str.lower
    raise NotImplementedError(f"tokenizer.json normalizer '{kind}' is not ported "
                              "(ported: none, Lowercase)")


def _metaspace(spec):
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:  # the files of tokenizers < 0.15
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"Metaspace prepend_scheme '{scheme}' is not ported")
    split = spec.get("split", True)

    def run(pieces):
        out = []
        for s, first in pieces:
            s = s.replace(" ", rep)
            if s and not s.startswith(rep) and (scheme == "always" or
                                                (scheme == "first" and first)):
                s = rep + s
            if not split:
                out.append((s, first))
                continue
            # split on the replacement, each piece keeping the one it starts with
            start = 0
            for i in range(1, len(s)):
                if s[i] == rep:
                    out.append((s[start:i], first and start == 0))
                    start = i
            if s:
                out.append((s[start:], first and start == 0))
        return out
    return run


def _pre_tokenizer(spec):
    """A function from [(piece, at the word's start)] to the same, pre-tokenized."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Metaspace":
        return _metaspace(spec)
    raise NotImplementedError(f"tokenizer.json pre_tokenizer '{kind}' is not ported "
                              "(ported: none, Metaspace)")


class _WordPiece:
    def __init__(self, spec):
        self.vocab = dict(spec["vocab"])
        self.unk = spec["unk_token"]
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece unk_token '{self.unk}' is not in the vocabulary")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def id_to_token(self):
        return {i: t for t, i in self.vocab.items()}

    def __call__(self, word: str) -> list:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end, found = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    found = self.vocab[sub]
                    break
                end -= 1
            if found is None:
                return [self.vocab[self.unk]]
            out.append(found)
            start = end
        return out


class _Unigram:
    def __init__(self, spec):
        if spec.get("byte_fallback"):
            raise NotImplementedError("Unigram byte_fallback is not ported")
        self.pieces = [(p, float(s)) for p, s in spec["vocab"]]
        self.vocab = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(s for _, s in self.pieces) - UNIGRAM_UNK_PENALTY
        self.max_len = max(len(p) for p, _ in self.pieces)

    def id_to_token(self):
        return {i: p for i, (p, _) in enumerate(self.pieces)}

    def __call__(self, word: str) -> list:
        """tokenizers' `Unigram::encode_optimized`: the best path by summed scores, the
        pieces at each position tried shortest first, a later one taking a node only
        with a strictly higher score; an unknown character where no one-character
        piece starts."""
        n = len(word)
        best = [None] * (n + 1)  # (score, start, id) of the best path ending here
        best[0] = (0.0, None, None)
        for s in range(n):
            till = best[s][0]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                i = self.vocab.get(word[s:e])
                if i is None:
                    continue
                cand = till + self.pieces[i][1]
                if best[e] is None or cand > best[e][0]:
                    best[e] = (cand, s, i)
                single |= e == s + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: '{word[s]}' is unknown and there is no unk_id")
                cand = till + self.unk_score
                if best[s + 1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        pieces, unk, e = [], [], n
        while e > 0:
            _, s, i = best[e]
            if i == self.unk_id:
                unk.append(word[s:e])
            else:
                if unk:
                    pieces.append("".join(reversed(unk)))
                    unk = []
                pieces.append(word[s:e])
            e = s
        if unk:
            pieces.append("".join(reversed(unk)))
        return [self.vocab.get(p, self.unk_id) for p in reversed(pieces)]


def _model(spec):
    kind = spec.get("type")
    if kind == "WordPiece":
        return _WordPiece(spec)
    if kind == "Unigram":
        return _Unigram(spec)
    raise NotImplementedError(f"tokenizer.json model '{kind}' is not ported "
                              "(ported: WordPiece, Unigram)")


class TokenizerJson:
    """The tokenizer a `tokenizer.json` describes, for words given one by one."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        added = [a for a in spec.get("added_tokens") or [] if a.get("content")]
        for a in added:
            for flag in ("normalized", "single_word"):
                if a.get(flag):
                    raise NotImplementedError(f"added token '{a['content']}' with {flag} "
                                              "set is not ported")
        # longest first: at a position the longest added token matches
        self.added = sorted(added, key=lambda a: -len(a["content"]))
        self.id_to_token = self.model.id_to_token()
        self.id_to_token.update({a["id"]: a["content"] for a in added})

    def _split_added(self, word: str) -> list:
        """`word` split around the added tokens, leftmost first: [(text, at the word's
        start, the added token's id or None)]."""
        out, start, i = [], 0, 0
        while i < len(word):
            hit = next((a for a in self.added if word.startswith(a["content"], i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((word[start:i], start == 0, None))
            out.append((hit["content"], i == 0, hit["id"]))
            i = start = i + len(hit["content"])
        if start < len(word):
            out.append((word[start:], start == 0, None))
        return out

    def word_ids(self, word: str) -> list:
        """The token ids of one word."""
        ids = []
        for text, first, tid in self._split_added(word):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, _ in self.pre_tokenize([(self.normalize(text), first)]):
                ids += self.model(sub)
        return ids

    def __call__(self, words: list) -> list:
        return [i for w in words for i in self.word_ids(w)]

    def convert_ids_to_tokens(self, ids: list) -> list:
        return [self.id_to_token[i] for i in ids]


class HFTokenizer:
    """`HFTokenizer(model_dir)(words)` → {"toks", "tok_ids", "word2tok"}, as the JAX
    class gives it; `model_dir` is a local directory with a `tokenizer.json`."""

    def __init__(self, model_name: str):
        path = os.path.join(model_name, "tokenizer.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"'{path}' not found: the port reads a fast "
                                    "tokenizer's tokenizer.json from a local directory")
        self._tok = TokenizerJson(path)

    def __call__(self, sentence: list[str]) -> dict:
        if len(sentence) == 0:
            return {"tok_ids": [], "toks": [], "word2tok": {}}
        orig = list(sentence)
        sentence = ["_" if w == " " else w for w in sentence]
        iid = self._tok(sentence)
        toks = self._tok.convert_ids_to_tokens(iid)
        # a lone '▁' followed by a token: that token starts a word
        for i in range(1, len(toks)):
            if toks[i - 1] == "▁":
                toks[i] = "▁" + toks[i]
        word2tok = {}
        tok_ids = []
        it, iw = 0, 0
        while it < len(toks) or iw < len(orig):
            while it < len(toks) and (
                    toks[it].replace("▁", "").replace("_", "") == "" or
                    not toks[it].startswith("▁")):
                if toks[it].replace("▁", "").replace("_", "") != "":
                    tok_ids.append(iid[it])
                it += 1
            while iw < len(orig) and orig[iw] == " ":
                iw += 1
            if it < len(iid):
                tok_ids.append(iid[it])
            word2tok[iw] = len(tok_ids) - 1
            it += 1
            iw += 1
        return {"toks": self._tok.convert_ids_to_tokens(tok_ids),
                "tok_ids": tok_ids, "word2tok": word2tok}
