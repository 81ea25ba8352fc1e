"""Text front end, counterpart of `ttscube_tpu/data/text.py`: `SimpleTokenizer`;
`Text2FeatBlizzard`, which runs the aligned phonemizer over the raw characters, strips
'_' deletions and rebuilds phon2word; and `Text2Feat`, the word-level front end, which
transcribes words through a G2P hook with a `Lexicon` that overrides it."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ttscube_tpu_torch.data.encodings import PhonemizerEncodings


@dataclasses.dataclass
class Token:
    word: str = ""
    is_word: bool = False


class SimpleTokenizer:
    """Char-class tokenizer: alpha/' runs are words, everything else is a 1-char token."""

    def __call__(self, utterance: str) -> list[Token]:
        tokens = []
        cb = ""
        for ch in utterance:
            if ch.isalpha() or ch == "'":
                cb += ch
            else:
                if cb:
                    tokens.append(Token(word=cb, is_word=True))
                    cb = ""
                tokens.append(Token(word=ch, is_word=False))
        if cb:
            tokens.append(Token(word=cb, is_word=True))
        return tokens


class Text2FeatBlizzard:
    """Sentence-level text → {orig_text, words, phones, phon2word} via the aligned
    phonemizer (a `ttscube_tpu_torch.models.phonemizer.Phonemizer` on `device`)."""

    def __init__(self, encodings: PhonemizerEncodings, phonemizer, device):
        self.encodings = encodings
        self.phonemizer = phonemizer
        self.device = torch.device(device)
        self.tokenizer = SimpleTokenizer()
        self.int2phon = [" "] * len(encodings.phonemes)
        for g, idx in encodings.phonemes.items():
            self.int2phon[idx] = g

    @torch.inference_mode()
    def __call__(self, text: str) -> dict:
        text = text.replace("\n\n", "§").replace("\n", " ")
        if not text.startswith("§"):
            text = "§" + text
        if not text.endswith("§"):
            text = text + "§"
        tokens = self.tokenizer(text)
        words = [t.word for t in tokens]

        n = len(text)
        x_char = np.zeros((1, n), np.int64)
        x_case = np.zeros((1, n), np.int64)
        for j, g in enumerate(text):
            low = g.lower()
            if low != g:
                x_case[0, j] = 1
            x_char[0, j] = self.encodings.grapheme2int.get(low, 0)
        X = {"x_char": torch.from_numpy(x_char).to(self.device),
             "x_case": torch.from_numpy(x_case).to(self.device)}
        pred = self.phonemizer(X).argmax(dim=-1)[0].cpu().numpy()
        phonemes = [self.int2phon[i] for i in pred]

        phon2word = []
        curated = []
        w_index, c_pos = 0, 0
        for ph in phonemes:
            if ph != "_":
                curated.append(ph)
                phon2word.append(w_index)
            c_pos += 1
            if w_index < len(words) and c_pos == len(words[w_index]):
                c_pos = 0
                w_index += 1
        return {"orig_text": text, "words": words, "phones": curated,
                "phon2word": phon2word}


class Lexicon:
    """Word → phones lookup with JSON persistence; words are looked up lower-cased."""

    def __init__(self, filename: str | None = None):
        self.word2phones: dict[str, list[str]] = {}
        if filename is not None:
            self.load(filename)

    def load(self, filename: str):
        with open(filename) as f:
            self.word2phones = json.load(f)

    def save(self, filename: str):
        with open(filename, "w") as f:
            json.dump(self.word2phones, f)

    def __contains__(self, word):
        return word.lower() in self.word2phones

    def __getitem__(self, word):
        return self.word2phones[word.lower()]


class Text2Feat:
    """Word-level front end: text → {orig_text, words, phones, phon2word}.

    `g2p_transcribe(words: list[str]) -> list[list[str]]` is the model hook (the port's
    `G2P.transcribe` fits it); it gets the words the lexicon lacks, in order and with
    duplicates, and is not called when there are none. The lexicon wins where it knows
    the word."""

    def __init__(self, g2p_transcribe, lexicon: Lexicon | None = None):
        self.g2p_transcribe = g2p_transcribe
        self.lexicon = lexicon or Lexicon()
        self.tokenizer = SimpleTokenizer()

    def __call__(self, text: str) -> dict:
        text = text.replace("\n\n", " ").replace("\n", " ")
        if not text.startswith(" "):
            text = " " + text
        if not text.endswith(" "):
            text = text + " "
        tokens = self.tokenizer(text)
        need_g2p = [t.word for t in tokens if t.is_word and t.word not in self.lexicon]
        transcriptions = dict(zip(need_g2p, self.g2p_transcribe(need_g2p))) if need_g2p else {}

        words, phones, phon2word = [], [], []
        for i, t in enumerate(tokens):
            words.append(t.word)
            if t.is_word:
                trans = (self.lexicon[t.word] if t.word in self.lexicon
                         else transcriptions.get(t.word, []))
            else:
                trans = [t.word] if t.word == " " else []
            for ph in trans:
                if ph != "_":
                    phones.append(ph)
                    phon2word.append(i)
        return {"orig_text": text, "words": words, "phones": phones,
                "phon2word": phon2word}
