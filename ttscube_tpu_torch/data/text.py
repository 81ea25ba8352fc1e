"""Text front end, counterpart of `ttscube_tpu/data/text.py` (`SimpleTokenizer`,
`Text2FeatBlizzard`): tokenize, run the aligned phonemizer over the raw characters,
strip '_' deletions and rebuild phon2word."""

from __future__ import annotations

import dataclasses

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
