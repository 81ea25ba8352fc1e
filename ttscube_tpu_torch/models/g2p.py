"""Word-level grapheme→phoneme Seq2Seq with additive attention, counterpart of
`ttscube_tpu/models/g2p.py`.

A 2-layer BiLSTM(200) encoder over the word's characters; a 2-layer LSTM(200) decoder
that attends over the encoder at every step and stops at EOS. The JAX module runs the
decode as one `lax.scan` of a static length; here it is a Python loop over the same
steps, whose fed-back token and EOS mask stay tensors on the model's device.

The reference's quirk is kept: the attention query is the *cell* state of the last
decoder layer (its ``decoder_hidden[-1][-1]`` indexes the (h, c) pair and picks c).

`G2P` is the orchestration around it: vocabularies with a count cutoff, the
`{base}.encodings` JSON and `{base}.best`/`.model`/`.last` weights (the JAX package's
files), a lexicon that overrides the model, batched transcription and word accuracy.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn as nn

from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data.text import SimpleTokenizer
from ttscube_tpu_torch.models.blocks import Attention
from ttscube_tpu_torch.models.languasito import MaskedEmbed
from ttscube_tpu_torch.models.phonemizer import phonemizer_loss
from ttscube_tpu_torch.ops.linear import Dense
from ttscube_tpu_torch.ops.rnn import LSTM, LSTMCell
from ttscube_tpu_torch.utils.checkpoint import load_params

PAD, UNK, EOS = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    num_input_tokens: int
    num_output_tokens: int
    embedding_size: int = 100
    encoder_size: int = 200
    encoder_layers: int = 2
    decoder_size: int = 200
    decoder_layers: int = 2


class _S2SStep(nn.Module):
    """One decode step's parameters (the JAX tree's `step`, shared by every step)."""

    def __init__(self, c: Seq2SeqConfig):
        super().__init__()
        enc = 2 * c.encoder_size
        self.att = Attention(c.decoder_size, enc, att_proj_size=c.decoder_size)
        for i in range(c.decoder_layers):
            self.add_module(f"dec_cell_{i}", LSTMCell(
                enc + c.embedding_size if i == 0 else c.decoder_size, c.decoder_size))
        self.n_layers = c.decoder_layers
        self.output = Dense(c.decoder_size, c.num_output_tokens)
        self.output_emb = MaskedEmbed(c.num_output_tokens, c.embedding_size)

    def forward(self, states, last_emb, enc):
        _, weighted = self.att(states[-1][1], enc)  # the query: the last layer's cell
        h = torch.cat([weighted, last_emb], dim=-1)
        new_states = []
        for i in range(self.n_layers):
            st = getattr(self, f"dec_cell_{i}")(h, states[i])
            new_states.append(st)
            h = st[0]
        return new_states, self.output(h)


class Seq2Seq(nn.Module):
    """`model(x, gs_output=None, max_steps=None)` → (logits (B, T, num_output_tokens),
    done (B, T)).

    Teacher-forced when `gs_output` (B, T) is given; otherwise greedy and free-running
    for `max_steps` steps (default 10 × the input length). `done` marks the steps at and
    after the first predicted EOS."""

    def __init__(self, config: Seq2SeqConfig):
        super().__init__()
        c = self.config = config
        self.input_emb = MaskedEmbed(c.num_input_tokens, c.embedding_size)
        self.encoder = LSTM(c.embedding_size, c.encoder_size, num_layers=c.encoder_layers,
                            bidirectional=True)
        self.step = _S2SStep(config)

    def forward(self, x, gs_output=None, max_steps: int | None = None):
        c = self.config
        B, S = x.shape
        enc, _ = self.encoder(self.input_emb(x))
        dev = enc.device
        T = gs_output.shape[1] if gs_output is not None else (max_steps or 10 * S)
        states = [LSTMCell.initial_state(B, c.decoder_size, dev, enc.dtype)
                  for _ in range(c.decoder_layers)]
        last_emb = enc.new_zeros(B, c.embedding_size)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        logits, dones = [], []
        for t in range(T):
            states, lg = self.step(states, last_emb, enc)
            pred = lg.argmax(dim=-1)
            tok = gs_output[:, t].long() if gs_output is not None else pred
            last_emb = self.step.output_emb(tok)
            done = done | (pred == EOS)
            logits.append(lg)
            dones.append(done)
        return torch.stack(logits, dim=1), torch.stack(dones, dim=1)


# the same cross entropy as the phonemizer's: ignore PAD (0), mean over the rest
seq2seq_loss = phonemizer_loss


def greedy_decode(logits, done):
    """The free run's tokens: argmax, zeroed after the first EOS."""
    toks = logits.argmax(dim=-1)
    emitted_before_done = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]], dim=1)
    return torch.where(emitted_before_done, torch.zeros_like(toks), toks)


# -- G2P orchestration ------------------------------------------------------------------


class G2PDataset:
    """Tab-separated word → space-separated phones file."""

    def __init__(self, path: str):
        self.examples = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                self.examples.append((parts[0], parts[1].split(" ")))


class G2P:
    """Word-level G2P: vocabularies, lexicon override, batched transcription, on
    `device` (the card unless the caller asks for the CPU).

    Files as in the JAX package: `{base}.encodings` (token2int / label2int / label_list
    JSON) and the `{base}.best`/`.model`/`.last` weights (flax msgpack). Words are padded
    to a multiple of 4 characters, as the JAX class pads them: the encoder and the
    attention see the padding, so the length changes the result."""

    MAX_PHONES = 48  # the free run's length (words, not sentences)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.token2int = {"<PAD>": 0, "<UNK>": 1, "<EOS>": 2}
        self.label2int = {"<PAD>": 0, "<UNK>": 1, "<EOS>": 2}
        self.label_list = ["<PAD>", "<UNK>", "<EOS>"]
        self.lookup: dict[str, list[str]] = {}
        self.model: Seq2Seq | None = None
        self.simple_tokenizer = SimpleTokenizer()

    # -- persistence -------------------------------------------------------------

    def save(self, base: str):
        """The vocabularies as `{base}.encodings`."""
        with open(base + ".encodings", "w") as f:
            json.dump({"token2int": self.token2int, "label2int": self.label2int,
                       "label_list": self.label_list}, f, indent=2)

    def load(self, base: str, load_last: bool = False):
        """The vocabularies of `{base}.encodings` and the weights of `{base}.best`, else
        `.model`, else `.last` (only `.last` with `load_last`)."""
        with open(base + ".encodings") as f:
            obj = json.load(f)
        self.token2int = obj["token2int"]
        self.label2int = obj["label2int"]
        self.label_list = obj["label_list"]
        self.initialize_network()
        for ext in ([".last"] if load_last else [".best", ".model", ".last"]):
            if os.path.exists(base + ext):
                load_params(base + ext, self.model)
                return
        raise FileNotFoundError(f"no weights found at {base}.best/.model/.last")

    def load_lexicon(self, path: str):
        with open(path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                self.lookup[parts[0].lower()] = parts[1].split(" ")

    # -- setup -------------------------------------------------------------------

    def update_encodings(self, dataset: G2PDataset, cutoff: int = 2):
        """Characters and phones seen at least `cutoff` times enter the vocabularies."""
        t2c, l2c = {}, {}
        for word, trans in dataset.examples:
            for ch in word.lower():
                t2c[ch] = t2c.get(ch, 0) + 1
            for ph in trans:
                l2c[ph] = l2c.get(ph, 0) + 1
        for tok, n in t2c.items():
            if n >= cutoff:
                self.token2int[tok] = len(self.token2int)
        for lab, n in l2c.items():
            if n >= cutoff:
                self.label2int[lab] = len(self.label2int)
                self.label_list.append(lab)

    def initialize_network(self):
        """A Seq2Seq for the current vocabularies, with seeded random weights, on the
        device."""
        self.model = init_random(Seq2Seq(Seq2SeqConfig(
            num_input_tokens=len(self.token2int),
            num_output_tokens=len(self.label2int))), 0).to(self.device)

    # -- batching ----------------------------------------------------------------

    @staticmethod
    def _bucket(n: int, step: int = 4) -> int:
        return max(step, ((n + step - 1) // step) * step)

    def encode_words(self, words: list[str]) -> np.ndarray:
        max_len = self._bucket(max(len(w) for w in words) + 1)
        x = np.zeros((len(words), max_len), np.int64)
        for i, w in enumerate(words):
            for j, ch in enumerate(w.lower()):
                x[i, j] = self.token2int.get(ch, UNK)
            x[i, len(w)] = EOS
        return x

    def encode_labels(self, transcriptions: list[list[str]]) -> np.ndarray:
        max_len = self._bucket(max(len(t) for t in transcriptions) + 1)
        y = np.zeros((len(transcriptions), max_len), np.int64)
        for i, t in enumerate(transcriptions):
            for j, ph in enumerate(t):
                y[i, j] = self.label2int.get(ph, UNK)
            y[i, len(t)] = EOS
        return y

    # -- inference ---------------------------------------------------------------

    def transcribe(self, words: list[str]) -> list[list[str]]:
        """Each word's phones: a free run of MAX_PHONES steps, read up to EOS."""
        if not words:
            return []
        x = torch.from_numpy(self.encode_words(words)).to(self.device)
        self.model.eval()
        with torch.inference_mode():
            logits, done = self.model(x, max_steps=self.MAX_PHONES)
            toks = greedy_decode(logits, done).cpu().numpy()
        out = []
        for row in toks:
            tr = []
            for t in row:
                if t == EOS:
                    break
                if t not in (PAD, UNK):
                    tr.append(self.label_list[t])
            out.append(tr)
        return out

    def __call__(self, utterance: str, trace: bool = False):
        """Tokens of `utterance`, each with its transcription; a word in the lexicon
        takes the lexicon's."""
        tokens = self.simple_tokenizer(utterance)
        words = [t.word.lower() for t in tokens if t.is_word]
        transcriptions = self.transcribe(words) if words else []
        trace_words = []
        i = 0
        for token in tokens:
            if token.is_word:
                token.transcription = transcriptions[i]
                i += 1
                if token.word.lower() in self.lookup:
                    token.transcription = self.lookup[token.word.lower()]
            elif token.word == " ":
                token.transcription = [" "]
            elif token.word in ("-", '"'):
                token.transcription = ["_"]
            else:
                token.transcription = [""]
            trace_words.append({"word": token.word, "transcription": token.transcription})
        return (tokens, trace_words) if trace else tokens

    def evaluate(self, dataset: G2PDataset, batch_size: int = 64) -> float:
        """Word accuracy: the share of exact transcriptions."""
        err, total = 0, len(dataset.examples)
        for i in range(0, total, batch_size):
            batch = dataset.examples[i: i + batch_size]
            preds = self.transcribe([w for w, _ in batch])
            for (_, gold), pred in zip(batch, preds):
                if pred != gold:
                    err += 1
        return 1.0 - err / max(total, 1)
