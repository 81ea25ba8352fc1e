"""Build a local HF-format BERT directory for HF conditioning: counterpart of
`scripts/make_demo_lm.py`, written without `transformers` or `tokenizers`.

    python -m ttscube_tpu_torch.scripts.make_demo_lm --output data/demo_lm \
        [--hidden 768 --layers 12 --heads 12 --pad-vocab 30522]

It writes, in the files `transformers.AutoTokenizer` and `BertModel.from_pretrained`
read:

  * `tokenizer.json`: a WordPiece model with a Metaspace pre-tokenizer over the pieces
    of the demo lexicon (`make_demo_corpus.WORDS`): words of more than 4 characters
    split into a word-start piece ("▁" + 3 characters) and a continuation piece ("##"
    + the rest), so that the word→token walk meets words of several tokens; with
    `--pad-vocab N` the vocabulary is filled with `[unusedK]` entries to N rows (BERT's
    30,522 gives the embedding table its real size);
  * `tokenizer_config.json` and `special_tokens_map.json` (`[PAD]` and `[UNK]`);
  * `config.json`, BERT's;
  * `pytorch_model.bin`: a seeded `TransformerEncoder` of the port
    (`models/lm.py`, BERT's initialisation) under HF `BertModel` names, no dropout.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

TOKENIZER_CLASS = "PreTrainedTokenizerFast"
SPECIAL = ("[PAD]", "[UNK]")


def build_vocab(pad_to: int = 0) -> list:
    """The demo lexicon's word pieces after [PAD] and [UNK], then "▁_", "▁." and ".";
    filled with [unusedK] entries to `pad_to` rows."""
    from ttscube_tpu_torch.scripts.make_demo_corpus import WORDS

    vocab = list(SPECIAL)
    seen = set(vocab)
    for w in sorted(WORDS):
        pieces = ["▁" + w] if len(w) <= 4 else ["▁" + w[:3], "##" + w[3:]]
        for p in pieces:
            if p not in seen:
                seen.add(p)
                vocab.append(p)
    for extra in ("▁_", "▁.", "."):  # the space placeholder and sentence punctuation
        if extra not in seen:
            seen.add(extra)
            vocab.append(extra)
    if pad_to and pad_to < len(vocab):
        raise ValueError(f"--pad-vocab {pad_to} is below the {len(vocab)} pieces")
    vocab += [f"[unused{k}]" for k in range(max(pad_to - len(vocab), 0))]
    return vocab


def tokenizer_json(vocab: list) -> dict:
    """The `tokenizer.json` of a WordPiece + Metaspace tokenizer, as `tokenizers` writes
    it."""
    ids = {w: i for i, w in enumerate(vocab)}
    added = [{"id": ids[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for t in sorted(SPECIAL, key=ids.get)]
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordPiece", "unk_token": "[UNK]",
                      "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                      "vocab": ids}}


def tokenizer_config(vocab: list) -> dict:
    ids = {w: i for i, w in enumerate(vocab)}
    return {"added_tokens_decoder": {
        str(ids[t]): {"content": t, "lstrip": False, "normalized": False, "rstrip": False,
                      "single_word": False, "special": True}
        for t in sorted(SPECIAL, key=ids.get)},
        "clean_up_tokenization_spaces": False, "model_max_length": int(1e30),
        "pad_token": "[PAD]", "tokenizer_class": TOKENIZER_CLASS, "unk_token": "[UNK]"}


def bert_config(lm_config) -> dict:
    c = lm_config
    return {"architectures": ["BertModel"], "model_type": "bert",
            "attention_probs_dropout_prob": 0.0, "hidden_act": "gelu",
            "hidden_dropout_prob": c.dropout, "hidden_size": c.hidden_size,
            "initializer_range": 0.02, "intermediate_size": c.intermediate_size,
            "layer_norm_eps": c.layer_norm_eps, "max_position_embeddings": c.max_position,
            "num_attention_heads": c.num_heads, "num_hidden_layers": c.num_layers,
            "pad_token_id": c.pad_token_id, "position_embedding_type": "absolute",
            "type_vocab_size": c.type_vocab_size, "vocab_size": c.vocab_size}


def parser() -> ArgumentParser:
    p = ArgumentParser(description="a local HF-format BERT directory for HF conditioning")
    p.add_argument("--output", required=True)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--pad-vocab", dest="pad_vocab", type=int, default=0,
                   help="fill the vocabulary with [unusedK] entries to this many rows")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> str:
    """Write the directory; returns its path."""
    import torch

    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.lm import LMConfig, TransformerEncoder, bert_state_dict

    args = parser().parse_args(argv)
    vocab = build_vocab(args.pad_vocab)
    os.makedirs(args.output, exist_ok=True)
    cfg = LMConfig(vocab_size=len(vocab), hidden_size=args.hidden, num_layers=args.layers,
                   num_heads=args.heads, intermediate_size=4 * args.hidden, dropout=0.0)
    for name, obj in (("tokenizer.json", tokenizer_json(vocab)),
                      ("tokenizer_config.json", tokenizer_config(vocab)),
                      ("special_tokens_map.json", {"pad_token": "[PAD]", "unk_token": "[UNK]"}),
                      ("config.json", bert_config(cfg))):
        with open(os.path.join(args.output, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2, ensure_ascii=False)
    encoder = init_random(TransformerEncoder(cfg), args.seed)
    torch.save(bert_state_dict(encoder), os.path.join(args.output, "pytorch_model.bin"))
    print(f"wrote demo LM (vocab={len(vocab)}, hidden={args.hidden}, layers={args.layers}) "
          f"to {args.output}/")
    return args.output


if __name__ == "__main__":
    main()
