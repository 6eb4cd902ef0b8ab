"""First-party Whisper byte-level BPE tokenizer — the port's own copy of
whisper_medusa_tpu/data/bpe.py.

The reference leans on HF ``WhisperProcessor``/``WhisperTokenizer`` for every
ids<->text conversion (reference: whisper_medusa/trainer.py:21-23,
eval_whisper_medusa.py:27-29).  This module removes that runtime dependency
from the product path: it loads the ``vocab.json``/``merges.txt`` files that
ship in every Whisper checkpoint directory and implements GPT-2-style
byte-level BPE — encode, decode, special/timestamp token handling — in plain
Python.  Numerics are pinned by a parity test against
``transformers.WhisperTokenizer`` instantiated from the same files
(tests/test_bpe_tokenizer.py).

Byte-level BPE in three steps (same construction as GPT-2 / Whisper):

  1. pre-tokenize text with the GPT-2 regex (contractions, letter runs, number
     runs, punctuation runs, whitespace);
  2. map each pre-token's UTF-8 bytes through the reversible byte<->unicode
     table (256 printable stand-ins, so the BPE vocab never contains raw
     control bytes);
  3. greedily apply the learned merge ranks until no adjacent pair is
     mergeable, then look each resulting symbol up in the vocab.

Decode inverts: ids -> token strings -> byte stand-ins -> UTF-8.  Ids at or
above the special block (<|endoftext|> onward) render their canonical
``<|...|>`` strings — timestamp ids, which live *outside* vocab.json, are
synthesized as ``<|t.tt|>`` — or are dropped under ``skip_special_tokens``.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from whisper_medusa_tpu_torch.config import SpecialTokens

# GPT-2's pre-tokenization pattern, used verbatim by HF WhisperTokenizer.
_PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table: printable ASCII and
    two Latin-1 ranges map to themselves; the remaining 68 bytes map to
    256 + running_index so every byte has a visible stand-in."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_SPECIAL_NAMES = {
    "<|endoftext|>": "eos",
    "<|startoftranscript|>": "sot",
    "<|translate|>": "translate",
    "<|transcribe|>": "transcribe",
    "<|startoflm|>": "start_of_lm",
    "<|startofprev|>": "start_of_prev",
    "<|nospeech|>": "no_speech",
    "<|notimestamps|>": "no_timestamps",
}


def _special_from_added_tokens(added: Dict[str, int],
                               vocab: Dict[str, int]) -> SpecialTokens:
    """Derive the SpecialTokens layout from a checkpoint's actual token files.

    ``added_tokens.json`` names every special with its true id — this handles
    the large-v3 vocabulary (``<|yue|>`` inserted at the end of the language
    block shifts every later id by one) without the vocab-size heuristic."""
    import dataclasses as _dc

    import regex

    kw = {attr: added[s] for s, attr in _SPECIAL_NAMES.items() if s in added}
    if "<|endoftext|>" in vocab and "eos" not in kw:
        kw["eos"] = vocab["<|endoftext|>"]
    lang_pat = regex.compile(r"<\|[a-z]{2,3}\|>$")
    lang_ids = sorted(v for k, v in added.items()
                      if lang_pat.match(k) and k not in _SPECIAL_NAMES)
    if lang_ids:
        kw["first_language"] = lang_ids[0]
        kw["num_languages"] = len(lang_ids)
    if "no_timestamps" in kw:
        kw["timestamp_begin"] = kw["no_timestamps"] + 1
    if kw:
        return _dc.replace(SpecialTokens(), **kw)
    vocab_size = max(len(vocab) + len(added),
                     max(added.values(), default=0) + 1)
    return SpecialTokens.for_vocab(max(vocab_size, 50257))


class WhisperBPETokenizer:
    """Byte-level BPE tokenizer over a Whisper ``vocab.json``/``merges.txt``.

    API-compatible with the subset of ``transformers.WhisperTokenizer`` this
    framework consumes: ``encode(text, add_special_tokens=False)``,
    ``decode(ids, skip_special_tokens=...)``, ``batch_decode``, plus
    ``decode_with_timestamps`` rendering for ids beyond the vocab.
    """

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 special: Optional[SpecialTokens] = None,
                 added_tokens: Optional[Dict[str, int]] = None,
                 time_precision: float = 0.02, errors: str = "replace"):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.errors = errors
        self.time_precision = time_precision
        self._cache: Dict[str, str] = {}
        # Special block: everything at/after <|endoftext|>.  Derive canonical
        # strings from the vocabulary layout, then let checkpoint-provided
        # added_tokens override/extend (added_tokens.json in HF checkpoints).
        self.special = special or SpecialTokens.for_vocab(
            max(len(self.encoder), 50257))
        st = self.special
        sp: Dict[int, str] = {
            st.eos: "<|endoftext|>",
            st.sot: "<|startoftranscript|>",
            st.translate: "<|translate|>",
            st.transcribe: "<|transcribe|>",
            st.start_of_lm: "<|startoflm|>",
            st.start_of_prev: "<|startofprev|>",
            st.no_speech: "<|nospeech|>",
            st.no_timestamps: "<|notimestamps|>",
        }
        for i, lang in enumerate(st.languages):
            sp[st.first_language + i] = f"<|{lang}|>"
        if added_tokens:
            for tok_str, tok_id in added_tokens.items():
                sp[int(tok_id)] = tok_str
        self.special_id_to_str = sp
        self.special_str_to_id = {s: i for i, s in sp.items()}
        self._first_special = min(sp) if sp else st.eos

    # ------------------------------------------------------------------ loading
    @classmethod
    def from_pretrained(cls, path: str,
                        special: Optional[SpecialTokens] = None,
                        ) -> "WhisperBPETokenizer":
        """Load from a checkpoint/assets directory holding ``vocab.json`` +
        ``merges.txt`` (the files every HF Whisper checkpoint ships)."""
        vpath = os.path.join(path, "vocab.json")
        mpath = os.path.join(path, "merges.txt")
        if not (os.path.isfile(vpath) and os.path.isfile(mpath)):
            raise FileNotFoundError(
                f"no vocab.json + merges.txt under {path}")
        with open(vpath, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(mpath, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        added: Dict[str, int] = {}
        apath = os.path.join(path, "added_tokens.json")
        if os.path.isfile(apath):
            with open(apath, encoding="utf-8") as f:
                added = {k: int(v) for k, v in json.load(f).items()}
        if special is None:
            special = _special_from_added_tokens(added, vocab)
        return cls(vocab, merges, special=special, added_tokens=added)

    # ------------------------------------------------------------------- encode
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Text -> BPE ids.  ``add_special_tokens=False`` matches how this
        framework builds label/prompt sequences (init tokens are constructed
        from :class:`SpecialTokens` ids, not re-tokenized strings)."""
        import regex

        ids: List[int] = []
        # Split on literal special-token strings first (HF AddedToken
        # behavior), longest match first so e.g. <|startoftranscript|> is not
        # shadowed by a shorter special.
        segments = [text]
        for sp_str in sorted(self.special_str_to_id, key=len, reverse=True):
            next_segments: List[str] = []
            for seg in segments:
                if seg in self.special_str_to_id:
                    next_segments.append(seg)
                    continue
                parts = seg.split(sp_str)
                for i, part in enumerate(parts):
                    if i:
                        next_segments.append(sp_str)
                    if part:
                        next_segments.append(part)
            segments = next_segments
        for seg in segments:
            if seg in self.special_str_to_id:
                ids.append(self.special_str_to_id[seg])
                continue
            for tok in regex.findall(_PAT, seg):
                tok_b = "".join(self.byte_encoder[b]
                                for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(tok_b).split(" "))
        if add_special_tokens:
            st = self.special
            ids = [st.sot] + ids + [st.eos]
        return ids

    # ------------------------------------------------------------------- decode
    def _special_str(self, i: int) -> str:
        if i in self.special_id_to_str:
            return self.special_id_to_str[i]
        st = self.special
        if i >= st.timestamp_begin:
            return f"<|{(i - st.timestamp_begin) * self.time_precision:.2f}|>"
        return ""

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True,
               decode_with_timestamps: bool = False) -> str:
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                text = "".join(buf)
                data = bytearray(self.byte_decoder[c] for c in text)
                out.append(data.decode("utf-8", errors=self.errors))
                buf.clear()

        st = self.special
        for i in ids:
            i = int(i)
            if i >= self._first_special or i not in self.decoder:
                if skip_special_tokens and not (
                        decode_with_timestamps and i >= st.timestamp_begin):
                    continue
                flush()
                out.append(self._special_str(i))
            else:
                buf.append(self.decoder[i])
        flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def get_vocab(self) -> Dict[str, int]:
        v = dict(self.encoder)
        v.update({s: i for i, s in self.special_id_to_str.items()})
        return v

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.special_id_to_str.get(int(i),
                                           self.decoder.get(int(i), ""))
                or self._special_str(int(i)) for i in ids]

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b) in sorted(self.bpe_ranks, key=self.bpe_ranks.get):
                f.write(f"{a} {b}\n")
