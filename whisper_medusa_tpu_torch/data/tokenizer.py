"""Tokenizer access (the port's own copy of whisper_medusa_tpu/data/tokenizer.py)
— first-party byte-level BPE when the checkpoint ships its
vocab files, HF tokenizer as a compatibility path, and a character-level
stand-in for tests/smoke runs.

The reference uses ``WhisperProcessor.from_pretrained`` for all ids<->text
conversion (reference: trainer.py:21-23, eval_whisper_medusa.py:27-29); the
product path here is :class:`whisper_medusa_tpu_torch.data.bpe.WhisperBPETokenizer`
(no ``transformers`` import needed), parity-tested against HF.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


def load_tokenizer(name_or_path: str, language: Optional[str] = None,
                   task: str = "transcribe"):
    """Load a tokenizer for a checkpoint dir or model name.

    Preference order: the first-party BPE tokenizer (``vocab.json`` +
    ``merges.txt`` in the directory — every Whisper checkpoint ships them),
    then the HF tokenizer from the local cache (compat path for bare model
    names; no network)."""
    if os.path.isdir(name_or_path):
        from whisper_medusa_tpu_torch.data.bpe import WhisperBPETokenizer

        try:
            return WhisperBPETokenizer.from_pretrained(name_or_path)
        except FileNotFoundError:
            pass
    from transformers import WhisperTokenizer

    return WhisperTokenizer.from_pretrained(
        name_or_path, language=language, task=task, local_files_only=True)


class CharTokenizer:
    """Deterministic char-level tokenizer over printable ASCII, mapped clear of the
    Whisper special-token id range.  decode(encode(s)) == s."""

    def __init__(self, offset: int = 100):
        self.offset = offset

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return [self.offset + (ord(c) - 32) for c in text if 32 <= ord(c) < 127]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if self.offset <= i < self.offset + 95:
                out.append(chr(32 + (i - self.offset)))
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]
