"""CSV-driven ASR dataset and collator — counterpart of
whisper_medusa_tpu/data/dataset.py.

A CSV with ``audio``, ``sentence`` and ``language`` columns; each item is
loaded (WAV or FLAC, ``data/audio.py``), resampled to 16 kHz and tokenized
with the Whisper prefix minus <|sot|>; the collator computes the log-mel
features through the port's ``ops/mel.py`` and pads the labels to a fixed
length with -100.  The CSV is read with the stdlib ``csv`` module (the JAX
package uses pandas).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import (EOS_TOKEN_ID, NO_TIMESTAMPS_ID,
                                             TASK_TRANSCRIBE_ID, language_token_id)
from whisper_medusa_tpu_torch.data.audio import load_audio, resample
from whisper_medusa_tpu_torch.ops import mel as mel_mod

IGNORE_INDEX = -100


def build_label_ids(sentence: str, language: str, tokenizer,
                    task_id: int = TASK_TRANSCRIBE_ID) -> List[int]:
    """Token ids of the Whisper prefix without the leading <|sot|>, the text
    and <|eos|> (the reference collator strips the decoder-start token)."""
    text_ids = tokenizer.encode(sentence, add_special_tokens=False)
    return [language_token_id(language), task_id, NO_TIMESTAMPS_ID, *text_ids,
            EOS_TOKEN_ID]


@dataclasses.dataclass
class ASRExample:
    audio_path: str
    sentence: str
    language: str


class ASRDataSet:
    """CSV-backed dataset (reference: dataset.py:15-104)."""

    def __init__(self, csv_path: str, tokenizer, language_fallback: str = "en"):
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        self.examples = [ASRExample(r["audio"], r.get("sentence") or "",
                                    r.get("language") or language_fallback)
                         for r in rows]
        self.tokenizer = tokenizer

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict:
        ex = self.examples[idx]
        audio, sr = load_audio(ex.audio_path)
        return {"audio": mel_mod.pad_or_trim(resample(audio, sr))[0],
                "labels": build_label_ids(ex.sentence, ex.language, self.tokenizer)}


@dataclasses.dataclass
class SpeechCollator:
    """Batch features and fixed-length label padding (reference:
    dataset.py:106-134).  Returns numpy arrays: ``input_features``
    (B, n_mels, 3000) float32, computed on ``device``, and ``labels``
    (B, max_label_length) int32 with -100 padding."""

    max_label_length: int = 224
    n_mels: int = 80
    device: str = "cuda"

    def __call__(self, items: Sequence[Dict]) -> Dict[str, np.ndarray]:
        audio = torch.from_numpy(np.stack([it["audio"] for it in items]))
        feats = mel_mod.log_mel_spectrogram(audio.to(self.device), n_mels=self.n_mels)
        labels = np.full((len(items), self.max_label_length), IGNORE_INDEX, np.int32)
        for i, it in enumerate(items):
            ids = it["labels"][: self.max_label_length]
            labels[i, : len(ids)] = ids
        return {"input_features": feats.cpu().numpy(), "labels": labels}


def batches(dataset: ASRDataSet, collator: SpeechCollator, batch_size: int,
            shuffle: bool = True, seed: int = 0, drop_last: bool = True):
    """Endless epoch iterator with a fixed batch size (numpy shuffling, the
    JAX package's order for the same seed)."""
    idx = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    while True:
        if shuffle:
            rng.shuffle(idx)
        for lo in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
            chunk = idx[lo: lo + batch_size]
            if drop_last and len(chunk) < batch_size:
                continue
            yield collator([dataset[int(i)] for i in chunk])
