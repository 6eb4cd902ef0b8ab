"""Evaluation CLI of the port — counterpart of whisper_medusa_tpu/cli/evaluate.py:
WER / CER over a CSV of (audio, sentence[, language]) rows, with tokens per
second, mean accept length and wall-clock time.

  python -m whisper_medusa_tpu_torch.cli.evaluate \\
      --model-name CKPT_DIR --data-path test.csv --out-file-path preds.csv

``CKPT_DIR`` is the framework's checkpoint format or a reference
(``aiola/whisper-medusa-*``) one.  The CSV is read with the standard
library; audio through ``data/audio.py`` (WAV or FLAC, resampled to 16
kHz), features by the port's processor, text by the checkpoint's tokenizer
or, without one, the ``CharTokenizer`` stand-in.  ``--device cuda`` (the
default) serves on the card; ``--int8`` serves ``model.quantize()``,
``--disable-medusa`` the vanilla greedy loop, ``--num-beams k`` beam search.
``--dp/--tp`` serve on a mesh (``model.shard``) of that many processes, one
per rank (torchrun, or the multi-process flags, with ``--dist-backend``);
every rank decodes its examples of each batch and the primary process
writes the CSV.
"""

from __future__ import annotations

import argparse
import csv
import logging
import time

from whisper_medusa_tpu_torch.cli.args import (add_eval_args, make_mesh_from_args,
                                               maybe_init_distributed, refuse_unported)
from whisper_medusa_tpu_torch.data.audio import load_audio, resample
from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer, load_tokenizer
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
from whisper_medusa_tpu_torch.parallel import distributed
from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor
from whisper_medusa_tpu_torch.utils import metrics
from whisper_medusa_tpu_torch.utils.logging_utils import set_logger

OUT_FIELDS = ("audio", "label", "prediction", "language", "wer", "cer")


def read_rows(path: str):
    """The CSV's rows as dicts of strings (an empty cell is "", as the JAX
    CLI's ``fillna("")``)."""
    with open(path, newline="") as f:
        return [{k: (v if v is not None else "") for k, v in r.items()}
                for r in csv.DictReader(f)]


def evaluate_model(args) -> dict:
    """Transcribe every row, write the per-utterance CSV (``OUT_FIELDS``) to
    ``--out-file-path`` and return the summary: corpus WER and CER, tokens
    per second, mean accept length, total wall-clock seconds, utterances."""
    logger = logging.getLogger("whisper_medusa_tpu_torch")
    refuse_unported(args)
    records = read_rows(args.data_path)
    model = WhisperMedusaModel.from_pretrained(args.model_name, device=args.device,
                                               dtype=args.param_dtype)
    if args.int8:
        model = model.quantize()
        logger.info("int8 weight-only serving mode")
    mesh = make_mesh_from_args(args)
    if mesh is not None:
        model.shard(mesh)
        logger.info("sharded over mesh (dp=%d, tp=%d)", mesh.dp, mesh.tp)
    try:
        tokenizer = load_tokenizer(args.tokenizer_path or args.model_name,
                                   language=args.language)
    except Exception:
        logger.warning("tokenizer unavailable locally; decoding with CharTokenizer")
        tokenizer = CharTokenizer()
    proc = WhisperMedusaProcessor(n_mels=model.config.dims.num_mel_bins, device=args.device)
    penalty = None
    if args.regulation_factor != 1.0:
        penalty = (args.regulation_start, args.regulation_factor)

    rows, preds, refs = [], [], []
    total_tokens, total_time, total_steps, total_accept = 0, 0.0, 0, 0
    for lo in range(0, len(records), args.batch_size):
        chunk = records[lo: lo + args.batch_size]
        audios = [resample(*load_audio(r["audio"])) for r in chunk]
        feats = proc(audios)
        langs = [str(r.get("language") or args.language) for r in chunk]
        t0 = time.perf_counter()
        out = model.generate(feats, language=langs, max_length=args.max_length,
                             disable_medusa=args.disable_medusa,
                             exponential_decay_length_penalty=penalty,
                             num_beams=args.num_beams)
        dt = time.perf_counter() - t0
        total_time += dt
        total_tokens += int(out.lengths.sum()) - 4 * len(chunk)
        total_steps += out.steps
        total_accept += int(out.accepted.sum())
        texts = tokenizer.batch_decode(out.sequences, skip_special_tokens=True)
        for r, text in zip(chunk, texts):
            preds.append(text)
            refs.append(str(r["sentence"]))
            rows.append({"audio": r["audio"], "label": r["sentence"], "prediction": text,
                         "language": r.get("language", "")})
        logger.info("processed %d/%d (%.2fs)", lo + len(chunk), len(records), dt)

    wer, wers = metrics.compute_wer(preds, refs)
    cer, cers = metrics.compute_cer(preds, refs)
    for row, w, c in zip(rows, wers, cers):
        row["wer"], row["cer"] = w, c
    if distributed.is_primary():
        with open(args.out_file_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=OUT_FIELDS)
            writer.writeheader()
            writer.writerows(rows)
    distributed.sync()
    summary = {
        "wer": wer,
        "cer": cer,
        "tokens_per_second": total_tokens / max(total_time, 1e-9),
        "mean_accept_length": total_accept / max(total_steps, 1),
        "total_wall_clock_s": total_time,
        "utterances": len(records),
    }
    logger.info("eval summary: %s", summary)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_eval_args(parser)
    args = parser.parse_args(argv)
    maybe_init_distributed(args)
    set_logger()
    return evaluate_model(args)


if __name__ == "__main__":
    main()
