"""Training CLI of the port — counterpart of whisper_medusa_tpu/cli/train.py.

  python -m whisper_medusa_tpu_torch.cli.train \
      --train-data-path train.csv --validation-data-path val.csv \
      --output-path out --whisper-size tiny

A local ``--whisper-model-name`` directory loads through ``from_pretrained``;
otherwise the model is drawn at random from ``--seed`` at ``--whisper-size``.
The run writes ``<output-path>/model_components/`` through
``save_pretrained`` (the JAX package's checkpoint format).  ``--device
cuda`` (the default) trains at either ``--param-dtype``: float32 (the
default) or bfloat16.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np

from whisper_medusa_tpu_torch.cli.args import (add_model_args, add_training_args,
                                               refuse_unported)
from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
from whisper_medusa_tpu_torch.data import dataset as ds_mod
from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer, load_tokenizer
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
from whisper_medusa_tpu_torch.training.trainer import MedusaTrainer, TrainingArgs

logger = logging.getLogger("whisper_medusa_tpu_torch")


def get_model(args) -> WhisperMedusaModel:
    """Fresh model unless --whisper-model-name is a local checkpoint dir."""
    if os.path.exists(args.whisper_model_name):
        return WhisperMedusaModel.from_pretrained(args.whisper_model_name,
                                                  device=args.device, dtype=args.param_dtype)
    dims = WHISPER_PRESETS[args.whisper_size]
    medusa = MedusaConfig(
        medusa_num_heads=args.medusa_num_heads,
        medusa_num_layers=args.medusa_num_layers,
        medusa_hidden_size=dims.d_model,
        medusa_choices=tuple(args.medusa_choices),
        medusa_heads_type=args.medusa_heads_type,
        medusa_loss_on_original=args.medusa_loss_on_original,
        medusa_kl_loss=args.medusa_kl_loss,
        medusa_kl_weight=args.medusa_kl_weight,
        output_whisper_original=args.output_whisper_original,
    )
    config = ModelConfig(dims=dims, medusa=medusa, param_dtype=args.param_dtype,
                         whisper_model_name=args.whisper_model_name)
    return WhisperMedusaModel.from_random(config, seed=args.seed, device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    add_training_args(parser)
    args = parser.parse_args(argv)
    refuse_unported(args)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    random.seed(args.seed)
    np.random.seed(args.seed)
    model = get_model(args)

    try:
        tokenizer = load_tokenizer(args.tokenizer_path or args.whisper_model_name,
                                   language=args.language)
    except Exception:
        logger.warning("tokenizer unavailable locally; using the CharTokenizer stand-in")
        tokenizer = CharTokenizer()

    collator = ds_mod.SpeechCollator(max_label_length=args.max_label_length,
                                     n_mels=model.config.dims.num_mel_bins,
                                     device=args.device)
    train_ds = ds_mod.ASRDataSet(args.train_data_path, tokenizer)
    val_ds = ds_mod.ASRDataSet(args.validation_data_path, tokenizer)
    train_iter = ds_mod.batches(train_ds, collator, args.batch_size, seed=args.seed)

    def eval_iter():
        return ds_mod.batches(val_ds, collator, args.batch_size, shuffle=False,
                              drop_last=False)

    targs = TrainingArgs(
        output_dir=args.output_path, batch_size=args.batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lr=args.lr, warmup_steps=args.warmup_steps, max_steps=args.max_steps,
        eval_steps=args.eval_steps, save_steps=args.save_steps,
        optim=args.optim, lr_scheduler_type=args.lr_scheduler_type,
        parts_to_freeze=None if args.parts_to_freeze == "none" else args.parts_to_freeze)
    trainer = MedusaTrainer(model.config, model.params, targs, train_iter,
                            eval_iter_fn=eval_iter)
    summary = trainer.train(resume_from_checkpoint=args.resume_from_checkpoint)

    # The trainer updated model.params in place.
    out_dir = os.path.join(args.output_path, "model_components")
    model.save_pretrained(out_dir)
    logger.info("training done: %s; saved to %s", summary, out_dir)

    if args.test_data_path:
        test_ds = ds_mod.ASRDataSet(args.test_data_path, tokenizer)
        trainer.eval_iter_fn = lambda: ds_mod.batches(
            test_ds, collator, args.batch_size, shuffle=False, drop_last=False)
        logger.info("test loss: %.4f", trainer.evaluate())
    return summary


if __name__ == "__main__":
    main()
