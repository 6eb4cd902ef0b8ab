"""Tokenizers and audio helpers of the port (copies of
whisper_medusa_tpu/data/{tokenizer,bpe}.py and of the resampling in
whisper_medusa_tpu/data/dataset.py)."""
