"""Tokenizers of the port (copies of whisper_medusa_tpu/data/{tokenizer,bpe}.py)."""
