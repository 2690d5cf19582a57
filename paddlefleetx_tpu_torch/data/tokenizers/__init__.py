"""Tokenizers of the PyTorch port: the GPT byte-level BPE tokenizer with
its native merge engine (``gpt_tokenizer.py``), registered in
``utils/registry.TOKENIZERS``."""
