"""Text front end of the port: tokenizer and phonemizer (copies of ``vits_tpu/text``)."""
